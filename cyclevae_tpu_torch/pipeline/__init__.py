"""Recipe stages (so far: the stage-6 conversion engine, batching, the train
stage's helpers, and neural-vocoder synthesis)."""
