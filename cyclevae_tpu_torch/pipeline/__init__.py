"""Recipe stage drivers (so far: the stage-6 conversion engine, batching and
the train stage's helpers)."""
