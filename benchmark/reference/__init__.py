"""The plain reference: float32, step by step, from the models' equations.
It imports nothing of the measured program (a test holds this)."""
