"""Training utilities: checkpoints and the kv logger."""
