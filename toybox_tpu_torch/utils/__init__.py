"""Training utilities: checkpoints, the kv logger, the episode monitor,
schedules, small numpy helpers, profiling and FLOP accounting, and the
named benchmark suites."""
