"""Training: the optimizer and schedules, checkpoints, failure injection and
the fault-tolerant loop with its OCS controller tick."""
