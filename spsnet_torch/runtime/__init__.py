"""Training runtime: optimizer and schedules, checkpoints, the train step
and the epoch loop."""
