"""Training-run support: runtime schedules and checkpoints."""
