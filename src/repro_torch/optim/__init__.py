"""The optimizer and learning-rate schedules of the port's training step."""
