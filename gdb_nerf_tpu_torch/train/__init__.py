"""Training: losses, optimizers and schedules, the train step, the trainer
loop and its recorder."""
