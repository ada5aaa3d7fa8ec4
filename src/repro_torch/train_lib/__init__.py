"""The port's training step (the port of `repro/train_lib/`)."""
