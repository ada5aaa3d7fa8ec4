"""The port's checkpointing (the port of `repro/checkpoint/`)."""

from .checkpoint import Checkpointer, resume_or_init

__all__ = ["Checkpointer", "resume_or_init"]
