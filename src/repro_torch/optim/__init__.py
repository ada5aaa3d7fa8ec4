"""The port's optimizer (the port of `repro/optim/`): AdamW over an f32
master copy, and the learning-rate schedules."""

from .adamw import AdamWConfig, apply_updates, global_norm, init_state
from .schedule import constant, linear_warmup_cosine

__all__ = ["AdamWConfig", "apply_updates", "constant", "global_norm",
           "init_state", "linear_warmup_cosine"]
