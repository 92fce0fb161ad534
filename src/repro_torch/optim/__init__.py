"""Optimizers (``init`` / ``update`` pairs) and learning-rate schedules."""
from .optimizers import Optimizer, sgd, momentum, adamw  # noqa: F401
from .schedules import constant, cosine, step_decay, warmup_cosine  # noqa: F401
