"""Synthetic data (numpy copies of the JAX package's generators), the
sharded LM pipeline, and the objectives."""
from .synthetic import logistic_dataset, partition, token_stream  # noqa: F401
from .objectives import (  # noqa: F401
    LogisticProblem, make_logistic_problem, LMProblem, make_lm_problem,
)
