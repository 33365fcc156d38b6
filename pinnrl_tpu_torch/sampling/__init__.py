"""Collocation sampling (uniform is ported; see strategies.py)."""

from pinnrl_tpu_torch.sampling.strategies import (  # noqa: F401
    sample_adaptive,
    sample_residual_based,
    sample_stratified,
    sample_uniform,
)
