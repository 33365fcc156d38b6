"""Collocation sampling: uniform, stratified, RAR and RL-adaptive (strategies.py)."""

from pinnrl_tpu_torch.sampling.strategies import (  # noqa: F401
    make_grid,
    sample_adaptive,
    sample_residual_based,
    sample_stratified,
    sample_uniform,
)
