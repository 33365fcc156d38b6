"""Derivative entry points that PDE residuals are written against.

Only the stacked-jet branch is ported: ``u`` is a
:class:`~pinnrl_tpu_torch.ops.jet_mlp.BundleView` holding the batched
derivative streams, and these functions return them. The residual code then
reads as in the JAX package, batched over N instead of under ``vmap``. The
generic engine (nested jvp over a black-box point function) is ROADMAP
item 10.
"""

from __future__ import annotations

from typing import Sequence

import torch

from pinnrl_tpu_torch.ops.jet_mlp import BundleView


def _require_bundle(u) -> BundleView:
    if not isinstance(u, BundleView):
        raise NotImplementedError(
            "the generic derivative engine (nested jvp) is not ported yet "
            "(ROADMAP item 10); only the stacked-jet BundleView is supported"
        )
    return u


def directional_derivative(u, z: torch.Tensor, axis: int, order: int) -> list:
    """Derivatives of orders 1..order of u along coordinate ``axis`` (batched)."""
    return _require_bundle(u).directional(axis, order)


def laplacian(u, z: torch.Tensor, spatial_axes: Sequence[int]) -> torch.Tensor:
    """Sum of pure second derivatives over the spatial axes (batched)."""
    view = _require_bundle(u)
    total = torch.zeros_like(view.value)
    for ax in spatial_axes:
        total = total + view.directional(ax, 2)[1]
    return total
