"""Collocation sampling strategies.

Every sampler returns ``(x, t)`` with ``x: (n, dim)`` and ``t: (n, 1)`` on
the generator's device. ``torch.Generator`` streams differ from
``jax.random``'s: tests inject identical points instead of matching seeds.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

Domain = Sequence[Tuple[float, float]]


def _bounds(domain: Domain, time_domain: Tuple[float, float], device):
    lo = torch.tensor([d[0] for d in domain] + [time_domain[0]], dtype=torch.float32, device=device)
    hi = torch.tensor([d[1] for d in domain] + [time_domain[1]], dtype=torch.float32, device=device)
    return lo, hi


def sample_uniform(
    generator: torch.Generator, n: int, domain: Domain, time_domain: Tuple[float, float]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """IID uniform points over space x time, drawn on the generator's device."""
    lo, hi = _bounds(domain, time_domain, generator.device)
    u = torch.rand((n, lo.shape[0]), generator=generator, device=generator.device)
    z = lo + (hi - lo) * u
    return z[:, :-1], z[:, -1:]


def sample_stratified(*args, **kwargs):
    raise NotImplementedError("stratified sampling is not ported yet (ROADMAP item 13)")


def sample_residual_based(*args, **kwargs):
    raise NotImplementedError("residual-based (RAR) sampling is not ported yet (ROADMAP item 7)")


def sample_adaptive(*args, **kwargs):
    raise NotImplementedError("RL-adaptive sampling is not ported yet (ROADMAP item 13)")
