"""Collocation sampling strategies.

Every sampler returns ``(x, t)`` with ``x: (n, dim)`` and ``t: (n, 1)`` on
the generator's device. ``torch.Generator`` streams differ from
``jax.random``'s, so the deterministic part of each sampler is a helper that
takes its uniform draws as tensors (``_stratified``, ``_residual_based``,
``_adaptive_pick``, ``_gumbel_top_k``, ``_categorical``); the tests feed it
JAX's own draws. The public functions draw those tensors from the generator.

Residual-adaptive refinement (RAR) and the RL-scored grid stay on the
device: the weights, the draw and the gather never read a value back.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from pinnrl_tpu_torch.config import resolve_device

Domain = Sequence[Tuple[float, float]]

_TINY = torch.finfo(torch.float32).tiny
# Bounds and grids per (domain, device): building them is a host-to-device
# copy, which would make every step wait for the card.
_BOUNDS: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}
_GRIDS: Dict[tuple, torch.Tensor] = {}


def _key(domain: Domain, time_domain, device) -> tuple:
    return (tuple((float(lo), float(hi)) for lo, hi in domain),
            (float(time_domain[0]), float(time_domain[1])), torch.device(device))


def _bounds(domain: Domain, time_domain: Tuple[float, float], device):
    key = _key(domain, time_domain, device)
    got = _BOUNDS.get(key)
    if got is None:
        lo = torch.tensor([d[0] for d in domain] + [time_domain[0]], dtype=torch.float32, device=device)
        hi = torch.tensor([d[1] for d in domain] + [time_domain[1]], dtype=torch.float32, device=device)
        got = _BOUNDS[key] = (lo, hi)
    return got


def sample_uniform(
    generator: torch.Generator, n: int, domain: Domain, time_domain: Tuple[float, float]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """IID uniform points over space x time, drawn on the generator's device."""
    lo, hi = _bounds(domain, time_domain, generator.device)
    u = torch.rand((n, lo.shape[0]), generator=generator, device=generator.device)
    z = lo + (hi - lo) * u
    return z[:, :-1], z[:, -1:]


def _stratified(jitter: torch.Tensor, perm: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor):
    """Latin hypercube from ``jitter`` (d, n) in [0, 1) and one permutation
    of range(n) per dimension in ``perm`` (d, n)."""
    n = jitter.shape[1]
    centers = (torch.arange(n, device=jitter.device) + jitter) / n
    cols = [lo[i] + (hi[i] - lo[i]) * centers[i][perm[i]] for i in range(jitter.shape[0])]
    z = torch.stack(cols, dim=-1)
    return z[:, :-1], z[:, -1:]


def sample_stratified(
    generator: torch.Generator, n: int, domain: Domain, time_domain: Tuple[float, float]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Latin-hypercube sampling: one point per equal-width bin per dimension,
    bins independently shuffled per dimension."""
    lo, hi = _bounds(domain, time_domain, generator.device)
    d, dev = lo.shape[0], generator.device
    jitter, perm = [], []
    for _ in range(d):
        jitter.append(torch.rand((n,), generator=generator, device=dev))
        perm.append(torch.randperm(n, generator=generator, device=dev))
    return _stratified(torch.stack(jitter), torch.stack(perm), lo, hi)


def _gumbel_top_k(logp: torch.Tensor, u: torch.Tensor, n: int) -> torch.Tensor:
    """Weighted draw of n indices WITHOUT replacement (Gumbel top-k, Vieira
    2014) from the uniforms ``u`` (same shape as ``logp``)."""
    g = -torch.log(-torch.log(u + 1e-12) + 1e-12)
    return torch.topk(logp + g, n).indices


def _categorical(logp: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """n draws WITH replacement from the uniforms ``u`` (n, len(logp)) in
    (tiny, 1): the argmax of logp plus Gumbel noise, as jax.random.categorical."""
    return torch.argmax(logp - torch.log(-torch.log(u)), dim=-1)


def _pool_size(n: int, pool_factor: int, chunk_size: int) -> int:
    pool = pool_factor * n
    if pool > chunk_size:
        pool = -(-pool // chunk_size) * chunk_size
    return pool


def _residual_based(x_pool, t_pool, residual_fn: Callable, n: int, u: torch.Tensor, *,
                    eps: float, uniform_floor: float, power: float, replace: bool,
                    chunk_size: int):
    """Score the pool (in chunks of ``chunk_size``) and draw n of it with
    p ~ |r|^k / mean|r|^k + c, from the uniforms ``u`` ((pool,) without
    replacement, (n, pool) with)."""
    pool = x_pool.shape[0]
    if pool > chunk_size:
        r = torch.cat([
            torch.abs(residual_fn(x_pool[i:i + chunk_size], t_pool[i:i + chunk_size])).reshape(-1)
            for i in range(0, pool, chunk_size)
        ])
    else:
        r = torch.abs(residual_fn(x_pool, t_pool)).reshape(-1)
    if power != 1.0:
        r = r**power
    p = r / (torch.mean(r) + eps) + uniform_floor
    # All-zero weights (uniform_floor=0 and a zero residual field) would make
    # every logit -inf: draw uniformly over the pool instead.
    p = torch.where(torch.sum(p) > 0, p, torch.ones_like(p))
    idx = _categorical(torch.log(p), u) if replace else _gumbel_top_k(torch.log(p), u, n)
    return x_pool[idx], t_pool[idx]


def sample_residual_based(
    generator: torch.Generator,
    n: int,
    domain: Domain,
    time_domain: Tuple[float, float],
    residual_fn: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
    pool_factor: int = 4,
    eps: float = 1e-8,
    uniform_floor: float = 4.0,
    power: float = 1.0,
    replace: bool = False,
    chunk_size: int = 8192,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Residual-Adaptive Refinement: draw a ``pool_factor * n`` uniform pool
    (rounded up to whole chunks when it exceeds ``chunk_size``), score
    |residual| and draw n points with p ~ |r|^k / mean|r|^k + c (the RAD
    hyper-parameters k = ``power``, c = ``uniform_floor`` of Wu et al. 2023;
    the defaults are the JAX package's tuned ones: c = 4, k = 1, without
    replacement). Uniform when no residual function is given. Callers run
    it under ``torch.no_grad()``."""
    if residual_fn is None:
        return sample_uniform(generator, n, domain, time_domain)
    pool = _pool_size(n, pool_factor, chunk_size)
    x_pool, t_pool = sample_uniform(generator, pool, domain, time_domain)
    dev = generator.device
    if replace:
        u = torch.rand((n, pool), generator=generator, device=dev).clamp_(min=_TINY)
    else:
        u = torch.rand((pool,), generator=generator, device=dev)
    return _residual_based(x_pool, t_pool, residual_fn, n, u, eps=eps,
                           uniform_floor=uniform_floor, power=power, replace=replace,
                           chunk_size=chunk_size)


def make_grid(domain: Domain, time_domain: Tuple[float, float], points_per_axis: int = 100,
              device=None) -> torch.Tensor:
    """Regular grid over (space, time), flattened to (G, dim + 1), on
    ``device`` (the card unless the caller names one; raises without it)."""
    if device is None:
        device = resolve_device("cuda")
    axes = [torch.linspace(lo, hi, points_per_axis, device=device) for lo, hi in domain]
    axes.append(torch.linspace(time_domain[0], time_domain[1], points_per_axis, device=device))
    mesh = torch.meshgrid(*axes, indexing="ij")
    return torch.stack([m.reshape(-1) for m in mesh], dim=-1)


def _adaptive_pick(grid, scores, n: int, u: torch.Tensor, jitter: torch.Tensor, lo, hi,
                   points_per_axis: int):
    """Draw n grid cells with p ~ |score| / mean|score| + 1 from the
    uniforms ``u`` ((G,) by Gumbel top-k when n <= G, else (n, G) with
    replacement), then move each point by ``jitter`` (n, dim + 1) in
    [-0.5, 0.5) of a cell and clamp it to the domain."""
    s = torch.abs(scores).reshape(-1)
    p = s / (torch.mean(s) + 1e-8) + 1.0
    if n <= p.shape[0]:
        idx = _gumbel_top_k(torch.log(p), u, n)
    else:
        idx = _categorical(torch.log(p), u)
    cell = (hi - lo) / (points_per_axis - 1)
    z = torch.clamp(grid[idx] + jitter * cell, lo, hi)
    return z[:, :-1], z[:, -1:]


def sample_adaptive(
    generator: torch.Generator,
    n: int,
    domain: Domain,
    time_domain: Tuple[float, float],
    score_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    points_per_axis: int = 100,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """RL-scored sampling: ``score_fn`` (the DQN policy) scores a regular
    grid, n cells are drawn by |score| (without replacement while n fits the
    grid), and the points are jittered within their cells and clamped to
    the domain. Uniform when no score function is given."""
    if score_fn is None:
        return sample_uniform(generator, n, domain, time_domain)
    dev = generator.device
    key = (_key(domain, time_domain, dev), points_per_axis)
    grid = _GRIDS.get(key)
    if grid is None:
        grid = _GRIDS[key] = make_grid(domain, time_domain, points_per_axis, dev)
    scores = score_fn(grid)
    G = grid.shape[0]
    if n <= G:
        u = torch.rand((G,), generator=generator, device=dev)
    else:
        u = torch.rand((n, G), generator=generator, device=dev).clamp_(min=_TINY)
    jitter = torch.rand((n, grid.shape[1]), generator=generator, device=dev) - 0.5
    lo, hi = _bounds(domain, time_domain, dev)
    return _adaptive_pick(grid, scores, n, u, jitter, lo, hi, points_per_axis)
