"""Forward-mode derivative engine for PINN residuals.

The counterpart of ``pinnrl_tpu.ops.derivatives``, with its names and keys
(``u, dt, dt2, dx, dx2, dx3, dx4`` in 1D, ``dx1, dx1x1, ...`` in N-D, and
``laplacian``). A PDE residual is written against a point function ``u``
and ``directional_derivative`` / ``laplacian``; ``u`` is either

- a :class:`~pinnrl_tpu_torch.ops.jet_mlp.BundleView` holding precomputed
  stacked-jet streams (the fast path), whose streams are returned as they
  are, or
- a batched scalar function: ``u`` maps z (N, d+1) to (N,), and the k-th
  directional derivative along a coordinate is k nested
  ``torch.func.jvp`` calls with the one-hot tangent broadcast to every row.

Batched where JAX is per point: JAX ``vmap``s a per-point ``u`` over the
batch. The two agree because every network of the port treats rows
independently (LayerNorm normalises over features; nothing normalises over
the batch), so the tangent e_axis on every row gives each row its own
directional derivative. A consequence: the networks see 2-D batches inside
the jvps, so the hand-written kernels run there too (SIREN's kernel 3 and
the Fourier features' kernel 2, through their ``jvp`` rules), where JAX's
per-point inputs take its plain branches.

``mode``: JAX's residuals use ``"jvp"``, the default here. ``"jet"`` and
``"auto"`` are accepted and give the same values through nested jvp; a
Taylor-mode route for orders >= 3 is ROADMAP item 10.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Sequence, Tuple

import torch

from pinnrl_tpu_torch.ops.jet_mlp import BundleView

PointFn = Callable[[torch.Tensor], torch.Tensor]  # (N, d+1) -> (N,)
_MODES = ("jvp", "jet", "auto")
# One-hot tangents per (width, device, dtype): building one from Python
# values is a host-to-device copy, which would make every step wait.
_EYES: Dict[tuple, torch.Tensor] = {}


def make_scalar_fn(apply_fn: Callable, params, out_index: int = 0) -> PointFn:
    """The batched scalar restriction u(z) = apply_fn(params, z)[:, out_index]."""

    def u(z: torch.Tensor) -> torch.Tensor:
        return apply_fn(params, z).reshape(z.shape[0], -1)[:, out_index]

    return u


def _tangent(z: torch.Tensor, axis: int) -> torch.Tensor:
    key = (z.shape[-1], z.device, z.dtype)
    eye = _EYES.get(key)
    if eye is None:
        eye = _EYES[key] = torch.eye(z.shape[-1], dtype=z.dtype, device=z.device)
    return eye[axis].expand(z.shape)


def _check_mode(mode: str) -> None:
    if mode not in _MODES:
        raise ValueError(f"Unknown derivative mode {mode!r}; valid: {_MODES}")


def _nested_jvp(u: PointFn, z: torch.Tensor, v: torch.Tensor, order: int) -> List[torch.Tensor]:
    """Orders 1..order of the directional derivative from one nest of
    ``order`` jvps. Level j returns the j-th derivative as its tangent; its
    primal, which it computes anyway, is the (j-1)-th, and it passes that
    out with the orders below as aux. Eager torch cannot drop an unused
    value as XLA does, so evaluating each order's nest on its own would
    recompute orders 1..k-1 for order k."""
    if order < 1:
        return []

    def first(zz):
        return torch.func.jvp(u, (zz,), (v,))[1], []

    fn = first
    for _ in range(order - 1):
        prev = fn

        def fn(zz, _prev=prev):  # loop-local closure over _prev
            below, deriv, lower = torch.func.jvp(_prev, (zz,), (v,), has_aux=True)
            return deriv, lower + [below]

    deriv, lower = fn(z)
    return lower + [deriv]


def value_and_derivative(u: PointFn, z: torch.Tensor, axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(u(z), du/dz_axis) from one jvp: one evaluation of the network."""
    return torch.func.jvp(u, (z,), (_tangent(z, axis),))


def directional_derivative(u, z: torch.Tensor, axis: int, order: int,
                           mode: str = "jvp") -> List[torch.Tensor]:
    """Derivatives of orders 1..order of u along coordinate ``axis``, each (N,)."""
    if isinstance(u, BundleView):
        return u.directional(axis, order)
    _check_mode(mode)
    return _nested_jvp(u, z, _tangent(z, axis), order)


def laplacian(u, z: torch.Tensor, spatial_axes: Sequence[int], mode: str = "jvp") -> torch.Tensor:
    """Sum of pure second directional derivatives over the spatial axes, (N,).
    Over two or more axes of a point function, one order-2 nest vmapped over
    the axes' tangents: the primal and its first pass run once for all."""
    axes = list(spatial_axes)
    if not axes:
        return torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)
    if isinstance(u, BundleView) or len(axes) == 1:
        total = directional_derivative(u, z, axes[0], 2, mode=mode)[1]
        for ax in axes[1:]:
            total = total + directional_derivative(u, z, ax, 2, mode=mode)[1]
        return total
    _check_mode(mode)
    tangents = torch.stack([_tangent(z, ax) for ax in axes])
    return torch.func.vmap(lambda v: _nested_jvp(u, z, v, 2)[1])(tangents).sum(dim=0)


def derivative_bundle(
    u: PointFn,
    z: torch.Tensor,
    dimension: int,
    spatial_orders: Iterable[int] = (1, 2),
    temporal_orders: Iterable[int] = (1,),
    mode: str = "auto",
) -> Dict[str, torch.Tensor]:
    """Batched derivative dictionary with the JAX package's keys: ``u``,
    ``dt``/``dt2``, per-axis spatial derivatives and ``laplacian`` whenever
    spatial order >= 2 is requested; each entry (N,)."""
    _check_mode(mode)
    spatial_orders = sorted(set(int(o) for o in spatial_orders))
    temporal_orders = sorted(set(int(o) for o in temporal_orders))
    max_s = spatial_orders[-1] if spatial_orders else 0
    max_t = temporal_orders[-1] if temporal_orders else 0

    out: Dict[str, torch.Tensor] = {"u": u(z)}
    if max_t:
        dts = directional_derivative(u, z, dimension, max_t, mode=mode)
        for o in temporal_orders:
            out["dt" if o == 1 else f"dt{o}"] = dts[o - 1]
    if max_s:
        lap = None
        for ax in range(dimension):
            dxs = directional_derivative(u, z, ax, max_s, mode=mode)
            if max_s >= 2:
                lap = dxs[1] if lap is None else lap + dxs[1]
            for o in spatial_orders:
                key = ("dx" if o == 1 else f"dx{o}") if dimension == 1 else "d" + f"x{ax + 1}" * o
                out[key] = dxs[o - 1]
        if max_s >= 2:
            out["laplacian"] = lap
    return out


def batched_derivative_bundle(
    apply_fn: Callable,
    params,
    x: torch.Tensor,
    t: torch.Tensor,
    dimension: int,
    spatial_orders: Iterable[int] = (1, 2),
    temporal_orders: Iterable[int] = (1,),
    mode: str = "auto",
) -> Dict[str, torch.Tensor]:
    """``x`` (N, d), ``t`` (N, 1) -> (N, 1) per key."""
    z = torch.cat([x, t], dim=-1)
    bundle = derivative_bundle(make_scalar_fn(apply_fn, params), z, dimension,
                               tuple(spatial_orders), tuple(temporal_orders), mode)
    return {k: v.reshape(-1, 1) for k, v in bundle.items()}


def hvp_diag(u, z: torch.Tensor, axes: Sequence[int]) -> torch.Tensor:
    """Diagonal Hessian entries along ``axes`` (forward over forward), (N, len(axes))."""
    return torch.stack([directional_derivative(u, z, ax, 2)[1] for ax in axes], dim=-1)
