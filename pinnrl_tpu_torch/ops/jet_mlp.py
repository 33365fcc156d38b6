"""Stacked-stream Taylor-jet evaluation of the Fourier / plain MLP.

The residual needs the network's value and its directional derivatives
along each coordinate. A Dense layer is linear, so every derivative stream
is transported by the same weight matrix: all streams are stacked along the
batch axis and go through ONE ``(S*N, n) @ (n, m)`` product per layer. The
row-wise blocks (LayerNorm -> tanh) transport their streams by hand-written
Taylor formulas (orders <= 3), and the Fourier embedding's streams are
closed-form phase rotations. The result is plain tensor algebra that
``torch.autograd`` differentiates in reverse mode, so the residual needs no
forward-mode AD.

This is the plain path of the residual and the plain version of the fused
CUDA kernel (``ops/kernels/fused_step.py``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

_LN_EPS = 1e-6  # flax.linen.LayerNorm default
_MAX_ORDER = 3


class BundleView:
    """Batched stand-in for the network, backed by precomputed streams.

    ``value`` is (N,), ``streams[axis]`` a list [d1, .., dk] of (N,). PDE
    residuals written against ``u(z)`` / ``directional_derivative`` /
    ``laplacian`` evaluate unchanged against it (see ``ops/derivatives.py``).
    """

    def __init__(self, value: torch.Tensor, streams: Dict[int, List[torch.Tensor]]):
        self.value = value
        self.streams = streams

    def __call__(self, z: torch.Tensor) -> torch.Tensor:  # noqa: ARG002 — parity
        return self.value

    def directional(self, axis: int, order: int) -> List[torch.Tensor]:
        per_axis = self.streams.get(axis)
        if per_axis is None or len(per_axis) < order:
            raise KeyError(
                f"BundleView has no order-{order} stream for axis {axis}; "
                f"available: { {a: len(s) for a, s in self.streams.items()} }. "
                "Declare the orders in the PDE's spatial_orders/temporal_orders."
            )
        return per_axis[:order]


def supports(model, pde=None) -> bool:
    """True when ``make_bundle_fn`` can evaluate this model structurally.

    The JAX package also covers other smooth activations and orders above 3
    through ``jax.experimental.jet``; the port has only the hand-written
    tanh transport; other activations and orders run on the generic engine
    (a bundle for them is ROADMAP item 10.5, a speed lever).
    """
    cfg = model.config
    if cfg.architecture not in ("fourier", "feedforward"):
        return False
    if bool(cfg.arch_params.get("modified", False)):
        return False
    if model.output_transform is not None:
        return False
    if cfg.activation.lower() != "tanh":
        return False
    if pde is not None:
        orders = max(max(pde.spatial_orders, default=0), max(pde.temporal_orders, default=0))
        if orders > _MAX_ORDER:
            return False
    return True


def _transport_block(
    h0: torch.Tensor,
    groups: List[List[torch.Tensor]],
    gamma: Optional[torch.Tensor],
    beta: Optional[torch.Tensor],
    act_name: str,
):
    """Taylor transport of [LayerNorm ->] tanh for orders <= 3.

    LayerNorm streams (c = h - mean(h), var = mean(c^2), s = sqrt(var+eps),
    q = c/s), from s^2 = var + eps and c = q s:
        s1 = var1 / (2 s0)
        s2 = (var2 - 2 s1^2) / (2 s0)
        s3 = (var3 - 6 s1 s2) / (2 s0)
        q_k = (c_k - sum_{j<k} C(k,j) q_j s_{k-j}) / s0
    tanh streams (a = tanh(y), d1 = 1-a^2, d2 = -2 a d1,
    d3 = -2 d1 (1 - 3 a^2)): Faa di Bruno orders 1..3.
    Returns (a0, groups_out).
    """
    if act_name != "tanh":
        raise ValueError("hand-rolled transport supports tanh only")

    def mean(v):
        return torch.mean(v, dim=-1, keepdim=True)

    if gamma is not None:
        mu0 = mean(h0)
        c0 = h0 - mu0
        var0 = mean(c0 * c0)
        s0 = torch.sqrt(var0 + _LN_EPS)
        inv_s0 = 1.0 / s0
        q0 = c0 * inv_s0
        y0 = q0 * gamma + beta
    else:
        y0 = h0

    a0 = torch.tanh(y0)
    d1 = 1.0 - a0 * a0
    d2 = -2.0 * a0 * d1
    d3 = -2.0 * d1 * (1.0 - 3.0 * a0 * a0)

    groups_out: List[List[torch.Tensor]] = []
    for streams in groups:
        k = len(streams)
        if k > _MAX_ORDER:
            raise ValueError(f"hand-rolled transport supports orders <= 3, got {k}")
        if gamma is not None:
            c = [streams[i] - mean(streams[i]) for i in range(k)]
            var1 = 2.0 * mean(c0 * c[0])
            s1 = 0.5 * var1 * inv_s0
            q1 = (c[0] - q0 * s1) * inv_s0
            y = [q1 * gamma]
            if k >= 2:
                var2 = 2.0 * mean(c[0] * c[0] + c0 * c[1])
                s2 = (0.5 * var2 - s1 * s1) * inv_s0
                q2 = (c[1] - 2.0 * q1 * s1 - q0 * s2) * inv_s0
                y.append(q2 * gamma)
            if k >= 3:
                var3 = 2.0 * mean(3.0 * c[0] * c[1] + c0 * c[2])
                s3 = (0.5 * var3 - 3.0 * s1 * s2) * inv_s0
                q3 = (c[2] - 3.0 * q2 * s1 - 3.0 * q1 * s2 - q0 * s3) * inv_s0
                y.append(q3 * gamma)
        else:
            y = streams

        out = [d1 * y[0]]
        if k >= 2:
            out.append(d1 * y[1] + d2 * y[0] * y[0])
        if k >= 3:
            out.append(d1 * y[2] + 3.0 * d2 * y[0] * y[1] + d3 * y[0] * y[0] * y[0])
        groups_out.append(out)
    return a0, groups_out


def make_bundle_fn(
    model,
    dimension: int,
    spatial_order: int,
    temporal_order: int,
) -> Callable[[Dict[str, torch.Tensor], torch.Tensor], Tuple[torch.Tensor, Dict[int, List[torch.Tensor]]]]:
    """Build ``bundle_fn(params, z) -> (value, streams)`` for a PINNModel.

    ``z``: (N, dimension+1) physical coordinates (x_1..x_d, t). Returns the
    batched value (N,) and, per coordinate axis, the directional-derivative
    streams [d1, .., dk], each (N,).
    """
    cfg = model.config
    if cfg.activation.lower() != "tanh":
        raise ValueError(
            "the stacked-jet bundle transports tanh only; other activations run on the "
            "generic engine (supports() is False for them; ROADMAP item 10.5 is the speed lever)"
        )
    ap = cfg.arch_params
    use_ln = bool(cfg.layer_norm)
    n_hidden = len(cfg.hidden_dims)
    periodic = bool(ap.get("periodic", True))
    frame_speed = model._frame_speed
    is_fourier = cfg.architecture == "fourier"
    # (axis, order) per direction group, in stacking order: spatial axes
    # first, then time.
    groups = [(ax, spatial_order) for ax in range(dimension)] + [(dimension, temporal_order)]
    groups = [(ax, k) for ax, k in groups if k > 0]
    if max((k for _, k in groups), default=0) > _MAX_ORDER:
        raise ValueError(
            f"the stacked-jet bundle transports orders up to {_MAX_ORDER}; higher orders run on "
            "the generic engine (supports() is False for them; ROADMAP item 10.5)"
        )
    in_dim = dimension + 1

    def _net_direction(axis: int) -> torch.Tensor:
        # A physical direction in network-input space: the input map is
        # affine, so e_axis maps to (J_frame e_axis) * in_scale.
        v = torch.zeros(in_dim, dtype=torch.float32, device=model._in_scale.device)
        v[axis] = 1.0
        if frame_speed is not None and axis == dimension:
            v[:dimension] = -frame_speed
        return (v * model._in_scale).reshape(1, in_dim)

    # Built once: writing into a device tensor from Python is a host round trip.
    directions = {ax: _net_direction(ax) for ax, _k in groups}

    def bundle_fn(params: Dict[str, torch.Tensor], z: torch.Tensor):
        w0 = model.map_inputs(z)
        if is_fourier:
            B = params.get("FourierFeatures_0.B")
            if B is None:
                B = model.constants["FourierFeatures_0.B"]
            s = 2.0 * math.pi if periodic else 1.0
            p0 = s * (w0 @ B)
            sin0, cos0 = torch.sin(p0), torch.cos(p0)
            h_streams: List[List[torch.Tensor]] = []
            for ax, k in groups:
                p1 = s * (directions[ax] @ B)  # (1, m): constant over the batch
                s_cur, c_cur = sin0, cos0
                streams_g = []
                for _ in range(k):
                    # d sin(p) = cos(p) p1 ; d cos(p) = -sin(p) p1
                    s_cur, c_cur = c_cur * p1, -s_cur * p1
                    streams_g.append(torch.cat([s_cur, c_cur], dim=-1))
                h_streams.append(streams_g)
            h0 = torch.cat([sin0, cos0], dim=-1)
        else:
            h0 = w0
            h_streams = []
            for ax, k in groups:
                v = directions[ax].expand_as(w0)
                h_streams.append([v] + [torch.zeros_like(w0) for _ in range(k - 1)])

        def _dense(i: int, prim, streams):
            W = params[f"Dense_{i}.weight"]
            b = params[f"Dense_{i}.bias"]
            flat = torch.cat([prim] + [st for g in streams for st in g], dim=0)
            if flat.dtype != W.dtype:  # promote, as flax's Dense does
                dt = torch.promote_types(flat.dtype, W.dtype)
                flat, W, b = flat.to(dt), W.to(dt), b.to(dt)
            n_each = prim.shape[0]
            out = F.linear(flat, W)
            parts = list(torch.split(out, n_each, dim=0))
            new_streams, j = [], 1
            for g in streams:
                new_streams.append(parts[j : j + len(g)])
                j += len(g)
            return parts[0] + b, new_streams

        for i in range(n_hidden):
            h0, h_streams = _dense(i, h0, h_streams)
            if use_ln:
                gamma, beta = params[f"LayerNorm_{i}.weight"], params[f"LayerNorm_{i}.bias"]
            else:
                gamma = beta = None
            h0, h_streams = _transport_block(h0, h_streams, gamma, beta, "tanh")

        h0, h_streams = _dense(n_hidden, h0, h_streams)
        value = h0[:, 0]
        streams_by_axis = {ax: [st[:, 0] for st in g] for (ax, _k), g in zip(groups, h_streams)}
        return value, streams_by_axis

    return bundle_fn
