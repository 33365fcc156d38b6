"""Stacked-stream Taylor-jet evaluation of the Fourier / plain MLP.

The residual needs the network's value and its directional derivatives
along each coordinate. A Dense layer is linear, so every derivative stream
is transported by the same weight matrix: all streams are stacked along the
batch axis and go through ONE ``(S*N, n) @ (n, m)`` product per layer. The
row-wise blocks (LayerNorm -> activation) transport their streams by
hand-written Taylor formulas (orders <= 3) in the activation's derivatives
at the primal pre-activation (``ACTIVATION_DERIVATIVES``: tanh, gelu,
sigmoid, silu/swish, sin), and the Fourier embedding's streams are
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

from pinnrl_tpu_torch.models.base import _SQRT_2_OVER_PI

_LN_EPS = 1e-6  # flax.linen.LayerNorm default
_MAX_ORDER = 3
_GELU_A = 0.044715  # models/base.py's gelu


# --------------------------------------------------------------------------- #
# The activations' derivatives: (y, order) -> [f(y), f'(y), .., f^(order)(y)]
# --------------------------------------------------------------------------- #


def _tanh_derivatives(y: torch.Tensor, order: int) -> List[torch.Tensor]:
    """a = tanh(y): d1 = 1 - a^2, d2 = -2 a d1, d3 = -2 d1 (1 - 3 a^2),
    d4 = 8 a d1 (2 - 3 a^2)."""
    a = torch.tanh(y)
    d1 = 1.0 - a * a
    d = [a, d1]
    if order >= 2:
        d.append(-2.0 * a * d1)
    if order >= 3:
        d.append(-2.0 * d1 * (1.0 - 3.0 * a * a))
    if order >= 4:
        d.append(8.0 * a * d1 * (2.0 - 3.0 * a * a))
    return d[: order + 1]


def _sigmoid_derivatives(y: torch.Tensor, order: int) -> List[torch.Tensor]:
    """s = sigmoid(y): d1 = s (1 - s), d2 = d1 (1 - 2 s),
    d3 = d1 (1 - 6 s + 6 s^2), d4 = d1 (1 - 2 s)(1 - 12 s + 12 s^2)."""
    s = torch.sigmoid(y)
    d1 = s * (1.0 - s)
    d = [s, d1]
    if order >= 2:
        d.append(d1 * (1.0 - 2.0 * s))
    if order >= 3:
        d.append(d1 * (1.0 - 6.0 * s + 6.0 * s * s))
    if order >= 4:
        d.append(d1 * (1.0 - 2.0 * s) * (1.0 - 12.0 * s + 12.0 * s * s))
    return d[: order + 1]


def _silu_derivatives(y: torch.Tensor, order: int) -> List[torch.Tensor]:
    """f = y s: f^(k) = y s^(k) + k s^(k-1)."""
    s = _sigmoid_derivatives(y, order)
    return [y * s[0]] + [y * s[k] + k * s[k - 1] for k in range(1, order + 1)]


def _sin_derivatives(y: torch.Tensor, order: int) -> List[torch.Tensor]:
    """d_k = sin(y + k pi/2): sin, cos, -sin, -cos, sin."""
    sn, cs = torch.sin(y), torch.cos(y)
    return [sn, cs, -sn, -cs, sn][: order + 1]


def _gelu_derivatives(y: torch.Tensor, order: int) -> List[torch.Tensor]:
    """flax's tanh approximation f = 0.5 (y + y h), h = tanh(u), u = c (y +
    a y^3), c = sqrt(2/pi), a = 0.044715 (``models/base.py: gelu``). h's
    derivatives compose tanh's t1..t4 at u with u' = c (1 + 3 a y^2),
    u'' = 6 a c y, u''' = 6 a c (Faa di Bruno, u'''' = 0); then
    f^(k) = 0.5 (delta_k1 + y h^(k) + k h^(k-1))."""
    u = _SQRT_2_OVER_PI * (y + _GELU_A * y**3)
    t = _tanh_derivatives(u, order)
    h = [t[0]]
    u1 = _SQRT_2_OVER_PI * (1.0 + 3.0 * _GELU_A * y * y)
    u2 = (6.0 * _GELU_A * _SQRT_2_OVER_PI) * y
    u3 = 6.0 * _GELU_A * _SQRT_2_OVER_PI
    if order >= 1:
        h.append(t[1] * u1)
    if order >= 2:
        h.append(t[1] * u2 + t[2] * u1 * u1)
    if order >= 3:
        h.append(t[1] * u3 + 3.0 * t[2] * u1 * u2 + t[3] * u1 * u1 * u1)
    if order >= 4:
        h.append(t[2] * (4.0 * u1 * u3 + 3.0 * u2 * u2) + 6.0 * t[3] * u1 * u1 * u2
                 + t[4] * u1 * u1 * u1 * u1)
    d = [y * (0.5 * (1.0 + h[0]))]  # models/base.py's gelu, term for term
    if order >= 1:
        d.append(0.5 * (1.0 + h[0] + y * h[1]))
    return d + [0.5 * (y * h[k] + k * h[k - 1]) for k in range(2, order + 1)]


# The single source of the activations' derivatives for the bundle and for
# kernel 1's plain twins (ops/kernels/fused_step.py); the CUDA kernel's
# ``act_derivs`` (csrc/fused_residual.cu) evaluates the same closed forms.
# Orders 0..4: the forward transports to order 3, its reverse needs one more.
ACTIVATION_DERIVATIVES: Dict[str, Callable[[torch.Tensor, int], List[torch.Tensor]]] = {
    "tanh": _tanh_derivatives,
    "gelu": _gelu_derivatives,
    "sigmoid": _sigmoid_derivatives,
    "silu": _silu_derivatives,
    "swish": _silu_derivatives,
    "sin": _sin_derivatives,
}


def activation_derivatives(name: str, y: torch.Tensor, order: int) -> List[torch.Tensor]:
    """[f(y), f'(y), .., f^(order)(y)] of the activation ``name``, order <= 4."""
    fn = ACTIVATION_DERIVATIVES.get(name.lower())
    if fn is None:
        raise ValueError(f"no transport for activation {name!r}; the bundle takes "
                         f"{sorted(ACTIVATION_DERIVATIVES)}")
    if not 0 <= order <= 4:
        raise ValueError(f"activation derivatives are tabled to order 4, got {order}")
    return fn(y, order)


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
    """True when ``make_bundle_fn`` can evaluate this model structurally:
    a Fourier or feedforward trunk (not modified, no output transform), an
    activation of ``ACTIVATION_DERIVATIVES`` (tanh, gelu, sigmoid,
    silu/swish, sin) and orders up to 3.

    The JAX package's gate also admits softplus, but its bundle then fails
    (``jet`` leaks a tracer through softplus's ``custom_jvp``): here
    softplus runs on the generic engine, as JAX's ``stacked_jet: false``
    does. JAX's bundle also reaches orders above 3 through ``jet``; no
    bundle-compatible PDE has one, and such orders run on the generic
    engine here (ROADMAP item 10.5).
    """
    cfg = model.config
    if cfg.architecture not in ("fourier", "feedforward"):
        return False
    if bool(cfg.arch_params.get("modified", False)):
        return False
    if model.output_transform is not None:
        return False
    if cfg.activation.lower() not in ACTIVATION_DERIVATIVES:
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
    """Taylor transport of [LayerNorm ->] the activation for orders <= 3.

    LayerNorm streams (c = h - mean(h), var = mean(c^2), s = sqrt(var+eps),
    q = c/s), from s^2 = var + eps and c = q s:
        s1 = var1 / (2 s0)
        s2 = (var2 - 2 s1^2) / (2 s0)
        s3 = (var3 - 6 s1 s2) / (2 s0)
        q_k = (c_k - sum_{j<k} C(k,j) q_j s_{k-j}) / s0
    activation streams, with d_k = f^(k)(y0) from ``ACTIVATION_DERIVATIVES``
    (Faa di Bruno orders 1..3):
        o1 = d1 y1 ;  o2 = d1 y2 + d2 y1^2 ;  o3 = d1 y3 + 3 d2 y1 y2 + d3 y1^3
    The LayerNorm statistics and d0..dK are shared by every group.
    Returns (d0, groups_out).
    """
    order = max((len(g) for g in groups), default=0)
    if order > _MAX_ORDER:
        raise ValueError(f"hand-rolled transport supports orders <= 3, got {order}")

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

    d = activation_derivatives(act_name, y0, order)

    groups_out: List[List[torch.Tensor]] = []
    for streams in groups:
        k = len(streams)
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

        out = [d[1] * y[0]]
        if k >= 2:
            out.append(d[1] * y[1] + d[2] * y[0] * y[0])
        if k >= 3:
            out.append(d[1] * y[2] + 3.0 * d[2] * y[0] * y[1] + d[3] * y[0] * y[0] * y[0])
        groups_out.append(out)
    return d[0], groups_out


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
    act_name = cfg.activation.lower()
    if act_name not in ACTIVATION_DERIVATIVES:
        raise ValueError(
            f"the stacked-jet bundle transports {sorted(ACTIVATION_DERIVATIVES)}, not "
            f"{cfg.activation!r}; it runs on the generic engine (supports() is False for it)"
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
            # Promoted where they meet, as jnp does: float64 inputs meet a
            # float32 basis in float64; the directions stay in B's dtype.
            dt = torch.promote_types(w0.dtype, B.dtype)
            p0 = s * (w0.to(dt) @ B.to(dt))
            sin0, cos0 = torch.sin(p0), torch.cos(p0)
            h_streams: List[List[torch.Tensor]] = []
            for ax, k in groups:
                p1 = s * (directions[ax].to(B.dtype) @ B)  # (1, m): constant over the batch
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
            h0, h_streams = _transport_block(h0, h_streams, gamma, beta, act_name)

        h0, h_streams = _dense(n_hidden, h0, h_streams)
        value = h0[:, 0]
        streams_by_axis = {ax: [st[:, 0] for st in g] for (ax, _k), g in zip(groups, h_streams)}
        return value, streams_by_axis

    return bundle_fn
