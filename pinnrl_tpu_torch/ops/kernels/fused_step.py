"""Fused residual loss: the (causally weighted) mean r^2 of a PDE's residual
AND its parameter gradient, computed by hand-written CUDA kernels
(``csrc/fused_residual.cu``).

``make_fused_residual_loss(model, pde)`` returns ``fn(params, z)``, which
``PDEBase.compute_loss`` calls for the residual term. On a CUDA tensor it
runs ``_FusedResidualFn``: its forward launches the kernels in sequence and
produces the loss together with every parameter gradient, and its backward
returns the stored gradients times the incoming cotangent (the JAX custom
VJP's fused_fwd / fused_bwd). The cotangent of ``z`` is zero. Where no
gradient is wanted (validation) the same kernels run without their reverse
pass. On a CPU tensor ``fn`` runs the plain version: the stacked-jet
bundle, the residual, ``PDEBase._residual_loss`` and ``torch.autograd``.

With ``training.causal_eps > 0`` the loss is sum_i w_i r_i^2 / sum_i w_i,
w_i = exp(-eps sum_{j<i} r_j^2 / N) over the points in the order given, so
the caller passes ``z`` sorted by time (``compute_loss`` does). The weights
carry no gradient: the residual cotangent is 2 w_i r_i / sum w.

Every kernel has a plain PyTorch twin with the same contract (``_TorchOps``
beside ``_CudaOps``), and one host-side launcher (``_loss_and_grads``) runs
either set. The tests run the launcher with the plain twins on the CPU — which
checks the hand-derived LayerNorm + tanh backward (``_transport_bwd_plain``),
the scan's block arithmetic and all the layout and stride bookkeeping against
autograd — and the chip smoke test compares the CUDA set with the plain
version on the card.

Scope: d = 1 to 3 space dimensions, temporal order 1, causal or not,
float32, with or without a co-moving frame (the input (x - c t, t)), on a
Fourier trunk (the embedding's closed-form phase-rotation streams; with a
trainable basis B is a leaf read per call, and dL/dB comes from the
embedding's cotangent, ``_embed_bwd_plain``) or a feedforward trunk (the
input map's constant direction rows, then a first GEMM with d + 1 input
columns), with the residual of Burgers, heat or
Allen-Cahn (spatial order K = 2), Black-Scholes (order 2; the one residual
that reads z, for S along each axis), KdV (order 3) or convection (order 1,
one velocity per axis). The stacked streams are [value; axis 0: 1..K; ..;
axis d-1: 1..K; t1], S = 2 + d K of them (the bundle's order); the x-groups
share the value stream's LayerNorm and tanh factors, and the residuals sum
over the axes.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from pinnrl_tpu_torch.ops.jet_mlp import BundleView, _transport_block, make_bundle_fn
from pinnrl_tpu_torch.ops.kernels import _build, _gemm_core
from pinnrl_tpu_torch.ops.kernels._gemm_core import TARGET_BLOCKS, TILE, cdiv, split_chunks

_LN_EPS = 1e-6
_COLSUM_ROWS = 256
_SCAN_BLOCK = 1024  # points per block of the causal prefix scan
_RESIDUALS = ("burgers", "heat", "kdv", "convection", "allen_cahn", "black_scholes")
_MAX_DIM = 3  # space dimensions the CUDA kernels are instantiated for
_MIN_SPLIT_K = 512  # least K per split: the prologue and epilogue stay small
_BASIS = "FourierFeatures_0.B"


# --------------------------------------------------------------------------- #
# Plain twins of the CUDA kernels (same arguments, same layouts)
# --------------------------------------------------------------------------- #


def _embed_plain(z, lo, sc, B, two_pi: bool, x_order: int, frame: Optional[float]) -> torch.Tensor:
    """Stacked ((2 + d K) N, 2m) Fourier input [value; axis 0: x1..xK; ..;
    axis d-1: x1..xK; t1] of the (N, d+1) points z, K = ``x_order``: the
    phase-rotation recurrence (s, c) <- (c p1, -s p1) of jet_mlp, with
    p1 = s sc_ax B_ax along axis ax. In a co-moving frame of speed c the
    network sees (x - c t, t), so the t-direction's rate is
    p1t = s (sc_t B_t - c sum_ax sc_ax B_ax)."""
    s = 2.0 * math.pi if two_pi else 1.0
    d = z.shape[1] - 1
    w0 = _affine_map(z, lo, sc, frame)
    p = s * (w0 @ B)
    sn, cs = torch.sin(p), torch.cos(p)
    rows = [torch.cat([sn, cs], dim=-1)]
    for ax in range(d):
        p1 = s * (sc[ax] * B[ax])
        s_cur, c_cur = sn, cs
        for _ in range(x_order):
            s_cur, c_cur = c_cur * p1, -s_cur * p1
            rows.append(torch.cat([s_cur, c_cur], dim=-1))
    p1t = s * (_t_direction(sc, frame) @ B)
    rows.append(torch.cat([cs * p1t, -sn * p1t], dim=-1))
    return torch.cat(rows, dim=0)


def _embed_bwd_plain(z, lo, sc, B, G, two_pi: bool, x_order: int,
                     frame: Optional[float]) -> torch.Tensor:
    """dL/dB (d+1, m) of a trainable basis from G, the cotangent of
    ``_embed_plain``'s stacked ((2 + d K) N, 2m) output. Stream (g, k) is
    p1^k [sin^(k)(p), cos^(k)(p)] with p = s w0 B and p1 = s v_g B (v_g =
    sc_g e_g along an axis, the t-direction for t1), so with (Gs, Gc) its
    cotangent
        dL/dp  += p1^k (Gs cos^(k)(p) - Gc sin^(k)(p))
        dL/dp1 += k p1^(k-1) (Gs sin^(k)(p) + Gc cos^(k)(p))
    and dL/dB = s (w0^T dL/dp + sum_g v_g (x) colsum(dL/dp1_g)). The CUDA
    embed_bwd_partial_kernel<D, KX> evaluates the same terms per point."""
    s = 2.0 * math.pi if two_pi else 1.0
    n, d = z.shape[0], z.shape[1] - 1
    m = B.shape[1]
    w0 = _affine_map(z, lo, sc, frame)
    p = s * (w0 @ B)
    sn, cs = torch.sin(p), torch.cos(p)
    Gr = G.reshape(-1, n, 2 * m)
    Gs, Gc = Gr[..., :m], Gr[..., m:]
    dp = Gs[0] * cs - Gc[0] * sn
    dB = torch.zeros_like(B)
    for ax in range(d):
        p1 = s * (sc[ax] * B[ax])
        sk, ck, pk = sn, cs, torch.ones_like(p1)
        dq = torch.zeros_like(p)
        for k in range(1, x_order + 1):
            gs, gc = Gs[1 + ax * x_order + k - 1], Gc[1 + ax * x_order + k - 1]
            sk, ck = ck, -sk
            dq = dq + k * pk * (gs * sk + gc * ck)
            pk = pk * p1
            dp = dp + pk * (gs * ck - gc * sk)
        dB[ax] = dB[ax] + sc[ax] * dq.sum(dim=0)
    vt = _t_direction(sc, frame)
    p1t = s * (vt @ B)
    gs, gc = Gs[-1], Gc[-1]
    dp = dp + p1t * (-gs * sn - gc * cs)
    dB = dB + vt[:, None] * (gs * cs - gc * sn).sum(dim=0)
    return s * (w0.t() @ dp + dB)


def _affine_map(z, lo, sc, frame: Optional[float]) -> torch.Tensor:
    """The network input w0 = (x - lo) sc - 1 of z, with x = (z_x - c t, t)
    in a co-moving frame of speed c (``PINNModel.map_inputs``)."""
    if frame is not None:
        d = z.shape[1] - 1
        z = torch.cat([z[:, :d] - frame * z[:, d:], z[:, d:]], dim=1)
    return (z - lo) * sc - 1.0


def _t_direction(sc, frame: Optional[float]) -> torch.Tensor:
    """The t-direction in network-input space: sc_t e_t, and in a co-moving
    frame of speed c also -c sc_ax on every spatial column."""
    if frame is None:
        return torch.diag(sc)[-1]
    return torch.cat([-frame * sc[:-1], sc[-1:]])


def _affine_input_plain(z, lo, sc, x_order: int, frame: Optional[float]) -> torch.Tensor:
    """Stacked ((2 + d K) N, d+1) input of the feedforward trunk's first
    layer, [w0; per axis: sc_ax e_ax, 0 x (K - 1); the t-direction], K =
    ``x_order``: the plain bundle's direction rows (jet_mlp.make_bundle_fn)."""
    n, d = z.shape[0], z.shape[1] - 1
    dirs = torch.diag(sc)  # row k: sc_k e_k
    rows = [_affine_map(z, lo, sc, frame)]
    for ax in range(d):
        rows += [dirs[ax].expand(n, d + 1), z.new_zeros(((x_order - 1) * n, d + 1))]
    rows.append(_t_direction(sc, frame).expand(n, d + 1))
    return torch.cat(rows, dim=0)


def _split_streams(T: torch.Tensor, n: int, dim: int):
    """(value, the ``dim`` x-groups' stream lists, t1) of a stacked (S n, W)
    tensor, S = 2 + dim K."""
    hs = T.split(n, dim=0)
    k = (len(hs) - 2) // dim
    return hs[0], [list(hs[1 + g * k: 1 + (g + 1) * k]) for g in range(dim)], hs[-1]


def _transport_fwd_plain(H, gamma, beta, n: int, dim: int) -> torch.Tensor:
    """LayerNorm + tanh transport of the stacked (S n, W) pre-activations,
    S = 2 + dim K streams [value; ``dim`` x-groups of K; t1]."""
    h0, hx, ht = _split_streams(H, n, dim)
    a0, groups = _transport_block(h0, [*hx, [ht]], gamma, beta, "tanh")
    return torch.cat([a0, *[o for g in groups for o in g]], dim=0)


def _mean(v):
    return torch.mean(v, dim=-1, keepdim=True)


def _rsum(v):
    return torch.sum(v, dim=-1, keepdim=True)


def _ln_group(c0, q0, r, c):
    """One x-group's LayerNorm row scalars and q streams from its K centred
    streams ``c``: ([S1..SK], [V2..VK], [q1..qK])."""
    K = len(c)
    S = [_mean(c0 * c[0]) * r]
    V = []
    q = [(c[0] - q0 * S[0]) * r]
    if K >= 2:
        V.append(_mean(c[0] * c[0] + c0 * c[1]))
        S.append((V[0] - S[0] * S[0]) * r)
        q.append((c[1] - 2.0 * q[0] * S[0] - q0 * S[1]) * r)
    if K == 3:
        V.append(_mean(3.0 * c[0] * c[1] + c0 * c[2]))
        S.append((V[1] - 3.0 * S[0] * S[1]) * r)
        q.append((c[2] - 3.0 * q[1] * S[0] - 3.0 * q[0] * S[1] - q0 * S[2]) * r)
    return S, V, q


def _tanh_group_bwd(a0, d1, d2, d3, y, Go):
    """One x-group's share of the tanh transport's reverse: (its term of
    G_a0, [G_y1..G_yK])."""
    K = len(y)
    if K == 1:
        return -2.0 * a0 * (Go[0] * y[0]), [Go[0] * d1]
    Gd1 = Go[0] * y[0] + Go[1] * y[1]
    Gd2 = Go[1] * y[0] * y[0]
    Ga = -2.0 * a0 * Gd1 + Gd2 * (4.0 * a0 * a0 - 2.0 * d1)
    Gy = [Go[0] * d1 + 2.0 * Go[1] * d2 * y[0], Go[1] * d1]
    if K == 3:
        y1, y2, y3 = y
        Ga = Ga + Go[2] * (-2.0 * a0 * y3 + 3.0 * y1 * y2 * (4.0 * a0 * a0 - 2.0 * d1)
                           + y1 * y1 * y1 * (4.0 * a0 * (1.0 - 3.0 * a0 * a0) + 12.0 * a0 * d1))
        Gy = [Gy[0] + Go[2] * (3.0 * d2 * y2 + 3.0 * d3 * y1 * y1), Gy[1] + 3.0 * Go[2] * d2 * y1,
              Go[2] * d1]
    return Ga, Gy


def _ln_group_bwd(Gy, q0, q, S, r, gamma):
    """One x-group's complete q cotangents [G_q1..G_qK] and its row scalars'
    cotangents [G_S1..G_SK] (see ``_transport_bwd_plain``)."""
    K = len(Gy)
    Gq = [g * gamma for g in Gy]
    if K == 3:
        Gq[1] = Gq[1] - 3.0 * Gq[2] * S[0] * r
        Gq[0] = Gq[0] - 3.0 * Gq[2] * S[1] * r
    if K >= 2:
        Gq[0] = Gq[0] - 2.0 * Gq[1] * S[0] * r

    def R(k, j):  # R_kj = sum G_qk q_j over the row
        return _rsum(Gq[k - 1] * (q0 if j == 0 else q[j - 1]))

    GS = [-R(1, 0) * r]
    if K >= 2:
        GS = [-(R(1, 0) + 2.0 * R(2, 1)) * r, -R(2, 0) * r]
    if K == 3:
        GS3 = -R(3, 0) * r
        GS[1] = GS[1] - 3.0 * R(3, 1) * r - 3.0 * S[0] * r * GS3
        GS[0] = GS[0] - 3.0 * R(3, 2) * r - 3.0 * S[1] * r * GS3
        GS.append(GS3)
    if K >= 2:
        GS[0] = GS[0] - 2.0 * S[0] * r * GS[1]
    return Gq, GS, sum(R(k, k) for k in range(1, K + 1))


def _transport_bwd_plain(H, gamma, beta, GA, n: int, dim: int):
    """Hand-derived reverse pass of ``_transport_fwd_plain``: ``dim`` x-groups
    (axes) of x-order K in {1, 2, 3} beside the value and the t-stream.

    Forward, per point (row means over the width W; r = 1/sqrt(var0+eps)).
    Shared by every group: c0 = h0 - mean(h0), q0 = c0 r, y0 = q0 g + b,
    a0 = tanh(y0), d1 = 1 - a0^2, d2 = -2 a0 d1, d3 = -2 d1 (1 - 3 a0^2);
    St = mean(c0 ct) r, qt = (ct - q0 St) r, yt = qt g, ot = d1 yt. Per
    x-group (its own streams c_k = h_k - mean(h_k), k = 1..K):
        S1 = mean(c0 c1) r ;  V2 = mean(c1^2 + c0 c2) ;  S2 = (V2 - S1^2) r
        V3 = mean(3 c1 c2 + c0 c3) ;  S3 = (V3 - 3 S1 S2) r       (K = 3)
        q1 = (c1 - q0 S1) r ;  q2 = (c2 - 2 q1 S1 - q0 S2) r
        q3 = (c3 - 3 q2 S1 - 3 q1 S2 - q0 S3) r                    (K = 3)
        y_k = q_k g ;  o1 = d1 y1 ;  o2 = d1 y2 + d2 y1^2
        o3 = d1 y3 + 3 d2 y1 y2 + d3 y1^3                          (K = 3)
    Reverse (G_v is the cotangent of v; sum_x runs over the x-groups):
        G_a0 += -2 a0 G_ot yt + sum_x [-2 a0 G_d1 + (4 a0^2 - 2 d1) G_d2
                + (4 a0 (1 - 3 a0^2) + 12 a0 d1) G_d3]
          per group G_d1 = G_o1 y1 + G_o2 y2 + G_o3 y3,
          G_d2 = G_o2 y1^2 + 3 G_o3 y1 y2, G_d3 = G_o3 y1^3
        G_y1 = G_o1 d1 + 2 G_o2 d2 y1 + G_o3 (3 d2 y2 + 3 d3 y1^2)
        G_y2 = G_o2 d1 + 3 G_o3 d2 y1 ;  G_y3 = G_o3 d1 ;  G_yt = G_ot d1
        G_y0 = G_a0 d1
    then the complete q cotangents, per group in reverse order,
        G_q3 = G_y3 g ;  G_q2 = G_y2 g - 3 G_q3 S1 r
        G_q1 = G_y1 g - 2 G_q2 S1 r - 3 G_q3 S2 r ;  G_qt = G_yt g
        G_q0 = G_y0 g - (G_qt St + sum_x (G_q3 S3 + G_q2 S2 + G_q1 S1)) r
    per group the row sums R_kj = sum G_qk q_j give its row scalars'
    cotangents
        G_S3 = -R30 r ;  G_S2 = -(R20 + 3 R31) r - 3 S1 r G_S3
        G_S1 = -(R10 + 2 R21 + 3 R32) r - 2 S1 r G_S2 - 3 S2 r G_S3
        G_V2 = G_S2 r ;  G_V3 = G_S3 r ;  G_St = -Rt0 r
    and the shared ones take every group's terms,
        G_r = (R00 + Rtt + G_St St + sum_x (sum_k R_kk + G_S1 S1 + G_S2 S2
               + G_S3 S3)) / r
        G_var0 = -r^3 G_r / 2
    the centred cotangents element-wise,
        G_c0 = G_q0 r + (G_St r ct + sum_x (G_S1 r c1 + G_V2 c2 + G_V3 c3)
               + 2 G_var0 c0) / W
        G_c1 = G_q1 r + (2 G_V2 c1 + 3 G_V3 c2 + G_S1 r c0) / W
        G_c2 = G_q2 r + (G_V2 c0 + 3 G_V3 c1) / W ;  G_c3 = G_q3 r + G_V3 c0 / W
        G_ct = G_qt r + G_St r c0 / W
    and G_h = G_c - mean(G_c), because centring is self-adjoint. Terms
    marked K = 3 (q3, S3, V3, G_o3, ...) are absent at K = 2, and every
    term of stream 2 (q2, S2, V2, d2, G_o2, R2j, ...) is absent at K = 1.
    The CUDA transport_bwd_kernel<D, KX> evaluates exactly these formulas.

    Returns (GH, Ggamma_rows, Gbeta_rows): per-point rows of the LayerNorm
    parameter gradients (``None`` without LayerNorm).
    """
    h0, hx, ht = _split_streams(H, n, dim)
    Ga0, Gox, Got = _split_streams(GA, n, dim)
    W = H.shape[1]
    if gamma is not None:
        c0, ct = h0 - _mean(h0), ht - _mean(ht)
        cx = [[h - _mean(h) for h in grp] for grp in hx]
        r = 1.0 / torch.sqrt(_mean(c0 * c0) + _LN_EPS)
        q0 = c0 * r
        St = _mean(c0 * ct) * r
        qt = (ct - q0 * St) * r
        lns = [_ln_group(c0, q0, r, c) for c in cx]
        y0, yt = q0 * gamma + beta, qt * gamma
        yx = [[qk * gamma for qk in q] for _S, _V, q in lns]
    else:
        y0, yx, yt = h0, hx, ht
    a0 = torch.tanh(y0)
    d1 = 1.0 - a0 * a0
    d2 = -2.0 * a0 * d1
    d3 = -2.0 * d1 * (1.0 - 3.0 * a0 * a0)
    Ga = Ga0 - 2.0 * a0 * (Got * yt)
    Gyx = []
    for y, Go in zip(yx, Gox):
        Ga_g, Gy = _tanh_group_bwd(a0, d1, d2, d3, y, Go)
        Ga = Ga + Ga_g
        Gyx.append(Gy)
    Gy0, Gyt = Ga * d1, Got * d1
    if gamma is None:
        return torch.cat([Gy0, *[g for Gy in Gyx for g in Gy], Gyt], dim=0), None, None

    inv_w = 1.0 / W
    Gqt = Gyt * gamma
    GSt = -_rsum(Gqt * q0) * r
    groups = [_ln_group_bwd(Gy, q0, q, S, r, gamma) for Gy, (S, _V, q) in zip(Gyx, lns)]
    Gq_S = Gqt * St
    Gr_num = _rsum(Gqt * qt) + GSt * St
    for (Gq, GS, Rkk), (S, _V, _q) in zip(groups, lns):
        Gq_S = Gq_S + sum(g * s for g, s in zip(Gq, S))
        Gr_num = Gr_num + Rkk + sum(g * s for g, s in zip(GS, S))
    Gq0 = Gy0 * gamma - Gq_S * r
    Gr = (Gr_num + _rsum(Gq0 * q0)) / r
    Gvar0 = -0.5 * r * r * r * Gr
    Gc0_w = GSt * r * ct + 2.0 * Gvar0 * c0
    Gcx = []
    for (Gq, GS, _R), c in zip(groups, cx):
        K = len(c)
        GV = [gs * r for gs in GS[1:]]  # G_V2, G_V3
        Gc0_w = Gc0_w + GS[0] * r * c[0]
        Gc = [Gq[0] * r + GS[0] * r * c0 * inv_w]
        if K >= 2:
            Gc0_w = Gc0_w + GV[0] * c[1]
            Gc = [Gc[0] + 2.0 * GV[0] * c[0] * inv_w, Gq[1] * r + GV[0] * c0 * inv_w]
        if K == 3:
            Gc0_w = Gc0_w + GV[1] * c[2]
            Gc = [Gc[0] + 3.0 * GV[1] * c[1] * inv_w, Gc[1] + 3.0 * GV[1] * c[0] * inv_w,
                  Gq[2] * r + GV[1] * c0 * inv_w]
        Gcx += Gc
    Gc0 = Gq0 * r + Gc0_w * inv_w
    Gct = Gqt * r + GSt * r * c0 * inv_w
    GH = torch.cat([g - _mean(g) for g in (Gc0, *Gcx, Gct)], dim=0)
    Ggamma = Gy0 * q0 + Gyt * qt
    for Gy, (_S, _V, q) in zip(Gyx, lns):
        for g, qk in zip(Gy, q):
            Ggamma = Ggamma + g * qk
    return GH, Ggamma, Gy0


def _exclusive_scan_plain(x: torch.Tensor, block: int) -> torch.Tensor:
    """Exclusive prefix sums of the 1-D ``x`` by the CUDA scan's three
    passes: block sums, an exclusive scan of the block sums, and an
    exclusive scan inside each block plus its block's offset."""
    n = x.shape[0]
    nb = cdiv(n, block)
    rows = torch.zeros(nb * block, dtype=x.dtype, device=x.device)
    rows[:n] = x
    rows = rows.reshape(nb, block)
    block_sums = rows.sum(dim=1)
    offsets = torch.cat([block_sums.new_zeros(1), torch.cumsum(block_sums, 0)[:-1]])
    local = torch.cat([rows.new_zeros(nb, 1), torch.cumsum(rows, dim=1)[:, :-1]], dim=1)
    return (offsets[:, None] + local).reshape(-1)[:n]


def _residual_scale(r, n: int, causal: bool) -> torch.Tensor:
    """The factor of dr/dU in a residual's cotangent: 2r/N plain, 1 causal
    (the causal weights scale it later)."""
    return torch.ones_like(r) if causal else (2.0 / n) * r


def _residual_out(r, n: int, causal: bool, dU_rows) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dU stacked (S n, 1), out (n, 1)): out is r^2 plain, r causal."""
    return torch.cat(dU_rows).reshape(-1, 1), (r if causal else r * r).reshape(n, 1)


class _TorchOps:
    """Plain PyTorch twins of the kernels, one method per C entry point."""

    def embed(self, z, lo, sc, B, two_pi, x_order, frame):
        return _embed_plain(z, lo, sc, B, two_pi, x_order, frame)

    def affine_input(self, z, lo, sc, x_order, frame):
        return _affine_input_plain(z, lo, sc, x_order, frame)

    def embed_bwd(self, z, lo, sc, B, G, two_pi, x_order, frame):
        return _embed_bwd_plain(z, lo, sc, B, G, two_pi, x_order, frame)

    def gemm(self, M, N, K, A, sam, sak, B, sbk, sbn, C, ldc, bias, bias_rows, splits, k_chunk):
        _gemm_core.gemm_plain(M, N, K, A, sam, sak, B, sbk, sbn, C, ldc, bias, bias_rows, splits,
                              k_chunk)

    def transport_fwd(self, H, gamma, beta, n, dim):
        return _transport_fwd_plain(H, gamma, beta, n, dim)

    def transport_bwd(self, H, gamma, beta, GA, n, dim):
        return _transport_bwd_plain(H, gamma, beta, GA, n, dim)

    # The residuals: U is the stacked (S n, 1) output [u; per axis u_x..; u_t]
    # (``_split_streams``); each returns (dU, out): plain, 2r/N dr/dU and r^2;
    # causal, dr/dU and r. Sums over the axes run in axis order.

    def burgers(self, U, n, dim, nu, causal):
        u, gx, ut = _split_streams(U.reshape(-1), n, dim)
        ux, uxx = sum(g[0] for g in gx), sum(g[1] for g in gx)
        r = (ut + u * ux) - nu * uxx
        c = _residual_scale(r, n, causal)
        return _residual_out(r, n, causal, [c * ux, *[v for _ in gx for v in (c * u, -c * nu)], c])

    def heat(self, U, n, dim, alpha, causal):
        _u, gx, ut = _split_streams(U.reshape(-1), n, dim)
        r = ut - alpha * sum(g[1] for g in gx)
        c, zero = _residual_scale(r, n, causal), torch.zeros_like(r)
        return _residual_out(r, n, causal, [zero, *[v for _ in gx for v in (zero, -c * alpha)], c])

    def kdv(self, U, n, dim, causal):
        u, gx, ut = _split_streams(U.reshape(-1), n, dim)
        ux = sum(g[0] for g in gx)
        r = ut + 6.0 * u * ux + sum(g[2] for g in gx)
        c, zero = _residual_scale(r, n, causal), torch.zeros_like(r)
        return _residual_out(r, n, causal,
                             [c * (6.0 * ux), *[v for _ in gx for v in (c * (6.0 * u), zero, c)], c])

    def convection(self, U, n, velocity, causal):
        _u, gx, ut = _split_streams(U.reshape(-1), n, len(velocity))
        r = ut + sum(v * g[0] for v, g in zip(velocity, gx))
        c = _residual_scale(r, n, causal)
        return _residual_out(r, n, causal, [torch.zeros_like(r), *[c * v for v in velocity], c])

    def allen_cahn(self, U, n, dim, eps2, causal):
        u, gx, ut = _split_streams(U.reshape(-1), n, dim)
        r = ((ut - eps2 * sum(g[1] for g in gx)) - u) + u * u * u
        c, zero = _residual_scale(r, n, causal), torch.zeros_like(r)
        return _residual_out(r, n, causal,
                             [c * (3.0 * u * u - 1.0), *[v for _ in gx for v in (zero, -c * eps2)], c])

    def black_scholes(self, U, z, n, sign, half_sigma2, rate, causal):
        """S = z[:, ax] along each axis ax."""
        V, gx, Vt = _split_streams(U.reshape(-1), n, z.shape[1] - 1)
        S = z[:, :-1].t()
        cSS, cS = half_sigma2 * (S * S), rate * S
        r = (Vt - (sign * rate) * V) + sign * sum(cSS[ax] * g[1] + cS[ax] * g[0]
                                                  for ax, g in enumerate(gx))
        c = _residual_scale(r, n, causal)
        per_axis = [v for ax in range(len(gx)) for v in (c * (sign * cS[ax]), c * (sign * cSS[ax]))]
        return _residual_out(r, n, causal, [-c * (sign * rate), *per_axis, c])

    def causal_weights(self, r, n, eps):
        r2 = (r * r).reshape(-1)
        w = torch.exp(-eps * _exclusive_scan_plain(r2, _SCAN_BLOCK) / n)
        return torch.stack([w, w * r2], dim=1)

    def causal_scale(self, dU, r, WR, sums, n):
        dU.view(-1, n).mul_(2.0 * WR[:, 0] * r.reshape(-1) / sums[0])
        return dU

    def colsum(self, A, rows, cols, ld, scale):
        return A.as_strided((rows, cols), (ld, 1), A.storage_offset()).sum(dim=0) * scale

    def rowdot(self, X, w, b, bias_rows):
        Y = X @ w.t()
        if b is not None:
            Y[:bias_rows] += b
        return Y

    def outer(self, G, w):
        return G @ w

    def wcolsum(self, G, X):
        return G.t() @ X


class _CudaOps:
    """The CUDA kernels of ``csrc/fused_residual.cu`` behind the same methods."""

    _ARGTYPES = {
        "fr_embed": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p],
        "fr_affine_input": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_void_p],
        "fr_embed_bwd": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
        + [ctypes.c_float] + [ctypes.c_void_p] * 3,
        "fr_gemm": _gemm_core.GEMM_ARGTYPES,
        "fr_transport_fwd": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
        "fr_transport_bwd": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
        "fr_burgers": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_int,
                                                                   ctypes.c_void_p],
        "fr_heat": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_int,
                                                                ctypes.c_void_p],
        "fr_kdv": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
        "fr_convection": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float] * 3
        + [ctypes.c_int, ctypes.c_void_p],
        "fr_allen_cahn": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_int,
                                                                      ctypes.c_void_p],
        "fr_black_scholes": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_float] * 3
        + [ctypes.c_int, ctypes.c_void_p],
        "fr_causal_weights": [ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
                              ctypes.c_void_p, ctypes.c_void_p],
        "fr_causal_scale": [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
        "fr_colsum": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
        "fr_rowdot": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
        "fr_outer": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p],
        "fr_wcolsum": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
        + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
    }

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.lib = _build.load_library("fused_residual")
        for name, argtypes in self._ARGTYPES.items():
            fn = getattr(self.lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int

    @property
    def stream(self) -> int:
        """torch's current stream, read at each launch."""
        return _build.stream_handle(self.device)

    def _empty(self, *shape):
        return torch.empty(shape, dtype=torch.float32, device=self.device)

    @staticmethod
    def _ptr(t: Optional[torch.Tensor]):
        return None if t is None else t.data_ptr()

    def embed(self, z, lo, sc, B, two_pi, x_order, frame):
        (n, d1), m = z.shape, B.shape[1]
        X = self._empty((2 + (d1 - 1) * x_order) * n, 2 * m)
        _build.check(self.lib.fr_embed(z.data_ptr(), lo.data_ptr(), sc.data_ptr(), B.data_ptr(),
                                       X.data_ptr(), n, m, int(two_pi), x_order, d1 - 1,
                                       int(frame is not None), float(frame or 0.0), self.stream),
                     "embed_kernel")
        return X

    def embed_bwd(self, z, lo, sc, B, G, two_pi, x_order, frame):
        (n, d1), m = z.shape, B.shape[1]
        partial = self._empty(cdiv(n, _COLSUM_ROWS), d1 * m)
        dB = self._empty(d1, m)
        _build.check(self.lib.fr_embed_bwd(z.data_ptr(), lo.data_ptr(), sc.data_ptr(),
                                           B.data_ptr(), G.data_ptr(), n, m, int(two_pi),
                                           x_order, d1 - 1, int(frame is not None),
                                           float(frame or 0.0), partial.data_ptr(),
                                           dB.data_ptr(), self.stream),
                     "embed_bwd_partial_kernel")
        return dB

    def affine_input(self, z, lo, sc, x_order, frame):
        n, d1 = z.shape
        X = self._empty((2 + (d1 - 1) * x_order) * n, d1)
        _build.check(self.lib.fr_affine_input(z.data_ptr(), lo.data_ptr(), sc.data_ptr(),
                                              X.data_ptr(), n, x_order, d1 - 1,
                                              int(frame is not None), float(frame or 0.0),
                                              self.stream),
                     "affine_input_kernel")
        return X

    def gemm(self, M, N, K, A, sam, sak, B, sbk, sbn, C, ldc, bias, bias_rows, splits, k_chunk):
        _build.check(self.lib.fr_gemm(M, N, K, A.data_ptr(), sam, sak, B.data_ptr(), sbk, sbn,
                                      C.data_ptr(), ldc, self._ptr(bias), bias_rows, splits,
                                      k_chunk, M * N, self.stream), "gemm_sm90_kernel")

    def transport_fwd(self, H, gamma, beta, n, dim):
        A = torch.empty_like(H)
        _build.check(self.lib.fr_transport_fwd(H.data_ptr(), self._ptr(gamma), self._ptr(beta),
                                               A.data_ptr(), n, H.shape[1], int(gamma is not None),
                                               (H.shape[0] // n - 2) // dim, dim, self.stream),
                     "transport_fwd_kernel")
        return A

    def transport_bwd(self, H, gamma, beta, GA, n, dim):
        GH = torch.empty_like(H)
        use_ln = gamma is not None
        Gg = self._empty(n, H.shape[1]) if use_ln else None
        Gb = self._empty(n, H.shape[1]) if use_ln else None
        _build.check(self.lib.fr_transport_bwd(H.data_ptr(), self._ptr(gamma), self._ptr(beta),
                                               GA.data_ptr(), GH.data_ptr(), self._ptr(Gg),
                                               self._ptr(Gb), n, H.shape[1], int(use_ln),
                                               (H.shape[0] // n - 2) // dim, dim, self.stream),
                     "transport_bwd_kernel")
        return GH, Gg, Gb

    def burgers(self, U, n, dim, nu, causal):
        dU = torch.empty_like(U)
        out = self._empty(n, 1)
        _build.check(self.lib.fr_burgers(U.data_ptr(), dU.data_ptr(), out.data_ptr(), n, dim,
                                         float(nu), int(causal), self.stream), "burgers_kernel")
        return dU, out

    def heat(self, U, n, dim, alpha, causal):
        dU = torch.empty_like(U)
        out = self._empty(n, 1)
        _build.check(self.lib.fr_heat(U.data_ptr(), dU.data_ptr(), out.data_ptr(), n, dim,
                                      float(alpha), int(causal), self.stream), "heat_kernel")
        return dU, out

    def kdv(self, U, n, dim, causal):
        dU = torch.empty_like(U)
        out = self._empty(n, 1)
        _build.check(self.lib.fr_kdv(U.data_ptr(), dU.data_ptr(), out.data_ptr(), n, dim,
                                     int(causal), self.stream), "kdv_kernel")
        return dU, out

    def convection(self, U, n, velocity, causal):
        dU = torch.empty_like(U)
        out = self._empty(n, 1)
        v = [float(x) for x in velocity] + [0.0] * (3 - len(velocity))
        _build.check(self.lib.fr_convection(U.data_ptr(), dU.data_ptr(), out.data_ptr(), n,
                                            len(velocity), *v, int(causal), self.stream),
                     "convection_kernel")
        return dU, out

    def allen_cahn(self, U, n, dim, eps2, causal):
        dU = torch.empty_like(U)
        out = self._empty(n, 1)
        _build.check(self.lib.fr_allen_cahn(U.data_ptr(), dU.data_ptr(), out.data_ptr(), n, dim,
                                            float(eps2), int(causal), self.stream),
                     "allen_cahn_kernel")
        return dU, out

    def black_scholes(self, U, z, n, sign, half_sigma2, rate, causal):
        dU = torch.empty_like(U)
        out = self._empty(n, 1)
        _build.check(self.lib.fr_black_scholes(U.data_ptr(), z.data_ptr(), dU.data_ptr(),
                                               out.data_ptr(), n, z.shape[1] - 1, float(sign),
                                               float(half_sigma2), float(rate), int(causal),
                                               self.stream),
                     "black_scholes_kernel")
        return dU, out

    def causal_weights(self, r, n, eps):
        block_sums = self._empty(cdiv(n, _SCAN_BLOCK))
        WR = self._empty(n, 2)
        _build.check(self.lib.fr_causal_weights(r.data_ptr(), n, float(eps), block_sums.data_ptr(),
                                                WR.data_ptr(), self.stream), "causal scan kernels")
        return WR

    def causal_scale(self, dU, r, WR, sums, n):
        _build.check(self.lib.fr_causal_scale(dU.data_ptr(), r.data_ptr(), WR.data_ptr(),
                                              sums.data_ptr(), n, dU.shape[0] // n, self.stream),
                     "causal_scale_kernel")
        return dU

    def colsum(self, A, rows, cols, ld, scale):
        partial = self._empty(cdiv(rows, _COLSUM_ROWS), cols)
        out = self._empty(cols)
        _build.check(self.lib.fr_colsum(A.data_ptr(), rows, cols, ld, float(scale),
                                        partial.data_ptr(), out.data_ptr(), self.stream),
                     "colsum kernels")
        return out

    def rowdot(self, X, w, b, bias_rows):
        R, K = X.shape
        Y = self._empty(R, 1)
        _build.check(self.lib.fr_rowdot(X.data_ptr(), w.data_ptr(), self._ptr(b), Y.data_ptr(), R,
                                        K, bias_rows, self.stream), "rowdot_kernel")
        return Y

    def outer(self, G, w):
        R, K = G.shape[0], w.shape[1]
        out = self._empty(R, K)
        _build.check(self.lib.fr_outer(G.data_ptr(), w.data_ptr(), out.data_ptr(), R, K,
                                       self.stream), "outer_kernel")
        return out

    def wcolsum(self, G, X):
        R, K = X.shape
        partial = self._empty(cdiv(R, _COLSUM_ROWS), K)
        out = self._empty(1, K)
        _build.check(self.lib.fr_wcolsum(G.data_ptr(), X.data_ptr(), R, K, K, partial.data_ptr(),
                                         out.data_ptr(), self.stream), "weighted colsum kernels")
        return out


_CUDA_OPS: Dict[torch.device, _CudaOps] = {}


def _cuda_ops(device: torch.device) -> _CudaOps:
    """The kernels bound once per device."""
    ops = _CUDA_OPS.get(device)
    if ops is None:
        ops = _CUDA_OPS[device] = _CudaOps(device)
    return ops


# --------------------------------------------------------------------------- #
# Host-side launcher (shared by both op sets)
# --------------------------------------------------------------------------- #


def _gemm_linear(ops, X, W, b, bias_rows: int):
    """X (R, K) @ W^T (W: (out, K)) + b on the first ``bias_rows`` rows, as
    one GEMM (``ops.gemm``)."""
    R, K = X.shape
    out = W.shape[0]
    Y = torch.empty((R, out), dtype=X.dtype, device=X.device)
    ops.gemm(R, out, K, X, K, 1, W, 1, K, Y, out, b, bias_rows, 1, K)
    return Y


# The output layer (out = 1) is a product with one column: its bound is
# bytes, so it runs as a row pass (rowdot, outer, wcolsum) and not as a tile.


def _linear(ops, X, W, b, bias_rows: int):
    """X (R, K) @ W^T (W: (out, K)) + b on the first ``bias_rows`` rows."""
    if W.shape[0] == 1:
        return ops.rowdot(X, W, b, bias_rows)
    return _gemm_linear(ops, X, W, b, bias_rows)


def _linear_dx(ops, G, W):
    """G (R, out) @ W (out, K) -> (R, K)."""
    R, out = G.shape
    if out == 1:
        return ops.outer(G, W)
    K = W.shape[1]
    dX = torch.empty((R, K), dtype=G.dtype, device=G.device)
    ops.gemm(R, K, out, G, out, 1, W, K, 1, dX, K, None, 0, 1, out)
    return dX


def _split_k(M: int, N: int, K: int) -> Tuple[int, int]:
    """(splits, k_chunk) for an (M, N) product with a long K: about
    ``TARGET_BLOCKS`` blocks of the core's tile, at least ``_MIN_SPLIT_K`` of
    K per split, chunks a multiple of BK."""
    tiles = cdiv(M, TILE) * cdiv(N, TILE)
    return split_chunks(K, max(1, min(cdiv(TARGET_BLOCKS, tiles), cdiv(K, _MIN_SPLIT_K))))


def _linear_dw(ops, G, X):
    """G^T (out, R) @ X (R, K) -> (out, K), split over R with a
    deterministic reduction of the split partials."""
    R, out = G.shape
    if out == 1:
        return ops.wcolsum(G, X)
    K = X.shape[1]
    splits, k_chunk = _split_k(out, K, R)
    buf = torch.empty((splits, out, K), dtype=G.dtype, device=G.device)
    ops.gemm(out, K, R, G, 1, out, X, K, 1, buf, K, None, 0, splits, k_chunk)
    if splits == 1:
        return buf[0]
    return ops.colsum(buf, splits, out * K, out * K, 1.0).reshape(out, K)


@dataclass
class _Spec:
    """What the launcher needs to know about the model and the PDE."""

    n_hidden: int
    use_ln: bool
    periodic: bool
    dimension: int  # d space axes, 1..3
    x_order: int  # K: the stacked streams are [value; per axis x1..xK; t1]
    frame_speed: Optional[float]  # c of a co-moving frame (x - c t, t); None: none
    residual: str  # one of _RESIDUALS
    causal_eps: float  # 0 = plain mean r^2
    lo: torch.Tensor
    scale: torch.Tensor
    B: Optional[torch.Tensor]  # a fixed Fourier basis; None: trainable, or a feedforward trunk
    leaf_names: List[str]
    trainable_basis: bool = False  # B is the leaf "FourierFeatures_0.B", with a gradient
    # The residual's coefficients (0 where the PDE has none of them).
    nu: float = 0.0  # Burgers' viscosity
    alpha: float = 0.0  # heat's diffusivity
    velocity: Tuple[float, ...] = ()  # convection's v, one per axis
    epsilon: float = 0.0  # Allen-Cahn's interface width
    sigma: float = 0.0  # Black-Scholes' volatility
    rate: float = 0.0  # Black-Scholes' interest rate r
    sign: float = 0.0  # Black-Scholes' time sign: +1 calendar, -1 to maturity


def _loss_and_grads(ops, spec: _Spec, z: torch.Tensor, P: Dict[str, torch.Tensor],
                    need_grads: bool = True):
    """(loss, {name: d loss / d param}) through ``ops``' kernels; with
    ``need_grads=False`` it stops before the reverse pass and the dict is
    empty. The loss stays on the device: nothing here reads it back."""
    n = z.shape[0]
    L = spec.n_hidden
    causal = spec.causal_eps > 0.0
    d = spec.dimension
    B = P[_BASIS] if spec.trainable_basis else spec.B
    if B is None:
        X = [ops.affine_input(z, spec.lo, spec.scale, spec.x_order, spec.frame_speed)]
    else:
        X = [ops.embed(z, spec.lo, spec.scale, B, spec.periodic, spec.x_order, spec.frame_speed)]
    Hs = []
    for i in range(L):
        H = _linear(ops, X[-1], P[f"Dense_{i}.weight"], P[f"Dense_{i}.bias"], n)
        gamma = P[f"LayerNorm_{i}.weight"] if spec.use_ln else None
        beta = P[f"LayerNorm_{i}.bias"] if spec.use_ln else None
        Hs.append(H)
        X.append(ops.transport_fwd(H, gamma, beta, n, d))
    U = _linear(ops, X[-1], P[f"Dense_{L}.weight"], P[f"Dense_{L}.bias"], n)
    if spec.residual == "burgers":
        G, out = ops.burgers(U, n, d, spec.nu, causal)
    elif spec.residual == "heat":
        G, out = ops.heat(U, n, d, spec.alpha, causal)
    elif spec.residual == "kdv":
        G, out = ops.kdv(U, n, d, causal)
    elif spec.residual == "convection":
        G, out = ops.convection(U, n, spec.velocity, causal)
    elif spec.residual == "allen_cahn":
        G, out = ops.allen_cahn(U, n, d, spec.epsilon**2, causal)
    else:
        G, out = ops.black_scholes(U, z, n, spec.sign, 0.5 * spec.sigma**2, spec.rate, causal)
    if causal:
        # out is r, G the unscaled dr/dU: weights, then [sum w, sum w r^2].
        WR = ops.causal_weights(out, n, spec.causal_eps)
        sums = ops.colsum(WR, n, 2, 2, 1.0)
        loss = sums[1] / sums[0]
    else:
        loss = ops.colsum(out, n, 1, 1, 1.0 / n).reshape(())

    grads: Dict[str, torch.Tensor] = {}
    if not need_grads:
        return loss, grads
    if causal:
        G = ops.causal_scale(G, out, WR, sums, n)
    for i in range(L, -1, -1):
        W = P[f"Dense_{i}.weight"]
        grads[f"Dense_{i}.weight"] = _linear_dw(ops, G, X[i])
        grads[f"Dense_{i}.bias"] = ops.colsum(G, n, G.shape[1], G.shape[1], 1.0)
        if i == 0:
            if spec.trainable_basis:
                # The embedding's cotangent, then its fold into dL/dB.
                GX = _linear_dx(ops, G, W)
                grads[_BASIS] = ops.embed_bwd(z, spec.lo, spec.scale, B, GX, spec.periodic,
                                              spec.x_order, spec.frame_speed)
            break
        GA = _linear_dx(ops, G, W)
        j = i - 1
        gamma = P[f"LayerNorm_{j}.weight"] if spec.use_ln else None
        beta = P[f"LayerNorm_{j}.bias"] if spec.use_ln else None
        G, Gg, Gb = ops.transport_bwd(Hs[j], gamma, beta, GA, n, d)
        if spec.use_ln:
            width = Gg.shape[1]
            grads[f"LayerNorm_{j}.weight"] = ops.colsum(Gg, n, width, width, 1.0)
            grads[f"LayerNorm_{j}.bias"] = ops.colsum(Gb, n, width, width, 1.0)
    return loss, grads


def _launch(spec: _Spec, z, leaves, need_grads: bool):
    """Run the CUDA kernels once; counts one launch."""
    loss, grads = _loss_and_grads(_cuda_ops(z.device), spec, z, dict(zip(spec.leaf_names, leaves)),
                                  need_grads)
    fused_residual_loss.launches += 1
    return loss, grads


class _FusedResidualFn(torch.autograd.Function):
    """Forward: loss and every parameter gradient from the CUDA kernels.
    Backward: the stored gradients times the incoming cotangent."""

    @staticmethod
    def forward(ctx, spec: _Spec, z, *leaves):
        loss, grads = _launch(spec, z, leaves, need_grads=True)
        ctx.save_for_backward(*[grads[k] for k in spec.leaf_names])
        return loss

    @staticmethod
    def backward(ctx, g):
        return (None, None, *[gr * g for gr in ctx.saved_tensors])


# --------------------------------------------------------------------------- #
# Public API
# --------------------------------------------------------------------------- #


def fused_residual_loss_plain(bundle_fn, pde, params, z) -> torch.Tensor:
    """The plain version: stacked-jet bundle -> residual -> the PDE's own
    residual reduction (causal when configured)."""
    value, streams = bundle_fn(params, z)
    r = pde.residual_pointwise(BundleView(value, streams), z, None)
    return pde._residual_loss(r.reshape(-1, 1), z[:, -1:])


def fused_residual_loss(spec: _Spec, bundle_fn, pde, params, z) -> torch.Tensor:
    """The kernels on a CUDA tensor, the plain version on a CPU tensor.
    Where no gradient is wanted (validation), the kernels stop before the
    reverse pass."""
    if z.device.type == "cpu":
        return fused_residual_loss_plain(bundle_fn, pde, params, z)
    if z.device.type != "cuda":
        raise ValueError(f"fused_residual_loss: unsupported device {z.device}")
    _build.require_cuda_f32("fused_residual_loss z", z)
    if z.ndim != 2 or z.shape[1] != spec.dimension + 1:
        raise ValueError(f"fused_residual_loss: z must be (N, {spec.dimension + 1}), "
                         f"got {tuple(z.shape)}")
    leaves = [params[k] for k in spec.leaf_names]
    for name, t in zip(spec.leaf_names, leaves):
        _build.require_cuda_f32(f"fused_residual_loss {name}", t)
    for name, t in (("lo", spec.lo), ("scale", spec.scale), ("B", spec.B)):  # B: when fixed
        if t is not None:
            _build.require_cuda_f32(f"fused_residual_loss {name}", t)
    if torch.is_grad_enabled() and any(t.requires_grad for t in leaves):
        return _FusedResidualFn.apply(spec, z, *leaves)
    return _launch(spec, z, leaves, need_grads=False)[0]


fused_residual_loss.launches = 0


def _spec(model, pde) -> _Spec:
    cfg = model.config
    use_ln = bool(cfg.layer_norm)
    n_hidden = len(cfg.hidden_dims)
    fourier = cfg.architecture == "fourier"
    trainable_basis = fourier and bool(cfg.arch_params.get("trainable_features", False))
    names = [_BASIS] if trainable_basis else []
    for i in range(n_hidden):
        names += [f"Dense_{i}.weight", f"Dense_{i}.bias"]
        if use_ln:
            names += [f"LayerNorm_{i}.weight", f"LayerNorm_{i}.bias"]
    names += [f"Dense_{n_hidden}.weight", f"Dense_{n_hidden}.bias"]
    kind = pde.pde_type
    coeffs = {}  # read once here, as floats: the kernels take them by value
    if kind == "burgers":
        coeffs["nu"] = float(pde._nu(None))
    elif kind == "heat":
        coeffs["alpha"] = float(pde._alpha(None))
    elif kind == "convection":
        coeffs["velocity"] = tuple(float(v) for v in pde._velocity(None))
    elif kind == "allen_cahn":
        coeffs["epsilon"] = float(pde._eps(None))
    elif kind == "black_scholes":
        coeffs.update(sigma=float(pde._sigma(None)), rate=float(pde._r(None)),
                      sign=pde.time_sign())
    return _Spec(
        n_hidden=n_hidden,
        use_ln=use_ln,
        periodic=bool(cfg.arch_params.get("periodic", True)),
        dimension=pde.dimension,
        x_order=max(pde.spatial_orders),
        frame_speed=model._frame_speed,
        residual=kind,
        causal_eps=pde.causal_eps(),
        lo=model._in_lo.contiguous(),
        scale=model._in_scale.contiguous(),
        B=model.constants[_BASIS].contiguous() if fourier and not trainable_basis else None,
        leaf_names=names,
        trainable_basis=trainable_basis,
        **coeffs,
    )


def make_fused_residual_loss(model, pde) -> Callable[[Dict[str, torch.Tensor], torch.Tensor], torch.Tensor]:
    """Build ``fn(params, z) -> residual loss`` whose gradient comes from the
    kernels' own backward. ``z`` is (N, d+1) physical coordinates
    (x_1..x_d, t), sorted by time when the loss is causal."""
    if not supports(model, pde):
        raise ValueError(
            f"fused residual kernel does not support pde={pde.pde_type}, "
            f"arch={model.config.architecture}"
        )
    spec = _spec(model, pde)
    bundle_fn = make_bundle_fn(model, pde.dimension, spatial_order=max(pde.spatial_orders),
                               temporal_order=max(pde.temporal_orders))

    def fn(params, z):
        return fused_residual_loss(spec, bundle_fn, pde, params, z)

    return fn


def supports(model, pde, training=None) -> bool:
    """The reference's ``supports``: the structural conditions of the
    stacked-jet bundle (a Fourier or feedforward trunk, a co-moving frame
    or none), the reductions the kernel hard-codes (plain MSE, no trainable
    coefficients), temporal order 1 and spatial order at most 3, causal or
    not; and this port's residuals (``_RESIDUALS``) in 1 to 3 space
    dimensions (the kernels are instantiated for d <= 3; more is ROADMAP
    queue 2's K1e). No width gate: the TPU's gate was a TPU measurement,
    and no H100 measurement has set one."""
    from pinnrl_tpu_torch.ops import jet_mlp

    if not (pde.bundle_compatible and pde.system_size == 1 and jet_mlp.supports(model, pde)):
        return False
    if getattr(pde, "trainable_parameters", None):
        return False
    if training is not None and getattr(training, "loss_function", "mse") != "mse":
        return False
    if pde.pde_type not in _RESIDUALS or not 1 <= pde.dimension <= _MAX_DIM:
        return False
    if model.config.architecture not in ("fourier", "feedforward"):
        return False
    if max(pde.spatial_orders, default=0) > 3 or max(pde.temporal_orders, default=0) != 1:
        return False
    return True
