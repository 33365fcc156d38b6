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

Scope: one space dimension, temporal order 1, causal or not, float32, on a
Fourier trunk (the embedding's closed-form phase-rotation streams) or a
feedforward trunk (the input map's constant direction rows, then a first
GEMM with two input columns), with the residual of Burgers, heat or
Allen-Cahn (spatial order 2, 4 stacked streams), Black-Scholes (order 2;
the one residual that reads z, for S), KdV (order 3, 5 streams) or
convection (order 1, 3 streams). Two space dimensions and the moving frame
are ROADMAP queue 2's K1b and K1d'.
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
_MIN_SPLIT_K = 512  # least K per split: the prologue and epilogue stay small


# --------------------------------------------------------------------------- #
# Plain twins of the CUDA kernels (same arguments, same layouts)
# --------------------------------------------------------------------------- #


def _embed_plain(z, lo, sc, B, two_pi: bool, x_order: int) -> torch.Tensor:
    """Stacked ((2 + x_order) N, 2m) Fourier input [value; x1..xK; t1]: the
    phase-rotation recurrence (s, c) <- (c p1, -s p1) of jet_mlp."""
    s = 2.0 * math.pi if two_pi else 1.0
    w0 = (z - lo) * sc - 1.0
    p = s * (w0 @ B)
    p1x = s * (sc[0] * B[0])
    p1t = s * (sc[1] * B[1])
    sn, cs = torch.sin(p), torch.cos(p)
    rows = [torch.cat([sn, cs], dim=-1)]
    s_cur, c_cur = sn, cs
    for _ in range(x_order):
        s_cur, c_cur = c_cur * p1x, -s_cur * p1x
        rows.append(torch.cat([s_cur, c_cur], dim=-1))
    rows.append(torch.cat([cs * p1t, -sn * p1t], dim=-1))
    return torch.cat(rows, dim=0)


def _affine_input_plain(z, lo, sc, x_order: int) -> torch.Tensor:
    """Stacked ((2 + x_order) N, 2) input of the feedforward trunk's first
    layer, [w0; sc_x e_x; 0 x (x_order - 1); sc_t e_t] with w0 = (z - lo) sc
    - 1: the plain bundle's direction rows (jet_mlp.make_bundle_fn)."""
    n = z.shape[0]
    w0 = (z - lo) * sc - 1.0
    dirs = torch.diag(sc)  # row k: sc_k e_k
    rows = [w0, dirs[0].expand(n, 2), w0.new_zeros(((x_order - 1) * n, 2)), dirs[1].expand(n, 2)]
    return torch.cat(rows, dim=0)


def _transport_fwd_plain(H, gamma, beta, n: int) -> torch.Tensor:
    """LayerNorm + tanh transport of the stacked (S n, W) pre-activations,
    S = 2 + K streams [value; x1..xK; t1]."""
    hs = H.split(n, dim=0)
    a0, (xs, (ot,)) = _transport_block(hs[0], [list(hs[1:-1]), [hs[-1]]], gamma, beta, "tanh")
    return torch.cat([a0, *xs, ot], dim=0)


def _transport_bwd_plain(H, gamma, beta, GA, n: int):
    """Hand-derived reverse pass of ``_transport_fwd_plain``, x-order K in {1, 2, 3}.

    Forward, per point (row means over the width W; r = 1/sqrt(var0+eps)):
        c_k = h_k - mean(h_k)                      k in {0, 1, .., K, t}
        S1 = mean(c0 c1) r ;  V2 = mean(c1^2 + c0 c2) ;  S2 = (V2 - S1^2) r
        V3 = mean(3 c1 c2 + c0 c3) ;  S3 = (V3 - 3 S1 S2) r       (K = 3)
        St = mean(c0 ct) r
        q0 = c0 r ;  q1 = (c1 - q0 S1) r ;  q2 = (c2 - 2 q1 S1 - q0 S2) r
        q3 = (c3 - 3 q2 S1 - 3 q1 S2 - q0 S3) r                    (K = 3)
        qt = (ct - q0 St) r
        y0 = q0 g + b ;  y_k = q_k g ;  a0 = tanh(y0)
        d1 = 1 - a0^2 ;  d2 = -2 a0 d1 ;  d3 = -2 d1 (1 - 3 a0^2)
        o1 = d1 y1 ;  o2 = d1 y2 + d2 y1^2 ;  ot = d1 yt
        o3 = d1 y3 + 3 d2 y1 y2 + d3 y1^3                          (K = 3)
    Reverse (G_v is the cotangent of v):
        G_d1 = sum_k G_ok y_k (k in 1..K, t) ; G_d2 = G_o2 y1^2 + 3 G_o3 y1 y2
        G_d3 = G_o3 y1^3 ;  G_y1 = G_o1 d1 + 2 G_o2 d2 y1 + G_o3 (3 d2 y2 + 3 d3 y1^2)
        G_y2 = G_o2 d1 + 3 G_o3 d2 y1 ;  G_y3 = G_o3 d1 ;  G_yt = G_ot d1
        G_a0 += -2 a0 G_d1 + (4 a0^2 - 2 d1) G_d2 + (4 a0 (1 - 3 a0^2) + 12 a0 d1) G_d3
        G_y0 = G_a0 d1
    then the complete q cotangents, in reverse order,
        G_q3 = G_y3 g ;  G_q2 = G_y2 g - 3 G_q3 S1 r
        G_q1 = G_y1 g - 2 G_q2 S1 r - 3 G_q3 S2 r ;  G_qt = G_yt g
        G_q0 = G_y0 g - (G_qt St + G_q3 S3 + G_q2 S2 + G_q1 S1) r
    twelve row sums R_kj = sum G_qk q_j give the row scalars' cotangents
        G_S3 = -R30 r ;  G_S2 = -(R20 + 3 R31) r - 3 S1 r G_S3 ;  G_St = -Rt0 r
        G_S1 = -(R10 + 2 R21 + 3 R32) r - 2 S1 r G_S2 - 3 S2 r G_S3
        G_V2 = G_S2 r ;  G_V3 = G_S3 r
        G_r = (sum_k R_kk + G_S1 S1 + G_S2 S2 + G_S3 S3 + G_St St) / r
        G_var0 = -r^3 G_r / 2
    the centred cotangents element-wise,
        G_c0 = G_q0 r + (G_St r ct + G_V2 c2 + G_V3 c3 + G_S1 r c1 + 2 G_var0 c0) / W
        G_c1 = G_q1 r + (2 G_V2 c1 + 3 G_V3 c2 + G_S1 r c0) / W
        G_c2 = G_q2 r + (G_V2 c0 + 3 G_V3 c1) / W ;  G_c3 = G_q3 r + G_V3 c0 / W
        G_ct = G_qt r + G_St r c0 / W
    and G_h = G_c - mean(G_c), because centring is self-adjoint. Terms
    marked K = 3 (q3, S3, V3, G_o3, ...) are absent at K = 2, and every
    term of stream 2 (q2, S2, V2, d2, G_o2, R2j, ...) is absent at K = 1
    (convection: G_d1 = G_o1 y1 + G_ot yt, G_y1 = G_o1 d1, G_a0 += -2 a0 G_d1,
    G_S1 = -R10 r, G_c1 = G_q1 r + G_S1 r c0 / W). The CUDA
    transport_bwd_kernel<K> evaluates exactly these formulas.

    Returns (GH, Ggamma_rows, Gbeta_rows): per-point rows of the LayerNorm
    parameter gradients (``None`` without LayerNorm).
    """
    hs = H.split(n, dim=0)
    gs = GA.split(n, dim=0)
    K = len(hs) - 2
    h0, hx, ht = hs[0], hs[1:-1], hs[-1]
    Ga0, Gox, Got = gs[0], gs[1:-1], gs[-1]
    W = H.shape[1]

    def mean(v):
        return torch.mean(v, dim=-1, keepdim=True)

    def rsum(v):
        return torch.sum(v, dim=-1, keepdim=True)

    if gamma is not None:
        c0, ct = h0 - mean(h0), ht - mean(ht)
        cx = [h - mean(h) for h in hx]
        r = 1.0 / torch.sqrt(mean(c0 * c0) + _LN_EPS)
        S1 = mean(c0 * cx[0]) * r
        St = mean(c0 * ct) * r
        q0 = c0 * r
        q1 = (cx[0] - q0 * S1) * r
        qx = [q1]
        if K >= 2:
            V2 = mean(cx[0] * cx[0] + c0 * cx[1])
            S2 = (V2 - S1 * S1) * r
            qx.append((cx[1] - 2.0 * q1 * S1 - q0 * S2) * r)
        if K == 3:
            V3 = mean(3.0 * cx[0] * cx[1] + c0 * cx[2])
            S3 = (V3 - 3.0 * S1 * S2) * r
            qx.append((cx[2] - 3.0 * qx[1] * S1 - 3.0 * q1 * S2 - q0 * S3) * r)
        qt = (ct - q0 * St) * r
        y0, yx, yt = q0 * gamma + beta, [q * gamma for q in qx], qt * gamma
    else:
        y0, yx, yt = h0, list(hx), ht
    a0 = torch.tanh(y0)
    d1 = 1.0 - a0 * a0
    d2 = -2.0 * a0 * d1
    y1, Go1 = yx[0], Gox[0]
    Gyt = Got * d1
    if K == 1:
        Gd1 = Go1 * y1 + Got * yt
        Ga = Ga0 - 2.0 * a0 * Gd1
        Gyx = [Go1 * d1]
    else:
        y2, Go2 = yx[1], Gox[1]
        Gd1 = Go1 * y1 + Go2 * y2 + Got * yt
        Gd2 = Go2 * y1 * y1
        Ga = Ga0 - 2.0 * a0 * Gd1 + Gd2 * (4.0 * a0 * a0 - 2.0 * d1)
        Gyx = [Go1 * d1 + 2.0 * Go2 * d2 * y1, Go2 * d1]
    if K == 3:
        y3, Go3 = yx[2], Gox[2]
        d3 = -2.0 * d1 * (1.0 - 3.0 * a0 * a0)
        Ga = Ga + Go3 * (-2.0 * a0 * y3 + 3.0 * y1 * y2 * (4.0 * a0 * a0 - 2.0 * d1)
                         + y1 * y1 * y1 * (4.0 * a0 * (1.0 - 3.0 * a0 * a0) + 12.0 * a0 * d1))
        Gyx = [Gyx[0] + Go3 * (3.0 * d2 * y2 + 3.0 * d3 * y1 * y1), Gyx[1] + 3.0 * Go3 * d2 * y1,
               Go3 * d1]
    Gy0 = Ga * d1
    if gamma is None:
        return torch.cat([Gy0, *Gyx, Gyt], dim=0), None, None

    Gqt = Gyt * gamma
    if K == 3:
        Gq3 = Gyx[2] * gamma
        Gq2 = Gyx[1] * gamma - 3.0 * Gq3 * S1 * r
        Gq1 = Gyx[0] * gamma - 2.0 * Gq2 * S1 * r - 3.0 * Gq3 * S2 * r
        Gq0 = Gy0 * gamma - (Gqt * St + Gq3 * S3 + Gq2 * S2 + Gq1 * S1) * r
    elif K == 2:
        Gq2 = Gyx[1] * gamma
        Gq1 = Gyx[0] * gamma - 2.0 * Gq2 * S1 * r
        Gq0 = Gy0 * gamma - (Gqt * St + Gq2 * S2 + Gq1 * S1) * r
    else:
        Gq1 = Gyx[0] * gamma
        Gq0 = Gy0 * gamma - (Gqt * St + Gq1 * S1) * r

    GSt = -rsum(Gqt * q0) * r
    GS1 = -rsum(Gq1 * q0) * r
    Rdiag = rsum(Gqt * qt) + rsum(Gq1 * q1) + rsum(Gq0 * q0)
    if K >= 2:
        q2 = qx[1]
        GS2 = -rsum(Gq2 * q0) * r
        GS1 = GS1 - 2.0 * rsum(Gq2 * q1) * r
        Rdiag = Rdiag + rsum(Gq2 * q2)
    if K == 3:
        q3 = qx[2]
        GS3 = -rsum(Gq3 * q0) * r
        GS2 = GS2 - 3.0 * rsum(Gq3 * q1) * r - 3.0 * S1 * r * GS3
        GS1 = GS1 - 3.0 * rsum(Gq3 * q2) * r - 3.0 * S2 * r * GS3
        GV3 = GS3 * r
        Rdiag = Rdiag + rsum(Gq3 * q3) + GS3 * S3
    Gr_num = Rdiag + GSt * St
    if K >= 2:
        GV2 = GS2 * r
        GS1 = GS1 - 2.0 * S1 * r * GS2
        Gr_num = Gr_num + GS2 * S2
    Gr = (Gr_num + GS1 * S1) / r
    Gvar0 = -0.5 * r * r * r * Gr
    inv_w = 1.0 / W
    Gct = Gqt * r + GSt * r * c0 * inv_w
    Gc1 = Gq1 * r + GS1 * r * c0 * inv_w
    Gc0 = Gq0 * r + (GSt * r * ct + GS1 * r * cx[0] + 2.0 * Gvar0 * c0) * inv_w
    Gcx = [Gc1]
    if K >= 2:
        Gc0 = Gc0 + GV2 * cx[1] * inv_w
        Gcx = [Gc1 + 2.0 * GV2 * cx[0] * inv_w, Gq2 * r + GV2 * c0 * inv_w]
    if K == 3:
        Gc0 = Gc0 + GV3 * cx[2] * inv_w
        Gcx = [Gcx[0] + 3.0 * GV3 * cx[1] * inv_w, Gcx[1] + 3.0 * GV3 * cx[0] * inv_w,
               Gq3 * r + GV3 * c0 * inv_w]
    GH = torch.cat([Gc0 - mean(Gc0), *[g - mean(g) for g in Gcx], Gct - mean(Gct)], dim=0)
    Ggamma = Gy0 * q0 + Gyt * qt
    for g, q in zip(Gyx, qx):
        Ggamma = Ggamma + g * q
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


class _TorchOps:
    """Plain PyTorch twins of the kernels, one method per C entry point."""

    def embed(self, z, lo, sc, B, two_pi, x_order):
        return _embed_plain(z, lo, sc, B, two_pi, x_order)

    def affine_input(self, z, lo, sc, x_order):
        return _affine_input_plain(z, lo, sc, x_order)

    def gemm(self, M, N, K, A, sam, sak, B, sbk, sbn, C, ldc, bias, bias_rows, splits, k_chunk):
        _gemm_core.gemm_plain(M, N, K, A, sam, sak, B, sbk, sbn, C, ldc, bias, bias_rows, splits,
                              k_chunk)

    def transport_fwd(self, H, gamma, beta, n):
        return _transport_fwd_plain(H, gamma, beta, n)

    def transport_bwd(self, H, gamma, beta, GA, n):
        return _transport_bwd_plain(H, gamma, beta, GA, n)

    def burgers(self, U, n, nu, causal):
        u, ux, uxx, ut = U.reshape(4, n)
        r = (ut + u * ux) - nu * uxx
        if causal:
            one = torch.ones_like(u)
            return torch.stack([ux, u, -nu * one, one]).reshape(-1, 1), r.reshape(n, 1)
        c = (2.0 / n) * r
        return torch.stack([c * ux, c * u, -c * nu, c]).reshape(-1, 1), (r * r).reshape(n, 1)

    def heat(self, U, n, alpha, causal):
        _u, _ux, uxx, ut = U.reshape(4, n)
        r = ut - alpha * uxx
        one, zero = torch.ones_like(r), torch.zeros_like(r)
        c = one if causal else (2.0 / n) * r
        dU = torch.stack([zero, zero, -c * alpha, c]).reshape(-1, 1)
        return dU, (r if causal else r * r).reshape(n, 1)

    def kdv(self, U, n, causal):
        u, ux, uxx, uxxx, ut = U.reshape(5, n)
        r = ut + 6.0 * u * ux + uxxx
        c = torch.ones_like(r) if causal else (2.0 / n) * r
        dU = torch.stack([c * (6.0 * ux), c * (6.0 * u), torch.zeros_like(c), c, c]).reshape(-1, 1)
        return dU, (r if causal else r * r).reshape(n, 1)

    def convection(self, U, n, v, causal):
        _u, ux, ut = U.reshape(3, n)
        r = ut + v * ux
        c = torch.ones_like(r) if causal else (2.0 / n) * r
        dU = torch.stack([torch.zeros_like(c), c * v, c]).reshape(-1, 1)
        return dU, (r if causal else r * r).reshape(n, 1)

    def allen_cahn(self, U, n, eps2, causal):
        u, _ux, uxx, ut = U.reshape(4, n)
        r = ((ut - eps2 * uxx) - u) + u * u * u
        c = torch.ones_like(r) if causal else (2.0 / n) * r
        dU = torch.stack([c * (3.0 * u * u - 1.0), torch.zeros_like(c), -c * eps2, c])
        return dU.reshape(-1, 1), (r if causal else r * r).reshape(n, 1)

    def black_scholes(self, U, z, n, sign, half_sigma2, rate, causal):
        V, VS, VSS, Vt = U.reshape(4, n)
        S = z[:, 0]
        cSS, cS = half_sigma2 * (S * S), rate * S
        r = (Vt - (sign * rate) * V) + sign * (cSS * VSS + cS * VS)
        c = torch.ones_like(r) if causal else (2.0 / n) * r
        dU = torch.stack([-c * (sign * rate), c * (sign * cS), c * (sign * cSS), c])
        return dU.reshape(-1, 1), (r if causal else r * r).reshape(n, 1)

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
        "fr_embed": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
        "fr_affine_input": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p],
        "fr_gemm": _gemm_core.GEMM_ARGTYPES,
        "fr_transport_fwd": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
        "fr_transport_bwd": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
        "fr_burgers": [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_float, ctypes.c_int,
                                               ctypes.c_void_p],
        "fr_heat": [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_float, ctypes.c_int,
                                            ctypes.c_void_p],
        "fr_kdv": [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
        "fr_convection": [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_float, ctypes.c_int,
                                                  ctypes.c_void_p],
        "fr_allen_cahn": [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_float, ctypes.c_int,
                                                  ctypes.c_void_p],
        "fr_black_scholes": [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_float] * 3
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

    def embed(self, z, lo, sc, B, two_pi, x_order):
        n, m = z.shape[0], B.shape[1]
        X = self._empty((2 + x_order) * n, 2 * m)
        _build.check(self.lib.fr_embed(z.data_ptr(), lo.data_ptr(), sc.data_ptr(), B.data_ptr(),
                                       X.data_ptr(), n, m, int(two_pi), x_order, self.stream),
                     "embed_kernel")
        return X

    def affine_input(self, z, lo, sc, x_order):
        n = z.shape[0]
        X = self._empty((2 + x_order) * n, 2)
        _build.check(self.lib.fr_affine_input(z.data_ptr(), lo.data_ptr(), sc.data_ptr(),
                                              X.data_ptr(), n, x_order, self.stream),
                     "affine_input_kernel")
        return X

    def gemm(self, M, N, K, A, sam, sak, B, sbk, sbn, C, ldc, bias, bias_rows, splits, k_chunk):
        _build.check(self.lib.fr_gemm(M, N, K, A.data_ptr(), sam, sak, B.data_ptr(), sbk, sbn,
                                      C.data_ptr(), ldc, self._ptr(bias), bias_rows, splits,
                                      k_chunk, M * N, self.stream), "gemm_sm90_kernel")

    def transport_fwd(self, H, gamma, beta, n):
        A = torch.empty_like(H)
        _build.check(self.lib.fr_transport_fwd(H.data_ptr(), self._ptr(gamma), self._ptr(beta),
                                               A.data_ptr(), n, H.shape[1], int(gamma is not None),
                                               H.shape[0] // n - 2, self.stream),
                     "transport_fwd_kernel")
        return A

    def transport_bwd(self, H, gamma, beta, GA, n):
        GH = torch.empty_like(H)
        use_ln = gamma is not None
        Gg = self._empty(n, H.shape[1]) if use_ln else None
        Gb = self._empty(n, H.shape[1]) if use_ln else None
        _build.check(self.lib.fr_transport_bwd(H.data_ptr(), self._ptr(gamma), self._ptr(beta),
                                               GA.data_ptr(), GH.data_ptr(), self._ptr(Gg),
                                               self._ptr(Gb), n, H.shape[1], int(use_ln),
                                               H.shape[0] // n - 2, self.stream),
                     "transport_bwd_kernel")
        return GH, Gg, Gb

    def burgers(self, U, n, nu, causal):
        dU = torch.empty_like(U)
        out = self._empty(n, 1)
        _build.check(self.lib.fr_burgers(U.data_ptr(), dU.data_ptr(), out.data_ptr(), n,
                                         float(nu), int(causal), self.stream), "burgers_kernel")
        return dU, out

    def heat(self, U, n, alpha, causal):
        dU = torch.empty_like(U)
        out = self._empty(n, 1)
        _build.check(self.lib.fr_heat(U.data_ptr(), dU.data_ptr(), out.data_ptr(), n,
                                      float(alpha), int(causal), self.stream), "heat_kernel")
        return dU, out

    def kdv(self, U, n, causal):
        dU = torch.empty_like(U)
        out = self._empty(n, 1)
        _build.check(self.lib.fr_kdv(U.data_ptr(), dU.data_ptr(), out.data_ptr(), n, int(causal),
                                     self.stream), "kdv_kernel")
        return dU, out

    def convection(self, U, n, v, causal):
        dU = torch.empty_like(U)
        out = self._empty(n, 1)
        _build.check(self.lib.fr_convection(U.data_ptr(), dU.data_ptr(), out.data_ptr(), n,
                                            float(v), int(causal), self.stream), "convection_kernel")
        return dU, out

    def allen_cahn(self, U, n, eps2, causal):
        dU = torch.empty_like(U)
        out = self._empty(n, 1)
        _build.check(self.lib.fr_allen_cahn(U.data_ptr(), dU.data_ptr(), out.data_ptr(), n,
                                            float(eps2), int(causal), self.stream),
                     "allen_cahn_kernel")
        return dU, out

    def black_scholes(self, U, z, n, sign, half_sigma2, rate, causal):
        dU = torch.empty_like(U)
        out = self._empty(n, 1)
        _build.check(self.lib.fr_black_scholes(U.data_ptr(), z.data_ptr(), dU.data_ptr(),
                                               out.data_ptr(), n, float(sign), float(half_sigma2),
                                               float(rate), int(causal), self.stream),
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
    x_order: int  # K: the stacked streams are [value; x1..xK; t1]
    residual: str  # one of _RESIDUALS
    causal_eps: float  # 0 = plain mean r^2
    lo: torch.Tensor
    scale: torch.Tensor
    B: Optional[torch.Tensor]  # the Fourier basis; None: a feedforward trunk
    leaf_names: List[str]
    # The residual's coefficients (0 where the PDE has none of them).
    nu: float = 0.0  # Burgers' viscosity
    alpha: float = 0.0  # heat's diffusivity
    velocity: float = 0.0  # convection's v
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
    if spec.B is None:
        X = [ops.affine_input(z, spec.lo, spec.scale, spec.x_order)]
    else:
        X = [ops.embed(z, spec.lo, spec.scale, spec.B, spec.periodic, spec.x_order)]
    Hs = []
    for i in range(L):
        H = _linear(ops, X[-1], P[f"Dense_{i}.weight"], P[f"Dense_{i}.bias"], n)
        gamma = P[f"LayerNorm_{i}.weight"] if spec.use_ln else None
        beta = P[f"LayerNorm_{i}.bias"] if spec.use_ln else None
        Hs.append(H)
        X.append(ops.transport_fwd(H, gamma, beta, n))
    U = _linear(ops, X[-1], P[f"Dense_{L}.weight"], P[f"Dense_{L}.bias"], n)
    if spec.residual == "burgers":
        G, out = ops.burgers(U, n, spec.nu, causal)
    elif spec.residual == "heat":
        G, out = ops.heat(U, n, spec.alpha, causal)
    elif spec.residual == "kdv":
        G, out = ops.kdv(U, n, causal)
    elif spec.residual == "convection":
        G, out = ops.convection(U, n, spec.velocity, causal)
    elif spec.residual == "allen_cahn":
        G, out = ops.allen_cahn(U, n, spec.epsilon**2, causal)
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
            break
        GA = _linear_dx(ops, G, W)
        j = i - 1
        gamma = P[f"LayerNorm_{j}.weight"] if spec.use_ln else None
        beta = P[f"LayerNorm_{j}.bias"] if spec.use_ln else None
        G, Gg, Gb = ops.transport_bwd(Hs[j], gamma, beta, GA, n)
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
    if z.ndim != 2 or z.shape[1] != 2:
        raise ValueError(f"fused_residual_loss: z must be (N, 2), got {tuple(z.shape)}")
    leaves = [params[k] for k in spec.leaf_names]
    for name, t in zip(spec.leaf_names, leaves):
        _build.require_cuda_f32(f"fused_residual_loss {name}", t)
    for name, t in (("lo", spec.lo), ("scale", spec.scale), ("B", spec.B)):
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
    names = []
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
        coeffs["velocity"] = float(pde._velocity(None)[0])
    elif kind == "allen_cahn":
        coeffs["epsilon"] = float(pde._eps(None))
    elif kind == "black_scholes":
        coeffs.update(sigma=float(pde._sigma(None)), rate=float(pde._r(None)),
                      sign=pde.time_sign())
    return _Spec(
        n_hidden=n_hidden,
        use_ln=use_ln,
        periodic=bool(cfg.arch_params.get("periodic", True)),
        x_order=max(pde.spatial_orders),
        residual=kind,
        causal_eps=pde.causal_eps(),
        lo=model._in_lo.contiguous(),
        scale=model._in_scale.contiguous(),
        B=(model.constants["FourierFeatures_0.B"].contiguous()
           if cfg.architecture == "fourier" else None),
        leaf_names=names,
        **coeffs,
    )


def make_fused_residual_loss(model, pde) -> Callable[[Dict[str, torch.Tensor], torch.Tensor], torch.Tensor]:
    """Build ``fn(params, z) -> residual loss`` whose gradient comes from the
    kernels' own backward. ``z`` is (N, 2) physical coordinates (x, t),
    sorted by time when the loss is causal."""
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
    """The reference's ``supports`` in one space dimension: the structural
    conditions of the stacked-jet bundle (a Fourier or feedforward trunk),
    the reductions the kernel hard-codes (plain MSE, no trainable
    coefficients), temporal order 1 and spatial order at most 3, causal or
    not; and this port's residuals (``_RESIDUALS``). Two exclusions stay: a
    moving frame and more than one space dimension (two space dimensions are
    ROADMAP queue 2's K1b). No width gate: the TPU's gate was a TPU
    measurement, and no H100 measurement has set one."""
    from pinnrl_tpu_torch.ops import jet_mlp

    if not (pde.bundle_compatible and pde.system_size == 1 and jet_mlp.supports(model, pde)):
        return False
    if getattr(pde, "trainable_parameters", None):
        return False
    if training is not None and getattr(training, "loss_function", "mse") != "mse":
        return False
    if pde.pde_type not in _RESIDUALS or pde.dimension != 1:
        return False
    if model.config.architecture not in ("fourier", "feedforward") or model._frame_speed is not None:
        return False
    if max(pde.spatial_orders, default=0) > 3 or max(pde.temporal_orders, default=0) != 1:
        return False
    return True
