"""Fused residual loss: mean r^2 of the Burgers residual AND its parameter
gradient, computed by hand-written CUDA kernels (``csrc/fused_residual.cu``).

``make_fused_residual_loss(model, pde)`` returns ``fn(params, z)``, which
``PDEBase.compute_loss`` calls for the residual term. On a CUDA tensor it
runs ``_FusedResidualFn``: its forward launches the kernels in sequence and
produces the loss together with every parameter gradient, and its backward
returns the stored gradients times the incoming cotangent (the JAX custom
VJP's fused_fwd / fused_bwd). The cotangent of ``z`` is zero. Where no
gradient is wanted (validation) the same kernels run without their reverse
pass. On a CPU tensor ``fn`` runs the plain version: the stacked-jet
bundle, the residual and ``torch.autograd``.

Every kernel has a plain PyTorch twin with the same contract (``_TorchOps``
beside ``_CudaOps``), and one host-side launcher (``_loss_and_grads``) runs
either set. The tests run the launcher with the plain twins on the CPU — which
checks the hand-derived LayerNorm + tanh backward (``_transport_bwd_plain``)
and all the layout and stride bookkeeping against autograd — and the chip
smoke test compares the CUDA set with the plain version on the card.

Scope: spatial order <= 2 in one space dimension, temporal order 1, the
Burgers residual, non-causal, float32. The causal variant, order 3 and the
other PDEs' residuals are ROADMAP work.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from pinnrl_tpu_torch.ops.jet_mlp import BundleView, _transport_block, make_bundle_fn
from pinnrl_tpu_torch.ops.kernels import _build

_LN_EPS = 1e-6
_STREAMS = 4  # [value, d/dx, d2/dx2, d/dt]
_GEMM_TILE = 64
_GEMM_BK = 16
_COLSUM_ROWS = 256
_TARGET_BLOCKS = 264  # two waves of the H100's 132 SMs for split-K products


# --------------------------------------------------------------------------- #
# Plain twins of the CUDA kernels (same arguments, same layouts)
# --------------------------------------------------------------------------- #


def _embed_plain(z, lo, sc, B, two_pi: bool) -> torch.Tensor:
    """Stacked (4N, 2m) Fourier input [value; x1; x2; t1] (see jet_mlp)."""
    s = 2.0 * math.pi if two_pi else 1.0
    w0 = (z - lo) * sc - 1.0
    p = s * (w0 @ B)
    p1x = s * (sc[0] * B[0])
    p1t = s * (sc[1] * B[1])
    sn, cs = torch.sin(p), torch.cos(p)
    s1, c1 = cs * p1x, -sn * p1x
    rows = [
        torch.cat([sn, cs], dim=-1),
        torch.cat([s1, c1], dim=-1),
        torch.cat([c1 * p1x, -s1 * p1x], dim=-1),
        torch.cat([cs * p1t, -sn * p1t], dim=-1),
    ]
    return torch.cat(rows, dim=0)


def _transport_fwd_plain(H, gamma, beta, n: int) -> torch.Tensor:
    """LayerNorm + tanh transport of the stacked (4n, W) pre-activations."""
    h0, h1, h2, ht = H.split(n, dim=0)
    a0, ((o1, o2), (ot,)) = _transport_block(h0, [[h1, h2], [ht]], gamma, beta, "tanh")
    return torch.cat([a0, o1, o2, ot], dim=0)


def _transport_bwd_plain(H, gamma, beta, GA, n: int):
    """Hand-derived reverse pass of ``_transport_fwd_plain``.

    Forward, per point (row means over the width W; r = 1/sqrt(var0+eps)):
        c_k = h_k - mean(h_k)                      k in {0, 1, 2, t}
        S1 = mean(c0 c1) r ;  V2 = mean(c1^2 + c0 c2) ;  S2 = (V2 - S1^2) r
        St = mean(c0 ct) r
        q0 = c0 r ;  q1 = (c1 - q0 S1) r ;  q2 = (c2 - 2 q1 S1 - q0 S2) r
        qt = (ct - q0 St) r
        y0 = q0 g + b ;  y_k = q_k g ;  a0 = tanh(y0)
        d1 = 1 - a0^2 ;  d2 = -2 a0 d1
        o1 = d1 y1 ;  o2 = d1 y2 + d2 y1^2 ;  ot = d1 yt
    Reverse (G_v is the cotangent of v): the element-wise part gives G_y*
    and G_q*; eight row sums of G_q* against q* give the cotangents of the
    row scalars S1, S2, V2, St and r; then G_c* follow element-wise, and
    G_h = G_c - mean(G_c) because centring is self-adjoint. The CUDA
    transport_bwd_kernel evaluates exactly these formulas.

    Returns (GH, Ggamma_rows, Gbeta_rows): per-point rows of the LayerNorm
    parameter gradients (``None`` without LayerNorm).
    """
    h0, h1, h2, ht = H.split(n, dim=0)
    Ga0, Go1, Go2, Got = GA.split(n, dim=0)
    W = H.shape[1]

    def mean(v):
        return torch.mean(v, dim=-1, keepdim=True)

    if gamma is not None:
        c0, c1, c2, ct = h0 - mean(h0), h1 - mean(h1), h2 - mean(h2), ht - mean(ht)
        r = 1.0 / torch.sqrt(mean(c0 * c0) + _LN_EPS)
        S1 = mean(c0 * c1) * r
        V2 = mean(c1 * c1 + c0 * c2)
        S2 = (V2 - S1 * S1) * r
        St = mean(c0 * ct) * r
        q0 = c0 * r
        q1 = (c1 - q0 * S1) * r
        q2 = (c2 - 2.0 * q1 * S1 - q0 * S2) * r
        qt = (ct - q0 * St) * r
        y0, y1, y2, yt = q0 * gamma + beta, q1 * gamma, q2 * gamma, qt * gamma
    else:
        y0, y1, y2, yt = h0, h1, h2, ht
    a0 = torch.tanh(y0)
    d1 = 1.0 - a0 * a0
    d2 = -2.0 * a0 * d1

    Gd1 = Go1 * y1 + Go2 * y2 + Got * yt
    Gd2 = Go2 * y1 * y1
    Gy1 = Go1 * d1 + 2.0 * Go2 * d2 * y1
    Gy2 = Go2 * d1
    Gyt = Got * d1
    Ga = Ga0 - 2.0 * a0 * Gd1 + Gd2 * (4.0 * a0 * a0 - 2.0 * d1)
    Gy0 = Ga * d1
    if gamma is None:
        return torch.cat([Gy0, Gy1, Gy2, Gyt], dim=0), None, None

    Gq2 = Gy2 * gamma
    Gqt = Gyt * gamma
    Gq1 = Gy1 * gamma - 2.0 * Gq2 * S1 * r
    Gq0 = Gy0 * gamma - (Gqt * St + Gq2 * S2 + Gq1 * S1) * r

    def rsum(v):
        return torch.sum(v, dim=-1, keepdim=True)

    GSt = -rsum(Gqt * q0) * r
    GS2 = -rsum(Gq2 * q0) * r
    GV2 = GS2 * r
    GS1 = -2.0 * rsum(Gq2 * q1) * r - 2.0 * S1 * r * GS2 - rsum(Gq1 * q0) * r
    Gr = (
        rsum(Gqt * qt) + rsum(Gq2 * q2) + rsum(Gq1 * q1) + rsum(Gq0 * q0)
        + GSt * St + GS2 * S2 + GS1 * S1
    ) / r
    Gvar0 = -0.5 * r * r * r * Gr
    inv_w = 1.0 / W
    Gc1 = Gq1 * r + (2.0 * GV2 * c1 + GS1 * r * c0) * inv_w
    Gc2 = Gq2 * r + GV2 * c0 * inv_w
    Gct = Gqt * r + GSt * r * c0 * inv_w
    Gc0 = Gq0 * r + (GSt * r * ct + GV2 * c2 + GS1 * r * c1 + 2.0 * Gvar0 * c0) * inv_w
    GH = torch.cat([Gc0 - mean(Gc0), Gc1 - mean(Gc1), Gc2 - mean(Gc2), Gct - mean(Gct)], dim=0)
    Ggamma = Gy0 * q0 + Gy1 * q1 + Gy2 * q2 + Gyt * qt
    return GH, Ggamma, Gy0


class _TorchOps:
    """Plain PyTorch twins of the kernels, one method per C entry point."""

    def embed(self, z, lo, sc, B, two_pi):
        return _embed_plain(z, lo, sc, B, two_pi)

    def gemm(self, M, N, K, A, sam, sak, B, sbk, sbn, C, ldc, bias, bias_rows, splits, k_chunk):
        Av = A.as_strided((M, K), (sam, sak), A.storage_offset())
        Bv = B.as_strided((K, N), (sbk, sbn), B.storage_offset())
        for s in range(splits):
            k0, k1 = s * k_chunk, min(K, (s + 1) * k_chunk)
            out = Av[:, k0:k1] @ Bv[k0:k1]
            if bias is not None:
                out[:bias_rows] += bias
            C.as_strided((M, N), (ldc, 1), C.storage_offset() + s * M * N).copy_(out)

    def transport_fwd(self, H, gamma, beta, n):
        return _transport_fwd_plain(H, gamma, beta, n)

    def transport_bwd(self, H, gamma, beta, GA, n):
        return _transport_bwd_plain(H, gamma, beta, GA, n)

    def burgers(self, U, n, nu):
        u, ux, uxx, ut = U.reshape(_STREAMS, n)
        r = (ut + u * ux) - nu * uxx
        c = (2.0 / n) * r
        return torch.stack([c * ux, c * u, -c * nu, c]).reshape(-1, 1), (r * r).reshape(n, 1)

    def colsum(self, A, rows, cols, ld, scale):
        return A.as_strided((rows, cols), (ld, 1), A.storage_offset()).sum(dim=0) * scale


class _CudaOps:
    """The CUDA kernels of ``csrc/fused_residual.cu`` behind the same methods."""

    _ARGTYPES = {
        "fr_embed": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
        "fr_gemm": [ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong]
        + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong]
        + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
           ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p],
        "fr_transport_fwd": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
        "fr_transport_bwd": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
        "fr_burgers": [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
        "fr_colsum": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
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

    def embed(self, z, lo, sc, B, two_pi):
        n, m = z.shape[0], B.shape[1]
        X = self._empty(_STREAMS * n, 2 * m)
        _build.check(self.lib.fr_embed(z.data_ptr(), lo.data_ptr(), sc.data_ptr(), B.data_ptr(),
                                       X.data_ptr(), n, m, int(two_pi), self.stream), "embed_kernel")
        return X

    def gemm(self, M, N, K, A, sam, sak, B, sbk, sbn, C, ldc, bias, bias_rows, splits, k_chunk):
        _build.check(self.lib.fr_gemm(M, N, K, A.data_ptr(), sam, sak, B.data_ptr(), sbk, sbn,
                                      C.data_ptr(), ldc, self._ptr(bias), bias_rows, splits,
                                      k_chunk, M * N, self.stream), "sgemm_kernel")

    def transport_fwd(self, H, gamma, beta, n):
        A = torch.empty_like(H)
        _build.check(self.lib.fr_transport_fwd(H.data_ptr(), self._ptr(gamma), self._ptr(beta),
                                               A.data_ptr(), n, H.shape[1], int(gamma is not None),
                                               self.stream), "transport_fwd_kernel")
        return A

    def transport_bwd(self, H, gamma, beta, GA, n):
        GH = torch.empty_like(H)
        use_ln = gamma is not None
        Gg = self._empty(n, H.shape[1]) if use_ln else None
        Gb = self._empty(n, H.shape[1]) if use_ln else None
        _build.check(self.lib.fr_transport_bwd(H.data_ptr(), self._ptr(gamma), self._ptr(beta),
                                               GA.data_ptr(), GH.data_ptr(), self._ptr(Gg),
                                               self._ptr(Gb), n, H.shape[1], int(use_ln),
                                               self.stream), "transport_bwd_kernel")
        return GH, Gg, Gb

    def burgers(self, U, n, nu):
        dU = torch.empty_like(U)
        r2 = self._empty(n, 1)
        _build.check(self.lib.fr_burgers(U.data_ptr(), dU.data_ptr(), r2.data_ptr(), n,
                                         float(nu), self.stream), "burgers_kernel")
        return dU, r2

    def colsum(self, A, rows, cols, ld, scale):
        partial = self._empty(_cdiv(rows, _COLSUM_ROWS), cols)
        out = self._empty(cols)
        _build.check(self.lib.fr_colsum(A.data_ptr(), rows, cols, ld, float(scale),
                                        partial.data_ptr(), out.data_ptr(), self.stream),
                     "colsum kernels")
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


def _linear(ops, X, W, b, bias_rows: int):
    """X (R, K) @ W^T (W: (out, K)) + b on the first ``bias_rows`` rows."""
    R, K = X.shape
    out = W.shape[0]
    Y = torch.empty((R, out), dtype=X.dtype, device=X.device)
    ops.gemm(R, out, K, X, K, 1, W, 1, K, Y, out, b, bias_rows, 1, K)
    return Y


def _linear_dx(ops, G, W):
    """G (R, out) @ W (out, K) -> (R, K)."""
    R, out = G.shape
    K = W.shape[1]
    dX = torch.empty((R, K), dtype=G.dtype, device=G.device)
    ops.gemm(R, K, out, G, out, 1, W, K, 1, dX, K, None, 0, 1, out)
    return dX


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _split_k(M: int, N: int, K: int) -> Tuple[int, int]:
    """(splits, k_chunk) for an (M, N) product with a long K: enough blocks
    to fill the card, at least 512 of K per split, chunks a multiple of BK."""
    tiles = _cdiv(M, _GEMM_TILE) * _cdiv(N, _GEMM_TILE)
    splits = max(1, min(_cdiv(_TARGET_BLOCKS, tiles), _cdiv(K, 512)))
    k_chunk = _cdiv(_cdiv(K, splits), _GEMM_BK) * _GEMM_BK
    return _cdiv(K, k_chunk), k_chunk


def _linear_dw(ops, G, X):
    """G^T (out, R) @ X (R, K) -> (out, K), split over R with a
    deterministic reduction of the split partials."""
    R, out = G.shape
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
    nu: float
    lo: torch.Tensor
    scale: torch.Tensor
    B: torch.Tensor
    leaf_names: List[str]


def _loss_and_grads(ops, spec: _Spec, z: torch.Tensor, P: Dict[str, torch.Tensor],
                    need_grads: bool = True):
    """(mean r^2, {name: d loss / d param}) through ``ops``' kernels; with
    ``need_grads=False`` it stops before the reverse pass and the dict is
    empty."""
    n = z.shape[0]
    L = spec.n_hidden
    X = [ops.embed(z, spec.lo, spec.scale, spec.B, spec.periodic)]
    Hs = []
    for i in range(L):
        H = _linear(ops, X[-1], P[f"Dense_{i}.weight"], P[f"Dense_{i}.bias"], n)
        gamma = P[f"LayerNorm_{i}.weight"] if spec.use_ln else None
        beta = P[f"LayerNorm_{i}.bias"] if spec.use_ln else None
        Hs.append(H)
        X.append(ops.transport_fwd(H, gamma, beta, n))
    U = _linear(ops, X[-1], P[f"Dense_{L}.weight"], P[f"Dense_{L}.bias"], n)
    G, r2 = ops.burgers(U, n, spec.nu)
    loss = ops.colsum(r2, n, 1, 1, 1.0 / n).reshape(())

    grads: Dict[str, torch.Tensor] = {}
    if not need_grads:
        return loss, grads
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
    """The plain version: stacked-jet bundle -> residual -> mean r^2."""
    value, streams = bundle_fn(params, z)
    r = pde.residual_pointwise(BundleView(value, streams), z, None)
    return torch.mean(r * r)


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
    return _Spec(
        n_hidden=n_hidden,
        use_ln=use_ln,
        periodic=bool(cfg.arch_params.get("periodic", True)),
        nu=float(pde._nu(None)),
        lo=model._in_lo.contiguous(),
        scale=model._in_scale.contiguous(),
        B=model.constants["FourierFeatures_0.B"].contiguous(),
        leaf_names=names,
    )


def make_fused_residual_loss(model, pde) -> Callable[[Dict[str, torch.Tensor], torch.Tensor], torch.Tensor]:
    """Build ``fn(params, z) -> mean r^2`` whose gradient comes from the
    kernels' own backward. ``z`` is (N, 2) physical coordinates (x, t)."""
    if not supports(model, pde):
        raise ValueError(
            f"fused residual kernel does not support pde={pde.pde_type}, "
            f"arch={model.config.architecture}"
        )
    spec = _spec(model, pde)
    bundle_fn = make_bundle_fn(model, pde.dimension, spatial_order=2, temporal_order=1)

    def fn(params, z):
        return fused_residual_loss(spec, bundle_fn, pde, params, z)

    return fn


def supports(model, pde, training=None) -> bool:
    """The structural conditions of the stacked-jet bundle, the reductions
    the kernel hard-codes (plain MSE, no trainable coefficients), and this
    port's scope: the Burgers residual on a Fourier trunk in one space
    dimension, non-causal, no moving frame. No width gate: the TPU's gate
    was a TPU measurement, and no H100 measurement has set one."""
    from pinnrl_tpu_torch.ops import jet_mlp

    if not (pde.bundle_compatible and pde.system_size == 1 and jet_mlp.supports(model, pde)):
        return False
    if getattr(pde, "trainable_parameters", None):
        return False
    if training is not None:
        if getattr(training, "loss_function", "mse") != "mse":
            return False
        if float(getattr(training, "causal_eps", 0.0) or 0.0) > 0.0:
            return False
    if pde.pde_type != "burgers" or pde.dimension != 1:
        return False
    if model.config.architecture != "fourier" or model._frame_speed is not None:
        return False
    if max(pde.spatial_orders, default=0) > 2 or max(pde.temporal_orders, default=0) != 1:
        return False
    return True
