"""Fused MLP scorer: Dense -> LayerNorm -> ReLU, twice, then Dense.

This is the DQN agent's grid scorer (``rl/dqn.py``), evaluated over the
adaptive sampler's 100x100 grid on every training step. It is a pure
forward pass: the scores feed a draw, and no gradient flows through them.

CUDA kernels: ``csrc/mlp_score.cu``. On a CUDA tensor ``fused_mlp_score``
launches them (or raises); on a CPU tensor it runs
``fused_mlp_score_plain``. As in ``fused_step``, every CUDA entry point has
a plain twin with the same contract (``_TorchOps`` beside ``_CudaOps``), and
one host launcher (``_score``) runs either set, so the CPU tests rehearse
the sequence, the strides and the split of the product.

``params`` is the port's ``DQNNetwork`` parameter dict (``Dense_i.weight``
of shape (out, in), ``LayerNorm_i.{weight,bias}``); see ``models/bridge.py``
for the mapping from flax's tree.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Mapping, Optional, Tuple

import torch

from pinnrl_tpu_torch.ops.kernels import _build, _gemm_core, counts
from pinnrl_tpu_torch.ops.kernels._gemm_core import TARGET_BLOCKS, TILE, cdiv, split_chunks

_NAMES = (
    "Dense_0.weight", "Dense_0.bias", "LayerNorm_0.weight", "LayerNorm_0.bias",
    "Dense_1.weight", "Dense_1.bias", "LayerNorm_1.weight", "LayerNorm_1.bias",
    "Dense_2.weight", "Dense_2.bias",
)


def _ln_relu_plain(y: torch.Tensor, g, be, eps: float) -> torch.Tensor:
    """LayerNorm with the two-pass variance, then ReLU."""
    mean = y.mean(dim=-1, keepdim=True)
    var = ((y - mean) ** 2).mean(dim=-1, keepdim=True)
    return torch.relu((y - mean) * torch.rsqrt(var + eps) * g + be)


def fused_mlp_score_plain(x: torch.Tensor, params: Mapping[str, torch.Tensor],
                          eps: float = 1e-6) -> torch.Tensor:
    """The plain PyTorch version of the kernel: (N, d) -> (N, action_dim)."""
    P = params
    z = _ln_relu_plain(x @ P["Dense_0.weight"].t() + P["Dense_0.bias"],
                       P["LayerNorm_0.weight"], P["LayerNorm_0.bias"], eps)
    z = _ln_relu_plain(z @ P["Dense_1.weight"].t() + P["Dense_1.bias"],
                       P["LayerNorm_1.weight"], P["LayerNorm_1.bias"], eps)
    return z @ P["Dense_2.weight"].t() + P["Dense_2.bias"]


class _TorchOps:
    """Plain PyTorch twins of the kernels, one method per C entry point."""

    def dense_ln_relu_in(self, x, W1, b1, g1, be1, eps):
        return _ln_relu_plain(x @ W1.t() + b1, g1, be1, eps)

    def transpose(self, W):
        return W.t().contiguous()

    def gemm(self, M, N, K, A, sam, sak, B, sbk, sbn, C, ldc, bias, bias_rows, splits, k_chunk):
        if bias is not None and (splits > 1 or bias_rows != M):
            raise ValueError("gemm: a bias goes on every row of an unsplit product only")
        _gemm_core.gemm_plain(M, N, K, A, sam, sak, B, sbk, sbn, C, ldc, bias, bias_rows, splits,
                              k_chunk)

    def gemm_blocks(self, M, N, splits):
        return cdiv(M, TILE) * cdiv(N, TILE) * splits

    def ln_relu_head(self, P, b2, g2, be2, W3, b3, eps):
        y = P[0]
        for part in P[1:]:
            y = y + part
        if b2 is not None:
            y = y + b2
        return _ln_relu_plain(y, g2, be2, eps) @ W3.t() + b3


class _CudaOps:
    """The CUDA kernels of ``csrc/mlp_score.cu`` behind the same methods."""

    _ARGTYPES = {
        "ms_dense_ln_relu_in": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
        + [ctypes.c_float, ctypes.c_void_p],
        "ms_transpose": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p],
        "ms_gemm": _gemm_core.GEMM_ARGTYPES,
        "ms_gemm_blocks": [ctypes.c_int] * 3,
        "ms_ln_relu_head": [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong]
        + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p],
    }

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.lib = _build.load_library("mlp_score")
        for name, argtypes in self._ARGTYPES.items():
            fn = getattr(self.lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int

    @property
    def stream(self) -> int:
        return _build.stream_handle(self.device)

    def _empty(self, *shape):
        return torch.empty(shape, dtype=torch.float32, device=self.device)

    def dense_ln_relu_in(self, x, W1, b1, g1, be1, eps):
        n, d = x.shape
        h = W1.shape[0]
        H1 = self._empty(n, h)
        _build.check(self.lib.ms_dense_ln_relu_in(
            x.data_ptr(), W1.data_ptr(), b1.data_ptr(), g1.data_ptr(), be1.data_ptr(),
            H1.data_ptr(), n, d, h, float(eps), self.stream), "dense_ln_relu_in_kernel")
        return H1

    def transpose(self, W):
        rows, cols = W.shape
        WT = self._empty(cols, rows)
        _build.check(self.lib.ms_transpose(W.data_ptr(), WT.data_ptr(), rows, cols, self.stream),
                     "transpose_kernel")
        return WT

    def gemm(self, M, N, K, A, sam, sak, B, sbk, sbn, C, ldc, bias, bias_rows, splits, k_chunk):
        _build.check(self.lib.ms_gemm(M, N, K, A.data_ptr(), sam, sak, B.data_ptr(), sbk, sbn,
                                      C.data_ptr(), ldc, None if bias is None else bias.data_ptr(),
                                      bias_rows, splits, k_chunk, M * N, self.stream),
                     "gemm_sm90_kernel")

    def gemm_blocks(self, M, N, splits):
        """The thread blocks ``gemm`` launches, from the launch's own grid."""
        return self.lib.ms_gemm_blocks(M, N, splits)

    def ln_relu_head(self, P, b2, g2, be2, W3, b3, eps):
        splits, n, h = P.shape
        a_dim = W3.shape[0]
        out = self._empty(n, a_dim)
        _build.check(self.lib.ms_ln_relu_head(
            P.data_ptr(), splits, n * h, None if b2 is None else b2.data_ptr(), g2.data_ptr(),
            be2.data_ptr(), W3.data_ptr(), b3.data_ptr(), out.data_ptr(), n, h, a_dim, float(eps),
            self.stream), "ln_relu_head_kernel")
        return out


_CUDA_OPS: Dict[torch.device, _CudaOps] = {}


def _cuda_ops(device: torch.device) -> _CudaOps:
    """The kernels bound once per device."""
    ops = _CUDA_OPS.get(device)
    if ops is None:
        ops = _CUDA_OPS[device] = _CudaOps(device)
    return ops


def _product_split(M: int, N: int, K: int) -> Tuple[int, int]:
    """(splits, k_chunk) for the scorer's (M, N) product over K: in two when
    the unsplit 128x128 tiles fill more than one wave of ``TARGET_BLOCKS``
    (two per SM) but less than two, so that the second wave would run part
    empty; unsplit otherwise.

    Measured at the shipped (10000, 512) x 512 only, on an NVIDIA H100 80GB
    HBM3 (700 W), CUDA-graph replay (``chip_smoke.py`` phase 9): 316 tiles
    unsplit 0.1602 ms (1.2 waves), 632 split in two 0.1349 ms (2.4 waves of
    half the length); the whole call 0.1852 against 0.1712 ms, the head's
    sum of the two partials included. Other shapes take the rule untested."""
    tiles = cdiv(M, TILE) * cdiv(N, TILE)
    return split_chunks(K, 2 if TARGET_BLOCKS < tiles < 2 * TARGET_BLOCKS else 1)


def _score(ops, x: torch.Tensor, P: Mapping[str, torch.Tensor], eps: float,
           splits: Optional[int] = None) -> torch.Tensor:
    """Host launcher shared by both op sets: first layer, W2's transpose, the
    product H1 W2^T (split over K as ``_product_split`` picks, or in about
    ``splits``), head."""
    n, h = x.shape[0], P["Dense_1.weight"].shape[0]
    H1 = ops.dense_ln_relu_in(x, P["Dense_0.weight"], P["Dense_0.bias"],
                              P["LayerNorm_0.weight"], P["LayerNorm_0.bias"], eps)
    W2t = ops.transpose(P["Dense_1.weight"])  # (in, out): n-contiguous, through cp.async
    splits, k_chunk = _product_split(n, h, h) if splits is None else split_chunks(h, splits)
    b2 = P["Dense_1.bias"]
    partials = torch.empty((splits, n, h), dtype=H1.dtype, device=H1.device)
    ops.gemm(n, h, h, H1, h, 1, W2t, h, 1, partials, h, b2 if splits == 1 else None, n, splits,
             k_chunk)
    return ops.ln_relu_head(partials, None if splits == 1 else b2, P["LayerNorm_1.weight"],
                            P["LayerNorm_1.bias"], P["Dense_2.weight"], P["Dense_2.bias"], eps)


def _check_shapes(x: torch.Tensor, P: Mapping[str, torch.Tensor]) -> None:
    missing = [k for k in _NAMES if k not in P]
    if missing:
        raise KeyError(f"fused_mlp_score: params lack {missing}")
    if x.ndim != 2 or x.shape[0] < 1:
        raise ValueError(f"fused_mlp_score: x must be (N >= 1, d), got {tuple(x.shape)}")
    d = x.shape[1]
    h = P["Dense_0.weight"].shape[0]
    a_dim = P["Dense_2.weight"].shape[0]
    want = {
        "Dense_0.weight": (h, d), "Dense_1.weight": (h, h), "Dense_2.weight": (a_dim, h),
        "Dense_2.bias": (a_dim,),
        **{k: (h,) for k in ("Dense_0.bias", "LayerNorm_0.weight", "LayerNorm_0.bias",
                             "Dense_1.bias", "LayerNorm_1.weight", "LayerNorm_1.bias")},
    }
    bad = {k: tuple(P[k].shape) for k, s in want.items() if tuple(P[k].shape) != s}
    if bad or h < 1 or a_dim < 1:
        raise ValueError(f"fused_mlp_score: shapes do not chain from x {tuple(x.shape)}: {bad}")


def fused_mlp_score(x: torch.Tensor, params: Mapping[str, torch.Tensor],
                    eps: float = 1e-6) -> torch.Tensor:
    """Score an (N, d) point grid with a ``DQNNetwork`` parameter dict;
    returns (N, action_dim). The CUDA kernels on CUDA tensors (one launch
    counted), the plain version on CPU tensors; anything else raises."""
    tensors = [x] + [params[k] for k in _NAMES if k in params]
    if all(t.device.type == "cpu" for t in tensors):
        return fused_mlp_score_plain(x, params, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp_score: unsupported device {x.device}")
    _check_shapes(x, params)
    for name, t in zip(("x",) + _NAMES, tensors):
        _build.require_cuda_f32(f"fused_mlp_score {name}", t)
        if t.device != x.device:
            raise ValueError(f"fused_mlp_score: {name} on {t.device}, x on {x.device}")
    out = _score(_cuda_ops(x.device), x, params, float(eps))
    counts.add(fused_mlp_score, "launches")
    return out


counts.register(fused_mlp_score, "launches")
