"""Fused MLP scorer: Dense -> LayerNorm -> ReLU, twice, then Dense.

This is the DQN agent's grid scorer (``rl/dqn.py``), evaluated over the
adaptive sampler's 100x100 grid on every training step. It is a pure
forward pass: the scores feed a draw, and no gradient flows through them.

CUDA kernels: ``csrc/mlp_score.cu``. On a CUDA tensor ``fused_mlp_score``
launches them (or raises); on a CPU tensor it runs
``fused_mlp_score_plain``. As in ``fused_step``, every CUDA entry point has
a plain twin with the same contract (``_TorchOps`` beside ``_CudaOps``), and
one host launcher (``_score``) runs either set, so the CPU tests rehearse
the sequence, the strides and the GEMM call.

``params`` is the port's ``DQNNetwork`` parameter dict (``Dense_i.weight``
of shape (out, in), ``LayerNorm_i.{weight,bias}``); see ``models/bridge.py``
for the mapping from flax's tree.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Mapping

import torch

from pinnrl_tpu_torch.ops.kernels import _build, fused_step

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

    gemm = fused_step._TorchOps.gemm

    def ln_relu_head(self, H2, g2, be2, W3, b3, eps):
        return _ln_relu_plain(H2, g2, be2, eps) @ W3.t() + b3


class _CudaOps:
    """The CUDA kernels of ``csrc/mlp_score.cu`` behind the same methods."""

    _ROW_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
    _ARGTYPES = {
        "ms_dense_ln_relu_in": _ROW_ARGS,
        "ms_gemm": fused_step._CudaOps._ARGTYPES["fr_gemm"],
        "ms_ln_relu_head": _ROW_ARGS,
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

    def dense_ln_relu_in(self, x, W1, b1, g1, be1, eps):
        n, d = x.shape
        h = W1.shape[0]
        H1 = torch.empty((n, h), dtype=torch.float32, device=self.device)
        _build.check(self.lib.ms_dense_ln_relu_in(
            x.data_ptr(), W1.data_ptr(), b1.data_ptr(), g1.data_ptr(), be1.data_ptr(),
            H1.data_ptr(), n, d, h, float(eps), self.stream), "dense_ln_relu_in_kernel")
        return H1

    def gemm(self, M, N, K, A, sam, sak, B, sbk, sbn, C, ldc, bias, bias_rows, splits, k_chunk):
        _build.check(self.lib.ms_gemm(M, N, K, A.data_ptr(), sam, sak, B.data_ptr(), sbk, sbn,
                                      C.data_ptr(), ldc, None if bias is None else bias.data_ptr(),
                                      bias_rows, splits, k_chunk, M * N, self.stream),
                     "sgemm_kernel")

    def ln_relu_head(self, H2, g2, be2, W3, b3, eps):
        n, h = H2.shape
        a_dim = W3.shape[0]
        out = torch.empty((n, a_dim), dtype=torch.float32, device=self.device)
        _build.check(self.lib.ms_ln_relu_head(
            H2.data_ptr(), g2.data_ptr(), be2.data_ptr(), W3.data_ptr(), b3.data_ptr(),
            out.data_ptr(), n, h, a_dim, float(eps), self.stream), "ln_relu_head_kernel")
        return out


_CUDA_OPS: Dict[torch.device, _CudaOps] = {}


def _cuda_ops(device: torch.device) -> _CudaOps:
    """The kernels bound once per device."""
    ops = _CUDA_OPS.get(device)
    if ops is None:
        ops = _CUDA_OPS[device] = _CudaOps(device)
    return ops


def _score(ops, x: torch.Tensor, P: Mapping[str, torch.Tensor], eps: float) -> torch.Tensor:
    """Host launcher shared by both op sets: first layer, GEMM, head."""
    H1 = ops.dense_ln_relu_in(x, P["Dense_0.weight"], P["Dense_0.bias"],
                              P["LayerNorm_0.weight"], P["LayerNorm_0.bias"], eps)
    H2 = fused_step._gemm_linear(ops, H1, P["Dense_1.weight"], P["Dense_1.bias"], H1.shape[0])
    return ops.ln_relu_head(H2, P["LayerNorm_1.weight"], P["LayerNorm_1.bias"],
                            P["Dense_2.weight"], P["Dense_2.bias"], eps)


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
    fused_mlp_score.launches += 1
    return out


fused_mlp_score.launches = 0
