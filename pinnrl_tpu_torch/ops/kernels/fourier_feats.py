"""Fused Fourier-feature embedding: [sin(s x@B), cos(s x@B)], s = 2 pi or 1.

CUDA kernel: ``csrc/fourier_feats.cu``. On a CUDA tensor ``fourier_features``
launches it (or raises); on a CPU tensor it runs ``fourier_features_plain``.
Its gradient is written on the kernel's own output, as the JAX jvp rule is:
g_proj = s (g_sin cos - g_cos sin), g_x = g_proj @ B^T, g_B = x^T @ g_proj.
The forward-mode (jvp) rule waits for the generic derivative engine
(ROADMAP item 10).
"""

from __future__ import annotations

import ctypes
import math

import torch

from pinnrl_tpu_torch.ops.kernels import _build

_TWO_PI = 2.0 * math.pi


def fourier_features_plain(x: torch.Tensor, B: torch.Tensor, two_pi: bool = True) -> torch.Tensor:
    """The plain PyTorch version of the kernel."""
    proj = x @ B
    if two_pi:
        proj = _TWO_PI * proj
    return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


def _lib():
    lib = _build.load_library("fourier_feats")
    fn = lib.fourier_features_launch
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return lib


def fourier_features_cuda(x: torch.Tensor, B: torch.Tensor, two_pi: bool = True) -> torch.Tensor:
    """Launch the CUDA kernel (forward only); counts one launch."""
    if x.ndim != 2 or B.ndim != 2 or x.shape[1] != B.shape[0]:
        raise ValueError(f"fourier_features: shapes {tuple(x.shape)} @ {tuple(B.shape)} do not chain")
    _build.require_cuda_f32("fourier_features x", x)
    _build.require_cuda_f32("fourier_features B", B)
    if x.device != B.device:
        raise ValueError(f"fourier_features: x on {x.device}, B on {B.device}")
    n, d = x.shape
    m = B.shape[1]
    out = torch.empty((n, 2 * m), dtype=torch.float32, device=x.device)
    status = _lib().fourier_features_launch(
        x.data_ptr(), B.data_ptr(), out.data_ptr(), n, d, m, int(bool(two_pi)),
        _build.stream_handle(x.device),
    )
    _build.check(status, "fourier_features_kernel")
    fourier_features.launches += 1
    return out


class _FourierFeaturesFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, B, two_pi: bool):
        out = fourier_features_cuda(x, B, two_pi)
        ctx.save_for_backward(x, B, out)
        ctx.two_pi = two_pi
        return out

    @staticmethod
    def backward(ctx, g):
        x, B, out = ctx.saved_tensors
        m = B.shape[1]
        s = _TWO_PI if ctx.two_pi else 1.0
        g_proj = s * (g[:, :m] * out[:, m:] - g[:, m:] * out[:, :m])
        gx = g_proj @ B.t() if ctx.needs_input_grad[0] else None
        gB = x.t() @ g_proj if ctx.needs_input_grad[1] else None
        return gx, gB, None


def fourier_features(x: torch.Tensor, B: torch.Tensor, two_pi: bool = True) -> torch.Tensor:
    """[sin(s x@B), cos(s x@B)] for x (N, d), B (d, m): the CUDA kernel on
    CUDA tensors, the plain version on CPU tensors; anything else raises."""
    if x.device.type == "cpu" and B.device.type == "cpu":
        return fourier_features_plain(x, B, two_pi)
    if x.device.type == "cuda":
        return _FourierFeaturesFn.apply(x, B, bool(two_pi))
    raise ValueError(f"fourier_features: unsupported devices x={x.device}, B={B.device}")


fourier_features.launches = 0
