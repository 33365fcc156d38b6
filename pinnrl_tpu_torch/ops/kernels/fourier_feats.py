"""Fused Fourier-feature embedding: [sin(s x@B), cos(s x@B)], s = 2 pi or 1.

CUDA kernel: ``csrc/fourier_feats.cu``. On a CUDA tensor ``fourier_features``
launches it through ``_FourierFeaturesFn`` (or raises); on a CPU tensor it
runs ``fourier_features_plain``. Both derivative rules are written on the
kernel's own output, as the JAX ``custom_jvp`` rule is
(``pinnrl_tpu/ops/kernels/fourier_feats.py``):

- jvp: d[sin, cos] = [cos, -sin] s (dx B + x dB), in plain ops on the
  output, which an enclosing ``jvp`` or ``grad`` differentiates again (the
  periodic boundary loss differentiates the network through it);
- backward: g_proj = s (g_sin cos - g_cos sin), g_x = g_proj B^T,
  g_B = x^T g_proj.

``_FourierFeaturesFn`` takes the launch as an argument, so the CPU tests run
it with ``fourier_features_plain`` in its place. ``fourier_features.jvps``
counts the jvp rule's runs on CUDA tensors.
"""

from __future__ import annotations

import ctypes
import math

import torch

from pinnrl_tpu_torch.ops.kernels import _build, _jvp

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
    """[sin(s x B), cos(s x B)] with ``launch`` computing the primal."""

    @staticmethod
    def forward(x, B, two_pi: bool, launch):
        return launch(x, B, two_pi)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, B, two_pi, _launch = inputs
        ctx.save_for_backward(x, B, output)
        ctx.save_for_forward(x, B, output)
        ctx.two_pi = two_pi

    @staticmethod
    def backward(ctx, g):
        x, B, out = ctx.saved_tensors
        m = B.shape[1]
        s = _TWO_PI if ctx.two_pi else 1.0
        g_proj = s * (g[:, :m] * out[:, m:] - g[:, m:] * out[:, :m])
        gx = g_proj @ B.t() if ctx.needs_input_grad[0] else None
        gB = x.t() @ g_proj if ctx.needs_input_grad[1] else None
        return gx, gB, None, None

    @staticmethod
    def jvp(ctx, dx, dB, _two_pi, _launch):
        level, (x, B, out, dx, dB) = _jvp.lower(*ctx.saved_tensors, dx, dB)
        if out.device.type == "cuda":
            fourier_features.jvps += 1
        m = B.shape[1]
        s = _TWO_PI if ctx.two_pi else 1.0
        with _jvp.forward_mode(level):
            terms = [t for t in (None if dx is None else dx @ B,
                                 None if dB is None else x @ dB) if t is not None]
            dproj = terms[0] if len(terms) == 1 else terms[0] + terms[1]
            dproj = s * dproj
            return torch.cat([out[..., m:] * dproj, -out[..., :m] * dproj], dim=-1)

    @staticmethod
    def vmap(info, in_dims, x, B, two_pi, launch):
        x_bd, B_bd = in_dims[:2]
        if B_bd is None:
            # Rows are independent: fold the batch into x's rows, one call.
            xb = x.movedim(x_bd, 0)
            out = _FourierFeaturesFn.apply(xb.reshape(-1, xb.shape[-1]), B, two_pi, launch)
            return out.reshape(*xb.shape[:-1], 2 * B.shape[-1]), 0
        outs = [_FourierFeaturesFn.apply(x if x_bd is None else x.select(x_bd, i),
                                         B.select(B_bd, i), two_pi, launch)
                for i in range(info.batch_size)]
        return torch.stack(outs), 0


def fourier_features(x: torch.Tensor, B: torch.Tensor, two_pi: bool = True) -> torch.Tensor:
    """[sin(s x@B), cos(s x@B)] for x (N, d), B (d, m): the CUDA kernel on
    CUDA tensors, the plain version on CPU tensors; anything else raises."""
    if x.device.type == "cpu" and B.device.type == "cpu":
        return fourier_features_plain(x, B, two_pi)
    if x.device.type == "cuda":
        return _FourierFeaturesFn.apply(x, B, bool(two_pi), fourier_features_cuda)
    raise ValueError(f"fourier_features: unsupported devices x={x.device}, B={B.device}")


fourier_features.launches = 0
fourier_features.jvps = 0
