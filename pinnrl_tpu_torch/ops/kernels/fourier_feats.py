"""Fused Fourier-feature embedding: [sin(s x@B), cos(s x@B)], s = 2 pi or 1.

CUDA kernel: ``csrc/fourier_feats.cu``. On a CUDA tensor ``fourier_features``
launches it (or raises), through ``_FourierFeaturesFn`` where a derivative
rule can be asked; on a CPU tensor it runs ``fourier_features_plain``. Both
derivative rules are written on the kernel's own output, as the JAX
``custom_jvp`` rule is (``pinnrl_tpu/ops/kernels/fourier_feats.py``):

- jvp: d[sin, cos] = [cos, -sin] s (dx B + x dB), in plain ops on the
  output, which an enclosing ``jvp`` or ``grad`` differentiates again (the
  periodic boundary loss differentiates the network through it);
- backward: g_proj = s (g_sin cos - g_cos sin), g_x = g_proj B^T,
  g_B = x^T g_proj.

``_FourierFeaturesFn`` takes the launch as an argument, so the CPU tests run
it with ``fourier_features_plain`` in its place. ``fourier_features.jvps``
counts the jvp rule's runs on CUDA tensors.

Its vmap rule launches once for the whole batch: with B unbatched the batch
folds into x's rows; with a member axis on B (a deep ensemble's trainable
basis, B (E, d, m)) the kernel runs the E members on its member axis, x
(E, n, d) (or one x for all, member stride 0) and out (E, n, 2m), as the
reference's vmap of its kernel gives one pallas_call with a member axis.

The kernel takes float32 alone. As the JAX kernel gates its Pallas call, a
CUDA call whose x or B is not float32 (the float64 residual phase) runs the
plain version, which promotes both to a common dtype as ``jnp`` does;
``fourier_features.plain_f64`` counts those calls.

The launch path is kept short, because a call moves ~4 MB and its device
time is a few microseconds: a call that no derivative rule can be asked of
(no input needs a gradient, no ``torch.func`` transform and no forward-AD
level is active: the BC and IC losses, validation) launches the kernel
without going through ``_FourierFeaturesFn``, whose ``apply`` costs tens of
microseconds of host time (``needs_rules``); the ctypes functions are
bound once; shape, dtype, device and layout are checked in one function
(``_accepts``; ``_reject`` names what failed); the stream is read raw.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch
import torch.autograd.forward_ad as _fwad

from pinnrl_tpu_torch.ops.kernels import _build, _jvp, counts

_TWO_PI = 2.0 * math.pi

# The kernel's block (csrc/fourier_feats.cu): QUADS feature quads (features
# on the edge path) by ROWS rows; the vector path takes d <= MAX_VEC_D.
QUADS, ROWS, MAX_VEC_D = 32, 8, 3
# Blocks along the rows per SM: each block strides over rows, reusing the B
# it holds in registers.
BLOCKS_PER_SM = 4
_MAX_GRID_Y = 65535


def fourier_features_plain(x: torch.Tensor, B: torch.Tensor, two_pi: bool = True) -> torch.Tensor:
    """The plain PyTorch version of the kernel; x and B are promoted to a
    common dtype (float32 points into a float64 basis give float64)."""
    if x.dtype != B.dtype:
        dt = torch.promote_types(x.dtype, B.dtype)
        x, B = x.to(dt), B.to(dt)
    proj = x @ B
    if two_pi:
        proj = _TWO_PI * proj
    return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


_ARGTYPES = {
    "ff_forward": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 2
    + [ctypes.c_void_p],
    "ff_empty": [ctypes.c_int] * 3 + [ctypes.c_void_p],
}


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library, its functions bound once."""
    lib = _build.load_library("fourier_feats")
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch_plan(n: int, d: int, m: int, b_aligned: bool, sms: int) -> Tuple[int, int, int]:
    """(path, grid_cols, grid_rows) of the kernel for x (n, d), B (d, m):
    path d for the vector path (d <= MAX_VEC_D, m % 4 == 0, B 16-byte
    aligned), else 0, the edge path; grid_cols blocks across the feature
    quads (features on the edge path), grid_rows along the rows: enough
    for every row to have a thread, at most BLOCKS_PER_SM per SM."""
    path = d if d <= MAX_VEC_D and m % 4 == 0 and b_aligned else 0
    cols = -(-(m // 4 if path else m) // QUADS)
    rows = min(-(-n // ROWS), max(BLOCKS_PER_SM * sms // max(cols, 1), 1), _MAX_GRID_Y)
    return path, cols, max(rows, 1)


def _chains(x: torch.Tensor, B: torch.Tensor) -> bool:
    """x (n, d) @ B (d, m), or E members: x (E, n, d) @ B (E, d, m)."""
    return ((x.ndim == B.ndim == 2 and x.shape[1] == B.shape[0])
            or (x.ndim == B.ndim == 3 and x.shape[0] == B.shape[0] and x.shape[2] == B.shape[1]))


def _accepts(x: torch.Tensor, B: torch.Tensor) -> bool:
    """Shapes that chain, float32 on one CUDA device, B contiguous and each
    member's x contiguous (the members' x at any stride, 0 included)."""
    return (_chains(x, B) and x.is_cuda and x.dtype == torch.float32
            and B.dtype == torch.float32 and x[(0,) * (x.ndim - 2)].is_contiguous()
            and B.is_contiguous() and B.get_device() == x.get_device())


def _reject(x: torch.Tensor, B: torch.Tensor) -> None:
    """Raise for the first of ``_accepts``'s conditions that x, B fail."""
    if not _chains(x, B):
        raise ValueError(f"fourier_features: shapes {tuple(x.shape)} @ {tuple(B.shape)} do not chain")
    _build.require_cuda_f32("fourier_features x", x[(0,) * (x.ndim - 2)])
    _build.require_cuda_f32("fourier_features B", B)
    raise ValueError(f"fourier_features: x on {x.device}, B on {B.device}")


def fourier_features_cuda(x: torch.Tensor, B: torch.Tensor, two_pi: bool = True) -> torch.Tensor:
    """Launch the CUDA kernel (forward only) on x (n, d), B (d, m), or on E
    members at once, x (E, n, d), B (E, d, m) -> (E, n, 2m), each member on
    the single call's grid; counts one launch."""
    if not _accepts(x, B):
        _reject(x, B)
    n, d = x.shape[-2:]
    m = B.shape[-1]
    members = x.shape[0] if x.ndim == 3 else 1
    index = x.get_device()
    b_ptr = B.data_ptr()
    path, _, rows = launch_plan(n, d, m, b_ptr % 16 == 0, _sm_count(index))
    out = x.new_empty((*x.shape[:-1], 2 * m))
    status = _lib().ff_forward(x.data_ptr(), b_ptr, out.data_ptr(), n, d, m, path, rows,
                               1 if two_pi else 0, members, x.stride(0) if members > 1 else 0,
                               d * m if members > 1 else 0, _build.stream_handle(index))
    _build.check(status, "fourier_features_kernel")
    counts.add(fourier_features, "launches")
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
        m = B.shape[-1]
        s = _TWO_PI if ctx.two_pi else 1.0
        g_proj = s * (g[..., :m] * out[..., m:] - g[..., m:] * out[..., :m])
        gx = g_proj @ B.transpose(-1, -2) if ctx.needs_input_grad[0] else None
        gB = x.transpose(-1, -2) @ g_proj if ctx.needs_input_grad[1] else None
        return gx, gB, None, None

    @staticmethod
    def jvp(ctx, dx, dB, _two_pi, _launch):
        level, (x, B, out, dx, dB) = _jvp.lower(*ctx.saved_tensors, dx, dB)
        if out.device.type == "cuda":
            counts.add(fourier_features, "jvps")
        m = B.shape[-1]
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
        m = B.shape[-1]
        if B_bd is None:
            # Rows are independent: fold the batch into x's rows, one call.
            xb = x.movedim(x_bd, 0)
            out = _FourierFeaturesFn.apply(xb.reshape(-1, xb.shape[-1]), B, two_pi, launch)
            return out.reshape(*xb.shape[:-1], 2 * m), 0
        # A member axis on B: one call with the members on the kernel's member
        # axis (an unbatched x is shared at member stride 0).
        E = info.batch_size
        xb = x.movedim(x_bd, 0) if x_bd is not None else x.expand(E, *x.shape)
        lead = xb.shape[1:-1]
        out = _FourierFeaturesFn.apply(xb.reshape(E, -1, xb.shape[-1]), B.movedim(B_bd, 0),
                                       two_pi, launch)
        return out.reshape(E, *lead, 2 * m), 0


def needs_rules(x: torch.Tensor, B: torch.Tensor) -> bool:
    """Whether a derivative rule of ``_FourierFeaturesFn`` can be asked of a
    call on x, B: a ``torch.func`` transform (jvp, grad, vmap) is active, a
    forward-AD level is open, or autograd records and an input needs a
    gradient. Otherwise the output is the primal alone."""
    return (torch._C._are_functorch_transforms_active() or _fwad._current_level >= 0
            or (torch.is_grad_enabled() and (x.requires_grad or B.requires_grad)))


def fourier_features(x: torch.Tensor, B: torch.Tensor, two_pi: bool = True) -> torch.Tensor:
    """[sin(s x@B), cos(s x@B)] for x (N, d), B (d, m): the CUDA kernel on
    float32 CUDA tensors, the plain version on CPU tensors and on CUDA
    tensors of another dtype (the JAX kernel's gate); anything else raises."""
    if x.is_cpu and B.is_cpu:
        return fourier_features_plain(x, B, two_pi)
    if x.is_cuda and (x.dtype != torch.float32 or B.dtype != torch.float32):
        counts.add(fourier_features, "plain_f64")
        return fourier_features_plain(x, B, two_pi)
    if x.is_cuda:
        if needs_rules(x, B):
            return _FourierFeaturesFn.apply(x, B, bool(two_pi), fourier_features_cuda)
        return fourier_features_cuda(x, B, two_pi)
    raise ValueError(f"fourier_features: unsupported devices x={x.device}, B={B.device}")


# Kernel launches (a member-batched one counting once), jvp-rule calls on the
# card, and float64 calls on the card's plain version.
counts.register(fourier_features, "launches", "jvps", "plain_f64")
