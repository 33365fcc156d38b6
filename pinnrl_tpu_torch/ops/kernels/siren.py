"""Fused SIREN layer: sin(omega (x @ W + b)).

CUDA kernel: ``csrc/siren.cu``. On a CUDA tensor ``siren_layer`` launches it
through ``_SirenFn`` (or raises); on a CPU tensor it runs
``siren_layer_plain``. Every SIREN layer of a residual runs inside nested
``torch.func.jvp`` (the generic derivative engine, ``ops/derivatives.py``),
so the Function carries the JAX kernel's ``custom_jvp`` rule
(``pinnrl_tpu/ops/kernels/siren.py``): the primal comes through the
Function itself, the tangent cos(omega pre) omega (dx W + x dW + db) is
written in plain ops, which an enclosing ``jvp`` or ``grad`` differentiates
again. The pre-activation is recomputed there and in ``backward``, as JAX
does, rather than written out by the kernel: the kernel stays one output,
and a forward without autograd (validation) moves no extra bytes.

``_SirenFn`` takes the launch as an argument, so the CPU tests run the
Function with ``siren_layer_plain`` in its place and hold its ``jvp``,
``backward`` and ``vmap`` rules against the plain function. The vmap rule
launches once for the whole batch: with W and b unbatched the batch folds
into x's rows; with a member axis on W or b (a deep ensemble's stacked
layers) the kernel runs the E members on its member axis, x (E, n, k),
W (E, k, m), b (E, m) -> (E, n, m), as the reference's vmap of its kernel
gives one pallas_call with a member axis.

The kernel takes float32 alone. As the JAX kernel gates its Pallas call, a
CUDA call whose x or W is not float32 (the float64 residual phase) runs the
plain version, which promotes to a common dtype as ``jnp`` does;
``siren_layer.plain_f64`` counts those calls.
"""

from __future__ import annotations

import ctypes

import torch

from pinnrl_tpu_torch.ops.kernels import _build, _jvp, counts


def _row(b: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """The bias as a row of the pre-activation: b (m,), or each member's
    (E, 1, m) when W is stacked (E, k, m)."""
    return b.unsqueeze(-2) if W.ndim == 3 else b


def siren_layer_plain(x: torch.Tensor, W: torch.Tensor, b: torch.Tensor,
                      omega: float = 30.0) -> torch.Tensor:
    """The plain PyTorch version of the kernel (members too: x (E, n, k),
    W (E, k, m), b (E, m)); x, W and b are promoted to a common dtype."""
    if not x.dtype == W.dtype == b.dtype:
        dt = torch.promote_types(torch.promote_types(x.dtype, W.dtype), b.dtype)
        x, W, b = x.to(dt), W.to(dt), b.to(dt)
    return torch.sin(omega * (x @ W + _row(b, W)))


def _lib():
    lib = _build.load_library("siren")
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        if fn.restype is not ctypes.c_int or fn.argtypes is None:
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
    return lib


_ARGTYPES = {
    "siren_forward": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int]
    + [ctypes.c_longlong] * 3 + [ctypes.c_void_p],
    "siren_blocks": [ctypes.c_int] * 2,
}


def launch_blocks(n: int, m: int) -> int:
    """The thread blocks the CUDA kernel launches for n rows and m features."""
    return _lib().siren_blocks(n, m)


def _chains(x: torch.Tensor, W: torch.Tensor, b: torch.Tensor) -> bool:
    """x (..., k), W (k, m), b (m,); or E members: x (E, n, k), W (E, k, m),
    b (E, m)."""
    if W.ndim == 3:
        return (x.ndim == 3 and b.shape == (W.shape[0], W.shape[2]) and x.shape[0] == W.shape[0]
                and x.shape[2] == W.shape[1] >= 1)
    return (W.ndim == 2 and W.shape[0] >= 1 and b.shape == (W.shape[1],) and x.ndim >= 1
            and x.shape[-1] == W.shape[0])


def siren_layer_cuda(x: torch.Tensor, W: torch.Tensor, b: torch.Tensor,
                     omega: float = 30.0) -> torch.Tensor:
    """Launch the CUDA kernel on x (..., k), W (k, m), b (m,), or on E
    members at once (``_chains``; each member's x, W and b contiguous, the
    members at any stride, 0 included); counts one launch."""
    if not _chains(x, W, b):
        raise ValueError(f"siren_layer: shapes x {tuple(x.shape)}, W {tuple(W.shape)}, "
                         f"b {tuple(b.shape)} do not chain")
    members = W.shape[0] if W.ndim == 3 else 1
    for name, t in (("x", x), ("W", W), ("b", b)):
        _build.require_cuda_f32(f"siren_layer {name}", t[0] if members > 1 else t)
        if t.device != x.device:
            raise ValueError(f"siren_layer: {name} on {t.device}, x on {x.device}")
    k, m = W.shape[-2:]
    n = x.numel() // (k * members)
    out = torch.empty((*x.shape[:-1], m), dtype=torch.float32, device=x.device)
    sx, sW, sb = ((x.stride(0), W.stride(0), b.stride(0)) if members > 1 else (0, 0, 0))
    status = _lib().siren_forward(x.data_ptr(), W.data_ptr(), b.data_ptr(), out.data_ptr(),
                                  n, k, m, float(omega), members, sx, sW, sb,
                                  _build.stream_handle(x.device))
    _build.check(status, "siren_sm90_kernel")
    counts.add(siren_layer, "launches")
    return out


class _SirenFn(torch.autograd.Function):
    """sin(omega (x W + b)) with ``launch`` computing the primal."""

    @staticmethod
    def forward(x, W, b, omega: float, launch):
        return launch(x, W, b, omega)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, W, b, omega, _launch = inputs
        ctx.save_for_backward(x, W, b)
        ctx.save_for_forward(x, W, b)
        ctx.omega = omega

    @staticmethod
    def backward(ctx, g):
        x, W, b = ctx.saved_tensors
        om = ctx.omega
        g_pre = g * (om * torch.cos(om * (x @ W + _row(b, W))))
        gx = g_pre @ W.transpose(-1, -2) if ctx.needs_input_grad[0] else None
        if W.ndim == 3:  # members: x (E, n, k), g_pre (E, n, m)
            gW = x.transpose(1, 2) @ g_pre if ctx.needs_input_grad[1] else None
            gb = g_pre.sum(dim=1) if ctx.needs_input_grad[2] else None
            return gx, gW, gb, None, None
        g2 = g_pre.reshape(-1, W.shape[1])
        gW = x.reshape(-1, W.shape[0]).t() @ g2 if ctx.needs_input_grad[1] else None
        gb = g2.sum(dim=0) if ctx.needs_input_grad[2] else None
        return gx, gW, gb, None, None

    @staticmethod
    def jvp(ctx, dx, dW, db, _omega, _launch):
        level, (x, W, b, dx, dW, db) = _jvp.lower(*ctx.saved_tensors, dx, dW, db)
        om = ctx.omega
        with _jvp.forward_mode(level):
            pre = x @ W + _row(b, W)
            terms = [t for t in (None if dx is None else dx @ W,
                                 None if dW is None else x @ dW,
                                 None if db is None else _row(db, W)) if t is not None]
            dpre = terms[0]
            for t in terms[1:]:
                dpre = dpre + t
            return torch.cos(om * pre) * (om * dpre)

    @staticmethod
    def vmap(info, in_dims, x, W, b, omega, launch):
        x_bd, W_bd, b_bd = in_dims[:3]
        if W_bd is None and b_bd is None:
            # Rows are independent: fold the batch into x's rows, one call.
            xb = x.movedim(x_bd, 0)
            out = _SirenFn.apply(xb.reshape(-1, xb.shape[-1]), W, b, omega, launch)
            return out.reshape(*xb.shape[:-1], W.shape[1]), 0

        # A member axis on W or b: one call with the members on the kernel's
        # member axis (an unbatched operand is shared at member stride 0).
        E = info.batch_size

        def members(t, bd):
            return t.movedim(bd, 0) if bd is not None else t.expand(E, *t.shape)

        xb = members(x, x_bd)
        lead = xb.shape[1:-1]
        out = _SirenFn.apply(xb.reshape(E, -1, xb.shape[-1]), members(W, W_bd), members(b, b_bd),
                             omega, launch)
        return out.reshape(E, *lead, W.shape[-1]), 0


def siren_layer(x: torch.Tensor, W: torch.Tensor, b: torch.Tensor,
                omega: float = 30.0) -> torch.Tensor:
    """sin(omega (x @ W + b)) for x (..., k), W (k, m), b (m,): the CUDA
    kernel on CUDA tensors, the plain version on CPU tensors; anything else
    raises. No width gate: the JAX kernel's %128 gate is a TPU tiling fact;
    its dtype gate holds: CUDA tensors whose x or W is not float32 take the
    plain version."""
    if all(t.device.type == "cpu" for t in (x, W, b)):
        return siren_layer_plain(x, W, b, omega)
    if x.device.type == "cuda" and (x.dtype != torch.float32 or W.dtype != torch.float32):
        counts.add(siren_layer, "plain_f64")
        return siren_layer_plain(x, W, b, omega)
    if x.device.type == "cuda":
        return _SirenFn.apply(x, W, b, float(omega), siren_layer_cuda)
    raise ValueError(f"siren_layer: unsupported devices x={x.device}, W={W.device}, b={b.device}")


counts.register(siren_layer, "launches", "plain_f64")
