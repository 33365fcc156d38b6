"""Kernel 1's residual for any PDE: its ``residual_pointwise`` traced into a
straight-line program, run by a plain PyTorch twin or compiled into a CUDA
residual kernel.

The JAX kernel traces the PDE's own residual into its Pallas body (a vmap of
``residual_pointwise`` over one tile's points, its reverse pass the VJP of
that tile), so any registered PDE runs there. Here the residual is traced
once, when the kernel is attached:

- ``trace(pde, x_order, device)`` runs ``residual_pointwise`` under
  ``make_fx`` (fake tensors) on a ``BundleView`` of the stacked output
  streams U (S, n), [u; per axis u_x..; u_t], and the points z (n, d+1),
  and takes dr/dU by a vjp with a cotangent of ones. No JAX residual couples
  points (JAX vmaps one point at a time), so a reduction over the points
  left in the graph is the residual's own and is refused.
- The graph is lowered to a ``ResidualProgram``: per-point values, scalar
  constants (the coefficients, read once here: the JAX kernel bakes them at
  trace time too), z column reads and a fixed table of elementwise ops
  (``UNARY``, ``BINARY``, ``TERNARY``), with the ops autograd's reverse
  emits lowered into them (``tanh_backward``, ``sigmoid_backward``, ...).
  A comparison is a value of 0.0 or 1.0, and one select, ``where(c, a,
  b)``, carries every branch: the logical ops, ``masked_fill``, the clamp
  family, ``maximum``/``minimum``, ``relu`` and ``softplus`` are lowered to
  selects with torch's NaN rules (``maximum``, ``minimum``, ``clamp`` and
  ``relu`` propagate a NaN, ``fmax``/``fmin`` drop it), so the emitted code
  never calls ``fmaxf``/``fminf``, which drop it. In-place ops of
  autograd's reverse (``logical_and_``, ``masked_fill_``) are lowered as
  their functional twins. An op outside the table raises ``Unsupported``
  with its name, and kernel 1 is not attached for that PDE.
- ``ResidualProgram.evaluate`` runs the program with torch ops (float32 or
  float64), the plain twin's arithmetic (``fused_step._TorchOps.generated``
  adds the contract below); ``ResidualProgram.source`` emits the body of a
  CUDA kernel
  that ``csrc/residual_generated.cuh`` wraps, with the contract of the hand
  residual kernels of ``csrc/fused_residual.cu``: one thread per point,
  plain ``out = r^2, dU = (2/N) r dr/dU``, causal ``out = r, dU = dr/dU``.

What bounds the kernel: it reads U and z and writes dU and out once,
(2S + d + 2) N floats, a few MB at the trainer's batches, so its launch
sets its time; the design does nothing beyond one thread per point.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import operator
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pinnrl_tpu_torch.ops.kernels import counts

# Points in the trace: a prime larger than any stream or column count, so the
# point axis of every traced tensor is the one dimension of this size.
_TRACE_POINTS = 1009


class Unsupported(ValueError):
    """The residual does not lower into the op table (the reason says why)."""


# The op table: IR name -> (torch twin, CUDA C expression). Arguments are
# value names; constants are float literals.
UNARY = {
    "neg": (torch.neg, "-({0})"),
    "sin": (torch.sin, "sinf({0})"),
    "cos": (torch.cos, "cosf({0})"),
    "tan": (torch.tan, "tanf({0})"),
    "exp": (torch.exp, "expf({0})"),
    "expm1": (torch.expm1, "expm1f({0})"),
    "log": (torch.log, "logf({0})"),
    "log1p": (torch.log1p, "log1pf({0})"),
    "sqrt": (torch.sqrt, "sqrtf({0})"),
    "rsqrt": (torch.rsqrt, "rsqrtf({0})"),
    "reciprocal": (torch.reciprocal, "1.0f / {0}"),
    "tanh": (torch.tanh, "tanhf({0})"),
    "sigmoid": (torch.sigmoid, "1.0f / (1.0f + expf(-{0}))"),
    "sinh": (torch.sinh, "sinhf({0})"),
    "cosh": (torch.cosh, "coshf({0})"),
    "atan": (torch.atan, "atanf({0})"),
    "erf": (torch.erf, "erff({0})"),
    "abs": (torch.abs, "fabsf({0})"),
    "sign": (torch.sign, "(float)(({0} > 0.0f) - ({0} < 0.0f))"),
    "asinh": (torch.asinh, "asinhf({0})"),
    "log10": (torch.log10, "log10f({0})"),
    "erfc": (torch.erfc, "erfcf({0})"),
}
# A comparison is 1.0 where it holds and 0.0 elsewhere (a NaN compares
# false, except under ne), in the twin and on the card alike.
_COMPARISONS = {"gt": ">", "ge": ">=", "lt": "<", "le": "<=", "eq": "==", "ne": "!="}
BINARY = {
    "add": (operator.add, "{0} + {1}"),
    "sub": (operator.sub, "{0} - {1}"),
    "mul": (operator.mul, "{0} * {1}"),
    "div": (operator.truediv, "{0} / {1}"),
    "pow": (operator.pow, "powf({0}, {1})"),
    "atan2": (torch.atan2, "atan2f({0}, {1})"),
    **{name: (getattr(operator, name), f"({{0}} {sym} {{1}}) ? 1.0f : 0.0f")
       for name, sym in _COMPARISONS.items()},
}
# The select: b where c is 0, else a (a NaN c selects a, as torch.where(c != 0) does).
TERNARY = {
    "where": (lambda c, a, b: torch.where(c != 0, a, b), "({0} != 0.0f) ? {1} : {2}"),
}
_TABLE = {**UNARY, **BINARY, **TERNARY}
# Ops whose twin takes a Python float as it is: torch's scalar paths (x * c,
# x ** 2) are the traced residual's own. Every other op's constants become
# 0-d tensors of the program's dtype.
_SCALAR_TWINS = {"add", "sub", "mul", "div", "pow"}
_FOLD = {
    "neg": lambda a: -a, "sin": math.sin, "cos": math.cos, "tan": math.tan, "exp": math.exp,
    "expm1": math.expm1, "log": math.log, "log1p": math.log1p, "sqrt": math.sqrt,
    "rsqrt": lambda a: 1.0 / math.sqrt(a),
    "reciprocal": lambda a: 1.0 / a, "tanh": math.tanh, "sigmoid": lambda a: 1.0 / (1.0 + math.exp(-a)),
    "sinh": math.sinh, "cosh": math.cosh, "atan": math.atan, "erf": math.erf, "abs": abs,
    "sign": lambda a: float((a > 0) - (a < 0)),
    "add": lambda a, b: a + b, "sub": lambda a, b: a - b, "mul": lambda a, b: a * b,
    "div": lambda a, b: a / b, "pow": lambda a, b: a**b,
    "asinh": math.asinh, "log10": math.log10, "erfc": math.erfc, "atan2": math.atan2,
    **{name: (lambda f: lambda a, b: float(f(a, b)))(getattr(operator, name)) for name in _COMPARISONS},
    "where": lambda c, a, b: a if c != 0 else b,
}


@dataclass(frozen=True)
class ResidualProgram:
    """A residual and its per-stream derivative as straight-line code.

    ``instrs[k]`` defines value k: ``("u", s)`` stream s of U, ``("z", j)``
    column j of z, ``("const", x)``, or ``(op, a[, b[, c]])`` with a, b, c
    earlier values and op in ``UNARY``, ``BINARY`` or ``TERNARY``. ``r`` is
    the residual's value, ``g[s]`` that of dr/dU_s."""

    n_streams: int
    n_cols: int
    instrs: Tuple[tuple, ...]
    r: int
    g: Tuple[int, ...]
    origin: str  # the traced function, for the emitted source's header

    @property
    def ops(self) -> List[str]:
        """The table ops the program uses, in first use."""
        seen: Dict[str, None] = {}
        for ins in self.instrs:
            if ins[0] not in ("u", "z", "const"):
                seen.setdefault(ins[0])
        return list(seen)

    # ------------------------------------------------------------ twin --

    def evaluate(self, U: torch.Tensor, z: torch.Tensor, n: int):
        """(r (n,), [dr/dU_s (n,) per stream]) from the stacked streams U
        (S n or (S, n)) and the points z (n, d+1), with torch ops in U's dtype."""
        rows = U.reshape(self.n_streams, n)
        vals: List[object] = []

        def tensor(v):  # a fill, not a host copy: the twin runs inside CUDA graphs too
            return v if isinstance(v, torch.Tensor) else torch.full((), v, dtype=U.dtype,
                                                                      device=U.device)
        for ins in self.instrs:
            op = ins[0]
            if op == "u":
                vals.append(rows[ins[1]])
            elif op == "z":
                vals.append(z[:, ins[1]].to(U.dtype))
            elif op == "const":
                vals.append(ins[1])
            else:
                args = [vals[a] for a in ins[1:]]
                scalar = op in _SCALAR_TWINS and any(isinstance(a, torch.Tensor) for a in args)
                v = _TABLE[op][0](*(args if scalar else map(tensor, args)))
                vals.append(v.to(U.dtype) if v.dtype == torch.bool else v)

        def field_of(k):
            v = vals[k]
            if isinstance(v, torch.Tensor) and v.dim():
                return v
            return torch.full((n,), float(v), dtype=U.dtype, device=U.device)
        return field_of(self.r), [field_of(k) for k in self.g]

    # ---------------------------------------------------------- emitter --

    @functools.cached_property
    def source(self) -> str:
        """The emitted CUDA translation unit: ``gen_residual`` for one point,
        then ``csrc/residual_generated.cuh``'s kernel and C entry point."""
        names: Dict[int, str] = {}
        lines = []
        live = self._live()
        for k, ins in enumerate(self.instrs):
            if k not in live:
                continue
            op = ins[0]
            if op == "const":
                names[k] = _literal(ins[1])
                continue
            names[k] = f"v{k}"
            if op == "u":
                expr = f"U[{ins[1]}LL * n + i]"
            elif op == "z":
                expr = f"z[(long long)i * GEN_COLS + {ins[1]}]"
            else:
                expr = _TABLE[op][1].format(*(names[a] for a in ins[1:]))
            lines.append(f"    const float v{k} = {expr};")
        lines += [f"    g[{s}] = {names[k]};" for s, k in enumerate(self.g)]
        lines.append(f"    return {names[self.r]};")
        return "\n".join([
            f"// Generated from {self.origin} by pinnrl_tpu_torch/ops/kernels/residual_codegen.py.",
            f"// Streams [u; per axis u_x..; u_t]: {self.n_streams}; z columns: {self.n_cols}.",
            f"#define GEN_STREAMS {self.n_streams}",
            f"#define GEN_COLS {self.n_cols}",
            "",
            "// r at point i; g[s] = dr/dU_s.",
            "__device__ __forceinline__ float gen_residual(const float* __restrict__ U,",
            "                                              const float* __restrict__ z, int n,",
            "                                              int i, float* __restrict__ g) {",
            *lines,
            "}",
            "",
            '#include "residual_generated.cuh"',
            "",
        ])

    @functools.cached_property
    def digest(self) -> str:
        return hashlib.sha256(self.source.encode()).hexdigest()[:16]

    def _live(self) -> set:
        live, stack = set(), [self.r, *self.g]
        while stack:
            k = stack.pop()
            if k in live:
                continue
            live.add(k)
            ins = self.instrs[k]
            if ins[0] in _TABLE:
                stack.extend(ins[1:])
        return live


def _literal(x: float) -> str:
    """A float literal that the compiler rounds to float32(x)."""
    v = float(np.float32(x))
    if not math.isfinite(v):
        raise Unsupported(f"the residual has a constant {x!r} that is not finite in float32")
    text = repr(v)
    text = f"{text}f" if ("." in text or "e" in text) else f"{text}.0f"
    return f"({text})" if v < 0 else text


# --------------------------------------------------------------------------- #
# The CUDA kernel
# --------------------------------------------------------------------------- #

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_LIBRARIES: Dict[str, Tuple[str, ctypes.CDLL]] = {}


def library(program: ResidualProgram) -> Tuple[str, ctypes.CDLL]:
    """(name, library) of the program's kernel, built by nvcc at first use
    (``_build.load_generated``; a failed build raises with nvcc's output)."""
    from pinnrl_tpu_torch.ops.kernels import _build

    bound = _LIBRARIES.get(program.digest)
    if bound is None:
        name = f"gen_residual_{program.digest}"
        lib = _build.load_generated(name, program.source)
        lib.gr_residual.argtypes = _ARGTYPES
        lib.gr_residual.restype = ctypes.c_int
        bound = _LIBRARIES[program.digest] = (name, lib)
    return bound


def launch(program: ResidualProgram, U: torch.Tensor, z: torch.Tensor, n: int, causal: bool,
           members: int = 1):
    """The generated kernel on torch's current stream: (dU (S n, 1), out
    (n, 1)) as its plain twin ``fused_step._TorchOps.generated``, for
    ``members`` stacked members in one launch (U (members S n, 1), z
    (members, n, d+1); out (members n, 1)). Counts one launch."""
    from pinnrl_tpu_torch.ops.kernels import _build

    for what, t in (("U", U), ("z", z)):
        _build.require_cuda_f32(f"generated residual {what}", t)
    if (U.numel() != members * program.n_streams * n
            or z.numel() != members * n * program.n_cols or z.shape[-1] != program.n_cols):
        raise ValueError(f"generated residual: U {tuple(U.shape)} and z {tuple(z.shape)} do not "
                         f"match {members} x {program.n_streams} streams and {program.n_cols} "
                         f"columns")
    name, lib = library(program)
    dU = torch.empty_like(U)
    out = torch.empty((members * n, 1), dtype=torch.float32, device=U.device)
    _build.check(lib.gr_residual(U.data_ptr(), z.data_ptr(), dU.data_ptr(), out.data_ptr(), n,
                                 int(causal), members, _build.stream_handle(U.device)), name)
    counts.add(launch, "launches")
    return dU, out


counts.register(launch, "launches")


# --------------------------------------------------------------------------- #
# Lowering
# --------------------------------------------------------------------------- #


class _SSA:
    """SSA values with common-subexpression reuse, constant folding and the
    identities that are exact in floating point (x + 0, x * 1, x / 1, x^1)."""

    def __init__(self) -> None:
        self.instrs: List[tuple] = []
        self._index: Dict[tuple, int] = {}

    def _add(self, ins: tuple) -> int:
        k = self._index.get(ins)
        if k is None:
            k = self._index[ins] = len(self.instrs)
            self.instrs.append(ins)
        return k

    def const(self, x) -> int:
        return self._add(("const", float(x)))

    def value(self, kind: str, j: int) -> int:
        return self._add((kind, int(j)))

    def _cval(self, k: int) -> Optional[float]:
        ins = self.instrs[k]
        return ins[1] if ins[0] == "const" else None

    def is_bool(self, k: int) -> bool:
        """Whether value k is 0.0 or 1.0 at every point."""
        ins = self.instrs[k]
        if ins[0] in _COMPARISONS:
            return True
        if ins[0] == "const":
            return ins[1] in (0.0, 1.0)
        if ins[0] in ("where", "mul"):
            return all(self.is_bool(a) for a in ins[-2:])
        return False

    def truth(self, k: int) -> int:
        """Value k as 0/1: 1.0 where it is nonzero (a NaN included), as
        torch's logical ops read a float."""
        return k if self.is_bool(k) else self.op("ne", k, self.const(0.0))

    def op(self, name: str, *args: int) -> int:
        consts = [self._cval(a) for a in args]
        if name == "where":
            c, a, b = args
            if consts[0] is not None:
                return a if consts[0] != 0 else b
            if a == b:
                return a
            if consts[1] == 1.0 and consts[2] == 0.0 and self.is_bool(c):
                return c
        if name == "ne" and consts[1] == 0.0 and self.is_bool(args[0]):
            return args[0]
        if all(c is not None for c in consts):
            try:
                return self.const(_FOLD[name](*consts))
            except (ValueError, ZeroDivisionError, OverflowError):
                pass  # left to the device, as the traced code would compute it
        if len(args) != 2:
            if name == "neg" and self.instrs[args[0]][0] == "neg":
                return self.instrs[args[0]][1]
            return self._add((name, *args))
        if name in ("add", "sub") and consts[1] == 0.0:
            return args[0]
        if name == "add" and consts[0] == 0.0:
            return args[1]
        if name == "sub" and consts[0] == 0.0:
            return self.op("neg", args[1])
        if name == "mul" and consts[1] == 1.0:
            return args[0]
        if name == "mul" and consts[0] == 1.0:
            return args[1]
        if name == "mul" and consts[1] == -1.0:
            return self.op("neg", args[0])
        if name == "mul" and consts[0] == -1.0:
            return self.op("neg", args[1])
        if name == "div" and consts[1] == 1.0:
            return args[0]
        if name == "pow" and consts[1] is not None:
            return self._pow(args[0], consts[1])
        return self._add((name, *args))

    def _pow(self, a: int, p: float) -> int:
        if p == 0.0:
            return self.const(1.0)
        if p == 1.0:
            return a
        if p == 2.0:
            return self.op("mul", a, a)
        if p == 3.0:
            return self.op("mul", self.op("mul", a, a), a)
        if p == 0.5:
            return self.op("sqrt", a)
        if p == -0.5:
            return self.op("rsqrt", a)
        if p == -1.0:
            return self.op("reciprocal", a)
        if p == -2.0:
            return self.op("reciprocal", self.op("mul", a, a))
        return self._add(("pow", a, self.const(p)))


class _Val:
    """A traced tensor as an object array of SSA values: the tensor's shape
    with its point axis (``paxis``, None for a value uniform over points)
    collapsed to 1."""

    def __init__(self, arr: np.ndarray, paxis: Optional[int]):
        self.arr = arr
        self.paxis = paxis


def _point_axis(shape: Sequence[int], what: str) -> Optional[int]:
    axes = [i for i, s in enumerate(shape) if s == _TRACE_POINTS]
    if len(axes) > 1:
        raise Unsupported(f"{what} pairs every point with every other point (shape "
                          f"{tuple(shape)}); the residual must map each point to its own value")
    return axes[0] if axes else None


def _collapsed(shape: Sequence[int], paxis: Optional[int]) -> Tuple[int, ...]:
    return tuple(1 if i == paxis else int(s) for i, s in enumerate(shape))


def _meta_shape(node) -> Tuple[int, ...]:
    """The node's shape; raises unless it is a float tensor, or a bool one
    from an op that makes or carries 0/1 values (``_BOOL_OK``)."""
    val = node.meta.get("val")
    if not isinstance(val, torch.Tensor):
        raise Unsupported(f"{node.target}: no tensor metadata")
    if not (val.dtype.is_floating_point
            or (val.dtype == torch.bool and _functional(_op_name(node)) in _BOOL_OK)):
        raise Unsupported(f"{_op_name(node)} makes a {val.dtype} tensor")
    return tuple(int(s) for s in val.shape)


def _functional(name: str) -> str:
    """The functional twin of an in-place op's name (``_INPLACE``)."""
    if name not in _INPLACE:
        return name
    packet, overload = name.split(".")
    return f"{packet[:-1]}.{overload}"


def _op_name(node) -> str:
    t = node.target
    packet = getattr(t, "_overloadpacket", None)
    if packet is None:
        return getattr(t, "__name__", str(t))
    return f"{packet.__name__}.{t._overloadname}"


_VIEWS = {"view.default", "reshape.default", "_unsafe_view.default", "squeeze.default",
          "squeeze.dim", "squeeze.dims", "unsqueeze.default", "expand.default",
          "expand_copy.default", "view_copy.default"}
_SAME = {"detach.default", "alias.default", "clone.default", "lift_fresh_copy.default",
         "_to_copy.default", "to.dtype", "contiguous.default", "positive.default"}
_FILLS = {"zeros_like.default": 0.0, "ones_like.default": 1.0, "zeros.default": 0.0,
          "ones.default": 1.0, "new_zeros.default": 0.0, "new_ones.default": 1.0}
_ELEMENTWISE_1 = {f"{k}.default": k for k in UNARY}
_ELEMENTWISE_1.update({"sgn.default": "sign", "square.default": "square"})


# Per-point lowerings onto the table, each (b: _SSA, operand values...) ->
# value.
def _extremum(larger: bool, nan_wins: bool):
    """torch's maximum/minimum (nan_wins: NaN if either operand is NaN) or
    fmax/fmin (the other operand where one is NaN), else (x < y) ? y : x
    for the larger and (y < x) ? y : x for the smaller. A constant
    operand's NaN test folds away."""

    def fn(b, x, y):
        pick = b.op("where", b.op("lt", x, y) if larger else b.op("lt", y, x), y, x)
        x_nan, y_nan = b.op("ne", x, x), b.op("ne", y, y)
        if nan_wins:
            return b.op("where", y_nan, y, b.op("where", x_nan, x, pick))
        return b.op("where", y_nan, x, b.op("where", x_nan, y, pick))

    return fn


_maximum, _minimum = _extremum(True, True), _extremum(False, True)


def _softplus(b, x, beta=None, threshold=None):
    """torch's: x where beta x > threshold, else log1p(exp(beta x)) / beta
    (make_fx leaves out beta = 1 and threshold = 20)."""
    beta = b.const(1.0) if beta is None else beta
    threshold = b.const(20.0) if threshold is None else threshold
    bx = b.op("mul", x, beta)
    return b.op("where", b.op("gt", bx, threshold), x,
                b.op("div", b.op("log1p", b.op("exp", bx)), beta))


def _softplus_backward(b, grad, x, beta, threshold):
    """torch's: grad where beta x > threshold, else grad e / (e + 1), e = exp(beta x)."""
    bx = b.op("mul", x, beta)
    e = b.op("exp", bx)
    return b.op("where", b.op("gt", bx, threshold), grad,
                b.op("div", b.op("mul", grad, e), b.op("add", e, b.const(1.0))))


# torch's logical ops read a float as true where it is nonzero (NaN included).
_LOGICAL = {"and": lambda b, x, y: b.op("mul", b.truth(x), b.truth(y)),
            "or": lambda b, x, y: b.op("where", x, b.const(1.0), b.truth(y)),
            "xor": lambda b, x, y: b.op("ne", b.truth(x), b.truth(y))}


_POINTWISE = {
    **{f"{c}.{k}": (lambda c: lambda b, x, y: b.op(c, x, y))(c)
       for c in _COMPARISONS for k in ("Scalar", "Tensor")},
    "logical_not.default": lambda b, x: b.op("eq", x, b.const(0.0)),
    "bitwise_not.default": lambda b, x: b.op("eq", x, b.const(0.0)),
    **{f"{pre}_{kind}.{k}": fn for kind, fn in _LOGICAL.items()
       for pre, k in (("logical", "default"), ("bitwise", "Tensor"), ("bitwise", "Scalar"))},
    "isnan.default": lambda b, x: b.op("ne", x, x),
    **{f"where.{k}": lambda b, c, x, y: b.op("where", c, x, y)
       for k in ("self", "ScalarSelf", "ScalarOther", "Scalar")},
    **{f"masked_fill.{k}": lambda b, x, m, v: b.op("where", m, v, x) for k in ("Scalar", "Tensor")},
    "maximum.default": _maximum, "minimum.default": _minimum,
    "fmax.default": _extremum(True, False), "fmin.default": _extremum(False, False),
    "clamp_min.default": _maximum, "clamp_min.Tensor": _maximum,
    "clamp_max.default": _minimum, "clamp_max.Tensor": _minimum,
    "relu.default": lambda b, x: _maximum(b, x, b.const(0.0)),
    "threshold_backward.default": lambda b, grad, x, threshold: b.op(
        "where", b.op("le", x, threshold), b.const(0.0), grad),
    "atan2.default": lambda b, y, x: b.op("atan2", y, x),
    "softplus.default": _softplus,
    "softplus_backward.default": _softplus_backward,
}
# In-place ops of autograd's reverse: lowered as their functional twins, the
# result bound to the mutated operand's node too.
_INPLACE = {"logical_and_.default", "logical_or_.default", "logical_xor_.default",
            "logical_not_.default", "masked_fill_.Scalar", "masked_fill_.Tensor"}
# Ops whose reads share the operand's storage: an in-place op on such a
# tensor would reach values this lowering keeps apart.
_ALIASING = _VIEWS | {"detach.default", "alias.default", "select.int", "slice.Tensor",
                      "unbind.int", "permute.default", "transpose.int", "t.default"}
# Ops that may make a bool tensor: each makes or carries 0/1 values.
_BOOL_OK = {name for name in _POINTWISE if name.split(".")[0] in (
    *_COMPARISONS, "logical_not", "logical_and", "logical_or", "logical_xor", "bitwise_not",
    "bitwise_and", "bitwise_or", "bitwise_xor", "isnan", "where", "masked_fill")} | {
    *_VIEWS, *_SAME, *_FILLS, "unbind.int", "unbind_copy.int", "select.int", "select_copy.int",
    "slice.Tensor", "slice_copy.Tensor", "stack.default", "cat.default", "permute.default",
    "transpose.int", "t.default", "full_like.default", "full.default", "new_full.default"}


def _lower(gm, n_streams: int, n_cols: int) -> Tuple[_SSA, _Val, _Val]:
    b = _SSA()
    env: Dict[object, object] = {}
    placeholders = [nd for nd in gm.graph.nodes if nd.op == "placeholder"]
    env[placeholders[0]] = _Val(np.array([[b.value("u", s)] for s in range(n_streams)], object), 1)
    env[placeholders[1]] = _Val(np.array([[b.value("z", j) for j in range(n_cols)]], object), 0)

    def arg(a):
        if isinstance(a, (list, tuple)):
            return [arg(x) for x in a]
        if hasattr(a, "op") and hasattr(a, "target"):
            return env[a]
        return a

    def as_val(x):
        """A tensor operand, or a Python scalar broadcast as a constant."""
        if isinstance(x, _Val):
            return x
        if isinstance(x, (bool, int, float)):
            return _Val(np.array(b.const(x), object), None)
        raise Unsupported(f"an operand of type {type(x).__name__}")

    def elementwise(node, name, operands):
        """``name`` (a table op, or a per-point lowering ``fn(b, *values)``)
        over the broadcast operands; a bool result is made 0/1."""
        fn = name if callable(name) else (lambda _b, *a: b.op(name, *a))
        shape = _meta_shape(node)
        boolean = node.meta["val"].dtype == torch.bool
        paxis = _point_axis(shape, _op_name(node))
        out_shape = _collapsed(shape, paxis)
        vals = [as_val(x) for x in operands]
        try:
            arrs = np.broadcast_arrays(*[v.arr for v in vals])
            arrs = [np.broadcast_to(a, out_shape) for a in arrs]
        except ValueError as e:
            raise Unsupported(f"{_op_name(node)}: operands do not broadcast ({e})") from None
        out = np.empty(out_shape, object)
        for idx in np.ndindex(*out_shape):
            v = fn(b, *[a[idx] for a in arrs])
            out[idx] = b.truth(v) if boolean else v
        return _Val(out, paxis)

    def fill(node, value):
        """A tensor of one value, rounded to the node's dtype (a float32
        ``scalar_tensor`` of a Python float in a float64 trace)."""
        shape = _meta_shape(node)
        paxis = _point_axis(shape, _op_name(node))
        value = float(torch.tensor(float(value), dtype=node.meta["val"].dtype))
        return _Val(np.full(_collapsed(shape, paxis), b.const(value), object), paxis)

    def reshaped(node, x: _Val):
        """view / reshape / squeeze / unsqueeze / expand to the node's shape."""
        shape = _meta_shape(node)
        paxis = _point_axis(shape, _op_name(node))
        if x.paxis is not None:
            if paxis is None:
                raise Unsupported(f"{_op_name(node)} folds the point axis into another")
            if int(np.prod(x.arr.shape[:x.paxis])) != int(np.prod(shape[:paxis])):
                raise Unsupported(f"{_op_name(node)} moves values across points")
        target = _collapsed(shape, paxis)
        if x.arr.size == int(np.prod(target)):
            return _Val(x.arr.reshape(target), paxis)
        try:
            return _Val(np.broadcast_to(x.arr, target).copy(), paxis)  # expand
        except ValueError:
            raise Unsupported(f"{_op_name(node)} to {tuple(shape)}") from None

    for node in gm.graph.nodes:
        if node.op == "placeholder":
            continue
        if node.op == "output":
            r, g = node.args[0]
            return b, env[r], env[g]
        if node.op == "get_attr":
            t = getattr(gm, node.target)
            arr = t.detach().cpu().double().numpy()
            if arr.ndim and _TRACE_POINTS in arr.shape:
                raise Unsupported("a constant tensor the size of the batch")
            env[node] = _Val(np.vectorize(b.const, otypes=[object])(arr) if arr.ndim
                             else np.array(b.const(float(arr)), object), None)
            continue
        if node.op != "call_function":
            raise Unsupported(f"a graph node of kind {node.op}")
        name = _op_name(node)
        mutated = node.args[0] if name in _INPLACE else None
        if mutated is not None:
            _check_unaliased(mutated, node)
            name = _functional(name)
        args = arg(list(node.args))
        kw = node.kwargs
        if name == "getitem":
            env[node] = args[0][args[1]]
        elif name in ("_to_copy.default", "to.dtype"):  # a cast to bool makes 0/1 values
            _meta_shape(node)
            env[node] = (elementwise(node, "ne", [args[0], 0.0])
                         if node.meta["val"].dtype == torch.bool else args[0])
        elif name in _SAME:
            env[node] = args[0]
        elif name in _VIEWS:
            env[node] = reshaped(node, args[0])
        elif name in ("unbind.int", "unbind_copy.int"):
            x, dim = args[0], (args[1] if len(args) > 1 else 0) % args[0].arr.ndim
            if dim == x.paxis:
                raise Unsupported(f"{name} splits the points")
            pax = None if x.paxis is None else x.paxis - (x.paxis > dim)
            env[node] = [_Val(np.take(x.arr, i, axis=dim), pax) for i in range(x.arr.shape[dim])]
        elif name in ("select.int", "select_copy.int"):
            x, dim, idx = args[0], args[1] % args[0].arr.ndim, args[2]
            if dim == x.paxis:
                raise Unsupported(f"{name} reads one point's value at the others")
            pax = None if x.paxis is None else x.paxis - (x.paxis > dim)
            env[node] = _Val(np.take(x.arr, idx, axis=dim), pax)
        elif name in ("slice.Tensor", "slice_copy.Tensor"):
            x = args[0]
            dim = (args[1] if len(args) > 1 else 0) % x.arr.ndim
            start = args[2] if len(args) > 2 else None
            end = args[3] if len(args) > 3 else None
            step = args[4] if len(args) > 4 else 1
            if dim == x.paxis:
                if (start or 0) != 0 or step != 1 or (end is not None and end < _TRACE_POINTS):
                    raise Unsupported(f"{name} takes some of the points")
                env[node] = x
            else:
                sl = [slice(None)] * x.arr.ndim
                sl[dim] = slice(start, end, step)
                env[node] = _Val(x.arr[tuple(sl)], x.paxis)
        elif name in ("stack.default", "cat.default"):
            parts = args[0]
            dim = args[1] if len(args) > 1 else kw.get("dim", 0)
            shape = _meta_shape(node)
            paxis = _point_axis(shape, name)
            ndim = len(shape)
            if name == "stack.default":
                dim %= ndim
                in_shape = shape[:dim] + shape[dim + 1:]
                target = _collapsed(in_shape, _point_axis(in_shape, name))
                env[node] = _Val(np.stack([np.broadcast_to(p.arr, target) for p in parts],
                                          axis=dim), paxis)
            else:
                dim %= ndim
                if dim == paxis:
                    raise Unsupported("cat.default joins points")
                env[node] = _Val(np.concatenate([p.arr for p in parts], axis=dim), paxis)
        elif name in ("permute.default", "transpose.int", "t.default"):
            x = args[0]
            nd = x.arr.ndim
            if name == "permute.default":
                perm = [p % nd for p in args[1]]
            elif name == "t.default":
                perm = list(range(nd))[::-1]
            else:
                perm = list(range(nd))
                i, j = args[1] % nd, args[2] % nd
                perm[i], perm[j] = perm[j], perm[i]
            shape = _meta_shape(node)
            env[node] = _Val(np.transpose(x.arr, perm), _point_axis(shape, name))
        elif name in _FILLS:
            env[node] = fill(node, _FILLS[name])
        elif name in ("full_like.default", "full.default"):
            env[node] = fill(node, args[1])
        elif name == "new_full.default":
            env[node] = fill(node, args[2])
        elif name == "scalar_tensor.default":
            env[node] = fill(node, args[0])
        elif name in ("sum.dim_IntList", "sum.default", "mean.dim", "mean.default"):
            env[node] = _reduce(b, node, name, args)
        elif name in _ELEMENTWISE_1:
            op = _ELEMENTWISE_1[name]
            if op == "square":
                env[node] = elementwise(node, "mul", [args[0], args[0]])
            else:
                env[node] = elementwise(node, op, args[:1])
        elif name in ("add.Tensor", "add.Scalar", "sub.Tensor", "sub.Scalar"):
            x, y = args[0], args[1]
            alpha = kw.get("alpha", args[2] if len(args) > 2 else 1)
            if alpha != 1:
                y = elementwise(node, "mul", [y, float(alpha)])
            env[node] = elementwise(node, name.split(".")[0], [x, y])
        elif name in ("rsub.Scalar", "rsub.Tensor"):
            alpha = kw.get("alpha", 1)
            x = args[0] if alpha == 1 else elementwise(node, "mul", [args[0], float(alpha)])
            env[node] = elementwise(node, "sub", [args[1], x])
        elif name in ("mul.Tensor", "mul.Scalar", "div.Tensor", "div.Scalar"):
            if kw.get("rounding_mode") is not None:
                raise Unsupported(f"{name} with rounding_mode={kw['rounding_mode']!r}")
            env[node] = elementwise(node, name.split(".")[0], args[:2])
        elif name in ("pow.Tensor_Scalar", "pow.Scalar", "pow.Tensor_Tensor"):
            env[node] = elementwise(node, "pow", args[:2])
        elif name == "tanh_backward.default":  # grad (1 - y^2)
            grad, y = args[0], args[1]
            one_minus = elementwise(node, "sub", [1.0, elementwise(node, "mul", [y, y])])
            env[node] = elementwise(node, "mul", [grad, one_minus])
        elif name == "sigmoid_backward.default":  # grad y (1 - y)
            grad, y = args[0], args[1]
            dy = elementwise(node, "mul", [y, elementwise(node, "sub", [1.0, y])])
            env[node] = elementwise(node, "mul", [grad, dy])
        elif name in ("clamp.default", "clamp.Tensor"):  # minimum(maximum(x, lo), hi)
            lo, hi = (args + [None, None])[1:3]
            lo, hi = kw.get("min", lo), kw.get("max", hi)
            if lo is None and hi is None:
                raise Unsupported(f"{name} with neither bound")
            x = args[0]
            if lo is not None:
                x = elementwise(node, _maximum, [x, lo])
            env[node] = x if hi is None else elementwise(node, _minimum, [x, hi])
        elif name in _POINTWISE:
            env[node] = elementwise(node, _POINTWISE[name], args)
        else:
            raise Unsupported(f"the op {name} is not in kernel 1's residual op table")
        if mutated is not None:
            env[mutated] = env[node]
    raise Unsupported("the traced graph has no output")


def _check_unaliased(mutated, node) -> None:
    """Refuse an in-place op on a graph input or on a tensor that shares its
    storage with another node: the lowering binds the new value to the
    mutated node alone."""
    sharing = [n for n in mutated.users if n is not node and _op_name(n) in _ALIASING]
    if (mutated.op != "call_function" or _op_name(mutated) in _ALIASING or sharing):
        raise Unsupported(f"{_op_name(node)} writes into a tensor that shares its storage")


def _reduce(b: _SSA, node, name: str, args) -> _Val:
    x = args[0]
    nd = x.arr.ndim
    dims = list(range(nd)) if len(args) < 2 or args[1] is None else [d % nd for d in (
        args[1] if isinstance(args[1], (list, tuple)) else [args[1]])]
    if not dims:
        dims = list(range(nd))
    if x.paxis is not None and x.paxis in dims:
        raise Unsupported(f"{name} sums over the points: the residual couples points")
    keep = bool(args[2]) if len(args) > 2 else bool(node.kwargs.get("keepdim", False))
    arr = x.arr
    count = 1
    for d in sorted(dims, reverse=True):
        count *= arr.shape[d]
        parts = [np.take(arr, i, axis=d) for i in range(arr.shape[d])]
        acc = parts[0]
        for p in parts[1:]:
            acc = np.vectorize(lambda a, c: b.op("add", a, c), otypes=[object])(acc, p)
        arr = np.expand_dims(acc, d) if keep else acc
    if name.startswith("mean"):
        arr = np.vectorize(lambda a: b.op("div", a, b.const(count)), otypes=[object])(arr)
    arr = np.asarray(arr, object)
    paxis = _point_axis(_meta_shape(node), name)
    return _Val(arr.reshape(_collapsed(_meta_shape(node), paxis)), paxis)


# --------------------------------------------------------------------------- #
# Tracing
# --------------------------------------------------------------------------- #


def _stream_layout(pde, x_order: int) -> Tuple[int, Dict[int, List[int]]]:
    """(S, {axis: stream indices}) of the stacked output [u; per axis
    u_x..u_x^K; u_t]. With K = 0 (an ODE) there is no x-group; the t-stream
    is always computed, and a PDE with no time derivative (temporal order 0)
    is shown no t-axis, as the JAX bundle builds none for it."""
    d = pde.dimension
    streams = {ax: [1 + ax * x_order + k for k in range(x_order)] for ax in range(d)} if x_order else {}
    if max(pde.temporal_orders, default=0) >= 1:
        streams[d] = [1 + d * x_order]
    return 2 + d * x_order, streams


def trace(pde, x_order: int, device=None) -> ResidualProgram:
    """Trace ``pde.residual_pointwise`` and its dr/dU into a program; raises
    ``Unsupported`` with the reason where it does not lower."""
    origin = f"{type(pde).__module__}.{type(pde).__qualname__}.residual_pointwise"
    try:
        return _program(*_graph(pde, x_order, device), origin)
    except Unsupported:
        raise
    except Exception as e:  # noqa: BLE001 — any failure to trace or lower is a refusal
        raise Unsupported(f"{origin} does not trace: {type(e).__name__}: {e}") from None


def _graph(pde, x_order: int, device=None):
    """(graph, S, d + 1): ``fn(U, z) -> (r, dr/dU)`` traced by ``make_fx``
    on fake float64 tensors of ``_TRACE_POINTS`` points."""
    from torch.fx.experimental.proxy_tensor import make_fx

    from pinnrl_tpu_torch.ops.jet_mlp import BundleView

    n_streams, layout = _stream_layout(pde, x_order)
    n_cols = pde.dimension + 1
    if max(n_streams, n_cols) >= _TRACE_POINTS:
        raise Unsupported(f"{n_streams} streams: more than the trace tells apart from points")

    def fn(U, z):
        U = U.detach().requires_grad_(True)
        with torch.enable_grad():
            rows = U.unbind(0)
            view = BundleView(rows[0], {ax: [rows[s] for s in idx] for ax, idx in layout.items()})
            r = pde.residual_pointwise(view, z, None)
            if not isinstance(r, torch.Tensor) or r.numel() != z.shape[0]:
                raise Unsupported(f"the residual has shape {tuple(getattr(r, 'shape', ()))}, "
                                  f"not one value per point")
            r = r.reshape(-1)
            if not r.requires_grad:
                raise Unsupported("the residual does not read the network's output")
            (g,) = torch.autograd.grad(r, U, grad_outputs=torch.ones_like(r))
        return r.detach(), g

    dev = torch.device(device) if device is not None else torch.device("cpu")
    gm = make_fx(fn, tracing_mode="fake")(
        torch.zeros(n_streams, _TRACE_POINTS, dtype=torch.float64, device=dev),
        torch.zeros(_TRACE_POINTS, n_cols, dtype=torch.float64, device=dev))
    return gm, n_streams, n_cols


def _program(gm, n_streams: int, n_cols: int, origin: str) -> ResidualProgram:
    """The program of a traced graph (``_graph``)."""
    b, r, g = _lower(gm, n_streams, n_cols)
    if r.paxis is None or r.arr.size != 1 or g.arr.shape[0] != n_streams:
        raise Unsupported("the traced residual is not one value per point")
    return ResidualProgram(n_streams=n_streams, n_cols=n_cols, instrs=tuple(b.instrs),
                           r=int(r.arr.reshape(-1)[0]),
                           g=tuple(int(v) for v in g.arr.reshape(n_streams)), origin=origin)
