"""Fourier-feature op: the port's plain version (what the wrapper runs on
CPU tensors) against pinnrl_tpu's fourier_features, primal and gradient.

Tolerance 1e-5 relative to max: f32, phases up to tens of radians, where
one ulp of the phase is ~4e-6.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_helpers import rel_to_max

from pinnrl_tpu.ops.kernels.fourier_feats import fourier_features as jax_ff
from pinnrl_tpu_torch.ops.kernels.fourier_feats import fourier_features

TOL = 1e-5


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("d", [1, 2, 3])
def test_primal_and_gradient_match_jax(periodic, d):
    rng = np.random.default_rng(d)
    x = (2.0 * rng.random((64, d)) - 1.0).astype(np.float32)
    B = (2.0 * rng.standard_normal((d, 16))).astype(np.float32)
    g = rng.standard_normal((64, 32)).astype(np.float32)

    out_j, vjp = jax.vjp(lambda a, b: jax_ff(a, b, periodic), jnp.asarray(x), jnp.asarray(B))
    gx_j, gB_j = vjp(jnp.asarray(g))

    xt = torch.from_numpy(x).requires_grad_(True)
    Bt = torch.from_numpy(B).requires_grad_(True)
    out_t = fourier_features(xt, Bt, periodic)
    gx_t, gB_t = torch.autograd.grad(out_t, (xt, Bt), torch.from_numpy(g))

    assert rel_to_max(out_t, out_j) < TOL
    assert rel_to_max(gx_t, gx_j) < TOL
    assert rel_to_max(gB_t, gB_j) < TOL


@pytest.mark.parametrize("periodic", [True, False])
def test_primal_and_gradient_match_jax_at_kdv_width(periodic):
    """Mapping 256, the KdV recipe's width, on 300 rows."""
    rng = np.random.default_rng(256)
    x = (2.0 * rng.random((300, 2)) - 1.0).astype(np.float32)
    B = (0.75 * rng.standard_normal((2, 256))).astype(np.float32)
    g = rng.standard_normal((300, 512)).astype(np.float32)

    out_j, vjp = jax.vjp(lambda a, b: jax_ff(a, b, periodic), jnp.asarray(x), jnp.asarray(B))
    gx_j, gB_j = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    Bt = torch.from_numpy(B).requires_grad_(True)
    out_t = fourier_features(xt, Bt, periodic)
    gx_t, gB_t = torch.autograd.grad(out_t, (xt, Bt), torch.from_numpy(g))

    assert rel_to_max(out_t, out_j) < TOL
    assert rel_to_max(gx_t, gx_j) < TOL
    assert rel_to_max(gB_t, gB_j) < TOL


# ------------------------------------------------------- the CUDA launch path
# What the launcher decides on the host, rehearsed here: the C entry points
# and their bindings, the path and grid of launch_plan (through a twin of the
# kernel's thread mapping), when a call needs the Function's rules, and the
# checks made before a pointer is handed over.


def test_cuda_bindings_match_the_c_entry_points():
    """Every extern "C" function of fourier_feats.cu has a ctypes binding
    with as many arguments, and every binding a C function."""
    from pinnrl_tpu_torch.ops.kernels import fourier_feats as ff

    src = (Path(ff.__file__).resolve().parents[2] / "csrc" / "fourier_feats.cu").read_text()
    entries = {m.group(1): m.group(2) for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src)}
    assert set(entries) == set(ff._ARGTYPES)
    for name, args in entries.items():
        assert len(args.split(",")) == len(ff._ARGTYPES[name]), name
    for const, value in (("QUADS", ff.QUADS), ("ROWS", ff.ROWS), ("MAX_VEC_D", ff.MAX_VEC_D)):
        assert re.search(rf"constexpr int {const} = {value};", src), const


def _mapping_twin(x, B, two_pi, plan):
    """The output the kernel writes under ``plan``, following its thread
    mapping: block (bx, by), thread (tx, ty) takes column unit
    bx * QUADS + tx (a quad of features on the vector path, one feature on
    the edge path) and rows by * ROWS + ty + k * grid_rows * ROWS. Returns
    the output (NaN where nothing was written) and the writes per element."""
    from pinnrl_tpu_torch.ops.kernels import fourier_feats as ff
    from pinnrl_tpu_torch.ops.kernels.fourier_feats import fourier_features_plain

    path, cols, rows = plan
    n, m = x.shape[0], B.shape[1]
    width = 4 if path else 1
    units = min(cols * ff.QUADS, m // width)  # threads past the last unit return
    out = torch.full((n, 2 * m), float("nan"), dtype=x.dtype)
    writes = torch.zeros((n, 2 * m), dtype=torch.int64)
    step = rows * ff.ROWS
    for start in range(0, n, step):  # one pass of the grid-stride loop
        r = slice(start, min(start + step, n))
        feats = fourier_features_plain(x[r], B[:, : units * width], two_pi)
        out[r, : units * width] = feats[:, : units * width]
        out[r, m: m + units * width] = feats[:, units * width:]
        writes[r, : units * width] += 1
        writes[r, m: m + units * width] += 1
    return out, writes


@pytest.mark.parametrize("sms", [132, 1])
@pytest.mark.parametrize("n,d,m,aligned,path", [
    (4096, 2, 128, True, 2), (4096, 2, 256, True, 2), (20000, 2, 128, True, 2), (1, 1, 4, True, 1),
    (7, 3, 256, True, 3), (5000, 3, 127, True, 0), (300, 4, 128, True, 0), (64, 2, 128, False, 0),
    (33, 2, 5, True, 0), (9, 1, 1, True, 0),
])
def test_launch_plan_covers_every_output_once(n, d, m, aligned, path, sms):
    from pinnrl_tpu_torch.ops.kernels import fourier_feats as ff

    plan = ff.launch_plan(n, d, m, aligned, sms)
    assert plan[0] == path
    cols, rows = plan[1:]
    assert 1 <= rows <= min(-(-n // ff.ROWS), 65535)
    assert cols * rows <= max(ff.BLOCKS_PER_SM * sms, cols)
    rng = np.random.default_rng(n + m)
    x = torch.from_numpy(2.0 * rng.random((n, d)) - 1.0)
    B = torch.from_numpy(2.0 * rng.standard_normal((d, m)))
    out, writes = _mapping_twin(x, B, True, plan)
    assert bool((writes == 1).all())
    assert rel_to_max(out, ff.fourier_features_plain(x, B, True)) < 1e-12


def test_launch_plan_grid_limits():
    """Rows grow with n up to BLOCKS_PER_SM per SM, split across the column
    blocks, and never pass CUDA's grid-y limit."""
    from pinnrl_tpu_torch.ops.kernels import fourier_feats as ff

    assert ff.launch_plan(10**9, 2, 128, True, 132) == (2, 1, ff.BLOCKS_PER_SM * 132)
    assert ff.launch_plan(10**9, 2, 256, True, 132) == (2, 2, ff.BLOCKS_PER_SM * 66)
    assert ff.launch_plan(10**9, 2, 10**6, False, 132) == (0, 31250, 1)
    assert ff.launch_plan(10**9, 2, 128, True, 10**6)[2] == 65535
    assert ff.launch_plan(0, 2, 128, True, 132) == (2, 1, 1)


def test_needs_rules_only_where_a_rule_can_be_asked():
    """The launch skips the Function only where none of its rules could
    run: no gradient wanted, no torch.func transform, no forward-AD level."""
    import torch.autograd.forward_ad as fwad

    from pinnrl_tpu_torch.ops.kernels.fourier_feats import needs_rules

    x, B = torch.zeros((4, 2)), torch.zeros((2, 8))
    assert not needs_rules(x, B)
    assert needs_rules(x.requires_grad_(True), B) and needs_rules(B, x)
    with torch.no_grad():
        assert not needs_rules(x, B)
    x = x.detach()
    seen = []
    torch.func.jvp(lambda a: seen.append(needs_rules(a, B)) or a, (x,), (x,))
    torch.func.vmap(lambda a: seen.append(needs_rules(a, B)) or a)(x)
    torch.func.grad(lambda a: seen.append(needs_rules(a, B)) or a.sum())(x)
    with fwad.dual_level():
        seen.append(needs_rules(x, B))
    assert seen == [True] * 4
    assert not needs_rules(x, B)


def test_cuda_launch_checks_on_host_tensors():
    """The launch's one check names what failed, before any library is
    loaded: host tensors, shapes that do not chain."""
    from pinnrl_tpu_torch.ops.kernels import fourier_feats as ff

    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        ff.fourier_features_cuda(torch.zeros((4, 2)), torch.zeros((2, 8)))
    with pytest.raises(ValueError, match="do not chain"):
        ff.fourier_features_cuda(torch.zeros((4, 3)), torch.zeros((2, 8)))
    with pytest.raises(ValueError, match="do not chain"):
        ff.fourier_features_cuda(torch.zeros(4), torch.zeros((2, 8)))


def test_cuda_function_backward_formula_on_cpu():
    """The autograd.Function's backward (written on the kernel's output) is
    the exact VJP: run it on CPU with the plain forward standing in."""
    from pinnrl_tpu_torch.ops.kernels import fourier_feats as ff

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((32, 2), np.float32)).requires_grad_(True)
    B = torch.from_numpy(rng.standard_normal((2, 8)).astype(np.float32)).requires_grad_(True)
    g = torch.from_numpy(rng.standard_normal((32, 16)).astype(np.float32))

    class Ctx:
        needs_input_grad = (True, True, False)
        two_pi = True
        saved_tensors = (x.detach(), B.detach(), ff.fourier_features_plain(x.detach(), B.detach()))

    gx, gB = ff._FourierFeaturesFn.backward(Ctx, g)[:2]
    rx, rB = torch.autograd.grad(ff.fourier_features_plain(x, B), (x, B), g)
    assert rel_to_max(gx, rx) < TOL and rel_to_max(gB, rB) < TOL


# ------------------------------------------------ the Function's jvp and vmap
# Rehearsed on the CPU with the plain version in place of the CUDA launch, in
# float64 against the plain function: 1e-10 relative to max (the same
# arithmetic; the rule works on the kernel's own output).


def _fn(x, B, two_pi=True):
    from pinnrl_tpu_torch.ops.kernels import fourier_feats as ff

    return ff._FourierFeaturesFn.apply(x, B, two_pi, ff.fourier_features_plain)


def _ff_net(ff_fn, B, W):
    return lambda x: torch.tanh(ff_fn(x, B) @ W).sum(-1)


def _nested_torch(f, x, v, order):
    fn = f
    for _ in range(order):
        fn = (lambda prev: (lambda xx: torch.func.jvp(prev, (xx,), (v,))[1]))(fn)
    return fn(x)


def _f64_inputs(seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(2.0 * rng.random((40, 2)) - 1.0)
    B = torch.from_numpy(0.75 * rng.standard_normal((2, 8)))
    W = torch.from_numpy(0.3 * rng.standard_normal((16, 6)))
    v = torch.zeros_like(x)
    v[:, 1] = 1.0
    return x, B, W, v


@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_function_nested_jvp_rehearsal(order):
    from pinnrl_tpu_torch.ops.kernels.fourier_feats import fourier_features_plain

    x, B, W, v = _f64_inputs(order)
    got = _nested_torch(_ff_net(_fn, B, W), x, v, order)
    ref = _nested_torch(_ff_net(fourier_features_plain, B, W), x, v, order)
    assert float(ref.abs().max()) > 0.0
    assert rel_to_max(got, ref) < 1e-10


@pytest.mark.parametrize("order", [1, 2, 3])
def test_jvp_matches_jax_rule(order):
    """Nested jvp through the port's plain version against JAX's nested
    jax.jvp of its kernel's custom_jvp rule, f32: 1e-3 relative to max (the
    JAX suite's bound for nested forward derivatives of the kernel)."""
    from pinnrl_tpu_torch.ops.kernels.fourier_feats import fourier_features_plain

    x, B, W, v = (a.numpy().astype(np.float32) for a in _f64_inputs(10 + order))

    def jnet(xx):
        return jnp.tanh(jax_ff(xx, jnp.asarray(B)) @ jnp.asarray(W)).sum(-1)

    fn = jnet
    for _ in range(order):
        fn = (lambda prev: (lambda xx: jax.jvp(prev, (xx,), (jnp.asarray(v),))[1]))(fn)
    ref = np.asarray(fn(jnp.asarray(x)))
    got = _nested_torch(_ff_net(fourier_features_plain, torch.from_numpy(B), torch.from_numpy(W)),
                        torch.from_numpy(x), torch.from_numpy(v), order)
    assert rel_to_max(got, ref) < 1e-3


def test_function_jvp_in_the_basis():
    """Tangents in B as well as x, nested twice."""
    from pinnrl_tpu_torch.ops.kernels.fourier_feats import fourier_features_plain

    x, B, W, _ = _f64_inputs(20)
    rng = np.random.default_rng(21)
    dx, dB = (torch.from_numpy(rng.standard_normal(a.shape)) for a in (x, B))

    def second(ff_fn):
        f = lambda xx, BB: torch.tanh(ff_fn(xx, BB) @ W).sum(-1)  # noqa: E731
        g = lambda xx, BB: torch.func.jvp(f, (xx, BB), (dx, dB))[1]  # noqa: E731
        return torch.func.jvp(g, (x, B), (dx, dB))[1]

    assert rel_to_max(second(_fn), second(fourier_features_plain)) < 1e-10


def test_function_reverse_over_forward():
    """torch.autograd.grad of a loss built from order-1..3 jvp outputs,
    through the Function (its backward and its jvp rule)."""
    from pinnrl_tpu_torch.ops.kernels.fourier_feats import fourier_features_plain

    x, B0, W0, v = _f64_inputs(30)

    def grads(ff_fn):
        B, W = B0.clone().requires_grad_(True), W0.clone().requires_grad_(True)
        f = _ff_net(ff_fn, B, W)
        d1, d2, d3 = (_nested_torch(f, x, v, k) for k in (1, 2, 3))
        loss = (f(x) ** 2).mean() + (d1 * d3).mean() + (d2 ** 2).mean()
        return torch.autograd.grad(loss, (B, W))

    for got, ref in zip(grads(_fn), grads(fourier_features_plain)):
        assert rel_to_max(got, ref) < 1e-10


def test_function_vmap():
    from pinnrl_tpu_torch.ops.kernels.fourier_feats import fourier_features_plain

    x, B, _, _ = _f64_inputs(40)
    xb = x.reshape(4, 10, 2)
    assert rel_to_max(torch.func.vmap(lambda xx: _fn(xx, B))(xb),
                      torch.stack([fourier_features_plain(xx, B) for xx in xb])) < 1e-10
    assert rel_to_max(torch.func.vmap(lambda xx: _fn(xx, B))(x),
                      fourier_features_plain(x, B)) < 1e-10
    Bb = torch.stack([B, 2.0 * B])
    assert rel_to_max(torch.func.vmap(lambda BB: _fn(x, BB))(Bb),
                      torch.stack([fourier_features_plain(x, BB) for BB in Bb])) < 1e-10
