"""Fourier-feature op: the port's plain version (what the wrapper runs on
CPU tensors) against pinnrl_tpu's fourier_features, primal and gradient.

Tolerance 1e-5 relative to max: f32, phases up to tens of radians, where
one ulp of the phase is ~4e-6.
"""

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
