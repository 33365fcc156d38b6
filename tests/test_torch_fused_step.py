"""Fused residual loss: the port's plain version against the JAX Pallas
kernel (interpret mode), and the CUDA kernels' host launcher run with their
plain PyTorch twins against torch.autograd.

Tolerances: loss 1e-5 relative, each gradient 1e-4 relative to its max (the
bounds the JAX suite holds its fused kernel to; the sums run in another
order). The hand-derived transport backward is checked at 1e-5 relative to
max in f32 (and at 1e-12 in f64, where only rounding separates it from
autograd). Causal weighting: loss 1e-5, gradients 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_helpers import burgers_pair, points, rel_to_max, torch_params

from pinnrl_tpu.ops.kernels import fused_step as jax_fused
from pinnrl_tpu_torch.ops.jet_mlp import make_bundle_fn
from pinnrl_tpu_torch.ops.kernels import fused_step

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4


def _z(seed=7, n=128):
    x, t = points(seed, n)
    return np.concatenate([x, t], axis=1)


def _plain_loss_and_grads(pair, params, z):
    bundle_fn = make_bundle_fn(pair.tmodel, 1, 2, 1)
    loss = fused_step.fused_residual_loss_plain(bundle_fn, pair.tpde, params, torch.from_numpy(z))
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


@pytest.mark.parametrize("layer_norm", [True, False])
def test_plain_version_matches_jax_interpret_kernel(layer_norm):
    pair = burgers_pair(layer_norm=layer_norm)
    z = _z()
    fused_j = jax_fused.make_fused_residual_loss(pair.jmodel, pair.jpde, tile=32, interpret=True)
    l_j, g_j = jax.value_and_grad(lambda p: fused_j(p, jnp.asarray(z)))(pair.jmodel.params)
    params = torch_params(pair.tmodel)
    l_t, g_t = _plain_loss_and_grads(pair, params, z)
    assert abs(float(l_t) - float(l_j)) / abs(float(l_j)) < LOSS_TOL
    for name, g in g_t.items():
        module, leaf = name.split(".")
        jleaf = {"weight": "kernel" if module.startswith("Dense") else "scale", "bias": "bias"}[leaf]
        ref = np.asarray(g_j[module][jleaf])
        got = g.detach().numpy()
        got = got.T if got.ndim == 2 else got
        assert rel_to_max(got, ref) < GRAD_TOL, name


@pytest.mark.parametrize("layer_norm", [True, False])
def test_kernel_launcher_with_plain_twins_matches_autograd(layer_norm):
    """The host launcher of the CUDA kernels (layouts, strides, split-K,
    colsums, the hand-derived backward) run with the plain twins."""
    pair = burgers_pair(layer_norm=layer_norm, hidden=(32, 24, 16))
    z = _z(n=160)
    params = torch_params(pair.tmodel)
    l_ref, g_ref = _plain_loss_and_grads(pair, params, z)
    spec = fused_step._spec(pair.tmodel, pair.tpde)
    with torch.no_grad():
        loss, grads = fused_step._loss_and_grads(
            fused_step._TorchOps(), spec, torch.from_numpy(z), {k: v.detach() for k, v in params.items()})
    assert sorted(grads) == sorted(g_ref)
    assert abs(float(loss) - float(l_ref)) / abs(float(l_ref)) < LOSS_TOL
    for name in g_ref:
        assert grads[name].shape == g_ref[name].shape
        assert rel_to_max(grads[name], g_ref[name]) < GRAD_TOL, name
    # Validation's loss-only run: the same forward, no reverse pass.
    with torch.no_grad():
        loss_only, none = fused_step._loss_and_grads(
            fused_step._TorchOps(), spec, torch.from_numpy(z), {k: v.detach() for k, v in params.items()},
            need_grads=False)
    assert none == {} and torch.equal(loss_only, loss)


@pytest.mark.parametrize("x_order", [2, 3])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("layer_norm", [True, False])
def test_transport_backward_matches_autograd(dtype, tol, layer_norm, x_order):
    """The hand-derived reverse pass of the [value; x1..xK; t1] transport,
    K = 2 (Burgers) and K = 3 (KdV)."""
    rng = np.random.default_rng(11)
    n, width, streams = 24, 40, 2 + x_order
    H = torch.tensor(rng.standard_normal((streams * n, width)), dtype=dtype, requires_grad=True)
    gamma = torch.tensor(1.0 + 0.2 * rng.standard_normal(width), dtype=dtype, requires_grad=True)
    beta = torch.tensor(0.2 * rng.standard_normal(width), dtype=dtype, requires_grad=True)
    GA = torch.tensor(rng.standard_normal((streams * n, width)), dtype=dtype)
    g, b = (gamma, beta) if layer_norm else (None, None)
    out = fused_step._transport_fwd_plain(H, g, b, n)
    inputs = [H, gamma, beta] if layer_norm else [H]
    ref = torch.autograd.grad(out, inputs, GA)
    GH, Gg, Gb = fused_step._transport_bwd_plain(
        H.detach(), None if g is None else gamma.detach(), None if b is None else beta.detach(), GA, n)
    assert rel_to_max(GH, ref[0]) < tol
    if layer_norm:
        assert rel_to_max(Gg.sum(0), ref[1]) < tol
        assert rel_to_max(Gb.sum(0), ref[2]) < tol
    else:
        assert Gg is None and Gb is None


def test_causal_residual_loss_matches_jax():
    pair = burgers_pair(causal_eps=1.0)
    x, t = points(9, 128)
    pair.jpde.attach_fast_bundle(pair.jmodel)
    pair.tpde.attach_fast_bundle(pair.tmodel)

    def jloss(p):
        r = pair.jpde.compute_residual(pair.jmodel.apply, p, jnp.asarray(x), jnp.asarray(t), None)
        return pair.jpde._residual_loss(r, jnp.asarray(t))

    l_j, g_j = jax.value_and_grad(jloss)(pair.jmodel.params)
    params = torch_params(pair.tmodel)
    r = pair.tpde.compute_residual(pair.tmodel.apply, params, torch.from_numpy(x), torch.from_numpy(t))
    l_t = pair.tpde._residual_loss(r, torch.from_numpy(t))
    g_t = dict(zip(params, torch.autograd.grad(l_t, list(params.values()))))
    assert abs(float(l_t.detach()) - float(l_j)) / abs(float(l_j)) < LOSS_TOL
    ref = np.asarray(g_j["Dense_1"]["kernel"])
    assert rel_to_max(g_t["Dense_1.weight"].detach().numpy().T, ref) < GRAD_TOL
    ref = np.asarray(g_j["LayerNorm_0"]["scale"])
    assert rel_to_max(g_t["LayerNorm_0.weight"], ref) < GRAD_TOL


def test_supports_scope():
    pair = burgers_pair()
    assert fused_step.supports(pair.tmodel, pair.tpde, pair.tcfg.training)
    assert pair.tpde.attach_fused_residual_kernel(pair.tmodel)
    causal = burgers_pair(causal_eps=0.5)
    assert fused_step.supports(causal.tmodel, causal.tpde, causal.tcfg.training)
    assert causal.tpde.attach_fused_residual_kernel(causal.tmodel, enable="on")
    ff = burgers_pair(arch="feedforward")
    assert not fused_step.supports(ff.tmodel, ff.tpde)
    pair.tcfg.training.loss_function = "mae"
    assert not fused_step.supports(pair.tmodel, pair.tpde, pair.tcfg.training)
    with pytest.raises(ValueError, match="unsupported"):
        pair.tpde.attach_fused_residual_kernel(pair.tmodel, enable="on")
    # No width gate: narrow trunks stay on the kernel.
    narrow = burgers_pair(hidden=(8,), mapping=4)
    assert fused_step.supports(narrow.tmodel, narrow.tpde)


@pytest.mark.parametrize("M,N,K", [(256, 256, 32768), (1, 256, 32768), (256, 256, 100), (64, 64, 8192)])
def test_split_k_covers_k(M, N, K):
    splits, chunk = fused_step._split_k(M, N, K)
    assert chunk % 16 == 0 and splits >= 1
    assert (splits - 1) * chunk < K <= splits * chunk
