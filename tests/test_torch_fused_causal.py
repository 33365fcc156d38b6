"""Kernel 1's causal and order-3 (KdV) variants: the port's plain version
against the JAX Pallas kernel (interpret mode), the CUDA kernels' host
launcher run with their plain PyTorch twins against torch.autograd, and the
causal prefix scan's block arithmetic.

Tolerances:
- Burgers causal: loss 1e-5 relative, each gradient 1e-4 relative to its
  max (the JAX suite's bounds for its causal interpret kernel,
  tests/test_kernels.py:207-211).
- KdV, causal or not: loss 2e-4 relative (tests/test_kernels.py:271-273:
  order-3 jets of a random-init net amplify f32 rounding), gradients 1e-3
  relative to max (the JAX suite's causal gradient bound).
- The scan in float64 against torch.cumsum: 1e-12 relative to max (only
  the order of the additions differs).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_helpers import KDV_DOMAIN, burgers_pair, kdv_pair, points, rel_to_max, torch_params

from pinnrl_tpu.ops.kernels import fused_step as jax_fused
from pinnrl_tpu_torch.ops.jet_mlp import make_bundle_fn
from pinnrl_tpu_torch.ops.kernels import fused_step

BOUNDS = {"burgers": (1e-5, 1e-4), "kdv": (2e-4, 1e-3)}  # (loss, gradients)


def _pair(pde, **kw):
    return burgers_pair(**kw) if pde == "burgers" else kdv_pair(**kw)


def _sorted_z(pde, seed, n):
    x, t = points(seed, n) if pde == "burgers" else points(seed, n, **KDV_DOMAIN)
    z = np.concatenate([x, t], axis=1)
    return z[np.argsort(z[:, 1], kind="stable")]


def _plain_loss_and_grads(pair, params, z):
    pde = pair.tpde
    bundle_fn = make_bundle_fn(pair.tmodel, 1, max(pde.spatial_orders), max(pde.temporal_orders))
    loss = fused_step.fused_residual_loss_plain(bundle_fn, pde, params, torch.from_numpy(z))
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


@pytest.mark.parametrize("pde,eps,n,tile", [
    ("burgers", 1.0, 128, 32),
    ("kdv", 0.5, 64, 16),
    ("kdv", 0.0, 64, 16),
])
def test_plain_version_matches_jax_interpret_kernel(pde, eps, n, tile):
    pair = _pair(pde, causal_eps=eps)
    loss_tol, grad_tol = BOUNDS[pde]
    z = _sorted_z(pde, 7, n)
    fused_j = jax_fused.make_fused_residual_loss(pair.jmodel, pair.jpde, tile=tile, interpret=True,
                                                 causal_eps=eps)
    l_j, g_j = jax.value_and_grad(lambda p: fused_j(p, jnp.asarray(z)))(pair.jmodel.params)
    l_t, g_t = _plain_loss_and_grads(pair, torch_params(pair.tmodel), z)
    assert abs(float(l_t) - float(l_j)) / abs(float(l_j)) < loss_tol
    for name, g in g_t.items():
        module, leaf = name.split(".")
        jleaf = {"weight": "kernel" if module.startswith("Dense") else "scale", "bias": "bias"}[leaf]
        got = g.detach().numpy()
        got = got.T if got.ndim == 2 else got
        assert rel_to_max(got, np.asarray(g_j[module][jleaf])) < grad_tol, name


@pytest.mark.parametrize("layer_norm", [True, False])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("pde", ["burgers", "kdv"])
def test_kernel_launcher_with_plain_twins_matches_autograd(pde, causal, layer_norm):
    """The launcher's sequence (embedding of 2 + K streams, GEMMs, transport
    and its hand-derived backward, the residual, the causal weights and
    scaling, colsums) against autograd on the plain version."""
    pair = _pair(pde, layer_norm=layer_norm, hidden=(32, 24, 16), causal_eps=1.0 if causal else 0.0)
    loss_tol, grad_tol = BOUNDS[pde]
    z = _sorted_z(pde, 3, 160)
    params = torch_params(pair.tmodel)
    l_ref, g_ref = _plain_loss_and_grads(pair, params, z)
    spec = fused_step._spec(pair.tmodel, pair.tpde)
    assert (spec.x_order, spec.residual, spec.causal_eps) == (
        2 if pde == "burgers" else 3, pde, 1.0 if causal else 0.0)
    detached = {k: v.detach() for k, v in params.items()}
    with torch.no_grad():
        loss, grads = fused_step._loss_and_grads(fused_step._TorchOps(), spec, torch.from_numpy(z),
                                                 detached)
    assert sorted(grads) == sorted(g_ref)
    assert abs(float(loss) - float(l_ref)) / abs(float(l_ref)) < loss_tol
    for name in g_ref:
        assert grads[name].shape == g_ref[name].shape
        assert rel_to_max(grads[name], g_ref[name]) < grad_tol, name
    with torch.no_grad():
        loss_only, none = fused_step._loss_and_grads(fused_step._TorchOps(), spec,
                                                     torch.from_numpy(z), detached, need_grads=False)
    assert none == {} and torch.equal(loss_only, loss)


@pytest.mark.parametrize("n", [1, 3, fused_step._SCAN_BLOCK - 1, fused_step._SCAN_BLOCK,
                               3 * fused_step._SCAN_BLOCK + 17])
def test_scan_twin_matches_cumsum(n):
    """The three-pass scan at the launcher's block size: one block, a
    partial block, an exact block, and several blocks with a remainder."""
    x = torch.from_numpy(np.random.default_rng(n).random(n) * 10.0)  # float64, like r^2 >= 0
    got = fused_step._exclusive_scan_plain(x, fused_step._SCAN_BLOCK)
    ref = torch.cumsum(x, 0) - x
    assert got.shape == (n,) and float(got[0]) == 0.0
    assert rel_to_max(got, ref) < 1e-12 if n > 1 else float(got.abs().max()) == 0.0


def test_causal_weights_twin_matches_residual_loss():
    """w_i = exp(-eps sum_{j<i} r_j^2 / N) and the weighted loss, from the
    twins, equal PDEBase._residual_loss on the same sorted residuals."""
    pair = kdv_pair(causal_eps=0.7)
    n = 2 * fused_step._SCAN_BLOCK + 5
    rng = np.random.default_rng(4)
    r = torch.from_numpy(rng.standard_normal((n, 1)).astype(np.float32)) * 0.05
    t = torch.arange(n, dtype=torch.float32).reshape(-1, 1)
    ops = fused_step._TorchOps()
    WR = ops.causal_weights(r, n, 0.7)
    sums = ops.colsum(WR, n, 2, 2, 1.0)
    ref = pair.tpde._residual_loss(r, t)
    assert float(WR[0, 0]) == 1.0 and float(WR[:, 0].min()) > 0.0
    assert abs(float(sums[1] / sums[0]) - float(ref)) / float(ref) < 1e-5


def test_cuda_bindings_match_the_c_entry_points():
    """Every extern "C" function of fused_residual.cu has a ctypes binding
    with as many arguments, and every binding has a plain twin."""
    src = (Path(fused_step.__file__).resolve().parents[2] / "csrc" / "fused_residual.cu").read_text()
    entries = {m.group(1): m.group(2) for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src)}
    assert set(entries) == set(fused_step._CudaOps._ARGTYPES)
    for name, args in entries.items():
        assert len(args.split(",")) == len(fused_step._CudaOps._ARGTYPES[name]), name
        twin = name[len("fr_"):]
        assert callable(getattr(fused_step._TorchOps, twin)), twin


def test_supports_kdv_and_causal():
    for pair in (kdv_pair(), kdv_pair(causal_eps=1.0), burgers_pair(causal_eps=1.0)):
        assert fused_step.supports(pair.tmodel, pair.tpde, pair.tcfg.training)
        assert pair.tpde.attach_fused_residual_kernel(pair.tmodel, enable="on")
