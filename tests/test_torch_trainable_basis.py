"""Kernel 1 with a trainable Fourier basis: the host launcher run with its
plain twins (``fused_step._TorchOps``, the op sequence the CUDA kernels
run, ``embed_bwd`` included) against the JAX package's Pallas kernel in
interpret mode (which takes B as a leaf of ``params``) and against autograd
through the plain bundle, on bridged parameters: Burgers, KdV causal
(order 3), heat_2d and Burgers in a co-moving frame. Tolerances: loss 1e-5
relative and gradients 1e-4 relative to each gradient's max
(tests/test_pallas_parity_tpu.py:152-155), B's included; causal 1e-4 and
1e-3 (same file, lines 186-189)."""

import numpy as np
import pytest
import torch
from torch_parity_helpers import (KDV_DOMAIN, launcher_vs_jax_kernel, pde_pair, plain_vs_launcher,
                                  sorted_z)

from pinnrl_tpu_torch.ops.kernels import fused_step

BASIS = "FourierFeatures_0.B"
CASES = {
    "burgers": (dict(), dict(domain=((-1.0, 1.0),), time_domain=(0.0, 1.0)), 1e-5, 1e-4),
    "kdv_causal": (dict(causal_eps=1.0, scale=0.75), KDV_DOMAIN, 1e-4, 1e-3),
    "heat_2d": (dict(dim=2), dict(domain=((0.0, 2.0), (0.0, 2.0)), time_domain=(0.0, 10.0)),
                1e-5, 1e-4),
    "burgers_frame": (dict(frame=0.7), dict(domain=((-1.0, 1.0),), time_domain=(0.0, 1.0)),
                      1e-5, 1e-4),
}


def _pair(case):
    kw, _dom, _lt, _gt = CASES[case]
    pde = "kdv" if case.startswith("kdv") else "heat" if case.startswith("heat") else "burgers"
    return pde_pair(pde, arch_params={"trainable_features": True}, **kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_supports_and_spec_take_the_basis_as_a_leaf(case):
    pair = _pair(case)
    assert fused_step.supports(pair.tmodel, pair.tpde, pair.tcfg.training)
    spec = fused_step._spec(pair.tmodel, pair.tpde)
    assert spec.trainable_basis and spec.B is None and spec.leaf_names[0] == BASIS
    assert sorted(spec.leaf_names) == sorted(pair.tmodel.params)


@pytest.mark.parametrize("case", sorted(CASES))
def test_launcher_with_basis_gradient_matches_the_jax_kernel(case):
    pair = _pair(case)
    _kw, dom, loss_tol, grad_tol = CASES[case]
    loss_rel, rels = launcher_vs_jax_kernel(pair, sorted_z(3, 96, dom))
    assert loss_rel < loss_tol
    assert "['FourierFeatures_0']['B']" in rels
    for name, rel in rels.items():
        assert rel < grad_tol, name


@pytest.mark.parametrize("case", sorted(CASES))
def test_launcher_with_basis_gradient_matches_the_plain_bundle(case):
    pair = _pair(case)
    _kw, dom, loss_tol, grad_tol = CASES[case]
    loss_rel, rels = plain_vs_launcher(pair, sorted_z(5, 96, dom))
    assert loss_rel < loss_tol
    assert BASIS in rels
    for name, rel in rels.items():
        assert rel < grad_tol, name


def test_embed_bwd_twin_is_the_adjoint_of_the_embedding():
    """<G, d embed / dB [V]> = <embed_bwd(G), V> for random G and V: the
    plain twin is the exact transpose of the embedding's B-derivative (in
    float64, d = 2, x-order 3, periodic, in a frame)."""
    rng = np.random.default_rng(0)
    d, m, n, k = 2, 6, 40, 3
    z = torch.from_numpy(rng.random((n, d + 1)))
    lo, sc = torch.zeros(d + 1, dtype=torch.float64), torch.full((d + 1,), 2.0, dtype=torch.float64)
    B = torch.from_numpy(rng.standard_normal((d + 1, m)))
    V = torch.from_numpy(rng.standard_normal((d + 1, m)))
    G = torch.from_numpy(rng.standard_normal(((2 + d * k) * n, 2 * m)))
    _, jvp = torch.func.jvp(lambda b: fused_step._embed_plain(z, lo, sc, b, True, k, 0.3), (B,), (V,))
    lhs = float(torch.sum(G * jvp))
    rhs = float(torch.sum(fused_step._embed_bwd_plain(z, lo, sc, B, G, True, k, 0.3) * V))
    assert abs(lhs - rhs) <= 1e-10 * abs(lhs)


def test_a_trainable_basis_trains_and_moves():
    """A few Adam steps of the Burgers recipe's trunk cut to CPU size with
    ``trainable_features``: kernel 1 attached (its plain version on the
    CPU), the basis a parameter of the optimizer that moves, finite falling
    losses."""
    pair = _pair("burgers")
    cfg = pair.tcfg
    cfg.training.num_collocation_points, cfg.training.batch_size = 128, 64
    cfg.evaluation.num_points = 64
    from pinnrl_tpu_torch.training import PDETrainer

    trainer = PDETrainer(pair.tmodel, pair.tpde, cfg)
    assert trainer.fused_kernel_active
    before = pair.tmodel.params[BASIS].detach().clone()
    hist = trainer.train(num_epochs=4, seed=0)["history"]["train_loss"]
    assert all(np.isfinite(hist)) and hist[-1] < hist[0]
    assert not torch.equal(pair.tmodel.params[BASIS], before)
