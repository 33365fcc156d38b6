"""A deep ensemble's members in one call, on the CPU.

JAX trains and validates an ensemble by ``jax.vmap`` over the stacked
members, which turns its Pallas kernel 1 into one ``pallas_call`` with a
member axis in its grid, and its kernels 2 and 3 into member-batched calls.
The port's counterpart:

- kernel 1's launcher (``fused_step._loss_and_grads``) on z (E, N, d+1) and
  leaves stacked (E, ...), run here with its plain twins (``_TorchOps``),
  against JAX's ``jax.vmap(jax.value_and_grad(make_fused_residual_loss(...,
  interpret=True)))`` (with and without LayerNorm, causal, d = 2, a
  trainable basis) and against E single-member calls in float64;
- the GEMM core's member strides (``_gemm_core.gemm_plain``, a stride of 0
  for an operand the members share) against per-member products;
- the vmap rules of kernels 2 and 3 with a member axis on B, or on W and b:
  one launch (counted through a stand-in launch, the plain version), and
  their backward and jvp rules on the stacked shapes;
- ``_FusedResidualFn`` on stacked leaves: one launch counted, E members;
- the trainer: which path each ensemble takes (``PDETrainer.member_path``),
  one Adam step and one validation equal to the per-member loop on the same
  generators with the draws unchanged, and a SIREN ensemble's vmapped
  residual terms against JAX's vmapped residual loss.

Tolerances: the launcher against JAX's kernel at the parity rule's bounds,
loss 1e-5 relative and gradients 1e-4 relative to each member's max
(tests/test_pallas_parity_tpu.py:152-155); float64 equalities at 1e-12
(only the order of additions may differ); the step and validation against
the per-member loop 1e-6 relative (the vmapped plain version batches its
products, which rounds otherwise than one member's); the SIREN at the
bounds of tests/test_torch_kdv_siren.py (loss 1e-4 relative, gradients 1e-3
relative to max: omega_0 30 amplifies float32 rounding).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_helpers import (jax_grad_rels, pde_pair, points, rel_to_max, siren_kdv_pair,
                                  sorted_z)

from pinnrl_tpu.ops.kernels import fused_step as jax_fused
from pinnrl_tpu_torch.ops.kernels import _gemm_core, fourier_feats, fused_step, siren
from pinnrl_tpu_torch.training import PDETrainer

BURGERS = dict(domain=((-1.0, 1.0),), time_domain=(0.0, 1.0))
HEAT_2D = dict(domain=((0.0, 1.0), (0.0, 1.0)), time_domain=(0.0, 1.0))

# case: (pde_pair arguments, members, points per member, point domain)
CASES = {
    "layer_norm": (dict(pde_type="burgers", hidden=(32, 24), mapping=16), 3, 128, BURGERS),
    "no_layer_norm": (dict(pde_type="burgers", hidden=(16, 16), mapping=8, layer_norm=False), 2,
                      64, BURGERS),
    "causal": (dict(pde_type="burgers", hidden=(32, 24), mapping=16, causal_eps=1.0), 3, 128,
               BURGERS),
    "two_dims": (dict(pde_type="heat", hidden=(16, 16), mapping=8, dim=2), 2, 64, HEAT_2D),
    "trainable_basis": (dict(pde_type="burgers", hidden=(16, 16), mapping=8,
                             arch_params={"trainable_features": True}), 3, 64, BURGERS),
}


def _members(case):
    """E bridged pairs (seeds 0..E-1) of a case, the stacked z (E, N, d+1)
    (each member's own points, sorted by time) and the case's E and N."""
    kw, E, n, dom = CASES[case]
    pairs = [pde_pair(seed=e, **kw) for e in range(E)]
    z = np.stack([sorted_z(30 + e, n, dom) for e in range(E)])
    return pairs, z


def _stack_torch(pairs, dtype=torch.float32):
    return {k: torch.stack([p.tmodel.params[k].detach() for p in pairs]).to(dtype)
            for k in pairs[0].tmodel.params}


def _stack_jax(pairs):
    return jax.tree_util.tree_map(lambda *a: jnp.stack(a), *[p.jmodel.params for p in pairs])


def _member_tree(tree, e):
    return jax.tree_util.tree_map(lambda a: a[e], tree)


# --------------------------------------------------- kernel 1's launcher


@pytest.mark.parametrize("case", list(CASES))
def test_member_batched_launcher_matches_jax_vmapped_kernel(case):
    """One member-batched launcher call with the plain twins against JAX's
    kernel 1 vmapped over the same stacked members (one pallas_call with a
    member axis): each member's loss and every gradient. The members share
    the first member's fixed basis, as both trainers' stacks do."""
    pairs, z = _members(case)
    E = z.shape[0]
    first = pairs[0]
    fused_j = jax_fused.make_fused_residual_loss(first.jmodel, first.jpde, tile=32, interpret=True,
                                                 causal_eps=first.tpde.causal_eps())
    l_j, g_j = jax.vmap(jax.value_and_grad(lambda p, zz: fused_j(p, zz)))(_stack_jax(pairs),
                                                                          jnp.asarray(z))
    spec = fused_step._spec(first.tmodel, first.tpde)
    with torch.no_grad():
        loss, grads = fused_step._loss_and_grads(fused_step._TorchOps(), spec, torch.from_numpy(z),
                                                 _stack_torch(pairs))
    assert loss.shape == (E,)
    for e in range(E):
        assert abs(float(loss[e]) - float(l_j[e])) / abs(float(l_j[e])) < 1e-5, e
        rels = jax_grad_rels({k: v[e] for k, v in grads.items()}, _member_tree(g_j, e))
        assert max(rels.values()) < 1e-4, (e, rels)


@pytest.mark.parametrize("case", list(CASES))
def test_member_batched_launcher_equals_single_member_calls_in_float64(case):
    """The member-batched launcher (its stacked layouts, member strides and
    per-member sums) against E single-member calls, in float64: the loss
    (E,) and gradients of the leaves' stacked shapes, with and without the
    reverse pass."""
    pairs, z = _members(case)
    spec = fused_step._spec(pairs[0].tmodel, pairs[0].tpde)
    spec = fused_step._Spec(**{**spec.__dict__, "lo": spec.lo.double(),
                               "scale": spec.scale.double(),
                               "B": None if spec.B is None else spec.B.double()})
    P = _stack_torch(pairs, torch.float64)
    z = torch.from_numpy(z).double()
    ops = fused_step._TorchOps()
    loss, grads = fused_step._loss_and_grads(ops, spec, z, P)
    loss_only, none = fused_step._loss_and_grads(ops, spec, z, P, need_grads=False)
    assert none == {} and torch.equal(loss, loss_only)
    assert sorted(grads) == sorted(P) and all(grads[k].shape == P[k].shape for k in P)
    for e in range(z.shape[0]):
        l1, g1 = fused_step._loss_and_grads(ops, spec, z[e], {k: v[e] for k, v in P.items()})
        assert abs(float(loss[e]) - float(l1)) <= 1e-12 * abs(float(l1))
        for k in g1:
            assert rel_to_max(grads[k][e], g1[k]) < 1e-12, (e, k)


def test_fused_function_counts_one_launch_for_all_members(monkeypatch):
    """``_FusedResidualFn`` on stacked leaves (its CUDA ops replaced by the
    plain twins): one launch in ``fused_residual_loss.launches``, E members
    in ``fused_residual_loss.members``, a loss (E,) whose backward hands each
    member its own gradient times its own cotangent."""
    pairs, z = _members("layer_norm")
    E = z.shape[0]
    monkeypatch.setattr(fused_step, "_cuda_ops", lambda device: fused_step._TorchOps())
    monkeypatch.setattr(fused_step.fused_residual_loss, "launches", 0)
    monkeypatch.setattr(fused_step.fused_residual_loss, "members", 0)
    spec = fused_step._spec(pairs[0].tmodel, pairs[0].tpde)
    P = {k: v.requires_grad_(True) for k, v in _stack_torch(pairs).items()}
    zt = torch.from_numpy(z)
    loss = fused_step._FusedResidualFn.apply(spec, zt, *[P[k] for k in spec.leaf_names])
    assert loss.shape == (E,)
    assert fused_step.fused_residual_loss.launches == 1
    assert fused_step.fused_residual_loss.members == E
    weights = torch.arange(1.0, E + 1.0)
    (loss * weights).sum().backward()
    with torch.no_grad():
        _, ref = fused_step._loss_and_grads(fused_step._TorchOps(), spec, zt,
                                            {k: v.detach() for k, v in P.items()})
    for k in spec.leaf_names:
        want = ref[k] * weights.reshape((E,) + (1,) * (ref[k].ndim - 1))
        assert torch.equal(P[k].grad, want), k


# ------------------------------------------------------ the GEMM core


@pytest.mark.parametrize("shared", ["none", "A", "B", "bias"])
@pytest.mark.parametrize("splits", [1, 3])
def test_gemm_plain_member_strides(shared, splits):
    """``gemm_plain``'s member axis: member e's product of A + e sae, B + e
    sbe, bias + e s_bias into C + e sce, a stride of 0 sharing an operand,
    split over K with the single call's chunks; against per-member products
    in float64."""
    rng = np.random.default_rng(splits)
    E, M, N, K = 3, 7, 5, 20
    A = torch.from_numpy(rng.standard_normal((1 if shared == "A" else E, M, K)))
    B = torch.from_numpy(rng.standard_normal((1 if shared == "B" else E, K, N)))
    bias = torch.from_numpy(rng.standard_normal((1 if shared == "bias" else E, N)))
    splits, k_chunk = _gemm_core.split_chunks(K, splits)
    C = torch.full((E, splits, M, N), float("nan"), dtype=torch.float64)
    _gemm_core.gemm_plain(M, N, K, A, K, 1, B, N, 1, C, N, bias, 4, splits, k_chunk,
                          members=E, sae=0 if shared == "A" else M * K,
                          sbe=0 if shared == "B" else K * N, sce=splits * M * N,
                          s_bias=0 if shared == "bias" else N)
    for e in range(E):
        a, b, c = A[min(e, A.shape[0] - 1)], B[min(e, B.shape[0] - 1)], bias[min(e, bias.shape[0] - 1)]
        for s in range(splits):
            k0, k1 = s * k_chunk, min(K, (s + 1) * k_chunk)
            want = a[:, k0:k1] @ b[k0:k1]
            want[:4] += c
            assert rel_to_max(C[e, s], want) < 1e-12, (e, s)
    assert torch.allclose(C.sum(dim=1)[:, 4:], torch.stack(
        [A[min(e, A.shape[0] - 1)] @ B[min(e, B.shape[0] - 1)] for e in range(E)])[:, 4:],
        rtol=1e-12, atol=1e-12)


def test_launcher_products_keep_each_members_split():
    """The launcher's dW on stacked members splits each member's long K as
    one member's call does, and the members' split partials sum per member:
    (E, out, K) equal to the per-member products."""
    rng = np.random.default_rng(2)
    E, R, out, K = 2, 2048, 24, 16
    G = torch.from_numpy(rng.standard_normal((E * R, out)))
    X = torch.from_numpy(rng.standard_normal((E * R, K)))
    ops = fused_step._TorchOps()
    assert fused_step._split_k(out, K, R)[0] > 1
    dW = fused_step._linear_dw(ops, G, X, E)
    assert dW.shape == (E, out, K)
    for e in range(E):
        rows = slice(e * R, (e + 1) * R)
        assert torch.equal(dW[e], fused_step._linear_dw(ops, G[rows], X[rows]))
        assert rel_to_max(dW[e], G[rows].t() @ X[rows]) < 1e-12


# ------------------------------------------------- kernels 2 and 3's vmap


def _counting(plain):
    calls = []

    def launch(*args):
        calls.append(tuple(a.shape for a in args if isinstance(a, torch.Tensor)))
        return plain(*args)

    return launch, calls


@pytest.mark.parametrize("x_batched", [True, False])
def test_fourier_features_vmap_rule_launches_once_for_a_member_basis(x_batched):
    """``_FourierFeaturesFn``'s vmap rule with B (E, d, m) batched (a
    trainable basis per member) and x batched or shared: one launch on the
    stacked shapes, the members' outputs, their gradients in x and B and a
    jvp under the vmap equal to the plain version member by member."""
    rng = np.random.default_rng(5)
    E, n, d, m = 3, 17, 2, 8
    x = torch.from_numpy(rng.standard_normal((E, n, d) if x_batched else (n, d)))
    B = torch.from_numpy(rng.standard_normal((E, d, m)))
    launch, calls = _counting(fourier_feats.fourier_features_plain)
    xr, Br = x.clone().requires_grad_(True), B.clone().requires_grad_(True)
    out = torch.func.vmap(lambda a, b: fourier_feats._FourierFeaturesFn.apply(a, b, True, launch),
                          in_dims=(0 if x_batched else None, 0))(xr, Br)
    assert calls == [((E, n, d), (E, d, m))]
    xs = [x[e] if x_batched else x for e in range(E)]
    ref = torch.stack([fourier_feats.fourier_features_plain(xs[e], B[e]) for e in range(E)])
    assert out.shape == (E, n, 2 * m) and rel_to_max(out.detach(), ref) < 1e-12
    g = torch.from_numpy(rng.standard_normal(out.shape))
    gx, gB = torch.autograd.grad(out, (xr, Br), g)
    xp, Bp = x.clone().requires_grad_(True), B.clone().requires_grad_(True)
    ref = torch.stack([fourier_feats.fourier_features_plain(xp[e] if x_batched else xp, Bp[e])
                       for e in range(E)])
    rx, rB = torch.autograd.grad(ref, (xp, Bp), g)
    assert rel_to_max(gx, rx) < 1e-12 and rel_to_max(gB, rB) < 1e-12
    dx = torch.from_numpy(rng.standard_normal(x.shape))
    _, tangent = torch.func.vmap(
        lambda a, da, b: torch.func.jvp(
            lambda aa: fourier_feats._FourierFeaturesFn.apply(aa, b, True, launch), (a,), (da,)),
        in_dims=(0 if x_batched else None, 0 if x_batched else None, 0))(x, dx, B)
    want = torch.stack([torch.func.jvp(lambda aa: fourier_feats.fourier_features_plain(aa, B[e]),
                                       (xs[e],), (dx[e] if x_batched else dx,))[1]
                        for e in range(E)])
    assert rel_to_max(tangent, want) < 1e-12


@pytest.mark.parametrize("x_batched", [True, False])
def test_siren_vmap_rule_launches_once_for_member_weights(x_batched):
    """``_SirenFn``'s vmap rule with W (E, k, m) and b (E, m) batched (a
    SIREN layer per member) and x batched or shared: one launch on the
    stacked shapes, the members' outputs, their gradients in x, W and b and
    a jvp under the vmap equal to the plain version member by member."""
    rng = np.random.default_rng(6)
    E, n, k, m, om = 3, 11, 5, 7, 30.0
    x = torch.from_numpy(rng.standard_normal((E, n, k) if x_batched else (n, k)) * 0.1)
    W = torch.from_numpy(rng.standard_normal((E, k, m)) * 0.1)
    b = torch.from_numpy(rng.standard_normal((E, m)) * 0.1)
    launch, calls = _counting(siren.siren_layer_plain)
    xr, Wr, br = (t.clone().requires_grad_(True) for t in (x, W, b))
    out = torch.func.vmap(lambda a, w, c: siren._SirenFn.apply(a, w, c, om, launch),
                          in_dims=(0 if x_batched else None, 0, 0))(xr, Wr, br)
    assert calls == [((E, n, k), (E, k, m), (E, m))]
    xs = [x[e] if x_batched else x for e in range(E)]
    ref = torch.stack([siren.siren_layer_plain(xs[e], W[e], b[e], om) for e in range(E)])
    assert out.shape == (E, n, m) and rel_to_max(out.detach(), ref) < 1e-12
    g = torch.from_numpy(rng.standard_normal(out.shape))
    got = torch.autograd.grad(out, (xr, Wr, br), g)
    xp, Wp, bp = (t.clone().requires_grad_(True) for t in (x, W, b))
    ref = torch.stack([siren.siren_layer_plain(xp[e] if x_batched else xp, Wp[e], bp[e], om)
                       for e in range(E)])
    want = torch.autograd.grad(ref, (xp, Wp, bp), g)
    assert all(rel_to_max(a, r) < 1e-12 for a, r in zip(got, want))
    dW = torch.from_numpy(rng.standard_normal(W.shape))
    _, tangent = torch.func.vmap(
        lambda a, w, dw, c: torch.func.jvp(
            lambda ww: siren._SirenFn.apply(a, ww, c, om, launch), (w,), (dw,)),
        in_dims=(0 if x_batched else None, 0, 0, 0))(x, W, dW, b)
    want = torch.stack([torch.func.jvp(lambda ww: siren.siren_layer_plain(xs[e], ww, b[e], om),
                                       (W[e],), (dW[e],))[1] for e in range(E)])
    assert rel_to_max(tangent, want) < 1e-12


# ----------------------------------------------------------- the trainer


def _trainer(pair, members=3, **model):
    cfg = pair.tcfg
    cfg.training.ensemble_size = members
    t = cfg.training
    t.num_collocation_points, t.batch_size = 128, 64
    cfg.evaluation.num_points = 64
    return PDETrainer(pair.tmodel, pair.tpde, cfg)


@pytest.mark.parametrize("arch,pde_type,extra,want", [
    ("fourier", "burgers", {}, "kernel1"),
    ("fourier", "burgers", {"causal_eps": 1.0}, "kernel1"),
    ("fourier", "burgers", {"arch_params": {"trainable_features": True}}, "kernel1"),
    ("feedforward", "black_scholes", {}, "kernel1"),
    ("fourier", "burgers", {"arch_params": {"modified": True}}, "vmap"),
    ("resnet", "burgers", {}, "vmap"),
    ("fourier", "wave", {}, "vmap"),
    ("fourier", "cahn_hilliard", {}, "vmap"),
])
def test_member_path_is_fixed_at_construction(arch, pde_type, extra, want):
    """Which call computes an ensemble's residual terms is fixed when the
    trainer is built: one member-batched kernel-1 call where kernel 1 is
    attached, one vmap of the residual loss otherwise (the modified trunk,
    ResNet, temporal order 2, Cahn-Hilliard); one model has no member path."""
    pair = pde_pair(pde_type, arch=arch, hidden=(16, 16), mapping=8, **extra)
    trainer = _trainer(pair)
    assert trainer.member_path == want
    assert trainer.fused_kernel_active == (want == "kernel1")
    single = pde_pair(pde_type, arch=arch, hidden=(16, 16), mapping=8, **extra)
    assert _trainer(single, members=1).member_path is None


def test_inverse_ensemble_vmaps_its_members_coefficients():
    """Live coefficients (inverse mode) keep kernel 1 out of the residual
    term, as ``compute_loss`` gates it: the members vmap, each with its own
    coefficient, equal to each member's own residual term."""
    from pinnrl_tpu_torch.config import load_config
    from pinnrl_tpu_torch.models import PINNModel
    from pinnrl_tpu_torch.pdes import create_pde

    cfg = load_config(pde_type="burgers", architecture="fourier", device="cpu")
    cfg.model.hidden_dims, cfg.model.arch_params["mapping_size"] = [16, 16], 8
    cfg.training.mode, cfg.training.ensemble_size = "inverse", 2
    cfg.pde.trainable_parameters = ["nu"]
    trainer = PDETrainer(PINNModel(cfg), create_pde(cfg), cfg)
    assert trainer.coeffs and trainer.member_path == "vmap"
    params = trainer._stack_ensemble(0)
    trainer.coeffs = {k: torch.stack([v.detach(), 2.0 * v.detach()]) for k, v in
                      trainer.coeffs.items()}
    batches = [tuple(map(torch.from_numpy, points(70 + e, 64))) for e in range(2)]
    got = trainer._member_residual_losses(params, batches)
    for e, (x, t) in enumerate(batches):
        pm, cm = trainer._member(params, e)
        pde = trainer.pde
        want = pde._residual_loss(pde.compute_residual(trainer.model.apply, pm, x, t, cm), t)
        assert abs(float(got[e]) - float(want)) <= 1e-6 * abs(float(want)), e


def _old_ensemble_step(trainer, params, opt, gens, batch_size):
    """The per-member loop the member-batched step replaced: each member
    draws its batch, then its residual and BC/IC terms one member at a
    time."""
    for p in opt.params:
        p.grad = None
    weights = trainer.adaptive_weights.get_weights(trainer._aw_state)
    rows, total = [], 0.0
    for m, gen in enumerate(gens):
        pm, cm = trainer._member(params, m)
        x, t = trainer._sample(gen, batch_size, pm, cm)
        losses = trainer._loss_components(pm, x, t, gen, cm)
        total = total + losses["total"]
        rows.append(trainer._row(losses["total"], losses, weights))
    total.backward()
    opt.step()
    return torch.stack(rows).mean(dim=0)


def _old_val_loss(trainer, params, generator):
    x, t = trainer.pde.generate_collocation_points(generator, trainer.config.evaluation.num_points,
                                                   "uniform")
    start = generator.get_state()
    totals = []
    with torch.no_grad():
        for m in range(trainer.members):
            generator.set_state(start)
            pm, cm = trainer._member(params, m)
            totals.append(trainer._loss_components(pm, x, t, generator, cm)["total"])
    return float(torch.stack(totals).mean())


def _ensemble_pair(path):
    if path == "kernel1":
        return pde_pair("burgers", hidden=(16, 16), mapping=8, causal_eps=1.0)
    return pde_pair("burgers", hidden=(16, 16), mapping=8, arch_params={"modified": True})


@pytest.mark.parametrize("path", ["kernel1", "vmap"])
def test_ensemble_step_equals_the_per_member_loop(path):
    """One Adam step of 3 members through the member-batched residual call
    against the per-member loop on identically seeded generators: the same
    draws (the generators end in the same states), the same mean row, and
    the same Adam moments and parameters after the step."""
    trainer = _trainer(_ensemble_pair(path))
    assert trainer.member_path == path
    stacked = trainer._stack_ensemble(0)
    runs = []
    for step in (trainer._ensemble_step, lambda *a: _old_ensemble_step(trainer, *a)):
        params = {k: v.detach().clone().requires_grad_(True) for k, v in stacked.items()}
        opt = trainer._make_adam(2, 1, list(params.values()))
        gens = [torch.Generator().manual_seed(50 + m) for m in range(3)]
        row = step(params, opt, gens, 64)
        runs.append((row.detach(), params, opt, [g.get_state() for g in gens]))
    (row, params, opt, states), (row0, params0, opt0, states0) = runs
    assert all(torch.equal(a, b) for a, b in zip(states, states0))
    assert rel_to_max(row, row0) < 1e-6
    for k in params:
        assert rel_to_max(opt.optimizer.state[params[k]]["exp_avg"],
                          opt0.optimizer.state[params0[k]]["exp_avg"]) < 1e-5, k
        assert rel_to_max(params[k].detach(), params0[k].detach()) < 1e-6, k


@pytest.mark.parametrize("path", ["kernel1", "vmap"])
def test_ensemble_validation_equals_the_per_member_loop(path):
    """An ensemble's validation on one shared batch (every member's residual
    term from one call) against the per-member loop, on identically seeded
    generators: the same value and the same draws."""
    trainer = _trainer(_ensemble_pair(path))
    params = trainer._stack_ensemble(0)
    gen, gen0 = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    got = trainer._val_loss(params, gen)
    want = _old_val_loss(trainer, params, gen0)
    assert abs(got - want) <= 1e-6 * abs(want)
    assert torch.equal(gen.get_state(), gen0.get_state())


def test_siren_ensemble_vmapped_residual_matches_jax_vmapped_loss():
    """A SIREN ensemble (kernel 1 does not take it): the trainer's vmapped
    residual terms of 2 members and their gradients against JAX's residual
    loss vmapped over the same stacked members and batches."""
    pairs = [siren_kdv_pair(hidden=(24, 24), seed=e) for e in range(2)]
    trainer = _trainer(copy.copy(pairs[0]), members=2)
    assert trainer.member_path == "vmap"
    dom = dict(domain=tuple(map(tuple, pairs[0].tcfg.pde.domain)),
               time_domain=tuple(pairs[0].tcfg.pde.time_domain))
    xs, ts = zip(*[points(60 + e, 64, **dom) for e in range(2)])
    jpde, jmodel = pairs[0].jpde, pairs[0].jmodel

    def jloss(p, x, t):
        return jpde._residual_loss(jpde.compute_residual(jmodel.apply, p, x, t), t)

    l_j, g_j = jax.vmap(jax.value_and_grad(jloss))(_stack_jax(pairs), jnp.asarray(np.stack(xs)),
                                                   jnp.asarray(np.stack(ts)))
    P = {k: v.requires_grad_(True) for k, v in _stack_torch(pairs).items()}
    trainer.coeffs = {}
    loss = trainer._member_residual_losses(P, [(torch.from_numpy(x), torch.from_numpy(t))
                                               for x, t in zip(xs, ts)])
    grads = dict(zip(P, torch.autograd.grad(loss.sum(), list(P.values()))))
    for e in range(2):
        assert abs(float(loss[e]) - float(l_j[e])) / abs(float(l_j[e])) < 1e-4, e
        g_e = _member_tree(g_j, e)
        for name, g in grads.items():
            module, leaf = name.split(".")
            ref = np.asarray(g_e[module]["kernel" if leaf == "weight" else leaf])
            got = g[e].numpy().T if leaf == "weight" else g[e].numpy()
            assert rel_to_max(got, ref) < 1e-3, (e, name)
