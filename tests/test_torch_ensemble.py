"""Deep ensembles (``training.ensemble_size`` E > 1) against the JAX
package on the CPU: its ``_validate_ensemble`` refusals with its messages;
one stacked Adam step of E members equal to E single-member JAX steps
(optax's clip_by_global_norm + adam) on the same parameters and batches,
each member clipped by its own norm; the mean prediction; the stacked
leaves through ``final_model.npz``; kernel 1 once per step and per
validation for all members (counted through its plain version here); E = 1
unchanged.

Tolerances: losses 1e-5 relative; Adam's moments after the step 1e-4
relative to each leaf's max (they are the clipped gradients: the
gradients' bound, tests/test_pallas_parity_tpu.py:152-155); the mean
prediction 1e-6 relative to max."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_parity_helpers import (_pair, jax_bc_ic_points, jax_grad_rels, pde_pair, points,
                                  rel_to_max)

from pinnrl_tpu.training import PDETrainer as JaxTrainer
from pinnrl_tpu_torch.models.bridge import params_from_flax, params_to_flax
from pinnrl_tpu_torch.ops.kernels import fused_step
from pinnrl_tpu_torch.training import PDETrainer

E = 3
N = 64
BURGERS = dict(domain=((-1.0, 1.0),), time_domain=(0.0, 1.0))


def _t(a):
    return torch.from_numpy(np.array(a))


def members(seeds=(0, 1, 2), **kw):
    """E bridged Burgers pairs (16x16 Fourier trunk, mapping 8) with the
    given init seeds; the port's config asks for E members."""
    pairs = [pde_pair("burgers", hidden=(16, 16), mapping=8, seed=s, **kw) for s in seeds]
    for p in pairs:
        p.tcfg.training.ensemble_size = len(seeds)
        p.jcfg.training.ensemble_size = len(seeds)
    return pairs


def stacked_torch(pairs):
    """The members' port parameters stacked on a leading axis, as leaves."""
    names = list(pairs[0].tmodel.params)
    return {k: torch.stack([p.tmodel.params[k].detach() for p in pairs]).requires_grad_(True)
            for k in names}


def stacked_jax(pairs):
    return jax.tree_util.tree_map(lambda *a: jnp.stack(a), *[p.jmodel.params for p in pairs])


# ----------------------------------------------------------------- refusals


@pytest.mark.parametrize("changes", [
    {"optimizer": "lbfgs"},
    {"optimizer": "adam_lbfgs"},
    {"adaptive": True},
    {"scheduler_type": "reduce_lr"},
    {"collocation_distribution": "adaptive"},
    {"optimizer": "lbfgs", "scheduler_type": "reduce_lr", "collocation_distribution": "adaptive"},
])
def test_validate_ensemble_refusals_match_jax(changes):
    pair = pde_pair("burgers", hidden=(8,), mapping=4)
    for cfg in (pair.jcfg, pair.tcfg):
        t = cfg.training
        t.ensemble_size = 2
        for k, v in changes.items():
            if k == "adaptive":
                t.adaptive_weights.enabled = v
            else:
                setattr(t, k, v)
    jt = JaxTrainer(pair.jmodel, pair.jpde, pair.jcfg)
    with pytest.raises(ValueError) as ref:
        jt._validate_ensemble()
    tt = PDETrainer(pair.tmodel, pair.tpde, pair.tcfg)
    with pytest.raises(ValueError) as got:
        tt._validate_ensemble()
    assert str(got.value) == str(ref.value)
    assert str(got.value).startswith("training.ensemble_size > 1 constraints violated: ")
    with pytest.raises(ValueError, match="constraints violated"):
        tt.train(num_epochs=1)  # before any step
    assert tt.history["train_loss"] == []


# --------------------------------------------------------- one stacked step


def test_one_stacked_adam_step_equals_single_member_jax_steps(monkeypatch):
    pairs = members()
    keys = [jax.random.PRNGKey(40 + m) for m in range(E)]
    batches = [points(10 + m, N, **BURGERS) for m in range(E)]
    jt = JaxTrainer(pairs[0].jmodel, pairs[0].jpde, pairs[0].jcfg)

    def jloss(m):
        def f(net):
            losses = jt._loss_components({"net": net, "coeffs": {}}, jnp.asarray(batches[m][0]),
                                         jnp.asarray(batches[m][1]), keys[m])
            return losses["total"], losses
        return f

    ref = [jax.value_and_grad(jloss(m), has_aux=True)(pairs[m].jmodel.params) for m in range(E)]
    norms = [float(optax.global_norm(g)) for _, g in ref]
    clip = float(np.median(norms))  # one member clipped, one not, one at the bound
    for p in pairs:
        p.jcfg.training.gradient_clip_norm = p.tcfg.training.gradient_clip_norm = clip
    jt = JaxTrainer(pairs[0].jmodel, pairs[0].jpde, pairs[0].jcfg)
    tx = jt._make_adam(10, 1)
    jstates = []
    for m in range(E):
        state = tx.init({"net": pairs[m].jmodel.params, "coeffs": {}})
        _, state = tx.update({"net": ref[m][1], "coeffs": {}}, state,
                             {"net": pairs[m].jmodel.params, "coeffs": {}})
        jstates.append(state)

    # The port: the members stacked, each member's batch and JAX's BC/IC draws.
    trainer = PDETrainer(pairs[0].tmodel, pairs[0].tpde, pairs[0].tcfg)
    assert trainer.members == E
    params = stacked_torch(pairs)
    trainer.model.ensemble = params
    trainer.coeffs = {}
    opt = trainer._make_adam(10, 1, list(params.values()))
    it = iter(batches)
    monkeypatch.setattr(trainer, "_sample", lambda gen, n, p, c=None: tuple(map(_t, next(it))))
    draws = [jax_bc_ic_points(pairs[0].jpde, k, N) for k in keys]
    bc, ic = iter(draws), iter(draws)
    tpde = trainer.pde
    monkeypatch.setattr(tpde, "_sample_boundary_points",
                        lambda gen, n: tuple(map(_t, next(bc)[:2])))
    monkeypatch.setattr(tpde, "_sample_initial_points", lambda gen, n: tuple(map(_t, next(ic)[2:])))
    row = trainer._ensemble_step(params, opt, [torch.Generator()] * E, N)
    totals = [float(r[0][0]) for r in ref]
    assert abs(float(row[0]) - np.mean(totals)) / abs(np.mean(totals)) < 1e-5
    assert sum(n > clip * (1 + 1e-6) for n in norms) == 1  # per-member clipping is exercised
    names = list(params)
    for m in range(E):
        for moment, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            want = optax.tree_utils.tree_get(jstates[m], moment)["net"]
            got = {k: opt.optimizer.state[params[k]][key][m] for k in names}
            for name, rel in jax_grad_rels(got, want).items():
                assert rel < 1e-4, (m, moment, name)
        # The parameters moved by Adam's first step: lr x (mu_hat / (sqrt(nu_hat) + eps)).
        assert all(not torch.equal(params[k][m], pairs[m].tmodel.params[k]) for k in names
                   if k.endswith("weight"))


# -------------------------------------------------------- mean prediction


def test_mean_prediction_matches_jax():
    pairs = members()
    z = np.concatenate(points(3, N, **BURGERS), axis=1)
    model = pairs[0].tmodel
    ref = np.asarray(pairs[0].jmodel.apply(stacked_jax(pairs), jnp.asarray(z)))
    params = stacked_torch(pairs)
    assert model.is_ensemble_params(params)
    with torch.no_grad():
        got = model.apply(params, _t(z))
        # Each member on the first model's fixed basis, as JAX's constants.
        each = [model.apply({k: v[m] for k, v in params.items()}, _t(z)) for m in range(E)]
    assert got.shape == ref.shape == (N, 1)
    assert rel_to_max(got, ref) < 1e-6
    assert torch.allclose(got, torch.stack(each).mean(0), rtol=0, atol=1e-7)


def test_stacked_leaves_save_and_load(tmp_path):
    pairs = members(arch_params={"trainable_features": True})
    model = pairs[0].tmodel
    model.ensemble = {k: v.detach() for k, v in stacked_torch(pairs).items()}
    path = tmp_path / "final_model.npz"
    model.save_state(str(path))
    with np.load(path) as data:
        assert data["params/Dense_0/kernel"].shape == (E, 16, 16)
        assert data["params/FourierFeatures_0/B"].shape == (E, 2, 8)
        # The flax layout of the stacked tree JAX saves.
        ref = jax.tree_util.tree_map(np.asarray, stacked_jax(pairs))
        np.testing.assert_array_equal(data["params/Dense_1/kernel"], ref["Dense_1"]["kernel"])
    other = pde_pair("burgers", hidden=(16, 16), mapping=8, seed=9,
                     arch_params={"trainable_features": True}).tmodel
    other.load_state(str(path))
    assert other.ensemble is not None and other.is_ensemble_params(other.params)
    for k, v in model.ensemble.items():
        assert torch.equal(other.ensemble[k], v), k
    back = params_from_flax(*[params_to_flax(model.ensemble, model.ensemble)[0]])
    assert all(torch.equal(back[k], v) for k, v in model.ensemble.items())


# -------------------------------------------------------- training


def test_ensemble_trains_with_one_kernel_1_call_per_step(monkeypatch, tmp_path):
    """Three members of the Burgers trunk at CPU size for 2 epochs of 2
    steps: the plain version of kernel 1 runs once per step and once per
    validation, each time on all members' stacked leaves; member means in
    the history; the final model predicts the member mean and saves stacked
    leaves."""
    pairs = members()
    cfg = pairs[0].tcfg
    t = cfg.training
    t.num_collocation_points, t.batch_size, t.validation_frequency = 128, 64, 1
    cfg.evaluation.num_points = 64
    trainer = PDETrainer(pairs[0].tmodel, pairs[0].tpde, cfg)
    assert trainer.fused_kernel_active and trainer.member_path == "kernel1"
    calls = []
    plain = fused_step.fused_residual_loss_plain
    monkeypatch.setattr(fused_step, "fused_residual_loss_plain",
                        lambda *a: calls.append(a[2]["Dense_0.weight"].shape) or plain(*a))
    res = trainer.train(num_epochs=2, seed=0, experiment_dir=str(tmp_path / "run"))
    hist = res["history"]
    assert res["status"] == "completed" and len(hist["train_loss"]) == 2
    assert all(np.isfinite(hist["train_loss"] + hist["val_loss"]))
    assert len(calls) == 2 * 2 + 2  # steps and validations, all members in each call
    assert all(s == (E, 16, 16) for s in calls)  # the stacked members' leaves each time
    model = trainer.model
    assert model.ensemble is not None and model.params["Dense_0.weight"].shape == (E, 16, 16)
    members_differ = not torch.equal(model.params["Dense_0.weight"][0],
                                     model.params["Dense_0.weight"][1])
    assert members_differ
    with np.load(tmp_path / "run" / "final_model.npz") as data:
        assert data["params/Dense_0/kernel"].shape == (E, 16, 16)
    assert len(trainer.points_history) == 2 and trainer.points_history[0].shape == (64, 2)


def test_one_member_is_unchanged():
    """ensemble_size 1 takes the one-model path: no member axis, and a run
    is reproducible bit for bit."""
    runs = []
    for _ in range(2):
        pair = pde_pair("burgers", hidden=(8, 8), mapping=4)
        cfg = pair.tcfg
        cfg.training.ensemble_size = 1
        cfg.training.num_collocation_points, cfg.training.batch_size = 64, 32
        cfg.evaluation.num_points = 32
        trainer = PDETrainer(pair.tmodel, pair.tpde, cfg)
        assert trainer.members == 0
        runs.append((trainer.train(num_epochs=2, seed=1)["history"]["train_loss"],
                     {k: v.detach().clone() for k, v in pair.tmodel.params.items()}))
        assert pair.tmodel.ensemble is None and pair.tmodel.params["Dense_0.weight"].ndim == 2
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(runs[0][1][k], runs[1][1][k]) for k in runs[0][1])


def test_ensemble_members_draw_their_own_inits_and_batches():
    """Member m's initial weights come from a generator seeded from (seed,
    m): two runs with one seed start alike, another seed starts elsewhere."""
    pair = pde_pair("burgers", hidden=(8,), mapping=4)
    pair.tcfg.training.ensemble_size = 2
    trainer = PDETrainer(pair.tmodel, pair.tpde, pair.tcfg)
    a, b, c = (trainer._stack_ensemble(s) for s in (0, 0, 1))
    for k in a:
        assert torch.equal(a[k], b[k]), k
        assert a[k].shape[0] == 2
    assert not torch.equal(a["Dense_0.weight"][0], a["Dense_0.weight"][1])
    assert not torch.equal(a["Dense_0.weight"], c["Dense_0.weight"])
    assert trainer._member_seeds(0, 0) != trainer._member_seeds(0, 1)
