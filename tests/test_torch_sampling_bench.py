"""The port's sampling-strategy harness (``benchmarks/sampling.py``) against
``pinnrl_tpu.benchmarks.sampling``.

The JAX harness's step is a closure inside ``_train_one`` (sampling.py:
201-241); the tests compose it from the same public pieces (the PDE's
``compute_loss`` and ``residual_score``, the optax chain, the agent's
``compute_reward`` / ``update`` / ``update_epsilon``) on bridged parameters,
with JAX's draws injected into the port: the collocation points, the BC and
IC points, and the agent's TD batch indices.

Tolerances (each with its reason):
- configs equal field by field (the device aside);
- the validation grid and ``_evaluate`` (the port's ``_errors``) 1e-6
  relative: float32 linspace and the same network;
- one step's loss 1e-5 relative; its clipped gradients, the updated
  parameters and the agent's weights after its Adam step 1e-4 (relative to
  max for the gradients, absolute for parameters: float32 sums in another
  order, through one Adam step);
- the residual feature on JAX's residuals and the improve reward 1e-6
  relative to max (the first step's reward exactly 0); the feature through
  the port's own residuals 2e-6: the bundle's float32 residuals agree to
  ~1e-6, and the largest feature (~4) is then two ulps off;
- phases, epoch splits and CSV text equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_parity_helpers import inject_points, jax_bc_ic_points, points, rel_to_max

import pinnrl_tpu.benchmarks.sampling as jax_sampling
from pinnrl_tpu.pdes import create_pde as jax_create_pde
from pinnrl_tpu.rl import RLAgent as JaxRLAgent
from pinnrl_tpu_torch.benchmarks import cli
from pinnrl_tpu_torch.benchmarks import sampling
from pinnrl_tpu_torch.models.bridge import dqn_params_from_flax, params_from_flax

LOSS_TOL = 1e-5
STEP_TOL = 1e-4
FEATURE_TOL = 1e-6
FEATURE_PATH_TOL = 2e-6
GRID_TOL = 1e-6
CASES = [("uniform", "coord"), ("stratified", "coord"), ("residual_based", "coord"),
         ("adaptive", "coord"), ("adaptive", "resfeat"), ("adaptive", "improve"),
         ("adaptive", "resfeat_improve")]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("pde", sampling.PDE_CHOICES)
def test_benchmark_model_config_equals_jax(pde):
    jcfg, jmodel = jax_sampling._build_benchmark_model(pde, 0)
    tcfg, tmodel = sampling._build_benchmark_model(pde, 0, device="cpu")
    a, b = jcfg.to_dict(), tcfg.to_dict()
    assert b.pop("device") == "cpu"
    a.pop("device")
    assert a == b
    assert {k: tuple(v.shape) for k, v in params_from_flax(_np(jmodel.params)).items()} == {
        k: tuple(v.shape) for k, v in tmodel.params.items()}


class _Pair:
    """JAX's harness pieces (model, PDE, optax chain, agent) and the port's
    ``_Run`` on the same parameters."""

    def __init__(self, strategy="uniform", variant="coord", pde="burgers", epochs=10, lr=2e-3,
                 batch=64):
        self.jcfg, self.jmodel = jax_sampling._build_benchmark_model(pde, 0)
        self.jcfg.training.collocation_distribution = strategy
        self.jpde = jax_create_pde(self.jcfg)
        self.jpde.attach_fast_bundle(self.jmodel)
        self.run = sampling._Run(pde, strategy, epochs, batch, lr, 0, rar=None,
                                 rl_variant=variant, device="cpu")
        self.run.model.module.load_state_dict(
            params_from_flax(_np(self.jmodel.params), _np(self.jmodel.constants)), strict=True)
        self.opt = optax.chain(optax.clip_by_global_norm(1.0),
                               optax.adam(optax.cosine_decay_schedule(lr, epochs)))
        self.resfeat, self.improve = "resfeat" in variant, "improve" in variant
        self.jagent = self.jrl = None
        if strategy == "adaptive":
            self.jagent = JaxRLAgent(state_dim=2 + self.resfeat, hidden_dim=64, memory_size=4096,
                                     batch_size=64)
            self.jrl = self.jagent.init(jax.random.PRNGKey(1))
            with torch.no_grad():
                for tag in ("policy_params", "target_params"):
                    for k, v in dqn_params_from_flax(_np(getattr(self.jrl, tag))).items():
                        getattr(self.run.rl_state, tag)[k].copy_(v)

    def res_feature(self, p, grid):
        """JAX's ``_res_feature`` (sampling.py:161-167)."""
        r = self.jpde.residual_score(self.jmodel.apply, p, grid[:, :-1], grid[:, -1:]).reshape(-1)
        r = jnp.abs(r)
        return jnp.log1p(r / (jnp.mean(r) + 1e-12))[:, None]


def _jax_step(pair, params, opt_state, rl_st, prev_loss, x, t, k_l, k_rl):
    """One JAX harness step on the points (x, t) (sampling.py:201-241)."""
    pde, model, agent = pair.jpde, pair.jmodel, pair.jagent

    def loss_fn(p):
        losses = pde.compute_loss(model.apply, p, x, t, key=k_l)
        return losses["total"], losses

    (loss, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    updates, opt_state = pair.opt.update(grads, opt_state, params)
    params = optax.apply_updates(params, updates)
    reward = None
    if agent is not None:
        n = min(128, x.shape[0])
        res = pde.residual_score(model.apply, params, x[:n], t[:n])
        pts = jnp.concatenate([x[:n], t[:n]], axis=-1)
        if pair.resfeat:
            pts = jnp.concatenate([pts, pair.res_feature(params, pts)], -1)
        if pair.improve:
            rel = jnp.clip((prev_loss - loss) / (prev_loss + 1e-9), -1.0, 1.0)
            reward = jnp.broadcast_to(jnp.where(prev_loss > 0, rel, 0.0), (n,))
        else:
            reward = agent.compute_reward(res, losses["boundary"], losses["initial"])
        rl_st = agent.update(rl_st, pts, reward, pts, jnp.ones(()), k_rl)
        rl_st = agent.update_epsilon(rl_st)
    return params, opt_state, rl_st, loss, grads, reward


@pytest.mark.parametrize("strategy,variant", CASES)
def test_two_steps_on_injected_points_match_jax(monkeypatch, strategy, variant):
    """Two steps (the improve reward's first step and one with a previous
    loss): loss, clipped gradients, parameters, reward, buffer, the agent's
    weights after its Adam step, epsilon."""
    pair = _Pair(strategy, variant)
    run = pair.run
    params, opt_state = pair.jmodel.params, pair.opt.init(pair.jmodel.params)
    rl_st, prev = pair.jrl, jnp.asarray(0.0)
    n = 64
    for step in range(2):
        xs, ts = points(20 + step, n, domain=run.pde.domain, time_domain=run.pde.time_domain)
        key = jax.random.PRNGKey(100 + step)
        k_l, k_rl = jax.random.split(key)
        if pair.jagent is not None:  # the TD indices JAX's update draws
            size = min(int(rl_st.size) + min(128, n), 4096)
            jidx = np.array(jax.random.randint(k_rl, (64,), 0, max(size, 1)))
            monkeypatch.setattr(run.agent, "_train",
                                lambda st, gen, i=jidx: run.agent._train_on(st, torch.from_numpy(i).long()))
        params, opt_state, rl_st, loss, grads, reward = _jax_step(
            pair, params, opt_state, rl_st, prev, jnp.asarray(xs), jnp.asarray(ts), k_l, k_rl)
        prev = loss

        inject_points(monkeypatch, run.pde, *jax_bc_ic_points(pair.jpde, k_l, n))
        got = run.step_on(run.pde, torch.from_numpy(xs), torch.from_numpy(ts), None)
        assert abs(float(got) - float(loss)) / abs(float(loss)) < LOSS_TOL, step
        scale = min(1.0, 1.0 / float(optax.global_norm(grads)))
        ref_g = params_from_flax(_np(jax.tree_util.tree_map(lambda g: g * scale, grads)))
        for name, p in run.params.items():
            assert rel_to_max(p.grad, ref_g[name]) < STEP_TOL, (step, name)
        ref_p = params_from_flax(_np(params))
        for name, p in run.params.items():
            assert float((p.detach() - ref_p[name]).abs().max()) < STEP_TOL, (step, name)
        if pair.jagent is None:
            assert run.agent is None
            continue
        st = run.rl_state
        assert (st.ptr, st.size, st.steps) == (int(rl_st.ptr), int(rl_st.size), int(rl_st.steps))
        m = min(128, n)
        assert rel_to_max(st.buf_reward[:m * (step + 1)],
                          np.asarray(rl_st.buf_reward)[:m * (step + 1)]) < STEP_TOL
        assert rel_to_max(st.buf_state[:m * (step + 1)],
                          np.asarray(rl_st.buf_state)[:m * (step + 1)]) < STEP_TOL
        if pair.improve and step == 0:
            assert float(st.buf_reward[:m].abs().max()) == 0.0 == float(jnp.abs(reward).max())
        ref_q = dqn_params_from_flax(_np(rl_st.policy_params))
        for name, p in st.policy_params.items():
            assert float((p.detach() - ref_q[name]).abs().max()) < STEP_TOL, (step, name)
        assert abs(float(st.epsilon) - float(rl_st.epsilon)) < 1e-7


@pytest.mark.parametrize("variant", ["resfeat", "resfeat_improve"])
def test_residual_feature_and_featured_scores_match_jax(monkeypatch, variant):
    """The grid feature log1p(|r| / mean|r|) on the 100 x 100 grid (on JAX's
    residuals, then on the port's own), and the agent's scores on the
    featured grid from JAX's draws."""
    from pinnrl_tpu_torch.sampling import make_grid

    pair = _Pair("adaptive", variant)
    run = pair.run
    grid = make_grid(run.pde.domain, run.pde.time_domain, 100, device="cpu")
    jgrid = jnp.asarray(grid.numpy())
    ref = np.asarray(pair.res_feature(pair.jmodel.params, jgrid))
    with torch.no_grad():
        got = run.res_feature(run.params, grid)
    assert got.shape == (10000, 1) and rel_to_max(got, ref) < FEATURE_PATH_TOL
    jres = np.array(pair.jpde.residual_score(pair.jmodel.apply, pair.jmodel.params,
                                             jgrid[:, :-1], jgrid[:, -1:]))
    with monkeypatch.context() as m:
        m.setattr(run.pde, "residual_score", lambda *a: torch.from_numpy(jres))
        assert rel_to_max(run.res_feature(run.params, grid), ref) < FEATURE_TOL
    k_bern, k_rand = jax.random.split(jax.random.PRNGKey(3))
    featured = jnp.concatenate([jnp.asarray(grid.numpy()), jnp.asarray(ref)], -1)
    jrl = pair.jrl.replace(epsilon=jnp.asarray(0.0))
    jscores = pair.jagent.select_action(jrl, featured, jax.random.PRNGKey(3))
    run.rl_state.epsilon.zero_()
    scores = run.agent._select(run.rl_state, torch.cat([grid, got], -1),
                               torch.from_numpy(np.array(jax.random.uniform(k_bern))),
                               torch.from_numpy(np.array(jax.random.uniform(k_rand, (10000,)))))
    assert rel_to_max(scores, jscores) < 1e-5


@pytest.mark.parametrize("prev,loss", [(0.0, 3.7), (5.0, 3.7), (1.0, 4.0), (2.0, 1e-3),
                                       (1e-12, 1.0)])
def test_improve_reward_matches_jax(prev, loss):
    """rel = clip((prev - loss) / (prev + 1e-9), -1, 1), 0 while prev is the
    first step's 0, shared by the pushed points."""
    pair = _Pair("adaptive", "improve")
    run = pair.run
    run.prev_loss = torch.tensor(prev, dtype=torch.float32)
    xs, ts = points(7, 200, domain=run.pde.domain, time_domain=run.pde.time_domain)
    pts, reward = run.reward(run.pde, None, torch.from_numpy(xs), torch.from_numpy(ts),
                             torch.tensor(loss, dtype=torch.float32))
    p, lo = jnp.asarray(prev, jnp.float32), jnp.asarray(loss, jnp.float32)
    ref = jnp.broadcast_to(jnp.where(p > 0, jnp.clip((p - lo) / (p + 1e-9), -1.0, 1.0), 0.0), (128,))
    assert pts.shape == (128, 2) and reward.shape == (128,)
    assert rel_to_max(reward, ref) < FEATURE_TOL if prev else float(reward.abs().max()) == 0.0


def test_validation_grid_and_evaluate_match_jax():
    pair = _Pair()
    run = pair.run
    jx, jt = jax_sampling._fixed_validation_grid(pair.jpde)
    tx, tt = sampling._fixed_validation_grid(run.pde)
    assert tx.shape == (4096, 1) and rel_to_max(tx, jx) < GRID_TOL and rel_to_max(tt, jt) < GRID_TOL
    ref = jax_sampling._evaluate(pair.jpde, pair.jmodel, pair.jmodel.params, jx, jt)
    got = dict(zip(("l2", "rel_l2"), sampling._errors(run.pde, run.model, run.params, tx,
                                                      tt).tolist()))
    for k in ("l2", "rel_l2"):
        assert abs(got[k] - ref[k]) / abs(ref[k]) < GRID_TOL, k


@pytest.mark.parametrize("epochs,windows", [(10, 0), (10, 1), (10, 3), (7, 7), (100, 6)])
def test_windows_split_and_phase_domains_match_jax(monkeypatch, epochs, windows):
    """The epoch split of sampling.py:245-247 and each phase's time domain
    (recorded from JAX's _phase_pde through its create_pde)."""
    phases = max(windows, 1)
    want = [epochs // phases] * phases
    want[-1] += epochs - sum(want)
    assert sampling._phase_epochs(epochs, windows) == want
    run = sampling._Run("burgers", "uniform", epochs, 32, 2e-3, 0, device="cpu")
    got = [run.phase_pde(w, phases).time_domain for w in range(phases)]
    t_lo, t_hi = run.pde.time_domain
    assert got[-1] == run.pde.time_domain
    assert got == [(t_lo, t_lo + (w + 1) / phases * (t_hi - t_lo)) for w in range(phases)]


def test_jax_phase_domains_as_recorded():
    """JAX's own phase PDEs for windows=3 (its create_pde recorded): the
    same horizons as the port's."""
    seen = []
    real = jax_sampling.create_pde

    def recording(cfg):
        seen.append(tuple(cfg.pde.time_domain))
        return real(cfg)

    jax_sampling.create_pde = recording
    try:
        jax_sampling.run_sampling_benchmark(pde="heat", strategies=["uniform"], epochs=3,
                                            batch=16, windows=3)
    finally:
        jax_sampling.create_pde = real
    run = sampling._Run("heat", "uniform", 3, 16, 2e-3, 0, device="cpu")
    assert seen[1:] == [tuple(run.phase_pde(w, 3).time_domain) for w in range(2)]


def test_more_windows_than_epochs_is_refused_before_training(monkeypatch):
    monkeypatch.setattr(sampling, "_train_one", lambda *a, **k: pytest.fail("trained"))
    with pytest.raises(ValueError, match="windows > epochs"):
        sampling.run_sampling_benchmark(pde="burgers", epochs=2, windows=3, device="cpu")


def test_invalid_pde_strategy_and_variant_raise_as_jax():
    for kw, match in (({"pde": "maxwell"}, "pde must be one of"),
                      ({"strategies": ["sobol"]}, "Unknown strategy"),
                      ({"strategies": ["adaptive[bogus]"]}, "Unknown adaptive variant")):
        with pytest.raises(ValueError, match=match):
            sampling.run_sampling_benchmark(epochs=2, batch=16, device="cpu", **kw)
        with pytest.raises(ValueError, match=match):
            jax_sampling.run_sampling_benchmark(epochs=2, batch=16, **kw)


def test_results_to_csv_equals_jax():
    rows = [("burgers", "fourier", "uniform", 1.5e-3, 2.25e-4, 3.09e-3, 12.3456, 95123.7, 10000, 0),
            ("heat", "resnet", "adaptive[resfeat]", float("nan"), 1e30, 0.0, 0.0004, 1e-9, 2, 19)]
    got = sampling.results_to_csv([sampling.SamplingResult(*r) for r in rows])
    ref = jax_sampling.results_to_csv([jax_sampling.SamplingResult(*r) for r in rows])
    assert got == ref and got.startswith(
        "pde,architecture,strategy,final_loss,l2_error,rel_l2,wall_time_s,points_per_sec,epochs,seed\n")


def test_small_cpu_runs_give_finite_rows(tmp_path, capsys):
    """Every strategy and a variant, then a windows=2 curriculum, then the
    CLI with its CSV: finite rows, labels and epochs."""
    rs = sampling.run_sampling_benchmark(
        pde="burgers", strategies=[*sampling.STRATEGIES, "adaptive[resfeat_improve]"],
        epochs=4, batch=32, device="cpu")
    assert [r.strategy for r in rs] == [*sampling.STRATEGIES, "adaptive[resfeat_improve]"]
    for r in rs:
        assert r.epochs == 4 and r.points_per_sec > 0
        assert all(np.isfinite(v) for v in (r.final_loss, r.l2_error, r.rel_l2))
    rs = sampling.run_sampling_benchmark(pde="heat", strategies=["residual_based", "adaptive[improve]"],
                                         epochs=4, batch=16, windows=2, device="cpu")
    assert all(np.isfinite(r.final_loss) and np.isfinite(r.rel_l2) for r in rs)
    out = tmp_path / "s.csv"
    for seed in (0, 1):
        assert cli.main(["sampling", "--pde", "kdv", "--strategies", "uniform", "--epochs", "2",
                         "--batch", "16", "--seed", str(seed), "--device", "cpu",
                         "--csv", str(out)]) == 0
    assert "pts/sec" in capsys.readouterr().out
    lines = out.read_text().strip().split("\n")
    assert lines[0].startswith("pde,architecture,strategy") and len(lines) == 3
    assert [ln.split(",")[-1] for ln in lines[1:]] == ["0", "1"]
