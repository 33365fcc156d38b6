"""The trainer's L-BFGS phase and the adam -> L-BFGS switch against
pinnrl_tpu's ``PDETrainer.train``.

- The loop's structure (switch epoch, phase-1 schedule, steps per epoch,
  L-BFGS batch size, the epochs that validate, the ``learning_rate``
  history) against JAX's own loop, run with its epoch and validation
  functions replaced by recorders; the port runs with its steps and
  validation replaced the same way. Schedules: 1e-6 relative (optax
  evaluates them in float32), plus its rounding, 2.4e-10 absolute.
- A real run at CPU size: the L-BFGS objective (batch and BC/IC points) is
  the same at every evaluation of a round and redrawn at
  ``lbfgs.resample_every`` with the optimizer restarted; the loss does not
  rise within a round (beyond optax's approximate-decrease slack,
  approx_dec_rtol 1e-6 of the loss).
- Pure ``optimizer="lbfgs"`` and ``phase2_optimizer="adam"``.
"""

import math

import numpy as np
import optax
import pytest
import torch
from torch_parity_helpers import _pair, burgers_pair

from pinnrl_tpu.benchmarks import convergence as jax_conv
from pinnrl_tpu.training import PDETrainer as JaxTrainer
from pinnrl_tpu_torch.benchmarks import convergence
from pinnrl_tpu_torch.training import PDETrainer
from pinnrl_tpu_torch.training.lbfgs import LBFGS
from pinnrl_tpu_torch.training.trainer import AdamStep

APPROX_DEC_RTOL = 1e-6  # optax's approximate-decrease slack


def _sched_close(a: float, b: float) -> bool:
    return math.isclose(a, b, rel_tol=1e-6, abs_tol=2.4e-10)


def _heat_recipe_pair(epochs: int, points: int = 64, batch: int = 32):
    """The heat recipe (adam_lbfgs, switch ratio 0.4) in both packages, cut
    to CPU size."""
    cfgs = [jax_conv.build_recipe_config("heat", epochs=epochs),
            convergence.build_recipe_config("heat", epochs=epochs, device="cpu")]
    for cfg in cfgs:
        cfg.model.hidden_dims = [8, 8]
        cfg.model.arch_params["mapping_size"] = 4
        t = cfg.training
        assert t.optimizer == "adam_lbfgs" and t.adam_lbfgs_switch_ratio == 0.4
        t.num_collocation_points, t.batch_size = points, batch
        t.num_boundary_points = t.num_initial_points = 16
    return _pair(*cfgs, seed=0, jitter_ln=False)


def _jax_loop(monkeypatch, pair):
    """JAX's train() with recorders for its epoch and validation functions:
    (the epochs that validated, the epoch functions built as (batch, steps
    per epoch, lbfgs), history, trainer)."""
    jtr = JaxTrainer(pair.jmodel, pair.jpde, pair.jcfg)
    built, vals = [], []

    def build_epoch_fn(optimizer, batch_size, steps_per_epoch, lbfgs, f64=None):
        built.append((batch_size, steps_per_epoch, lbfgs))

        def epoch_fn(state, chunk):
            z = np.zeros(chunk, np.float32)
            metrics = {k: z for k in ("total", "residual", "boundary", "initial", "smoothness",
                                      "data")}
            metrics["weights"] = np.zeros((chunk, 3), np.float32)
            metrics["pts"] = np.zeros((chunk, 64, 2), np.float32)
            return state, metrics
        return epoch_fn

    def build_val_fn(num_points=1000):
        def val_fn(params, key):
            vals.append(len(jtr.history["train_loss"]))
            return 1.0
        return val_fn

    monkeypatch.setattr(jtr, "_build_epoch_fn", build_epoch_fn)
    monkeypatch.setattr(jtr, "_build_val_fn", build_val_fn)
    res = jtr.train(seed=0)
    return vals, built, res["history"], jtr


def _port_loop(monkeypatch, pair):
    """The port's train() with its steps and validation replaced by
    recorders: (validated epochs, Adam steps as (batch, optimizer), L-BFGS
    steps as (batch size, optimizer, its iteration count), history,
    trainer)."""
    ttr = PDETrainer(pair.tmodel, pair.tpde, pair.tcfg)
    adam, lbfgs, vals = [], [], []
    zeros = torch.zeros(6)

    def step(params, opt, generator, batch_size):
        adam.append((batch_size, opt))
        return zeros

    def lbfgs_step(params, opt, batch, generator):
        lbfgs.append((batch[0].shape[0], opt, opt.count))
        opt.count += 1
        return zeros

    def val_loss(params, generator):
        vals.append(len(ttr.history["train_loss"]))
        return 1.0

    monkeypatch.setattr(ttr, "_step", step)
    monkeypatch.setattr(ttr, "_lbfgs_step", lbfgs_step)
    monkeypatch.setattr(ttr, "_val_loss", val_loss)
    res = ttr.train(seed=0)
    return vals, adam, lbfgs, res["history"], ttr


@pytest.mark.parametrize("resample,lbfgs_batch", [(None, None), (400, 48)])
def test_phase_structure_matches_jax(monkeypatch, resample, lbfgs_batch):
    """The heat recipe's 3000 epochs: validation every 750 epochs, counted
    afresh from the switch at 1200 (and from each resample round)."""
    pair = _heat_recipe_pair(3000)
    for cfg in (pair.jcfg, pair.tcfg):
        cfg.training.validation_frequency = 750
        cfg.training.lbfgs.resample_every = resample
        cfg.training.lbfgs.batch_size = lbfgs_batch
    j_vals, built, j_hist, jtr = _jax_loop(monkeypatch, pair)
    t_vals, adam, lbfgs, t_hist, ttr = _port_loop(monkeypatch, pair)

    switch, spe, lbfgs_bs = 1200, 64 // 32, lbfgs_batch or 64
    if resample is None:
        assert j_vals == [750, 1200, 1950, 2700, 3000]
    assert t_vals == j_vals
    assert jtr.switch_epoch == ttr.switch_epoch == switch
    assert built == [(32, spe, False), (lbfgs_bs, 1, True)]
    # Phase 1: switch * spe Adam steps of one optimizer on the recipe's batch.
    assert len(adam) == switch * spe and {b for b, _ in adam} == {32}
    assert len({id(o) for _, o in adam}) == 1
    # Phase 2: one L-BFGS iteration per epoch on lbfgs_bs points; a round
    # restarts the optimizer.
    assert len(lbfgs) == 3000 - switch and {n for n, _, _ in lbfgs} == {lbfgs_bs}
    round_len = resample or 3000
    for k, (_, opt, count) in enumerate(lbfgs):
        assert count == k % round_len, k
        assert k == 0 or (opt is lbfgs[k - 1][1]) == (k % round_len != 0), k
    # The phase-1 cosine spans switch * spe steps, not the run.
    jsched = jtr._make_lr_schedule(switch, spe)
    opt = adam[0][1]
    assert isinstance(opt, AdamStep)
    for count in (0, 1, 600, 1199, 2399, 2400, 3000):
        assert _sched_close(opt.schedule(count), float(jsched(count))), count
    # learning_rate as JAX records it, the phase-1 schedule after the switch too.
    assert len(t_hist["learning_rate"]) == len(j_hist["learning_rate"]) == 3000
    for e, (a, b) in enumerate(zip(t_hist["learning_rate"], j_hist["learning_rate"])):
        assert _sched_close(a, b), e


def _spy_objective(monkeypatch, ttr):
    """Record, for every loss evaluation inside an L-BFGS step, (the step's
    index, x, t, the BC and IC points it drew); and each L-BFGS step's
    optimizer and its iteration count."""
    pde = ttr.pde
    evals, steps, drawn = [], [], []
    orig_b, orig_i = pde._sample_boundary_points, pde._sample_initial_points
    orig_loss, orig_step = ttr._loss_components, ttr._lbfgs_step

    def draw(orig):
        def spy(generator, n):
            out = orig(generator, n)
            drawn.append(out)
            return out
        return spy

    def loss_components(params, x, t, generator):
        drawn.clear()
        out = orig_loss(params, x, t, generator)
        if steps and steps[-1][2] is None:  # inside an L-BFGS step
            evals.append((len(steps) - 1, x, t, [tuple(d) for d in drawn]))
        return out

    def lbfgs_step(params, opt, batch, generator):
        steps.append([opt, opt.count, None])
        out = orig_step(params, opt, batch, generator)
        steps[-1][2] = "done"
        return out

    monkeypatch.setattr(pde, "_sample_boundary_points", draw(orig_b))
    monkeypatch.setattr(pde, "_sample_initial_points", draw(orig_i))
    monkeypatch.setattr(ttr, "_loss_components", loss_components)
    monkeypatch.setattr(ttr, "_lbfgs_step", lbfgs_step)
    return evals, steps


def _same(a, b) -> bool:
    return all(torch.equal(u, v) for u, v in zip(a, b))


def test_objective_is_fixed_within_a_round_and_redrawn_at_resample(monkeypatch):
    """Burgers, RAR in phase 1, 4 Adam epochs then 4 L-BFGS epochs in two
    rounds of 2."""
    pair = burgers_pair(hidden=(16, 16), mapping=8)
    t = pair.tcfg.training
    t.optimizer, t.adam_lbfgs_switch_ratio = "adam_lbfgs", 0.5
    t.collocation_distribution = "residual_based"
    t.num_collocation_points, t.batch_size, t.validation_frequency = 128, 64, 2
    t.lbfgs.resample_every = 2
    ttr = PDETrainer(pair.tmodel, pair.tpde, pair.tcfg)
    evals, steps = _spy_objective(monkeypatch, ttr)
    res = ttr.train(num_epochs=8, seed=0)
    assert ttr.switch_epoch == 4 and len(steps) == 4
    assert [count for _, count, _ in steps] == [0, 1, 0, 1]
    assert steps[0][0] is steps[1][0] and steps[2][0] is steps[3][0] and steps[1][0] is not steps[2][0]
    assert len(evals) >= 8 and {k for k, *_ in evals} == {0, 1, 2, 3}
    rounds = [[e for e in evals if e[0] // 2 == r] for r in (0, 1)]
    for r in rounds:
        _, x0, t0, bcic0 = r[0]
        assert x0.shape == (128, 1) and len(bcic0) == 2
        for _, x, tt, bcic in r[1:]:
            assert torch.equal(x, x0) and torch.equal(tt, t0)
            assert all(_same(a, b) for a, b in zip(bcic, bcic0))
    (_, xa, _, bca), (_, xb, _, bcb) = rounds[0][0], rounds[1][0]
    assert not torch.equal(xa, xb) and not _same(bca[0], bcb[0]) and not _same(bca[1], bcb[1])
    losses = res["history"]["train_loss"]
    assert all(np.isfinite(losses))
    for r in (slice(4, 6), slice(6, 8)):  # each round's epochs
        lr = losses[r]
        assert lr[1] <= lr[0] + APPROX_DEC_RTOL * abs(lr[0]), lr


def test_the_same_seed_gives_the_same_run_and_another_seed_another_objective():
    def run(seed):
        pair = burgers_pair(hidden=(16, 16), mapping=8)
        t = pair.tcfg.training
        t.optimizer, t.num_collocation_points, t.batch_size = "lbfgs", 64, 64
        ttr = PDETrainer(pair.tmodel, pair.tpde, pair.tcfg)
        return ttr.train(num_epochs=3, seed=seed)["history"]["train_loss"]

    a, b, c = run(0), run(0), run(1)
    assert a == b and a != c
    assert a[2] <= a[1] + APPROX_DEC_RTOL * abs(a[1]) and a[1] <= a[0] + APPROX_DEC_RTOL * abs(a[0])


def test_pure_lbfgs_runs_num_points_over_its_batch_iterations_per_epoch(monkeypatch):
    pair = burgers_pair(hidden=(16, 16), mapping=8)
    t = pair.tcfg.training
    t.optimizer, t.num_collocation_points, t.batch_size = "lbfgs", 128, 128
    t.lbfgs.batch_size = 64  # two iterations per epoch on one fixed batch of 64
    ttr = PDETrainer(pair.tmodel, pair.tpde, pair.tcfg)
    monkeypatch.setattr(ttr, "_step", lambda *a: pytest.fail("an Adam step in pure L-BFGS"))
    evals, steps = _spy_objective(monkeypatch, ttr)
    res = ttr.train(num_epochs=2, seed=0)
    assert ttr.switch_epoch is None and len(steps) == 4
    assert [count for _, count, _ in steps] == [0, 1, 2, 3]
    assert len({id(o) for o, _, _ in steps}) == 1
    assert {x.shape[0] for _, x, _, _ in evals} == {64}
    assert ttr._final_state["opt_state"]["count"] == 4
    losses = res["history"]["train_loss"]
    assert len(losses) == 2 and losses[1] < losses[0]


def test_phase2_adam_takes_fresh_batches_on_a_fresh_cosine(monkeypatch):
    pair = burgers_pair(hidden=(16, 16), mapping=8)
    t = pair.tcfg.training
    t.optimizer, t.adam_lbfgs_switch_ratio, t.phase2_optimizer = "adam_lbfgs", 0.5, "adam"
    t.num_collocation_points, t.batch_size = 128, 32
    t.lbfgs.batch_size = 96
    ttr = PDETrainer(pair.tmodel, pair.tpde, pair.tcfg)
    monkeypatch.setattr(ttr, "_lbfgs_step", lambda *a: pytest.fail("L-BFGS with phase2 adam"))
    calls = []
    orig = ttr._step

    def step(params, opt, generator, batch_size):
        calls.append((batch_size, opt))
        return orig(params, opt, generator, batch_size)

    monkeypatch.setattr(ttr, "_step", step)
    res = ttr.train(num_epochs=6, seed=0)
    assert ttr.switch_epoch == 3
    assert [b for b, _ in calls] == [32] * 12 + [96] * 3
    phase1, phase2 = calls[0][1], calls[-1][1]
    assert phase2 is not phase1 and all(o is phase2 for _, o in calls[12:])
    ref = optax.cosine_decay_schedule(t.phase2_learning_rate, 3)
    for count in range(5):
        assert _sched_close(phase2.schedule(count), float(ref(count))), count
    assert phase2.count == 3 and phase2.clip_norm == t.gradient_clip_norm
    assert all(np.isfinite(res["history"]["train_loss"]))


def test_lbfgs_counts_evaluations_and_host_reads():
    pair = burgers_pair(hidden=(16, 16), mapping=8)
    t = pair.tcfg.training
    t.optimizer, t.num_collocation_points = "lbfgs", 64
    ttr = PDETrainer(pair.tmodel, pair.tpde, pair.tcfg)
    e0, r0 = LBFGS.evaluations, LBFGS.host_reads
    ttr.train(num_epochs=2, seed=0)
    evals, reads = LBFGS.evaluations - e0, LBFGS.host_reads - r0
    assert evals >= 4  # one initial evaluation and >= 1 trial per iteration
    # The eager search reads ``active`` once per trial after the first, and
    # once more unless it ran out of steps: at most one read per evaluation.
    iterations = 2
    assert evals - 2 * iterations <= reads <= evals - iterations


def test_the_agent_updates_after_every_lbfgs_step_on_the_fixed_batch():
    """As JAX's scanned step: the agent's DQN update follows each L-BFGS
    iteration too, rewarded on the updated parameters at the round's batch,
    and its epsilon decays once per epoch of both phases."""
    from pinnrl_tpu_torch.rl import RLAgent

    pair = burgers_pair(hidden=(16, 16), mapping=8)
    t = pair.tcfg.training
    t.optimizer, t.adam_lbfgs_switch_ratio = "adam_lbfgs", 0.5
    t.num_collocation_points, t.batch_size = 128, 64
    agent = RLAgent(hidden_dim=16, memory_size=1024, batch_size=16, device="cpu")
    ttr = PDETrainer(pair.tmodel, pair.tpde, pair.tcfg, rl_agent=agent)
    pushed = []
    update = agent.update

    def spy(state, pts, reward, next_pts, done, generator):
        pushed.append(pts)
        return update(state, pts, reward, next_pts, done, generator)

    agent.update = spy
    res = ttr.train(num_epochs=4, seed=0)
    st = ttr._final_state["rl"]
    assert ttr.switch_epoch == 2 and st.steps == 2 * 2 + 2 and len(pushed) == 6
    assert all(p.shape == (64, 2) for p in pushed[:4]) and all(p.shape == (128, 2) for p in pushed[4:])
    assert torch.equal(pushed[4], pushed[5])  # the round's fixed batch
    assert float(st.epsilon) == pytest.approx(0.995**4, abs=1e-6)
    assert all(np.isfinite(res["history"]["train_loss"]))
