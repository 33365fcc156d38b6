"""The harnesses' step programs on the CPU, where they run eagerly, one call
per step: what a captured step replays on the card.

- The sampling harness's step (``benchmarks/sampling.py``, ``_Run.program``)
  at the harness's own width (64x3, mapping 32; the DQN at hidden 64) at
  batch 32, under every strategy, ``adaptive[resfeat_improve]`` and a
  ``windows=2`` curriculum: every state tensor keeps its address from step
  to step (those are the buffers a replay reads); the warm-up and the
  return to the start leave every buffer, host count and generator state
  equal to a fresh run's, bit for bit; a whole run's row and final
  parameters equal those of a run built without the warm-up, bit for bit;
  the warm-up runs eagerly until the agent's train branch is fixed.
- The capture rule (``step_path``) for a harness: the graph on the card,
  eager on the CPU.
- The gridded operator harness's epoch (``operator.gridded_program``) on
  injected batch indices against optax's Adam on bridged weights: the loss
  1e-5 relative and the parameters 1e-4 absolute after 3 epochs (float32;
  the FFT against JAX's, as ``test_gridded_adam_step_matches_optax``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_parity_helpers  # noqa: F401  (pins torch's intra-op threads)

import pinnrl_tpu.models.fno_grid as jax_fno_grid
from pinnrl_tpu_torch.benchmarks import operator, sampling
from pinnrl_tpu_torch.models.bridge import params_from_flax
from pinnrl_tpu_torch.models.fno_grid import GridFNO2D
from pinnrl_tpu_torch.training.step_program import StepProgram, step_path
from pinnrl_tpu_torch.training.trainer import AdamStep, cosine_decay

BATCH, EPOCHS = 32, 4
# (strategy, windows)
CASES = [("uniform", 0), ("stratified", 0), ("residual_based", 0), ("adaptive", 0),
         ("adaptive[resfeat_improve]", 0), ("adaptive", 2)]
IDS = [f"{s}-w{w}" for s, w in CASES]
LOSS_TOL = 1e-5
STEP_TOL = 1e-4


def _run(strategy: str, epochs: int = EPOCHS) -> sampling._Run:
    ((base, variant),) = sampling.parse_strategies([strategy])
    return sampling._Run("burgers", base, epochs, BATCH, 2e-3, 0, rl_variant=variant,
                         device="cpu")


def _programs(run: sampling._Run, windows: int, epochs: int = EPOCHS):
    per_phase = sampling._phase_epochs(epochs, windows)
    phases = len(per_phase)
    return [run.program(run.phase_pde(w, phases), n) for w, n in enumerate(per_phase)], per_phase


def _host_counts(run: sampling._Run):
    return ([opt.count for opt in run.optimizers()],
            run.rl_state.filled if run.agent is not None else None)


def _row(monkeypatch, strategy: str, windows: int, warm: bool):
    """A run's row and a copy of its final network and agent (from
    ``_Run.read``); without the warm-up when ``warm`` is False."""
    seen = {}
    read = sampling._Run.read

    def reading(self, programs, per_phase):
        nets = [self.params] + ([self.rl_state.policy_params] if self.agent is not None else [])
        seen["params"] = [{k: v.detach().clone() for k, v in net.items()} for net in nets]
        seen["losses"] = torch.cat([p.rows[:n, 0] for p, n in zip(programs, per_phase)])
        return read(self, programs, per_phase)

    with monkeypatch.context() as m:
        m.setattr(sampling._Run, "read", reading)
        if not warm:
            m.setattr(sampling._Run, "warm_up", lambda self, programs: None)
        (r,) = sampling.run_sampling_benchmark(pde="burgers", strategies=[strategy],
                                               epochs=EPOCHS, batch=BATCH, windows=windows,
                                               device="cpu")
    return r, seen


@pytest.mark.parametrize("strategy,windows", CASES, ids=IDS)
def test_a_harness_step_keeps_every_state_tensor_in_place(strategy, windows):
    run = _run(strategy)
    programs, per_phase = _programs(run, windows)
    addresses = {}
    for w, (program, n_ep) in enumerate(zip(programs, per_phase)):
        program.start_chunk()
        for _ in range(n_ep):
            program.run()
            now = {k: v.data_ptr() for k, v in run.state().items()}
            now[f"rows/{w}"], now[f"slot/{w}"] = program.rows.data_ptr(), program.slot.data_ptr()
            for k, v in now.items():
                assert addresses.setdefault(k, v) == v, k
    # The network, both Adams (moments and step counts), prev_loss and, with
    # the agent, its two networks, buffers and counters.
    assert len(addresses) > (60 if strategy.startswith("adaptive") else 20)


@pytest.mark.parametrize("strategy,windows", CASES, ids=IDS)
def test_the_warm_up_returns_the_run_to_a_fresh_runs_state(strategy, windows):
    run = _run(strategy)
    programs, _ = _programs(run, windows)
    run.warm_up(programs)
    assert all(p.eager_steps >= 1 and int(p.slot) == 0 for p in programs)
    fresh = _run(strategy)
    got, want = run.state(), fresh.state()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    # Adam's state, made at the warm-up's first step: a fresh Adam's zeros.
    extra = set(got) - set(want)
    assert extra and all(k.startswith(("adam/", "rl/adam/")) for k in extra)
    assert all(not got[k].any() for k in extra)
    assert _host_counts(run) == _host_counts(fresh)
    assert torch.equal(run.gen.get_state(), fresh.gen.get_state())


@pytest.mark.parametrize("strategy,windows", CASES, ids=IDS)
def test_a_run_equals_a_run_built_without_the_warm_up(monkeypatch, strategy, windows):
    r, seen = _row(monkeypatch, strategy, windows, warm=True)
    r0, seen0 = _row(monkeypatch, strategy, windows, warm=False)
    assert (r.final_loss, r.l2_error, r.rel_l2) == (r0.final_loss, r0.l2_error, r0.rel_l2)
    assert np.isfinite(r.final_loss) and r.final_loss == float(seen["losses"][-1])
    assert torch.equal(seen["losses"], seen0["losses"])
    for net, net0 in zip(seen["params"], seen0["params"]):
        assert all(torch.equal(net[k], net0[k]) for k in net)


@pytest.mark.parametrize("strategy,want", [("uniform", 1), ("adaptive", 2)])
def test_the_warm_up_runs_eagerly_until_the_agents_branch_is_fixed(strategy, want):
    """The agent trains once its buffer holds a batch (64): at batch 32 the
    second push fills it, so the warm-up takes two eager steps."""
    run = _run(strategy)
    (program,), _ = _programs(run, 0)
    assert isinstance(program, StepProgram) and program.path == "eager"
    program.warm_up()
    assert program.eager_steps == want and program.replays == 0
    assert run.agent is None or run.agent.settled(run.rl_state)


def test_a_harness_takes_the_graph_on_the_card_and_eager_on_the_cpu():
    for harness in ("sampling", "gridded operator"):
        assert step_path(torch.device("cuda"), harness=harness)[0] == "graph"
        assert step_path(torch.device("cuda", 0), harness=harness)[0] == "graph"
        assert step_path(torch.device("cpu"), harness=harness) == ("eager", "not on a card")
    fno = GridFNO2D(width=4, modes=2, num_blocks=1, grid=(8, 8))
    opt = AdamStep(list(fno.parameters()), cosine_decay(2e-3, 4, 0.0), None, 0.9, 0.999, 0.0,
                   capturable=True)
    a = torch.zeros((3, 8, 8, 1))
    program = operator.gridded_program(fno, opt, a, a, 2, torch.Generator(), 4)
    assert program.path == "eager" and program.generators and program.optimizers == [opt]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_the_gridded_epoch_on_given_indices_matches_optax(monkeypatch):
    """Three epochs of the harness's program (the batch drawn, MSE, Adam on
    the cosine schedule, no clipping) on the indices JAX's step is given."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal((6, 16, 16, 1)).astype(np.float32)
    u = rng.standard_normal((6, 16, 16, 1)).astype(np.float32)
    draws = [rng.permutation(6)[:4] for _ in range(3)]
    jfno = jax_fno_grid.GridFNO2D(width=8, modes=4, num_blocks=2)
    jp = jfno.init(jax.random.PRNGKey(0), jnp.asarray(a[:1]))
    jopt = optax.adam(optax.cosine_decay_schedule(2e-3, 10))
    state = jopt.init(jp)
    tfno = GridFNO2D(width=8, modes=4, num_blocks=2, grid=(16, 16))
    tfno.load_state_dict(params_from_flax(_np(jp["params"])), strict=True)
    topt = AdamStep(list(tfno.parameters()), cosine_decay(2e-3, 10, 0.0), None, 0.9, 0.999, 0.0,
                    capturable=True)
    given = iter(draws)
    monkeypatch.setattr(operator, "_batch_indices",
                        lambda n, batch, gen: torch.from_numpy(next(given)).long())
    program = operator.gridded_program(tfno, topt, torch.from_numpy(a), torch.from_numpy(u), 4,
                                       torch.Generator().manual_seed(1), 3)
    ref = []
    for idx in draws:
        def loss_fn(p, idx=idx):
            return jnp.mean((jfno.apply(p, a[idx]) - u[idx]) ** 2)

        loss, g = jax.value_and_grad(loss_fn)(jp)
        updates, state = jopt.update(g, state)
        jp = optax.apply_updates(jp, updates)
        ref.append(float(loss))
        program.run()
    got = program.rows[:, 0].tolist()
    assert all(abs(x - y) / y < LOSS_TOL for x, y in zip(got, ref)), (got, ref)
    assert topt.count == 3 and program.eager_steps == 3
    want = params_from_flax(_np(jp["params"]))
    for name, p in tfno.named_parameters():
        assert float((p.detach() - want[name]).abs().max()) < STEP_TOL, name
