"""The trainer's step program (``training/step_program.py``) on the CPU,
where it runs eagerly, one call per step: what a captured step on the card
replays.

- N eager steps of the program against the step sequence it replaced (the
  per-step composition kept below as ``ref_step`` / ``ref_ensemble_step``,
  with the optimizer as ``RefAdamStep`` and the adaptive-weight and EMA
  state reassigned every step), bit for bit: every row, the parameters,
  Adam's moments, the adaptive-weight and EMA state, the agent's networks
  and the generators' states. The agent's own update is the port's in both
  (its counters and replay draw are held against JAX in
  ``test_agent_device_counters_match_jax``).
- After a step every state tensor keeps its address: those are the buffers
  a replayed graph reads.
- The program makes no device-to-host read: under a dispatch mode that
  raises on ``aten._local_scalar_dense`` and ``aten.nonzero`` every case
  runs through (torch's Adam on the CPU reads its host step count; on the
  card it is ``capturable`` and reads none, so ``torch/optim`` frames are
  let through here).
- The capture rule (``step_path``) per configuration, and the history with
  one host read per chunk against JAX's loop (its epoch function replaced
  by a recorder), a run that goes non-finite mid-chunk included.
"""

import math
import traceback

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch_parity_helpers import _configure, burgers_pair

from pinnrl_tpu.training import PDETrainer as JaxTrainer
from pinnrl_tpu_torch.config import load_config
from pinnrl_tpu_torch.models import PINNModel
from pinnrl_tpu_torch.pdes import create_pde
from pinnrl_tpu_torch.rl import RLAgent
from pinnrl_tpu_torch.training import PDETrainer
from pinnrl_tpu_torch.training import trainer as trainer_mod
from pinnrl_tpu_torch.training.step_program import StepProgram, step_path
from pinnrl_tpu_torch.training.trainer import _PLATEAU_RTOL, AdamStep, cosine_decay

N_STEPS = 5
CASES = ("uniform", "rar", "rl", "plateau", "ema", "rbw", "lrw", "ensemble3", "trainable_basis",
         "phase2_adam")


# --------------------------------------------------------------------------- #
# The step sequence the program replaced
# --------------------------------------------------------------------------- #

class RefAdamStep:
    """The optimizer as it stepped before the step program: the plateau
    state reassigned and the learning rate written at each step."""

    def __init__(self, params, schedule, clip_norm, beta1, beta2, weight_decay, plateau=None,
                 members=0):
        self.params, self.members, self.schedule = params, int(members), schedule
        self.clip_norm = None if clip_norm is None else float(clip_norm)
        self.plateau = plateau
        cls = torch.optim.AdamW if weight_decay and weight_decay > 0 else torch.optim.Adam
        self.optimizer = cls(params, lr=schedule(0), betas=(beta1, beta2), eps=1e-8,
                             weight_decay=float(weight_decay or 0.0))
        self.count = 0
        if plateau is not None:
            self.scale = torch.ones(())
            self.best = torch.full((), float("inf"))
            self.plateau_count = torch.zeros((), dtype=torch.int32)

    def _update_scale(self, value):
        factor, patience = self.plateau
        value = value.detach().to(self.best.dtype)
        improved = value < (1 - _PLATEAU_RTOL) * self.best
        self.best = torch.where(improved, value, self.best)
        count = torch.where(improved, 0, self.plateau_count + 1)
        hit = count == patience
        self.plateau_count = torch.where(hit, 0, count)
        self.scale = torch.clamp(torch.where(hit, self.scale * factor, self.scale), min=0.0)

    def step(self, value=None):
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.clip_norm is not None:
            grads = [p.grad for p in self.params]
            if self.members:
                E = self.members
                sq = torch.stack([torch.sum(g.reshape(E, -1) ** 2, dim=1) for g in grads]).sum(0)
                scale = torch.clamp(self.clip_norm / torch.sqrt(sq), max=1.0)
                for g in grads:
                    g.mul_(scale.reshape((E,) + (1,) * (g.ndim - 1)))
            else:
                norm = torch.linalg.vector_norm(
                    torch.stack([torch.linalg.vector_norm(g) for g in grads]))
                torch._foreach_mul_(grads, torch.clamp(self.clip_norm / norm, max=1.0))
        lr = self.schedule(self.count)
        if self.plateau is not None:
            self._update_scale(value)
            lr = self.scale * lr
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.count += 1


def _ref_adaptive_total(tr, st, losses, leaves):
    comps = [losses["residual"], losses["boundary"], losses["initial"]]
    if tr.adaptive_weights.strategy == "lrw":
        sq = []
        for c in comps:
            if not c.requires_grad:
                sq.append(torch.zeros(()))
                continue
            grads = torch.autograd.grad(c, leaves, retain_graph=True, allow_unused=True,
                                        materialize_grads=True)
            sq.append(sum(torch.sum(g * g) for g in grads))
        values = torch.sqrt(torch.stack(sq))
    else:
        values = torch.stack(comps).detach()
    st["aw"] = tr.adaptive_weights.update(st["aw"], values)
    w = tr.adaptive_weights.get_weights(st["aw"]).detach()
    return tr._weighted_total(losses, w), w


@torch.no_grad()
def _ref_ema_update(tr, st, params):
    if st["ema"] is None:
        return
    d = tr._ema_decay
    shadow, n = st["ema"]
    torch._foreach_mul_(shadow, d)
    torch._foreach_add_(shadow, [p.detach() for p in params.values()], alpha=1.0 - d)
    st["ema"] = (shadow, n + 1)


def ref_step(tr, st, params, opt, generator, batch_size):
    x, t = tr._sample(generator, batch_size, params)
    x, t = x.to(tr._dtype), t.to(tr._dtype)
    st["last"] = (x, t)
    losses = tr._sharded_loss(params, x, t, generator)
    for p in opt.params:
        p.grad = None
    if tr.aw_enabled:
        total, weights = _ref_adaptive_total(tr, st, losses, opt.params)
    else:
        total, weights = losses["total"], tr.adaptive_weights.get_weights(st["aw"])
    total.backward()
    opt.step(total.detach())
    _ref_ema_update(tr, st, params)
    if tr.rl_agent is not None:
        tr._rl_update(params, x, t, losses, generator)
    return tr._row(total, losses, weights)


def ref_ensemble_step(tr, st, params, opt, gens, batch_size):
    for p in opt.params:
        p.grad = None
    weights = tr.adaptive_weights.get_weights(st["aw"])
    members = [tr._member(params, m) for m in range(len(gens))]
    batches = [tr._sample(gen, batch_size, pm, cm) for gen, (pm, cm) in zip(gens, members)]
    st["last"] = batches[0]
    residuals = tr._member_residual_losses(params, batches)
    rows, total = [], 0.0
    for m, gen in enumerate(gens):
        (pm, cm), (x, t) = members[m], batches[m]
        losses = tr._loss_components(pm, x, t, gen, cm, residual_loss=residuals[m])
        total = total + losses["total"]
        rows.append(tr._row(losses["total"], losses, weights))
    total.backward()
    opt.step()
    _ref_ema_update(tr, st, params)
    return torch.stack(rows).mean(dim=0)


# --------------------------------------------------------------------------- #
# Cases
# --------------------------------------------------------------------------- #

def _cfg(case):
    cfg = _configure(load_config(pde_type="burgers", architecture="fourier", device="cpu"),
                     hidden=(16, 16), mapping=8, periodic=True, layer_norm=True, scale=2.0,
                     causal_eps=0.0)
    t = cfg.training
    t.num_collocation_points, t.batch_size = 256, 64
    t.num_epochs = 4
    if case == "rar":
        t.collocation_distribution = "residual_based"
    elif case == "plateau":
        t.scheduler_type = "reduce_lr"
        t.lr_scheduler.patience = 1
        t.optimizer_config.learning_rate = 1e-2
    elif case == "ema":
        t.param_ema = 0.9
    elif case in ("rbw", "lrw"):
        t.adaptive_weights.enabled = True
        t.adaptive_weights.strategy = case
    elif case == "ensemble3":
        t.ensemble_size = 3
        t.scheduler_type = "cosine"
    elif case == "trainable_basis":
        cfg.model.arch_params["trainable_features"] = True
    return cfg


def _trainer(case):
    cfg = _cfg(case)
    agent = (RLAgent(state_dim=2, hidden_dim=16, memory_size=100, batch_size=16, target_update=2,
                     device="cpu") if case == "rl" else None)
    return PDETrainer(PINNModel(cfg, seed=0), create_pde(cfg), cfg, rl_agent=agent)


def _setup(tr, case, ref: bool):
    """What ``train`` sets up before its first step: the leaves, the
    optimizer, the generators, the agent, the adaptive weights and EMA."""
    t = tr.tcfg
    if tr.members:
        tr.model.ensemble = tr._stack_ensemble(0)
    params = tr.model.params
    leaves = tr._leaves(params)
    batch = t.batch_size
    cls = RefAdamStep if ref else AdamStep
    if case == "phase2_adam":
        batch = 96
        opt = cls(leaves, cosine_decay(t.phase2_learning_rate, 4, 0.0), t.gradient_clip_norm,
                  0.9, 0.999, 0.0)
    else:
        sched = tr._make_lr_schedule(t.num_epochs, t.num_collocation_points // batch)
        plateau = ((t.lr_scheduler.factor, int(t.lr_scheduler.patience))
                   if t.scheduler_type == "reduce_lr" else None)
        opt = cls(leaves, sched, t.gradient_clip_norm, t.optimizer_config.beta1,
                  t.optimizer_config.beta2, t.optimizer_config.weight_decay, plateau=plateau,
                  members=tr.members)
    gens = ([torch.Generator().manual_seed(s) for s in tr._member_seeds(0, 1)] if tr.members
            else [torch.Generator().manual_seed(0)])
    if tr.rl_agent is not None:
        tr._rl_state = tr._init_rl_state(0)
    tr._aw_state = tr.adaptive_weights.init()
    tr._ema_init(params)
    st = {"aw": tr._aw_state,
          "ema": (tr._ema_shadow, 0) if tr._ema_shadow is not None else None}
    return params, opt, gens, batch, st


def _program(tr, params, opt, gens, batch):
    return tr._start_program(params, opt, gens, batch, None, 0, N_STEPS, 1)


def _program_run(case, steps=N_STEPS, each=None):
    tr = _trainer(case)
    params, opt, gens, batch, _ = _setup(tr, case, ref=False)
    program = _program(tr, params, opt, gens, batch)
    assert program.path == "eager"
    for i in range(steps):
        program.run()
        if each is not None:
            each(i, tr, params, opt, program)
    return tr, params, opt, gens, program


def _state_tensors(tr, params, opt, program):
    """Every tensor a step reads at its start, by name."""
    out = {f"param/{k}": v for k, v in params.items()}
    for i, p in enumerate(opt.params):
        for key, v in opt.optimizer.state[p].items():
            out[f"adam/{i}/{key}"] = v
    if opt.plateau is not None:
        out.update({"plateau/scale": opt.scale, "plateau/best": opt.best,
                    "plateau/count": opt.plateau_count})
    for f in ("running", "weights", "prev_weights", "initialized"):
        out[f"aw/{f}"] = getattr(tr._aw_state, f)
    for i, v in enumerate(tr._ema_shadow or []):
        out[f"ema/{i}"] = v
    if tr._rl_state is not None:
        st = tr._rl_state
        for tag, net in (("policy", st.policy_params), ("target", st.target_params)):
            out.update({f"rl/{tag}/{k}": v for k, v in net.items()})
        for name in RLAgent._BUFFERS + RLAgent._COUNTERS:
            out[f"rl/{name}"] = getattr(st, name)
        for i, p in enumerate(st.opt_state.params):
            for key, v in st.opt_state.optimizer.state.get(p, {}).items():
                out[f"rl/adam/{i}/{key}"] = v
    out["last_points"] = tr._last_pts
    out["rows"], out["slot"] = program.rows, program.slot
    return out


@pytest.mark.parametrize("case", CASES)
def test_program_steps_equal_the_step_sequence_it_replaced(case):
    tr, params, opt, gens, program = _program_run(case)
    ref = _trainer(case)
    r_params, r_opt, r_gens, batch, st = _setup(ref, case, ref=True)
    rows = []
    for _ in range(N_STEPS):
        if ref.members:
            rows.append(ref_ensemble_step(ref, st, r_params, r_opt, r_gens, batch))
        else:
            rows.append(ref_step(ref, st, r_params, r_opt, r_gens[0], batch))
    assert torch.equal(program.rows[:N_STEPS], torch.stack(rows).detach())
    assert int(program.slot) == N_STEPS and opt.count == r_opt.count == N_STEPS
    for k in params:
        assert torch.equal(params[k], r_params[k]), k
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(opt.optimizer.state[params[k]][key],
                               r_opt.optimizer.state[r_params[k]][key]), (k, key)
    assert all(torch.equal(a.get_state(), b.get_state()) for a, b in zip(gens, r_gens))
    for f in ("running", "weights", "prev_weights", "initialized"):
        assert torch.equal(getattr(tr._aw_state, f), getattr(st["aw"], f)), f
    if opt.plateau is not None:
        assert torch.equal(opt.scale, r_opt.scale) and torch.equal(opt.best, r_opt.best)
        assert float(opt.scale) < 1.0  # the plateau was hit
    if tr._ema_shadow is not None:
        shadow, n = st["ema"]
        assert tr._ema_n == n == N_STEPS
        assert all(torch.equal(a, b) for a, b in zip(tr._ema_shadow, shadow))
    x, t = st["last"]
    assert torch.equal(tr._last_pts, torch.cat([x[:64], t[:64]], dim=-1))
    if tr.rl_agent is not None:
        a, b = tr._rl_state, ref._rl_state
        for k in a.policy_params:
            assert torch.equal(a.policy_params[k], b.policy_params[k])
            assert torch.equal(a.target_params[k], b.target_params[k])
        assert int(a.size) == 100 and int(a.steps) == N_STEPS  # the ring wrapped
        assert a.opt_state.count == b.opt_state.count == N_STEPS


@pytest.mark.parametrize("case", CASES)
def test_a_step_keeps_every_state_tensor_in_place(case):
    addresses = {}

    def each(i, tr, params, opt, program):
        now = {k: v.data_ptr() for k, v in _state_tensors(tr, params, opt, program).items()}
        if i == 0:
            addresses.update(now)
        else:
            assert now == addresses, {k for k in now if now[k] != addresses.get(k)}

    _program_run(case, steps=3, each=each)
    assert len(addresses) > 10


class _NoReads(TorchDispatchMode):
    """Raise on an op that reads a tensor's value on the host, except in
    torch's optimizers (on the card they are capturable and read none)."""

    READS = (torch.ops.aten._local_scalar_dense.default, torch.ops.aten.nonzero.default)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.READS and not any("torch/optim/" in f.filename.replace("\\", "/")
                                          for f in traceback.extract_stack()):
            raise AssertionError(f"{func} inside the step program")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("case", CASES)
def test_the_program_reads_nothing_back(case):
    tr = _trainer(case)
    params, opt, gens, batch, _ = _setup(tr, case, ref=False)
    program = _program(tr, params, opt, gens, batch)
    with _NoReads():
        for _ in range(3):
            program.run()
    assert int(program.slot) == 3


# --------------------------------------------------------------------------- #
# The agent's device counters
# --------------------------------------------------------------------------- #

def test_agent_device_counters_match_jax():
    """ptr, size and steps are device tensors updated in place, equal to
    JAX's after pushes that wrap the ring; ``filled`` counts up to the
    batch; the target sync falls where JAX's ``jnp.where`` puts it."""
    import jax
    import jax.numpy as jnp

    from pinnrl_tpu.rl import RLAgent as JaxRLAgent
    from pinnrl_tpu_torch.models.bridge import dqn_params_from_flax

    args = dict(state_dim=2, hidden_dim=8, memory_size=32, batch_size=10_000, target_update=3)
    jagent, tagent = JaxRLAgent(**args), RLAgent(**args, device="cpu")
    jstate = jagent.init(jax.random.PRNGKey(0))
    tstate = tagent.init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for k, v in dqn_params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                                jstate.policy_params)).items():
            tstate.policy_params[k].copy_(v)
            tstate.target_params[k].copy_(v)
    jstate = jstate.replace(target_params=jstate.policy_params)
    counters = [getattr(tstate, n) for n in ("ptr", "size", "steps")]
    rng = np.random.default_rng(3)
    for step, n in enumerate((20, 20, 9, 13), start=1):
        s = rng.standard_normal((n, 2)).astype(np.float32)
        r = rng.standard_normal(n).astype(np.float32)
        jstate = jstate.replace(policy_params=jax.tree_util.tree_map(lambda p: p + 1.0,
                                                                     jstate.policy_params))
        with torch.no_grad():
            for p in tstate.policy_params.values():
                p.add_(1.0)
        jstate = jagent.update(jstate, jnp.asarray(s), jnp.asarray(r), jnp.asarray(s),
                               jnp.ones(()), jax.random.PRNGKey(step))
        tstate = tagent.update(tstate, torch.from_numpy(s), torch.from_numpy(r),
                               torch.from_numpy(s), torch.ones(()), torch.Generator())
        got = [int(getattr(tstate, n)) for n in ("ptr", "size", "steps")]
        assert got == [int(jstate.ptr), int(jstate.size), int(jstate.steps)], step
        assert tstate.filled == min(int(jstate.size), 32)
        target = dqn_params_from_flax(jax.tree_util.tree_map(np.asarray, jstate.target_params))
        for k, v in tstate.target_params.items():
            assert torch.equal(v, target[k]), (step, k)
        assert all(v.dtype == torch.int64 and v.ndim == 0 for v in counters)
    assert [getattr(tstate, n) for n in ("ptr", "size", "steps")] == counters  # in place
    assert [int(c) for c in counters] == [(20 + 20 + 9 + 13) % 32, 32, 4]
    assert tagent.settled(tstate)  # full below a batch: the branch never trains
    back = tagent.load_arrays(tagent.state_arrays(tstate),
                              tagent.init(torch.Generator().manual_seed(1)))
    assert [int(getattr(back, n)) for n in ("ptr", "size", "steps")] == [30, 32, 4]
    assert back.filled == tstate.filled


def test_the_replay_draw_is_uniform_below_the_device_size():
    agent = RLAgent(state_dim=2, hidden_dim=8, memory_size=64, batch_size=4096, device="cpu")
    state = agent.init(torch.Generator().manual_seed(0))
    drawn = []
    state.size.fill_(5)
    agent._train_on = lambda st, idx: drawn.append(idx) or st
    agent._train(state, torch.Generator().manual_seed(0))
    idx = drawn[0]
    assert idx.dtype == torch.int64 and int(idx.min()) == 0 and int(idx.max()) == 4
    counts = torch.bincount(idx, minlength=5).double() / idx.numel()
    assert float((counts - 0.2).abs().max()) < 0.03


# --------------------------------------------------------------------------- #
# The capture rule
# --------------------------------------------------------------------------- #

RULE_CASES = {
    "uniform": ({}, ["graph"]),
    "rar": ({"collocation_distribution": "residual_based"}, ["graph"]),
    "rl": ({"rl": True}, ["graph"]),
    "plateau": ({"scheduler_type": "reduce_lr"}, ["graph"]),
    "ema": ({"param_ema": 0.9}, ["graph"]),
    "rbw": ({"aw": "rbw"}, ["graph"]),
    "lrw": ({"aw": "lrw"}, ["graph"]),
    "hard_ic": ({"hard_ic": True}, ["graph"]),
    "penalties": ({"penalties": True}, ["graph"]),
    "trainable_basis": ({"trainable_features": True}, ["graph"]),
    "inverse": ({"mode": "inverse"}, ["graph"]),
    "data_augmented": ({"mode": "data_augmented"}, ["graph"]),
    "ensemble": ({"ensemble_size": 2}, ["graph"]),
    "siren": ({"arch": "siren"}, ["graph"]),
    "adam_lbfgs": ({"optimizer": "adam_lbfgs"}, ["graph", "graph"]),
    "phase2_adam": ({"optimizer": "adam_lbfgs", "phase2_optimizer": "adam"}, ["graph", "graph"]),
    "lbfgs": ({"optimizer": "lbfgs"}, ["graph"]),
}


@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_capture_rule_per_configuration(monkeypatch, case):
    """What ``step_path`` answers for each phase of a configuration on the
    card (the run itself takes the CPU's answer, eager)."""
    changes, want = RULE_CASES[case]
    arch = changes.get("arch", "fourier")
    cfg = _configure(load_config(pde_type="burgers", architecture=arch, device="cpu"),
                     hidden=(8, 8), mapping=4, periodic=True, layer_norm=arch == "fourier",
                     scale=2.0, causal_eps=0.0)
    t = cfg.training
    t.num_collocation_points, t.batch_size, t.num_epochs = 64, 32, 2
    t.num_boundary_points = t.num_initial_points = 16
    t.lbfgs.batch_size = 32
    for key in ("collocation_distribution", "scheduler_type", "param_ema", "ensemble_size",
                "optimizer", "phase2_optimizer", "mode"):
        if key in changes:
            setattr(t, key, changes[key])
    if "aw" in changes:
        t.adaptive_weights.enabled, t.adaptive_weights.strategy = True, changes["aw"]
    if changes.get("penalties"):
        t.loss_weights.update({"smoothness": 0.1, "gpinn": 0.1})
    if changes.get("mode") == "inverse":
        cfg.pde.trainable_parameters = ["nu"]
    cfg.model.hard_ic = bool(changes.get("hard_ic"))
    if changes.get("trainable_features"):
        cfg.model.arch_params["trainable_features"] = True
    agent = RLAgent(hidden_dim=8, batch_size=16, device="cpu") if changes.get("rl") else None
    tr = PDETrainer(PINNModel(cfg, seed=0), create_pde(cfg), cfg, rl_agent=agent)
    seen, real = [], trainer_mod.step_path

    def spy(device, lbfgs, mesh):
        seen.append(real(torch.device("cuda"), lbfgs, mesh)[0])
        return real(device, lbfgs, mesh)

    monkeypatch.setattr(trainer_mod, "step_path", spy)
    tr.train(seed=0)
    assert seen == want
    assert [p.path for p in tr.programs] == ["eager"] * len(want)
    assert all(np.isfinite(tr.history["train_loss"]))


def test_capture_rule_on_each_device():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert step_path(cuda, False, None)[0] == "graph"
    assert step_path(cuda, True, None) == (
        "graph", "an L-BFGS phase on the card: the line search on the device")
    assert step_path(cuda, False, object())[0] == "eager"  # a device mesh
    assert step_path(cuda, True, object())[0] == "eager"
    assert step_path(cpu, False, None)[0] == "eager"


def _adam_recorder(monkeypatch, *modules):
    """Record what each AdamStep made through ``modules`` asks for."""
    made = []

    class Recorder(AdamStep):
        def __init__(self, *args, capturable=False, **kw):
            super().__init__(*args, capturable=capturable, **kw)
            made.append((capturable, self))

    for module in modules:
        monkeypatch.setattr(f"{module}.AdamStep", Recorder)
    return made


@pytest.mark.parametrize("case", ["uniform", "plateau", "mesh", "rl", "phase2_adam"])
def test_the_trainers_adams_ask_for_the_capturable_adam(monkeypatch, case):
    """Each of the trainer's Adams (phase 1, phase 2, the agent's) asks for
    torch's capturable Adam, on a mesh too, whose eager steps then compute
    what the replayed ones do; on the CPU each is torch's host-lr Adam."""
    made = _adam_recorder(monkeypatch, "pinnrl_tpu_torch.training.trainer",
                          "pinnrl_tpu_torch.rl.dqn")
    if case == "phase2_adam":
        cfg = _cfg("uniform")
        t = cfg.training
        t.optimizer, t.phase2_optimizer, t.lbfgs.batch_size = "adam_lbfgs", "adam", 64
        tr = PDETrainer(PINNModel(cfg, seed=0), create_pde(cfg), cfg)
    else:
        tr = _trainer("uniform" if case == "mesh" else case)
    if case == "mesh":
        tr.mesh = object()
        tr._make_adam(1, 1, tr._leaves(tr.model.params))
    else:
        tr.train(seed=0)
    assert [c for c, _ in made] == [True] * (2 if case in ("rl", "phase2_adam") else 1)
    assert not any(opt.optimizer.param_groups[0]["capturable"] for _, opt in made)


@pytest.mark.parametrize("strategy", ["uniform", "adaptive", "gridded"])
def test_the_sampling_harness_keeps_the_host_lr_adam(monkeypatch, strategy):
    """The harnesses capture their steps on the card: the sampling
    harness's network and agent and the gridded FNO ask for torch's
    capturable Adam, so their eager steps compute what the replayed ones do;
    on the CPU each keeps the host-lr Adam."""
    from pinnrl_tpu_torch.benchmarks import operator, sampling

    made = _adam_recorder(monkeypatch, "pinnrl_tpu_torch.benchmarks.sampling",
                          "pinnrl_tpu_torch.benchmarks.operator", "pinnrl_tpu_torch.rl.dqn")
    if strategy == "gridded":
        operator.run_gridded_operator_benchmark(epochs=1, n_traj_train=1, n_traj_test=1, width=4,
                                                modes=2, num_blocks=1, device="cpu")
    else:
        sampling._Run("burgers", strategy, 2, 16, 2e-3, 0, device="cpu")
    assert [c for c, _ in made] == [True] * (2 if strategy == "adaptive" else 1)
    assert not any(opt.optimizer.param_groups[0]["capturable"] for _, opt in made)


def test_a_program_slot_restarts_each_chunk():
    tr, params, opt, gens, program = _program_run("uniform", steps=2)
    program.start_chunk()
    program.run()
    assert int(program.slot) == 1 and isinstance(program, StepProgram)
    program.end_epoch(0, 1, lambda r: r, torch.ones(2))
    assert torch.equal(program.epochs[0], torch.cat([program.rows[0], torch.ones(2)]))


# --------------------------------------------------------------------------- #
# The chunk loop against JAX's
# --------------------------------------------------------------------------- #

def _totals(epochs: int, nan_at):
    # A non-finite loss stays non-finite: the parameters are.
    return [float("nan") if nan_at is not None and e >= nan_at else 10.0 / (e + 1)
            for e in range(epochs)]


def _jax_history(monkeypatch, pair, totals):
    jtr = JaxTrainer(pair.jmodel, pair.jpde, pair.jcfg)
    done = [0]

    def build_epoch_fn(optimizer, batch_size, steps_per_epoch, lbfgs, f64=None):
        def epoch_fn(state, chunk):
            tot = np.asarray(totals[done[0]:done[0] + chunk], np.float32)
            done[0] += chunk
            metrics = {k: tot for k in ("total", "residual", "boundary", "initial",
                                        "smoothness", "data")}
            metrics["weights"] = np.tile(np.float32([0.2, 0.3, 0.5]), (chunk, 1))
            metrics["pts"] = np.zeros((chunk, 64, 2), np.float32)
            return state, metrics
        return epoch_fn

    def build_val_fn(num_points=1000):
        return lambda params, key: 1.0

    monkeypatch.setattr(jtr, "_build_epoch_fn", build_epoch_fn)
    monkeypatch.setattr(jtr, "_build_val_fn", build_val_fn)
    res = jtr.train(seed=0)
    return res, jtr.history


def _port_history(monkeypatch, pair, totals, steps_per_epoch):
    ttr = PDETrainer(pair.tmodel, pair.tpde, pair.tcfg)
    done, reads = [0], []

    def step(params, opt, generator, batch_size):
        v = totals[done[0] // steps_per_epoch]
        done[0] += 1
        return torch.tensor([v] * 6 + [0.2, 0.3, 0.5])

    read = ttr._read_chunk

    def counted(*a):
        reads.append(len(ttr.history["train_loss"]))
        return read(*a)

    monkeypatch.setattr(ttr, "_step", step)
    monkeypatch.setattr(ttr, "_read_chunk", counted)
    monkeypatch.setattr(ttr, "_val_loss", lambda params, generator: 1.0)
    res = ttr.train(seed=0)
    return res, ttr.history, reads


@pytest.mark.parametrize("nan_at", [None, 5])
def test_history_with_one_read_per_chunk_equals_jax(monkeypatch, nan_at):
    """12 epochs validated every 4: the same history as JAX's loop, one host
    read per chunk; a loss that goes non-finite at epoch 6 stops both at the
    chunk's end (epoch 8), with histories of equal length."""
    pair = burgers_pair(hidden=(8, 8), mapping=4)
    for cfg in (pair.jcfg, pair.tcfg):
        t = cfg.training
        t.num_epochs, t.validation_frequency = 12, 4
        t.num_collocation_points, t.batch_size = 64, 32
    totals = _totals(12, nan_at)
    jres, jh = _jax_history(monkeypatch, pair, totals)
    tres, th, reads = _port_history(monkeypatch, pair, totals, 2)
    n = 12 if nan_at is None else 8
    assert len(th["train_loss"]) == len(jh["train_loss"]) == n
    assert reads == list(range(0, n, 4))  # one read per chunk, at its end
    np.testing.assert_array_equal(np.float32(th["train_loss"]), np.float32(jh["train_loss"]))
    for k in ("residual", "boundary", "initial", "smoothness", "data"):
        np.testing.assert_array_equal(np.float32(th["loss_components"][k]),
                                      np.float32(jh["loss_components"][k]))
    assert th["val_loss"] == jh["val_loss"] == [1.0] * (3 if nan_at is None else 1)
    np.testing.assert_allclose(th["adaptive_weights"], jh["adaptive_weights"], rtol=1e-7)
    assert len(th["epoch_time"]) == len(jh["epoch_time"]) == n
    for a, b in zip(th["learning_rate"], jh["learning_rate"]):
        assert math.isclose(a, b, rel_tol=1e-6, abs_tol=2.4e-10)
    assert tres["status"] == jres["status"] == ("completed" if nan_at is None else "failed")
