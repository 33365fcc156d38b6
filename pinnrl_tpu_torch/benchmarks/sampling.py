"""Sampling-strategy benchmark harness, as ``pinnrl_tpu.benchmarks.sampling``.

Compares collocation strategies (uniform / stratified / residual_based /
adaptive) on one PDE, with a fresh small Fourier MLP per strategy (so the
RL agent carries no state across strategies), a lightweight train loop
outside the trainer, and a fixed 64 x 64 validation grid for the L2
comparison. Reports collocation points per second.

Each step samples, computes the loss (the residual through the stacked-jet
bundle, BC and IC through the network: kernel 2 on the card; the fused
residual kernel is not attached, as in the JAX harness), takes a clipped
Adam step on a cosine schedule over the whole run, and, for ``adaptive``,
rewards the DQN agent (hidden 64, replay 4096, batch 64; kernel 4 scores its
100 x 100 grid in every sampling call) and takes its update and one epsilon
decay. The JAX harness scans 100 steps per device call and compiles each
phase's chunk outside its timed window. Here each curriculum phase's step
is a step program (``training/step_program.py``): on the card it is
captured once as a CUDA graph and replayed at every step (the agent's
steps before its buffer holds a batch run eagerly, as in the trainer), on
the CPU it runs eagerly. A step keeps every tensor it reads in place (the
parameters and gradients, both Adams' state, ``prev_loss``, the agent's
networks, buffers, counters and epsilon) and writes its loss into the
program's rows on the device.

Before the timed loop each phase's program takes its warm-up steps and its
capture (``StepProgram.warm_up``), and the run is then put back to its
initial state in place (``_Run.checkpoint``: every buffer, the optimizers'
step counts, the agent's host count, the generator), so the timed steps pay
no kernel build, cuBLAS, allocator or capture set-up and the reported state
is not advanced by the warm-up. The timed window covers exactly ``epochs``
steps and one synchronize, and on the card it raises on any host read
(``torch.cuda.set_sync_debug_mode("error")``). One host read follows it: the
last loss, the validation errors and the replays' kernel launches.
``points_per_sec = epochs * batch / wall``.

``rl_variant`` (adaptive only): "coord" Q(x, t) with reward -(weighted
losses); "resfeat" Q(x, t, log1p(|r| / mean|r|)); "improve" reward = the
relative one-step decrease of the total loss (0 on the first step);
"resfeat_improve" both. ``windows=W`` trains an expanding-horizon
curriculum: phase w samples from [t0, t0 + (w+1)/W * T] with the model,
optimizer and agent carried across phases; validation is always on the
full horizon. More windows than epochs is refused (the JAX harness divides
by zero there: ROADMAP §3).
"""

from __future__ import annotations

import contextlib
import copy
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import torch

from pinnrl_tpu_torch.config import load_config
from pinnrl_tpu_torch.models import PINNModel
from pinnrl_tpu_torch.pdes import create_pde
from pinnrl_tpu_torch.rl import RLAgent
from pinnrl_tpu_torch.training.step_program import StepProgram, step_path
from pinnrl_tpu_torch.training.trainer import AdamStep, cosine_decay

STRATEGIES = ("uniform", "stratified", "residual_based", "adaptive")
PDE_CHOICES = ("heat", "wave", "burgers", "kdv")
RL_VARIANTS = ("coord", "resfeat", "improve", "resfeat_improve")
# The agent's push per step: the first min(RL_PUSH, batch) points.
RL_PUSH = 128


@dataclass
class SamplingResult:
    """One benchmark row."""

    pde: str
    architecture: str
    strategy: str
    final_loss: float
    l2_error: float
    rel_l2: float
    wall_time_s: float
    points_per_sec: float
    epochs: int
    seed: int


def _fixed_validation_grid(pde, n_side: int = 64, device=None):
    device = pde.device if device is None else device
    xs = torch.linspace(pde.domain[0][0], pde.domain[0][1], n_side, device=device)
    ts = torch.linspace(pde.time_domain[0], pde.time_domain[1], n_side, device=device)
    X, T = torch.meshgrid(xs, ts, indexing="ij")
    return X.reshape(-1, 1), T.reshape(-1, 1)


@torch.no_grad()
def _errors(pde, model, params, x_grid, t_grid) -> torch.Tensor:
    """[l2, rel_l2] of the network against the exact solution on the grid,
    on the device (NaNs without an exact solution)."""
    u = model.apply(params, torch.cat([x_grid, t_grid], dim=-1))
    u = u.reshape(x_grid.shape[0], -1)[:, 0:1]
    exact = pde.exact_solution(x_grid, t_grid)
    if exact is None:
        return torch.full((2,), float("nan"), device=u.device)
    exact = exact.reshape(u.shape)
    err = u - exact
    l2 = torch.sqrt(torch.mean(err**2))
    rel = torch.sqrt(torch.sum(err**2)) / (torch.sqrt(torch.sum(exact**2)) + 1e-12)
    return torch.stack([l2, rel])


def _adam_state(prefix: str, opt: AdamStep) -> Dict[str, torch.Tensor]:
    """Adam's per-leaf state tensors (made at its first step), by name."""
    return {f"{prefix}/{i}/{key}": v for i, p in enumerate(opt.params)
            for key, v in opt.optimizer.state.get(p, {}).items()}


@contextlib.contextmanager
def _host_reads_raise(device: torch.device) -> Iterator[None]:
    """On the card, raise at any operation that waits for the device."""
    if device.type != "cuda":
        yield
        return
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def _build_benchmark_model(pde_key: str, seed: int, arch: str = "fourier", device: str = "cuda"):
    """A fresh small net (64x3; Fourier gets mapping 32, scale 2.0) on the
    PDE posed as its convergence recipe poses it (Burgers: the traveling
    wave with a steep moving front)."""
    from pinnrl_tpu_torch.benchmarks.convergence import RECIPES

    cfg = load_config(pde_type=pde_key, architecture=arch, device=device)
    for k, v in (RECIPES.get(pde_key, {}).get("pde") or {}).items():
        if k == "parameters":
            cfg.pde.parameters.update(v)
        else:
            setattr(cfg.pde, k, v)
    cfg.model.hidden_dims = [64, 64, 64]
    if arch == "fourier":
        cfg.model.arch_params["mapping_size"] = 32
        cfg.model.arch_params["scale"] = 2.0
    return cfg, PINNModel(cfg, seed=seed)


def _phase_epochs(epochs: int, windows: int) -> List[int]:
    """The epochs of each curriculum phase (one phase without windows)."""
    phases = max(int(windows), 1)
    if phases > epochs:
        raise ValueError(f"windows > epochs: {phases} windows cannot split {epochs} epochs")
    per_phase = [epochs // phases] * phases
    per_phase[-1] += epochs - sum(per_phase)
    return per_phase


class _Run:
    """One strategy's model, optimizer, agent and step (see the module
    docstring)."""

    def __init__(self, pde_key: str, strategy: str, epochs: int, batch: int, lr: float,
                 seed: int, arch: str = "fourier", rar: Optional[Dict[str, float]] = None,
                 rl_variant: str = "coord", device: str = "cuda") -> None:
        self.cfg, self.model = _build_benchmark_model(pde_key, seed, arch=arch, device=device)
        self.cfg.training.collocation_distribution = strategy
        self.pde = create_pde(self.cfg)
        self.pde.attach_fast_bundle(self.model)  # stacked-jet residual path
        self.strategy, self.batch, self.rar = strategy, batch, dict(rar or {})
        self.resfeat = "resfeat" in rl_variant
        self.improve = "improve" in rl_variant
        self.device = self.model.device
        self.params = self.model.params
        # The capturable Adams (the host-lr ones on the CPU): an eager step
        # on the card computes what a replayed one does.
        self.opt = AdamStep(list(self.params.values()), cosine_decay(lr, epochs, 0.0),
                            1.0, 0.9, 0.999, 0.0, capturable=True)
        self.agent = self.rl_state = None
        if strategy == "adaptive":
            self.agent = RLAgent(state_dim=self.cfg.model.input_dim + (1 if self.resfeat else 0),
                                 hidden_dim=64, memory_size=4096, batch_size=64,
                                 device=self.device)
            self.rl_state = self.agent.init(torch.Generator().manual_seed(seed + 1),
                                            capturable=True)
        self.prev_loss = torch.zeros((), device=self.device)
        self._done = torch.ones((), device=self.device)
        # Every draw of the run's steps: points, BC/IC points, the agent's.
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

    def optimizers(self) -> List[AdamStep]:
        return [self.opt] + ([self.rl_state.opt_state] if self.agent is not None else [])

    def state(self) -> Dict[str, torch.Tensor]:
        """Every tensor a step reads at its start, by name: the buffers that
        a step updates in place and a replayed one reads where its capture
        saw them."""
        out = {f"param/{k}": v for k, v in self.params.items()}
        out.update(_adam_state("adam", self.opt))
        out["prev_loss"] = self.prev_loss
        if self.agent is not None:
            st = self.rl_state
            for tag, net in (("policy", st.policy_params), ("target", st.target_params)):
                out.update({f"rl/{tag}/{k}": v for k, v in net.items()})
            for name in RLAgent._BUFFERS + RLAgent._COUNTERS:
                out[f"rl/{name}"] = getattr(st, name)
            out.update(_adam_state("rl/adam", st.opt_state))
        return out

    def checkpoint(self) -> Callable[[], None]:
        """A function that puts the run back, in place, where it is now:
        every tensor of ``state()`` (one made since, Adam's moments and step
        count at its first step, to zero, as a fresh Adam's), the
        optimizers' step counts, the agent's host count and the generator."""
        saved = {k: v.detach().clone() for k, v in self.state().items()}
        counts = [opt.count for opt in self.optimizers()]
        filled = self.rl_state.filled if self.agent is not None else 0
        gen_state = self.gen.get_state()

        def restore() -> None:
            with torch.no_grad():
                for k, v in self.state().items():
                    if k in saved:
                        v.copy_(saved[k])
                    else:
                        v.zero_()
            for opt, count in zip(self.optimizers(), counts):
                opt.count = count
            if self.agent is not None:
                self.rl_state.filled = filled
            self.gen.set_state(gen_state)

        return restore

    def program(self, pde, steps: int) -> StepProgram:
        """The step on ``pde`` as a step program (its path by ``step_path``)
        whose rows keep ``steps`` losses."""
        path, _ = step_path(self.device, harness="sampling")
        agent = self.agent
        return StepProgram(
            lambda: self.step(pde, self.gen), path, self.device, capacity=max(steps, 1),
            generators=[self.gen], optimizers=self.optimizers(),
            counters=[(self.rl_state, "filled")] if agent is not None else [],
            ready=(lambda: agent.settled(self.rl_state)) if agent is not None else (lambda: True),
            name="sampling step")

    def warm_up(self, programs: Sequence[StepProgram]) -> None:
        """Each program's warm-up steps and capture, then the run put back
        where it started."""
        restore = self.checkpoint()
        for program in programs:
            program.warm_up()
        restore()

    def timed(self, programs: Sequence[StepProgram], per_phase: Sequence[int]) -> float:
        """Seconds of ``per_phase[w]`` steps of each phase's program, and one
        synchronize; no host read in between."""
        _sync(self.device)
        t0 = time.perf_counter()
        with _host_reads_raise(self.device):
            for program, n_ep in zip(programs, per_phase):
                program.start_chunk()
                for _ in range(n_ep):
                    program.run()
        _sync(self.device)
        return time.perf_counter() - t0

    def read(self, programs: Sequence[StepProgram], per_phase: Sequence[int]):
        """One host read after the timed steps: the last loss, the
        validation grid's l2 and rel_l2, and the replays' kernel launches
        (each program's tally, settled into the counters)."""
        x_grid, t_grid = _fixed_validation_grid(self.pde)
        errors = _errors(self.pde, self.model, self.params, x_grid, t_grid)
        tallies = [p.tally for p in programs if p.tally is not None]
        last = programs[-1].rows[per_phase[-1] - 1]
        flat = torch.cat([last.double(), errors.double()] + [t.double() for t in tallies]).tolist()
        k = 3
        for p in programs:
            if p.tally is not None:
                p.settle(flat[k:k + p.tally.numel()])
                k += p.tally.numel()
        return flat[0], flat[1], flat[2]

    def release(self, programs: Sequence[StepProgram]) -> None:
        """Free the programs; a captured step's gradients live in its
        graph's memory."""
        for program in programs:
            program.release()
        nets = [self.params] + ([self.rl_state.policy_params] if self.agent is not None else [])
        for net in nets:
            for p in net.values():
                p.grad = None

    def phase_pde(self, w: int, phases: int):
        """The PDE of curriculum phase ``w``: the time domain cut to its
        horizon (the last phase is the run's own)."""
        if w == phases - 1:
            return self.pde
        t_lo, t_hi = self.pde.time_domain
        cfg_w = copy.deepcopy(self.cfg)
        cfg_w.pde.time_domain = [float(t_lo), float(t_lo + (w + 1) / phases * (t_hi - t_lo))]
        pde_w = create_pde(cfg_w)
        pde_w.attach_fast_bundle(self.model)
        return pde_w

    def res_feature(self, params, grid: torch.Tensor) -> torch.Tensor:
        """Scale-free residual feature log1p(|r| / mean|r|) over the set, as
        a column (on the run's own PDE, as the JAX harness computes it)."""
        r = self.pde.residual_score(self.model.apply, params, grid[:, :-1], grid[:, -1:])
        r = torch.abs(r.reshape(-1))
        return torch.log1p(r / (torch.mean(r) + 1e-12))[:, None]

    def _score(self, grid: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        with torch.no_grad():
            if self.resfeat:
                grid = torch.cat([grid, self.res_feature(self.params, grid)], dim=-1)
            return self.agent.select_action(self.rl_state, grid, generator)

    def sample(self, pde, generator: torch.Generator):
        """The step's collocation points, by the run's strategy."""
        if self.strategy == "residual_based":
            def residual_fn(xx, tt):
                return pde.residual_score(self.model.apply, self.params, xx, tt)

            with torch.no_grad():
                return pde.generate_collocation_points(generator, self.batch, self.strategy,
                                                       residual_fn=residual_fn, **self.rar)
        if self.strategy == "adaptive":
            return pde.generate_collocation_points(
                generator, self.batch, self.strategy,
                score_fn=lambda grid: self._score(grid, generator))
        return pde.generate_collocation_points(generator, self.batch, self.strategy)

    def reward(self, pde, losses, x: torch.Tensor, t: torch.Tensor, loss: torch.Tensor):
        """The agent's transitions of this step on the updated parameters:
        (points, reward) for the first ``min(RL_PUSH, batch)`` points."""
        n = min(RL_PUSH, x.shape[0])
        with torch.no_grad():
            pts = torch.cat([x[:n], t[:n]], dim=-1)
            if self.resfeat:
                pts = torch.cat([pts, self.res_feature(self.params, pts)], dim=-1)
            if self.improve:
                # The relative one-step decrease of the total loss, shared by
                # the batch, clipped; the first step (prev_loss 0) gets 0.
                prev = self.prev_loss
                rel = torch.clamp((prev - loss) / (prev + 1e-9), -1.0, 1.0)
                reward = torch.where(prev > 0, rel, torch.zeros_like(rel)).expand(n)
            else:
                res = pde.residual_score(self.model.apply, self.params, x[:n], t[:n])
                reward = self.agent.compute_reward(res, losses["boundary"].detach(),
                                                   losses["initial"].detach())
        return pts, reward

    def step_on(self, pde, x: torch.Tensor, t: torch.Tensor,
                generator: torch.Generator) -> torch.Tensor:
        """loss -> backward -> clip -> Adam (-> the agent's update and one
        epsilon decay) on the points (x, t); the BC and IC points and the
        agent's TD batch come from ``generator``. Returns the detached loss."""
        losses = pde.compute_loss(self.model.apply, self.params, x, t, generator=generator)
        for p in self.opt.params:
            p.grad = None
        losses["total"].backward()
        self.opt.step()
        loss = losses["total"].detach()
        if self.agent is not None:
            pts, reward = self.reward(pde, losses, x, t, loss)
            self.rl_state = self.agent.update(self.rl_state, pts, reward, pts, self._done,
                                              generator)
            self.rl_state = self.agent.update_epsilon(self.rl_state)
        self.prev_loss.copy_(loss)
        return loss

    def step(self, pde, generator: torch.Generator) -> torch.Tensor:
        x, t = self.sample(pde, generator)
        return self.step_on(pde, x, t, generator)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _train_one(
    pde_key: str,
    strategy: str,
    epochs: int,
    batch: int,
    lr: float,
    seed: int,
    arch: str = "fourier",
    rar: Optional[Dict[str, float]] = None,
    rl_variant: str = "coord",
    windows: int = 0,
    device: str = "cuda",
) -> SamplingResult:
    """One strategy's row (see the module docstring for ``rl_variant`` and
    ``windows``)."""
    per_phase = _phase_epochs(epochs, windows)
    run = _Run(pde_key, strategy, epochs, batch, lr, seed, arch, rar, rl_variant, device)
    phases = len(per_phase)
    # Each curriculum phase has its own PDE, so its own program (JAX builds
    # one chunk per phase).
    programs = [run.program(run.phase_pde(w, phases), n_ep) for w, n_ep in enumerate(per_phase)]
    try:
        run.warm_up(programs)
        wall = run.timed(programs, per_phase)
        loss, l2, rel_l2 = run.read(programs, per_phase)
    finally:
        run.release(programs)
    return SamplingResult(
        pde=pde_key,
        architecture=arch,
        strategy=(strategy if rl_variant == "coord" or strategy != "adaptive"
                  else f"adaptive[{rl_variant}]"),
        final_loss=loss,
        l2_error=l2,
        rel_l2=rel_l2,
        wall_time_s=wall,
        points_per_sec=epochs * batch / max(wall, 1e-9),
        epochs=epochs,
        seed=seed,
    )


def parse_strategies(strategies: Optional[Sequence[str]]):
    """[(base strategy, rl variant)]; "adaptive[<variant>]" selects a variant."""
    parsed = []
    for s in list(strategies or STRATEGIES):
        variant, base = "coord", s
        if s.startswith("adaptive[") and s.endswith("]"):
            base, variant = "adaptive", s[len("adaptive["):-1]
        if base not in STRATEGIES:
            raise ValueError(f"Unknown strategy {s!r}; valid: {STRATEGIES}")
        if variant not in RL_VARIANTS:
            raise ValueError(f"Unknown adaptive variant {variant!r}")
        parsed.append((base, variant))
    return parsed


def run_sampling_benchmark(
    pde: str = "heat",
    strategies: Optional[Sequence[str]] = None,
    epochs: int = 200,
    batch: int = 1024,
    lr: float = 2e-3,
    seed: int = 0,
    arch: str = "fourier",
    rar: Optional[Dict[str, float]] = None,
    windows: int = 0,
    device: str = "cuda",
) -> List[SamplingResult]:
    """Benchmark every requested strategy. ``rar`` overrides the RAD
    hyper-parameters of residual_based (pool_factor / uniform_floor /
    power); ``windows`` trains the expanding-horizon curriculum."""
    if pde not in PDE_CHOICES:
        raise ValueError(f"pde must be one of {PDE_CHOICES}, got {pde!r}")
    parsed = parse_strategies(strategies)
    _phase_epochs(epochs, windows)  # refuse before any training
    return [
        _train_one(pde, s, epochs, batch, lr, seed, arch=arch, rar=rar, rl_variant=v,
                   windows=windows, device=device)
        for s, v in parsed
    ]


def results_to_csv(results: List[SamplingResult]) -> str:
    header = (
        "pde,architecture,strategy,final_loss,l2_error,rel_l2,"
        "wall_time_s,points_per_sec,epochs,seed"
    )
    rows = [
        f"{r.pde},{r.architecture},{r.strategy},{r.final_loss:.6e},{r.l2_error:.6e},"
        f"{r.rel_l2:.6e},{r.wall_time_s:.3f},{r.points_per_sec:.1f},{r.epochs},{r.seed}"
        for r in results
    ]
    return "\n".join([header] + rows) + "\n"
