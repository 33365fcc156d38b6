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
decay. The JAX harness scans 100 steps per device call; here every step is
eager and reads nothing back: the loss stays on the device and the last one
is read once, after the timed loop.

Before the timed loop a throwaway copy of the run (the same seed) takes
``WARMUP_STEPS`` steps, so the timed steps pay no kernel build, cuBLAS or
allocator set-up and the reported state is not advanced by them.
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

import copy
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch

from pinnrl_tpu_torch.config import load_config
from pinnrl_tpu_torch.models import PINNModel
from pinnrl_tpu_torch.pdes import create_pde
from pinnrl_tpu_torch.rl import RLAgent
from pinnrl_tpu_torch.training.trainer import AdamStep, cosine_decay

STRATEGIES = ("uniform", "stratified", "residual_based", "adaptive")
PDE_CHOICES = ("heat", "wave", "burgers", "kdv")
RL_VARIANTS = ("coord", "resfeat", "improve", "resfeat_improve")
WARMUP_STEPS = 5
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
def _evaluate(pde, model, params, x_grid, t_grid) -> Dict[str, float]:
    u = model.apply(params, torch.cat([x_grid, t_grid], dim=-1))
    u = u.reshape(x_grid.shape[0], -1)[:, 0:1]
    exact = pde.exact_solution(x_grid, t_grid)
    if exact is None:
        return {"l2": float("nan"), "rel_l2": float("nan")}
    exact = exact.reshape(u.shape)
    err = u - exact
    l2 = torch.sqrt(torch.mean(err**2))
    rel = torch.sqrt(torch.sum(err**2)) / (torch.sqrt(torch.sum(exact**2)) + 1e-12)
    l2, rel = torch.stack([l2, rel]).tolist()  # one host read
    return {"l2": l2, "rel_l2": rel}


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
        self.opt = AdamStep(list(self.params.values()), cosine_decay(lr, epochs, 0.0),
                            1.0, 0.9, 0.999, 0.0)
        self.agent = self.rl_state = None
        if strategy == "adaptive":
            self.agent = RLAgent(state_dim=self.cfg.model.input_dim + (1 if self.resfeat else 0),
                                 hidden_dim=64, memory_size=4096, batch_size=64,
                                 device=self.device)
            self.rl_state = self.agent.init(torch.Generator().manual_seed(seed + 1))
        self.prev_loss = torch.zeros((), device=self.device)
        self._done = torch.ones((), device=self.device)

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
        self.prev_loss = loss
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
    args = (pde_key, strategy, epochs, batch, lr, seed, arch, rar, rl_variant, device)
    run = _Run(*args)
    phases = len(per_phase)
    pdes = [run.phase_pde(w, phases) for w in range(phases)]

    # Warm-up on a throwaway copy of the run: the same seed, another stream.
    warm = _Run(*args)
    warm_gen = torch.Generator(device=warm.device).manual_seed(seed + 7919)
    warm_pde = warm.phase_pde(0, phases)
    for _ in range(min(per_phase[0], WARMUP_STEPS)):
        warm.step(warm_pde, warm_gen)
    _sync(warm.device)
    del warm, warm_pde

    gen = torch.Generator(device=run.device).manual_seed(seed)
    loss = None
    _sync(run.device)
    t0 = time.perf_counter()
    for pde_w, n_ep in zip(pdes, per_phase):
        for _ in range(n_ep):
            loss = run.step(pde_w, gen)
    _sync(run.device)
    wall = time.perf_counter() - t0

    x_grid, t_grid = _fixed_validation_grid(run.pde)
    ev = _evaluate(run.pde, run.model, run.params, x_grid, t_grid)
    return SamplingResult(
        pde=pde_key,
        architecture=arch,
        strategy=(strategy if rl_variant == "coord" or strategy != "adaptive"
                  else f"adaptive[{rl_variant}]"),
        final_loss=float(loss),
        l2_error=ev["l2"],
        rel_l2=ev["rel_l2"],
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
