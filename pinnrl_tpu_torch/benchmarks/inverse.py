"""Inverse-problem benchmark: coefficient recovery against the truth, as
``pinnrl_tpu.benchmarks.inverse``.

Each recipe trains in inverse mode against noisy synthetic observations
made at the TRUE coefficients (from a generator seeded ``1000 + seed`` on
the run's device) and reports each parameter's relative recovery error.

Run:  python -m pinnrl_tpu_torch.benchmarks.cli inverse --pde heat
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch

from pinnrl_tpu_torch.config import Config, load_config
from pinnrl_tpu_torch.models import PINNModel
from pinnrl_tpu_torch.pdes import create_pde
from pinnrl_tpu_torch.training import PDETrainer


@dataclass
class InverseResult:
    pde: str
    parameter: str
    true_value: float
    initial_guess: float
    identified: float
    rel_error: float
    epochs: int
    noise: float
    wall_time_s: float
    seed: int


# (identify, guesses, overrides), copied from pinnrl_tpu/benchmarks/inverse.py,
# whose comments give their reasons. Guesses are far from the truth (heat 10x).
RECIPES: Dict[str, dict] = {
    "heat": dict(
        identify=["alpha"],
        guesses={"alpha": 0.1},  # truth 0.01
        arch="fourier",
        model=dict(hidden_dims=[128, 128, 128], mapping_size=64, scale=2.0),
        training=dict(
            num_epochs=2000, num_collocation_points=20000, batch_size=4096,
            num_boundary_points=2048, num_initial_points=2048,
            learning_rate=2e-3,
        ),
        obs=dict(num_points=2000, noise=0.01),
    ),
    "black_scholes": dict(
        identify=["sigma", "r"],
        guesses={"sigma": 0.4, "r": 0.02},  # truth sigma=0.2, r=0.05
        arch="fourier",
        # The well-posed variant of the convergence recipe: time to maturity,
        # the normal-CDF closed form and its trace as the Dirichlet target.
        pde=dict(
            parameters={"sigma": 0.2, "r": 0.05, "time_convention": "to_maturity"},
            exact_solution={"type": "black_scholes", "strike": 100.0,
                            "option_type": "call", "cdf": True},
            boundary_conditions={"dirichlet": {"type": "exact"}},
        ),
        model=dict(hidden_dims=[128, 128, 128], mapping_size=64, scale=1.0),
        training=dict(
            num_epochs=2000, num_collocation_points=20000, batch_size=4096,
            num_boundary_points=2048, num_initial_points=2048,
            learning_rate=2e-3,
        ),
        obs=dict(num_points=2000, noise=0.01),
    ),
}


def build_inverse_config(pde_key: str, epochs: Optional[int] = None, device: str = "cuda") -> Config:
    """Materialise a RECIPES entry into a Config on ``device``."""
    recipe = RECIPES[pde_key]
    cfg = load_config(pde_type=pde_key, architecture=recipe["arch"], device=device)
    for k, v in (recipe.get("pde") or {}).items():
        if k == "parameters":
            cfg.pde.parameters.update(v)
        else:
            setattr(cfg.pde, k, v)
    cfg.pde.trainable_parameters = list(recipe["identify"])
    cfg.pde.parameter_initial_guesses = dict(recipe["guesses"])
    m = recipe["model"]
    cfg.model.hidden_dims = list(m["hidden_dims"])
    for k in ("mapping_size", "scale"):
        if k in m:
            cfg.model.arch_params[k] = m[k]
    t = cfg.training
    t.mode = "inverse"
    tr_over = dict(recipe["training"])
    t.optimizer_config.learning_rate = tr_over.pop("learning_rate", 2e-3)
    for k, v in tr_over.items():
        setattr(t, k, v)
    if epochs:
        t.num_epochs = epochs
    t.early_stopping.enabled = False
    t.validation_frequency = max(t.num_epochs // 4, 1)
    return cfg


def run_inverse(pde_key: str, seed: int = 0, epochs: Optional[int] = None,
                device: str = "cuda") -> List[InverseResult]:
    """Train one recipe in inverse mode; one result per identified parameter."""
    recipe = RECIPES[pde_key]
    cfg = build_inverse_config(pde_key, epochs, device=device)
    t = cfg.training
    pde = create_pde(cfg)
    obs = recipe["obs"]
    pde.generate_synthetic_observations(
        torch.Generator(device=cfg.device).manual_seed(1000 + seed),
        num_points=obs["num_points"],
        noise=obs["noise"],
    )
    model = PINNModel(cfg, seed=seed)
    trainer = PDETrainer(model, pde, cfg)
    t0 = time.perf_counter()
    res = trainer.train(seed=seed)
    wall = time.perf_counter() - t0

    out = []
    for name in recipe["identify"]:
        truth = pde.true_parameters[name]
        ident = res["identified_parameters"][name]
        out.append(InverseResult(
            pde=pde_key,
            parameter=name,
            true_value=float(truth),
            initial_guess=float(recipe["guesses"][name]),
            identified=float(ident),
            rel_error=abs(float(ident) - float(truth)) / max(abs(float(truth)), 1e-12),
            epochs=t.num_epochs,
            noise=float(obs["noise"]),
            wall_time_s=wall,
            seed=seed,
        ))
    return out


def results_to_csv(results: Sequence[InverseResult]) -> str:
    header = (
        "pde,parameter,true_value,initial_guess,identified,rel_error,"
        "epochs,noise,wall_time_s,seed"
    )
    rows = [
        f"{r.pde},{r.parameter},{r.true_value:.6g},{r.initial_guess:.6g},"
        f"{r.identified:.6g},{r.rel_error:.4e},{r.epochs},{r.noise},"
        f"{r.wall_time_s:.1f},{r.seed}"
        for r in results
    ]
    return "\n".join([header, *rows]) + "\n"
