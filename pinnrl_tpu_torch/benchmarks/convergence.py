"""Convergence benchmark: rel-L2 against the exact solution for the tuned
per-PDE recipes, as ``pinnrl_tpu.benchmarks.convergence``.

Each recipe is the JAX package's entry unchanged (architecture, points,
optimizer schedule); ``build_recipe_config`` materialises it into a
``Config`` and ``run_convergence`` trains it and reports rel-L2, max error,
wall time and points per second.

Ported: the ``kdv`` and ``burgers`` recipes. ``run_convergence("burgers")``
raises in the trainer, since its ``adam_lbfgs`` optimizer is ROADMAP item 8.
The other recipes raise naming item 11 (their PDEs); experiment directories
and resume raise naming item 9; time-marching raises naming item 13 (no
shipped recipe is multi-stage).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

from pinnrl_tpu_torch.config import Config, load_config
from pinnrl_tpu_torch.models import PINNModel
from pinnrl_tpu_torch.pdes import create_pde
from pinnrl_tpu_torch.training import PDETrainer


@dataclass
class ConvergenceResult:
    pde: str
    architecture: str
    epochs: int
    rel_l2: float
    max_error: float
    final_train_loss: float
    wall_time_s: float
    points_per_sec: float
    seed: int


# Tuned recipes: (arch, model overrides, training overrides), copied from
# pinnrl_tpu/benchmarks/convergence.py, whose comments give their sweeps.
RECIPES: Dict[str, dict] = {
    "kdv": dict(
        arch="fourier",
        # feature_seed pins the random-Fourier basis (shipped as data in
        # config/feature_bases.json).
        model=dict(hidden_dims=[256, 256, 256], mapping_size=256, scale=0.75,
                   feature_seed=0),
        # Annealed Adam at Fourier scale 0.75, mapping 256, 100k collocation
        # points, causal weighting eps = 1.0.
        training=dict(
            num_epochs=1500, num_collocation_points=100000, batch_size=8192,
            optimizer="adam", causal_eps=1.0,
            num_boundary_points=4096, num_initial_points=4096,
            learning_rate=2e-3, weight_decay=0.0,
        ),
    ),
    "burgers": dict(
        # The viscous-shock traveling wave; the front is steep (width
        # 4 nu / a = 0.08), the regime RAR sampling exists for.
        arch="fourier",
        model=dict(hidden_dims=[256, 256, 256], mapping_size=128, scale=2.0),
        pde=dict(
            parameters={"nu": 0.01},
            exact_solution={"type": "traveling_wave", "amplitude": 0.5,
                            "speed": 0.5, "center": -0.25},
            initial_condition={"type": "traveling_wave"},
        ),
        training=dict(
            num_epochs=3000, num_collocation_points=40000, batch_size=8192,
            num_boundary_points=4096, num_initial_points=4096,
            optimizer="adam_lbfgs", adam_lbfgs_switch_ratio=0.5,
            learning_rate=2e-3, weight_decay=0.0,
            collocation_distribution="residual_based",
        ),
    ),
}


def _unported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP item {item})")


def _recipe(pde_key: str) -> dict:
    if pde_key not in RECIPES:
        raise _unported(f"the convergence recipe {pde_key!r} (ported: {sorted(RECIPES)})", 11)
    return RECIPES[pde_key]


def build_recipe_config(pde_key: str, epochs: Optional[int] = None, device: str = "cuda") -> Config:
    """Materialise a RECIPES entry into a Config on ``device``."""
    recipe = _recipe(pde_key)
    cfg = load_config(pde_type=recipe.get("pde_type", pde_key), architecture=recipe["arch"],
                      device=device)
    for k, v in (recipe.get("pde") or {}).items():
        if k == "parameters":
            cfg.pde.parameters.update(v)
        else:
            setattr(cfg.pde, k, v)
    cfg.model.input_dim = cfg.pde.dimension + 1
    m = recipe["model"]
    cfg.model.hidden_dims = list(m.get("hidden_dims", cfg.model.hidden_dims))
    if "hard_ic" in m:
        cfg.model.hard_ic = bool(m["hard_ic"])
    if "output_dim" in m:
        cfg.model.output_dim = int(m["output_dim"])
        cfg.pde.output_dim = int(m["output_dim"])
    for k in (
        "mapping_size", "scale", "omega_0", "hidden_dim", "num_blocks",
        "modified", "periodic", "feature_seed", "moving_frame_speed",
        "trainable_features",
    ):
        if k in m:
            cfg.model.arch_params[k] = m[k]
    t = cfg.training
    tr_over = dict(recipe["training"])
    t.optimizer_config.learning_rate = tr_over.pop("learning_rate", 2e-3)
    t.optimizer_config.weight_decay = tr_over.pop("weight_decay", 0.0)
    if "loss_weights" in tr_over:
        t.loss_weights.update(tr_over.pop("loss_weights"))
    if "lbfgs_batch_size" in tr_over:
        t.lbfgs.batch_size = tr_over.pop("lbfgs_batch_size")
    if "lbfgs_resample_every" in tr_over:
        t.lbfgs.resample_every = tr_over.pop("lbfgs_resample_every")
    for k, v in tr_over.items():
        setattr(t, k, v)
    if epochs:
        t.num_epochs = epochs
    t.early_stopping.enabled = False
    t.loss_weights["smoothness"] = 0.0
    t.validation_frequency = max(t.num_epochs // 4, 1)
    return cfg


def run_convergence(
    pde_key: str,
    seed: int = 0,
    epochs: Optional[int] = None,
    experiment_dir: Optional[str] = None,
    resume_from: Optional[str] = None,
    train_seed: Optional[int] = None,
    device: str = "cuda",
) -> ConvergenceResult:
    """Train one recipe and validate it on 20000 uniform points.

    ``train_seed`` (default: ``seed``) varies only the training draws; the
    model seed fixes the initial weights."""
    if experiment_dir is not None or resume_from is not None:
        raise _unported("experiment directories and resume", 9)
    recipe = _recipe(pde_key)
    cfg = build_recipe_config(pde_key, epochs, device=device)
    t = cfg.training
    pde = create_pde(cfg)
    model = PINNModel(cfg, seed=seed)
    trainer = PDETrainer(model, pde, cfg)
    t0 = time.perf_counter()
    res = trainer.train(seed=seed if train_seed is None else train_seed)
    wall = time.perf_counter() - t0
    params = trainer._final_state["params"]["net"]
    val = pde.validate(model.apply, params, num_points=20000)
    batch = min(t.batch_size, t.num_collocation_points)
    steps = len(trainer.history["train_loss"]) * max(t.num_collocation_points // batch, 1)
    return ConvergenceResult(
        pde=pde_key,
        architecture=recipe["arch"],
        epochs=t.num_epochs,
        rel_l2=val.get("rel_l2", float("nan")),
        max_error=val.get("max_error", float("nan")),
        final_train_loss=res["final_train_loss"],
        wall_time_s=wall,
        points_per_sec=steps * batch / wall,
        seed=seed,
    )


def results_to_csv(results: Sequence[ConvergenceResult]) -> str:
    header = "pde,architecture,epochs,rel_l2,max_error,final_train_loss,wall_time_s,points_per_sec,seed"
    rows = [
        f"{r.pde},{r.architecture},{r.epochs},{r.rel_l2:.6e},{r.max_error:.6e},"
        f"{r.final_train_loss:.6e},{r.wall_time_s:.1f},{r.points_per_sec:.0f},{r.seed}"
        for r in results
    ]
    return "\n".join([header, *rows]) + "\n"


def run_time_marching(pde_key: str, seed: int = 0, n_windows: int = 4,
                      epochs_per_window: Optional[int] = None, mutate=None) -> ConvergenceResult:
    """Time-marching training over sequential windows of the horizon."""
    raise _unported("time-marching", 13)
