"""Convergence benchmark: rel-L2 against the exact solution for the tuned
per-PDE recipes, as ``pinnrl_tpu.benchmarks.convergence``.

Each recipe is the JAX package's entry unchanged (architecture, points,
optimizer schedule); ``build_recipe_config`` materialises it into a
``Config`` and ``run_convergence`` trains it and reports rel-L2, max error,
wall time and points per second.

All 14 recipes are ported: ``heat``, ``kdv``, ``wave``, ``burgers``,
``heat_2d``, ``convection``, ``allen_cahn``, ``black_scholes``,
``pendulum``, ``allen_cahn_dynamics``, ``pendulum_nonlinear``,
``cahn_hilliard_dynamics``, ``cahn_hilliard_biharmonic`` and
``cahn_hilliard``; all but kdv and cahn_hilliard train with Adam, then
L-BFGS (``adam_lbfgs``). ``allen_cahn_dynamics`` and
``cahn_hilliard_dynamics`` run against their ETDRK4 spectral trajectories,
``pendulum_nonlinear`` against the pendulum's Jacobi-elliptic solution,
``cahn_hilliard_biharmonic`` is the direct fourth-order form and
``cahn_hilliard`` the 2-D mixed form on the attention trunk.
``points_per_sec`` counts each epoch at its own batch: the Adam epochs'
steps times the batch, each L-BFGS epoch's iterations times the L-BFGS
batch (the JAX package counts every epoch at the Adam batch).
An unknown key raises KeyError; ``experiment_dir`` writes the run's
experiment directory with its checkpoints (no plots, validation at least
every tenth of the run, as the JAX package does), and ``resume_from``
continues from such a checkpoint. A recipe with ``stages`` trains through
``training.multistage.run_multistage`` (no shipped recipe has them).

``run_time_marching`` trains the horizon as equal windows, each from the
previous window's weights (copied: the port's trainer updates parameters in
place) with its IC taken from the previous window's model at the window's
start, and validates the stitched solution on 20000 / n_windows points per
window. Those points come from ``torch.Generator().manual_seed(1234)``
(JAX: ``PRNGKey(1234)``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from pinnrl_tpu_torch.config import Config, load_config
from pinnrl_tpu_torch.models import PINNModel
from pinnrl_tpu_torch.pdes import create_pde
from pinnrl_tpu_torch.sampling import sample_uniform
from pinnrl_tpu_torch.training import PDETrainer
from pinnrl_tpu_torch.training.multistage import StageSpec, run_multistage


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
    "heat": dict(
        arch="fourier",
        # The sin(pi x) decay mode wants a low-frequency basis: scale 0.75.
        model=dict(hidden_dims=[256, 256, 256], mapping_size=128, scale=0.75),
        training=dict(
            num_epochs=3000, num_collocation_points=40000, batch_size=8192,
            num_boundary_points=4096, num_initial_points=4096,
            optimizer="adam_lbfgs", adam_lbfgs_switch_ratio=0.4,
            learning_rate=2e-3, weight_decay=0.0,
        ),
    ),
    "kdv": dict(
        arch="fourier",
        # feature_seed pins the random-Fourier basis (JAX's threefry draw,
        # utils/prng.py).
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
    "wave": dict(
        arch="fourier",
        # The sin(2 pi (x - c t)) mode wants a low-frequency basis: scale 0.35.
        model=dict(hidden_dims=[256, 256, 256], mapping_size=128, scale=0.35),
        training=dict(
            num_epochs=3000, num_collocation_points=40000, batch_size=8192,
            num_boundary_points=4096, num_initial_points=4096,
            optimizer="adam_lbfgs", adam_lbfgs_switch_ratio=0.5,
            learning_rate=1e-3, weight_decay=0.0,
            loss_weights={"residual": 1.0, "boundary": 100.0, "initial": 100.0,
                          "smoothness": 0.0, "data": 10.0},
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
    "heat_2d": dict(
        arch="fourier",
        # The single smooth 2-D sine mode wants a low-frequency basis (scale
        # 0.5); the config's default loss weights (residual 15, boundary 20,
        # initial 10) beat boosted BC/IC weights.
        model=dict(hidden_dims=[256, 256, 256], mapping_size=128, scale=0.5),
        training=dict(
            num_epochs=3000, num_collocation_points=40000, batch_size=8192,
            num_boundary_points=8192, num_initial_points=8192,
            optimizer="adam_lbfgs", adam_lbfgs_switch_ratio=0.5,
            learning_rate=2e-3, weight_decay=0.0,
        ),
    ),
    "convection": dict(
        # Linear advection of sin(2 pi (x - t)). IC frequency 2.0 so the IC
        # matches the exact solution at t = 0; exact-aware Dirichlet BCs
        # because the inflow boundary value -sin(2 pi t) is nonzero.
        arch="fourier",
        model=dict(hidden_dims=[256, 256, 256], mapping_size=128, scale=1.0),
        pde=dict(
            initial_condition={"type": "sin", "amplitude": 1.0, "frequency": 2.0},
            boundary_conditions={"dirichlet": {"type": "exact"}},
        ),
        training=dict(
            num_epochs=1500, num_collocation_points=40000, batch_size=8192,
            num_boundary_points=4096, num_initial_points=4096,
            optimizer="adam_lbfgs", adam_lbfgs_switch_ratio=0.5,
            learning_rate=2e-3, weight_decay=0.0,
        ),
    ),
    "allen_cahn": dict(
        # The genuine stationary interface tanh(x / (sqrt(2) eps)).
        arch="fourier",
        model=dict(hidden_dims=[256, 256, 256], mapping_size=128, scale=2.0),
        pde=dict(
            exact_solution={"type": "stationary_interface"},
            initial_condition={"type": "stationary_interface"},
            boundary_conditions={"dirichlet": {"type": "exact"}},
        ),
        training=dict(
            num_epochs=1500, num_collocation_points=40000, batch_size=8192,
            num_boundary_points=4096, num_initial_points=4096,
            optimizer="adam_lbfgs", adam_lbfgs_switch_ratio=0.5,
            learning_rate=2e-3, weight_decay=0.0,
        ),
    ),
    "black_scholes": dict(
        # The self-consistent time-to-maturity convention and the textbook
        # normal-CDF closed form.
        arch="fourier",
        model=dict(hidden_dims=[256, 256, 256], mapping_size=128, scale=1.0),
        pde=dict(
            parameters={"sigma": 0.2, "r": 0.05, "time_convention": "to_maturity"},
            exact_solution={"type": "black_scholes", "strike": 100.0,
                            "option_type": "call", "cdf": True},
            boundary_conditions={"dirichlet": {"type": "exact"}},
        ),
        training=dict(
            num_epochs=1500, num_collocation_points=40000, batch_size=8192,
            num_boundary_points=4096, num_initial_points=4096,
            optimizer="adam_lbfgs", adam_lbfgs_switch_ratio=0.5,
            learning_rate=2e-3, weight_decay=0.0,
        ),
    ),
    "pendulum": dict(
        # The linearized restoring force, so theta0 cos(omega t) is exact; the
        # anisotropic scale (0, 1) gives zero x-frequencies, so the network
        # is exactly independent of the dummy spatial axis.
        arch="fourier",
        model=dict(
            hidden_dims=[256, 256, 256], mapping_size=128, scale=(0.0, 1.0)
        ),
        pde=dict(
            parameters={"g": 9.81, "L": 1.0, "linearized": True},
            boundary_conditions={"dirichlet": {"type": "exact"}},
        ),
        training=dict(
            num_epochs=1500, num_collocation_points=40000, batch_size=8192,
            num_boundary_points=4096, num_initial_points=4096,
            optimizer="adam_lbfgs", adam_lbfgs_switch_ratio=0.5,
            learning_rate=2e-3, weight_decay=0.0,
        ),
    ),
    "pendulum_nonlinear": dict(
        # The nonlinear residual against the exact Jacobi-elliptic solution
        # at amplitude 0.5 rad (ops/special.py); the basis pinned by
        # feature_seed 0, like KdV's.
        pde_type="pendulum",
        arch="fourier",
        model=dict(
            hidden_dims=[256, 256, 256], mapping_size=128, scale=(0.0, 1.0),
            feature_seed=0,
        ),
        pde=dict(
            parameters={"g": 9.81, "L": 1.0},
            exact_solution={"type": "elliptic", "initial_angle": 0.5},
            initial_condition={"type": "small_angle", "initial_angle": 0.5},
            boundary_conditions={"dirichlet": {"type": "exact"}},
        ),
        training=dict(
            num_epochs=1500, num_collocation_points=40000, batch_size=8192,
            num_boundary_points=4096, num_initial_points=4096,
            optimizer="adam_lbfgs", adam_lbfgs_switch_ratio=0.5,
            learning_rate=2e-3, weight_decay=0.0,
        ),
    ),
    "allen_cahn_dynamics": dict(
        # A time-dependent phase-field target: the ETDRK4 spectral
        # trajectory of domain formation and interface relaxation from
        # large-amplitude modes (0.6 / 0.3).
        pde_type="allen_cahn",
        arch="fourier",
        model=dict(hidden_dims=[256, 256, 256], mapping_size=128, scale=1.0),
        pde=dict(
            parameters={"epsilon": 0.5},
            domain=[[0.0, 6.283185307179586]],
            time_domain=[0.0, 4.0],
            exact_solution={"type": "spectral", "ic_modes": [[1, 0.6], [2, 0.3]],
                            "nx": 128, "dt": 2e-3},
            initial_condition={"type": "spectral"},
            boundary_conditions={"periodic": {}},
        ),
        training=dict(
            num_epochs=3000, num_collocation_points=40000, batch_size=8192,
            num_boundary_points=4096, num_initial_points=4096,
            optimizer="adam_lbfgs", adam_lbfgs_switch_ratio=0.5,
            learning_rate=2e-3, weight_decay=0.0,
        ),
    ),
    "cahn_hilliard_dynamics": dict(
        # Fourth-order phase-field dynamics against the ETDRK4 trajectory
        # from large-amplitude modes, in the mixed (u, mu) form; eps 0.5
        # keeps the linear growth rate 1/(4 eps^2) at 1. The mass penalty
        # pins the conserved mean, mu_h2 the k^2-amplified compatibility
        # error; causal weighting; L-BFGS polish.
        pde_type="cahn_hilliard",
        arch="fourier",
        model=dict(hidden_dims=[256, 256, 256], mapping_size=128, scale=1.0,
                   output_dim=2),
        pde=dict(
            parameters={"epsilon": 0.5, "formulation": "mixed"},
            domain=[[0.0, 6.283185307179586]],
            time_domain=[0.0, 4.0],
            dimension=1,
            exact_solution={"type": "spectral", "ic_modes": [[1, 0.6], [2, 0.3]],
                            "nx": 256, "dt": 1e-3},
            initial_condition={"type": "spectral"},
            boundary_conditions={"periodic": {}},
        ),
        training=dict(
            num_epochs=8000, num_collocation_points=40000, batch_size=8192,
            num_boundary_points=4096, num_initial_points=4096,
            optimizer="adam_lbfgs", adam_lbfgs_switch_ratio=0.5,
            learning_rate=2e-3, weight_decay=0.0,
            loss_weights={"mass": 100.0, "mu_h2": 0.1},
            causal_eps=1.0,
        ),
    ),
    "cahn_hilliard_biharmonic": dict(
        # The direct fourth-order residual (four nested jvps) against the
        # 1-D standing interface tanh(x / (sqrt(2) eps)): a t-free basis
        # (scale (1, 0)), a long cosine horizon, then L-BFGS rounds on
        # fresh batches (the batch of 16384 is capped at the 4096
        # collocation points, as in the JAX package).
        pde_type="cahn_hilliard",
        arch="fourier",
        model=dict(hidden_dims=[128, 128, 128], mapping_size=64,
                   scale=(1.0, 0.0)),
        pde=dict(
            dimension=1,
            parameters={"epsilon": 0.18, "formulation": "direct"},
            domain=[[-1.0, 1.0]],
            time_domain=[0.0, 1.0],
            exact_solution={"type": "stationary_interface"},
            initial_condition={"type": "stationary_interface"},
            boundary_conditions={"dirichlet": {"type": "exact"}},
        ),
        training=dict(
            num_epochs=97500, num_collocation_points=4096, batch_size=4096,
            num_boundary_points=512, num_initial_points=512,
            optimizer="adam_lbfgs", adam_lbfgs_switch_ratio=0.9846,
            lbfgs_batch_size=16384, lbfgs_resample_every=500,
            learning_rate=2e-3, weight_decay=0.0,
        ),
    ),
    "cahn_hilliard": dict(
        # The 2-D headline: the standing interface tanh(x / (sqrt(2) eps)),
        # exact in any dimension, on the self-attention trunk (its factory
        # reads arch_params.hidden_dim, 124; hidden_dims is unused), in the
        # mixed (u, mu) form. The shipped block's Dirichlet (the exact
        # trace here) and zero-Neumann BCs stay.
        arch="attention",
        model=dict(hidden_dims=[128, 128, 128, 128], output_dim=2),
        pde=dict(
            dimension=2,
            domain=[[-0.5, 0.5], [-0.5, 0.5]],
            time_domain=[0.0, 1.0],
            parameters={"formulation": "mixed"},
            exact_solution={"type": "stationary_interface"},
            initial_condition={"type": "stationary_interface"},
        ),
        training=dict(
            num_epochs=2000, num_collocation_points=20000, batch_size=4096,
            num_boundary_points=4096, num_initial_points=4096,
            learning_rate=1e-3, weight_decay=0.0,
        ),
    ),
}


def _recipe(pde_key: str) -> dict:
    if pde_key not in RECIPES:
        raise KeyError(f"unknown convergence recipe {pde_key!r}; valid: {sorted(RECIPES)}")
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
    model seed fixes the initial weights (and the Fourier basis), so a run
    resumed from ``experiment_dir``'s checkpoint keeps ``seed`` and may vary
    ``train_seed`` to draw fresh L-BFGS batches."""
    recipe = _recipe(pde_key)
    cfg = build_recipe_config(pde_key, epochs, device=device)
    t = cfg.training
    if experiment_dir:
        cfg.evaluation.save_plots = False
        t.validation_frequency = min(t.validation_frequency, max(t.num_epochs // 10, 1))
    pde = create_pde(cfg)
    stages = recipe.get("stages")
    if stages:
        # The base and its correction stages; ``epochs`` caps the base.
        specs = [StageSpec(**s) for s in stages]
        t0 = time.perf_counter()
        ms = run_multistage(cfg, specs, seed=seed, pde=pde)
        wall = time.perf_counter() - t0
        val = ms.stage_metrics[-1]
        total_epochs = t.num_epochs + sum(s.epochs or t.num_epochs for s in specs)
        batch = min(t.batch_size, t.num_collocation_points)
        steps = total_epochs * max(t.num_collocation_points // batch, 1)
        return ConvergenceResult(
            pde=pde_key, architecture=recipe["arch"], epochs=total_epochs,
            rel_l2=val.get("rel_l2", float("nan")), max_error=val.get("max_error", float("nan")),
            final_train_loss=float("nan"), wall_time_s=wall,
            points_per_sec=steps * batch / wall, seed=seed,
        )
    model = PINNModel(cfg, seed=seed)
    trainer = PDETrainer(model, pde, cfg)
    t0 = time.perf_counter()
    res = trainer.train(seed=seed if train_seed is None else train_seed,
                        experiment_dir=experiment_dir, resume_from=resume_from)
    wall = time.perf_counter() - t0
    params = trainer._final_state["params"]["net"]
    val = pde.validate(model.apply, params, num_points=20000)
    return ConvergenceResult(
        pde=pde_key,
        architecture=recipe["arch"],
        epochs=t.num_epochs,
        rel_l2=val.get("rel_l2", float("nan")),
        max_error=val.get("max_error", float("nan")),
        final_train_loss=res["final_train_loss"],
        wall_time_s=wall,
        points_per_sec=_points_trained(t, trainer.switch_epoch, len(trainer.history["train_loss"]))
        / wall,
        seed=seed,
    )


def _points_trained(t, switch_epoch: Optional[int], epochs: int) -> int:
    """Collocation points that ``epochs`` epochs went through: each Adam
    epoch's steps times its batch, each L-BFGS epoch's iterations times the
    L-BFGS batch."""
    n = t.num_collocation_points
    lbfgs_batch = min(t.lbfgs.batch_size or n, n)
    if t.optimizer == "lbfgs":
        return epochs * max(n // lbfgs_batch, 1) * lbfgs_batch
    batch = min(t.batch_size, n)
    adam_epochs = epochs if switch_epoch is None else min(epochs, switch_epoch)
    phase2_batch = lbfgs_batch  # phase2_optimizer "adam" also steps once per epoch on it
    return adam_epochs * max(n // batch, 1) * batch + (epochs - adam_epochs) * phase2_batch


def results_to_csv(results: Sequence[ConvergenceResult]) -> str:
    header = "pde,architecture,epochs,rel_l2,max_error,final_train_loss,wall_time_s,points_per_sec,seed"
    rows = [
        f"{r.pde},{r.architecture},{r.epochs},{r.rel_l2:.6e},{r.max_error:.6e},"
        f"{r.final_train_loss:.6e},{r.wall_time_s:.1f},{r.points_per_sec:.0f},{r.seed}"
        for r in results
    ]
    return "\n".join([header, *rows]) + "\n"


def run_time_marching(pde_key: str, seed: int = 0, n_windows: int = 4,
                      epochs_per_window: Optional[int] = None, mutate=None,
                      device: str = "cuda") -> ConvergenceResult:
    """Time-marching training: window k trains on [t_k, t_{k+1}] with its
    initial condition taken from window k-1's trained model at t_k (window
    0 keeps the problem's IC) and starts from window k-1's weights. The
    stitched solution is validated window by window against the exact
    solution and aggregated into one rel-L2, returned as ``<key>_tm<N>``.

    ``mutate(cfg)``, when given, is applied to every window's config; it
    must keep the window's ``time_domain`` and ``num_epochs``. Window k's
    inherited IC reads window k-1's parameters, which no later window's
    optimizer holds (each window starts from copies)."""
    cfg0 = build_recipe_config(pde_key, device=device)
    t_lo_full, t_hi_full = cfg0.pde.time_domain
    edges = np.linspace(t_lo_full, t_hi_full, n_windows + 1)
    epw = epochs_per_window or max(cfg0.training.num_epochs // n_windows, 1)

    prev = None  # (apply_fn, params) of the previous window's model
    window_models = []
    total_wall = 0.0
    total_loss = 0.0
    for w in range(n_windows):
        cfg = build_recipe_config(pde_key, epochs=epw, device=device)
        cfg.pde.time_domain = [float(edges[w]), float(edges[w + 1])]
        cfg.training.validation_frequency = max(epw // 2, 1)
        if mutate is not None:
            mutate(cfg)
        pde = create_pde(cfg)
        model = PINNModel(cfg, seed=seed)
        if prev is not None:
            prev_apply, prev_params = prev
            t_anchor = float(edges[w])

            def inherited_ic(x, t, _a=prev_apply, _p=prev_params, _t=t_anchor):
                z = torch.cat([x, torch.full((x.shape[0], 1), _t, dtype=x.dtype, device=x.device)],
                              dim=-1)
                return _a(_p, z).reshape(x.shape[0], -1)[:, 0:1]

            pde.boundary_conditions["initial"] = inherited_ic
            # Warm start from the previous window's weights, as copies.
            with torch.no_grad():
                for k, p in model.params.items():
                    p.copy_(prev_params[k])
        trainer = PDETrainer(model, pde, cfg)
        t0 = time.perf_counter()
        res = trainer.train(seed=seed + w)
        total_wall += time.perf_counter() - t0
        total_loss = res["final_train_loss"]
        params = trainer._final_state["params"]["net"]
        window_models.append((model.apply, params, pde))
        prev = (model.apply, params)

    x_t = [_stitch_points(pde, 20000 // n_windows) for _, _, pde in window_models]
    rel_l2, max_err = _stitched_errors(window_models, x_t)
    t = cfg0.training
    batch = min(t.batch_size, t.num_collocation_points)
    steps = n_windows * epw * max(t.num_collocation_points // batch, 1)
    return ConvergenceResult(
        pde=f"{pde_key}_tm{n_windows}",
        architecture=RECIPES[pde_key]["arch"],
        epochs=n_windows * epw,
        rel_l2=rel_l2,
        max_error=max_err,
        final_train_loss=total_loss,
        wall_time_s=total_wall,
        points_per_sec=steps * batch / max(total_wall, 1e-9),
        seed=seed,
    )


def _stitch_points(pde, n: int):
    """A window's validation points: uniform, from a generator seeded 1234."""
    return sample_uniform(torch.Generator(device=pde.device).manual_seed(1234), n, pde.domain,
                          pde.time_domain)


@torch.no_grad()
def _stitched_errors(window_models, x_t):
    """(rel-L2, max error) of the stitched solution: each window's (apply,
    params, pde) on its points ``x_t[k]`` = (x, t), the squared errors and
    the exact solution's squares summed over every window."""
    err_sq, exact_sq, max_err = 0.0, 0.0, 0.0
    for (apply_fn, params, pde), (x, tt) in zip(window_models, x_t):
        ex = pde.exact_solution(x, tt)
        pred = apply_fn(params, torch.cat([x, tt], -1)).reshape(x.shape[0], -1)[:, 0:1]
        diff = (pred - ex.reshape(pred.shape)).cpu().numpy()  # float32 sums, as JAX's
        err_sq += float((diff**2).sum())
        exact_sq += float((ex.cpu().numpy() ** 2).sum())
        max_err = max(max_err, float(np.abs(diff).max()))
    return (err_sq ** 0.5) / ((exact_sq ** 0.5) + 1e-12), max_err
