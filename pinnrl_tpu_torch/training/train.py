"""Headless training CLI (``pinnrl-train``), as ``pinnrl_tpu.training.train``.

    python -m pinnrl_tpu_torch.training.train --pde heat --mode inverse \\
        --identify alpha --initial-guess alpha=0.5 --obs-noise 0.01

The JAX package's flags, precedence (CLI > PDE block > architecture block >
dataclass defaults) and failure protocol. ``--device`` is ``cuda`` (the
default; it raises without a card) or ``cpu``. Synthetic observations are
drawn from ``torch.Generator(device).manual_seed(pde.observation_seed)``.
``--dataset NAME`` trains against a The Well registry entry (its domain,
dimensions, channels and recommended mode; the observations through
``datasets.load_well_slice`` and its cache, ``$PINNRL_WELL_CACHE``).
``--profile-dir DIR`` writes one ``torch.profiler`` Chrome trace of a
chunk after the first into DIR.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import traceback
from datetime import datetime
from pathlib import Path

import torch

from pinnrl_tpu_torch.config import Config
from pinnrl_tpu_torch.datasets import get_entry
from pinnrl_tpu_torch.models import PINNModel
from pinnrl_tpu_torch.pdes import PDE_REGISTRY, create_pde
from pinnrl_tpu_torch.rl import RLAgent
from pinnrl_tpu_torch.training.trainer import PDETrainer
from pinnrl_tpu_torch.utils.io import write_config_snapshot
from pinnrl_tpu_torch.utils.logging import setup_logging

logger = logging.getLogger(__name__)

# Display name -> key.
_DISPLAY_TO_KEY = {v.lower(): k for k, v in PDE_REGISTRY.items()}


def resolve_pde_key(name: str) -> str:
    key = name.strip().lower().replace(" ", "_").replace("-", "_")
    if key in PDE_REGISTRY:
        return key
    if name.strip().lower() in _DISPLAY_TO_KEY:
        return _DISPLAY_TO_KEY[name.strip().lower()]
    raise ValueError(f"Unknown PDE {name!r}; valid: {sorted(PDE_REGISTRY)}")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="pinnrl-train", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--pde", required=True, help="PDE key or display name")
    p.add_argument("--arch", default=None, help="Architecture name")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--collocation-points", type=int, default=None)
    p.add_argument("--boundary-points", type=int, default=None)
    p.add_argument("--initial-points", type=int, default=None)
    p.add_argument("--rl", action="store_true", help="Enable DQN adaptive sampling")
    p.add_argument("--sampling", default=None,
                   choices=["uniform", "stratified", "residual_based", "adaptive"])
    p.add_argument("--optimizer", choices=["adam", "lbfgs", "adam_lbfgs"], default=None)
    p.add_argument("--mode", choices=["forward", "inverse", "data_only", "data_augmented"],
                   default=None)
    p.add_argument("--dataset", default=None, help="Well dataset name")
    p.add_argument("--dataset-split", default="train")
    p.add_argument("--dataset-traj", type=int, default=1)
    p.add_argument("--dataset-points", type=int, default=4096)
    p.add_argument("--dataset-seed", type=int, default=0)
    p.add_argument("--dataset-base", default=None)
    p.add_argument("--identify", action="append", default=[],
                   help="PDE parameter to identify in inverse mode (repeatable)")
    p.add_argument("--initial-guess", action="append", default=[],
                   help="e.g. 'alpha=0.5' (repeatable)")
    p.add_argument("--obs-path", default=None, help=".npz with keys x,t,u")
    p.add_argument("--obs-noise", type=float, default=None)
    p.add_argument("--obs-points", type=int, default=None)
    p.add_argument("--loss-function", choices=["mse", "mae", "huber"], default=None)
    p.add_argument("--huber-delta", type=float, default=None)
    p.add_argument("--config", default=None,
                   help="Config file: .json, or YAML (needs PyYAML unless its text is JSON)")
    p.add_argument("--device", default="cuda", help="cuda | cpu")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--results-dir", default=None)
    p.add_argument("--profile-dir", default=None,
                   help="Write one torch.profiler Chrome trace of a chunk after the first")
    return p.parse_args(argv)


def build_config(args: argparse.Namespace) -> Config:
    """Apply the CLI overrides on top of the config file or the defaults."""
    cfg = Config(config_path=args.config, pde_type=resolve_pde_key(args.pde),
                 architecture=args.arch, device=args.device)
    t = cfg.training
    if args.epochs is not None:
        t.num_epochs = args.epochs
    if args.lr is not None:
        t.optimizer_config.learning_rate = args.lr
    if args.batch_size is not None:
        t.batch_size = args.batch_size
    if args.collocation_points is not None:
        t.num_collocation_points = args.collocation_points
    if args.boundary_points is not None:
        t.num_boundary_points = args.boundary_points
    if args.initial_points is not None:
        t.num_initial_points = args.initial_points
    if args.sampling is not None:
        t.collocation_distribution = args.sampling
    if args.optimizer is not None:
        t.optimizer = args.optimizer
    if args.mode is not None:
        t.mode = args.mode
    if args.loss_function is not None:
        t.loss_function = args.loss_function
    if args.huber_delta is not None:
        t.huber_delta = args.huber_delta
    if args.rl:
        cfg.rl.enabled = True
    if args.results_dir:
        cfg.paths.results_dir = args.results_dir
    if args.profile_dir:
        t.profile_dir = args.profile_dir

    # Inverse-problem flags.
    if args.identify:
        cfg.pde.trainable_parameters = list(args.identify)
        if t.mode == "forward":
            t.mode = "inverse"
    for spec in args.initial_guess:
        name, _, val = spec.partition("=")
        cfg.pde.parameter_initial_guesses[name.strip()] = float(val)
    if args.obs_path:
        cfg.pde.observation_data = args.obs_path
    if args.obs_noise is not None:
        cfg.pde.observation_noise = args.obs_noise
    if args.obs_points is not None:
        cfg.pde.num_observation_points = args.obs_points

    if args.dataset:
        _apply_well_dataset_defaults(cfg, args)

    # The overrides mutate a validated Config: check its invariants again
    # (e.g. --mode inverse without --identify).
    cfg._validate()
    return cfg


def _apply_well_dataset_defaults(cfg: Config, args: argparse.Namespace) -> None:
    """The registry entry's defaults over the config: the observation spec,
    the domain and dimensions, the channels and (unless ``--mode`` was
    given) the recommended mode."""
    entry = get_entry(args.dataset)
    cfg.pde.observation_data = {
        "source": "well",
        "name": entry.name,
        "split": args.dataset_split,
        "n_traj": args.dataset_traj,
        "n_points": args.dataset_points,
        "seed": args.dataset_seed,
        "base": args.dataset_base,
    }
    cfg.pde.dimension = entry.n_spatial_dims
    cfg.pde.domain = [list(d) for d in entry.domain]
    cfg.pde.time_domain = list(entry.time_domain)
    cfg.model.input_dim = entry.default_input_dim
    cfg.model.output_dim = entry.default_output_dim
    if args.mode is None:
        cfg.training.mode = entry.recommended_mode


def make_agent(cfg: Config) -> RLAgent:
    """The DQN agent of ``cfg.rl``, on ``cfg.device``."""
    rl = cfg.rl
    return RLAgent(
        state_dim=cfg.model.input_dim, action_dim=rl.action_dim, hidden_dim=rl.hidden_dim,
        learning_rate=rl.learning_rate, gamma=rl.gamma, epsilon_start=rl.epsilon_start,
        epsilon_end=rl.epsilon_end, epsilon_decay=rl.epsilon_decay, memory_size=rl.memory_size,
        batch_size=rl.batch_size, target_update=rl.target_update,
        reward_weights=dict(rl.reward_weights), device=cfg.device,
    )


def run_training(cfg: Config, seed: int = 0, dataset_tag: str | None = None):
    """Create the experiment directory and train in it; on failure, record
    the error in its metadata.json, remove ``.running`` and re-raise."""
    timestamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    rl_status = "rl" if cfg.rl.enabled else "norl"
    tag = dataset_tag or cfg.pde_type
    experiment_name = f"{timestamp}_{tag}_{cfg.model.architecture}_{rl_status}"
    experiment_dir = Path(cfg.paths.results_dir) / experiment_name
    experiment_dir.mkdir(parents=True, exist_ok=True)
    write_config_snapshot(experiment_dir / "config.yaml", cfg)
    print(f"Experiment: {experiment_name}")
    print(f"Directory: {experiment_dir}")

    try:
        pde = create_pde(cfg)
        # Synthetic observations for inverse mode without explicit ones.
        if cfg.training.mode in ("inverse", "data_augmented") and pde.observations is None:
            pde.generate_synthetic_observations(
                torch.Generator(device=cfg.device).manual_seed(cfg.pde.observation_seed),
                num_points=cfg.pde.num_observation_points,
                noise=cfg.pde.observation_noise,
            )
        model = PINNModel(cfg, seed=seed)
        agent = make_agent(cfg) if cfg.rl.enabled else None
        trainer = PDETrainer(model, pde, cfg, rl_agent=agent)
        result = trainer.train(experiment_dir=str(experiment_dir), seed=seed)
        print(f"Final train loss: {result['final_train_loss']:.6e}")
        if result["identified_parameters"]:
            print(f"Identified parameters: {result['identified_parameters']}")
            print(f"True parameters:       {result['true_parameters']}")
        return result
    except Exception as exc:
        meta_path = experiment_dir / "metadata.json"
        meta = {}
        if meta_path.exists():
            try:
                meta = json.loads(meta_path.read_text())
            except ValueError:
                pass
        meta.update({"status": "failed", "error": str(exc), "traceback": traceback.format_exc()})
        meta_path.write_text(json.dumps(meta, indent=2, default=str))
        (experiment_dir / ".running").unlink(missing_ok=True)
        raise


def main(argv=None) -> int:
    args = parse_args(argv)
    setup_logging()
    cfg = build_config(args)
    run_training(cfg, seed=args.seed, dataset_tag=args.dataset or None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
