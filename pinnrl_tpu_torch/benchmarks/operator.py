"""The Well operator benchmark, as ``pinnrl_tpu.benchmarks.operator``.

``run_operator_benchmark``: the registry's architecture (the point-wise FNO
for ``synthetic_heat_2d``) trained through ``PDETrainer`` in the registry's
mode (``data_only``) on a Well slice served by ``load_well_slice``, with the
held-out rel-L2 on a disjoint split of the same field. Offline, the
``synthetic_heat_2d`` entry writes exact heat-kernel trajectories into the
loader's cache first, so the run takes the pipeline a real Well dataset
would: the registry overlay (as ``training/train.py --dataset``), the cache,
the data-mode loss gating.

``run_gridded_operator_benchmark``: operator learning proper. The gridded
2D FNO (``models/fno_grid.py``) learns the one-step map u(., t_i) ->
u(., t_{i+1}) from whole-field pairs of 10 trajectories and is evaluated on
2 held-out ones (unseen input functions), and optionally on the held-out
trajectories regenerated at other resolutions (the same weights). Batches
of 16 pairs are drawn without replacement from a ``torch.Generator`` seeded
``seed + 1``; Adam on a cosine schedule, in whole chunks of
``min(50, epochs)`` steps, as the JAX harness counts them. An epoch (the
draw, the forward and backward, the Adam step) is a step program
(``training/step_program.py``): on the card its first epoch runs eagerly
(cuFFT makes its plans there), the second is captured as a CUDA graph and
every epoch replays it; the last loss is read once, after the loop. The
wall time keeps the set-up and the capture, as JAX's keeps its first
chunk's compile.

Run:  python -m pinnrl_tpu_torch.benchmarks.cli operator --dataset synthetic_heat_2d
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from pinnrl_tpu_torch.config import load_config, resolve_device
from pinnrl_tpu_torch.datasets import get_entry, load_well_slice
from pinnrl_tpu_torch.models import PINNModel
from pinnrl_tpu_torch.pdes import create_pde
from pinnrl_tpu_torch.training import PDETrainer
from pinnrl_tpu_torch.training.step_program import StepProgram, step_path
from pinnrl_tpu_torch.training.trainer import AdamStep, cosine_decay


@dataclass
class OperatorResult:
    dataset: str
    architecture: str
    mode: str
    epochs: int
    train_points: int
    test_rel_l2: float
    test_max_error: float
    final_train_loss: float
    wall_time_s: float
    seed: int


def run_operator_benchmark(
    dataset: str = "synthetic_heat_2d",
    arch: Optional[str] = None,
    epochs: int = 2000,
    n_traj: int = 1,
    n_points: int = 8192,
    seed: int = 0,
    base: Optional[str] = None,
    device: str = "cuda",
) -> OperatorResult:
    """The point-wise run. The test split holds points disjoint from the
    train points on the same field (a point-wise model has no input-function
    conditioning); ``n_traj`` defaults to 1, because several trajectories
    put conflicting targets at equal coordinates."""
    entry = get_entry(dataset)
    if dataset.startswith("synthetic"):
        from pinnrl_tpu_torch.datasets.synthetic import ensure_synthetic_well_cache

        for split in ("train", "test"):
            ensure_synthetic_well_cache(dataset, split=split, n_traj=n_traj, n_points=n_points,
                                        seed=seed, base=base)

    arch = arch or entry.default_architecture
    cfg = load_config(pde_type=entry.default_pde_key or "heat", architecture=arch, device=device)
    cfg.pde.observation_data = {
        "source": "well", "name": entry.name, "split": "train",
        "n_traj": n_traj, "n_points": n_points, "seed": seed, "base": base,
    }
    cfg.pde.dimension = entry.n_spatial_dims
    cfg.pde.domain = [list(d) for d in entry.domain]
    cfg.pde.time_domain = list(entry.time_domain)
    cfg.model.input_dim = entry.default_input_dim
    cfg.model.output_dim = entry.default_output_dim
    cfg.training.mode = entry.recommended_mode
    cfg.training.num_epochs = epochs
    cfg.training.num_collocation_points = max(n_points, 1024)
    cfg.training.batch_size = min(4096, n_points)
    cfg.training.early_stopping.enabled = False
    cfg.training.validation_frequency = max(epochs // 4, 1)

    pde = create_pde(cfg)
    model = PINNModel(cfg, seed=seed)
    trainer = PDETrainer(model, pde, cfg)
    t0 = time.perf_counter()
    res = trainer.train(seed=seed)
    wall = time.perf_counter() - t0

    test = load_well_slice(entry.name, split="test", n_traj=n_traj, n_points=n_points,
                           seed=seed, base=base)
    params = trainer._final_state["params"]["net"]
    z = torch.as_tensor(np.concatenate([test["x"], test["t"]], axis=-1), dtype=torch.float32,
                        device=model.device)
    with torch.no_grad():
        pred = model.apply(params, z).cpu().numpy().reshape(test["u"].shape[0], -1)
    u = np.asarray(test["u"]).reshape(pred.shape)
    diff = pred - u
    return OperatorResult(
        dataset=entry.name,
        architecture=arch,
        mode=cfg.training.mode,
        epochs=epochs,
        train_points=n_points,
        test_rel_l2=float(np.linalg.norm(diff) / (np.linalg.norm(u) + 1e-12)),
        test_max_error=float(np.abs(diff).max()),
        final_train_loss=float(res["final_train_loss"]),
        wall_time_s=wall,
        seed=seed,
    )


def make_pairs(traj_list):
    """(inputs, targets): each trajectory's steps 0..n-2 and 1..n-1, stacked."""
    a = np.concatenate([tr[:-1] for tr in traj_list], axis=0)
    u = np.concatenate([tr[1:] for tr in traj_list], axis=0)
    return np.asarray(a, np.float32), np.asarray(u, np.float32)


def _batch_indices(n: int, batch: int, generator: torch.Generator) -> torch.Tensor:
    """``batch`` of range(n) without replacement, on the generator's device."""
    return torch.randperm(n, generator=generator, device=generator.device)[:batch]


def gridded_program(fno, opt: AdamStep, a_all: torch.Tensor, u_all: torch.Tensor, batch: int,
                    generator: torch.Generator, epochs: int) -> StepProgram:
    """One epoch of the gridded FNO on the pairs (``a_all``, ``u_all``): a
    batch drawn from ``generator``, the MSE, its gradients and the Adam step,
    as a step program whose rows keep ``epochs`` losses."""
    n = a_all.shape[0]

    def epoch() -> torch.Tensor:
        idx = _batch_indices(n, batch, generator)
        loss = torch.mean((fno(a_all[idx]) - u_all[idx]) ** 2)
        for p in opt.params:
            p.grad = None
        loss.backward()
        opt.step()
        return loss.detach()

    path, _ = step_path(a_all.device, harness="gridded operator")
    return StepProgram(epoch, path, a_all.device, capacity=epochs, generators=[generator],
                       optimizers=[opt], name="gridded epoch")


def run_gridded_operator_benchmark(
    dataset: str = "synthetic_heat_2d",
    epochs: int = 400,
    n_traj_train: int = 10,
    n_traj_test: int = 2,
    width: int = 32,
    modes: int = 12,
    num_blocks: int = 4,
    lr: float = 2e-3,
    seed: int = 0,
    transfer_resolutions: Sequence[int] = (),
    device: str = "cuda",
) -> List[OperatorResult]:
    """``[primary]`` plus one row per entry of ``transfer_resolutions``."""
    from pinnrl_tpu_torch.datasets.synthetic import generate_heat_2d_trajectory
    from pinnrl_tpu_torch.models.fno_grid import GridFNO2D

    device = torch.device(resolve_device(device))
    trajs = [generate_heat_2d_trajectory(i) for i in range(n_traj_train + n_traj_test)]
    a_train, u_train = make_pairs(trajs[:n_traj_train])
    a_test, u_test = make_pairs(trajs[n_traj_train:])

    fno = GridFNO2D(in_channels=1, out_channels=1, width=width, modes=modes,
                    num_blocks=num_blocks, grid=a_train.shape[1:3],
                    generator=torch.Generator().manual_seed(seed)).to(device)
    params = list(fno.parameters())
    # The capturable Adam (the host-lr one on the CPU): the eager first epoch
    # computes what the replays do.
    opt = AdamStep(params, cosine_decay(lr, epochs, 0.0), None, 0.9, 0.999, 0.0,
                   capturable=True)
    a_all = torch.as_tensor(a_train, device=device)
    u_all = torch.as_tensor(u_train, device=device)
    batch = min(16, a_train.shape[0])
    gen = torch.Generator(device=device).manual_seed(seed + 1)

    inner = min(50, epochs)
    # Whole chunks: the row reports the steps run.
    epochs_run = -(-epochs // inner) * inner
    program = gridded_program(fno, opt, a_all, u_all, batch, gen, epochs_run)
    t0 = time.perf_counter()
    try:
        for _ in range(epochs_run):
            program.run()
        # One host read: the last loss, and the replays' kernel launches.
        flat = torch.cat([program.rows[-1].double()]
                         + ([program.tally.double()] if program.tally is not None else [])).tolist()
        wall = time.perf_counter() - t0
        program.settle(flat[1:])
    finally:
        program.release()
        for p in params:
            p.grad = None
    final_loss = flat[0]

    def row(tag: str, a: np.ndarray, u: np.ndarray) -> OperatorResult:
        with torch.no_grad():
            diff = fno(torch.as_tensor(a, device=device)).cpu().numpy() - u
        return OperatorResult(
            dataset=f"{dataset}({tag})",
            architecture="grid_fno2d",
            mode="operator",
            epochs=epochs_run,
            train_points=int(np.prod(a_train.shape)),
            test_rel_l2=float(np.linalg.norm(diff) / (np.linalg.norm(u) + 1e-12)),
            test_max_error=float(np.abs(diff).max()),
            final_train_loss=final_loss,
            wall_time_s=wall,
            seed=seed,
        )

    # Resolution transfer: the same retained modes at any grid size, so the
    # weights trained at 48^2 evaluate unchanged on finer grids.
    results = [row("gridded", a_test, u_test)]
    for res in transfer_resolutions:
        trajs_hi = [generate_heat_2d_trajectory(i, nx=int(res), ny=int(res))
                    for i in range(n_traj_train, n_traj_train + n_traj_test)]
        results.append(row(f"gridded,transfer{int(res)}", *make_pairs(trajs_hi)))
    return results


def results_to_csv(results: Sequence[OperatorResult]) -> str:
    header = (
        "dataset,architecture,mode,epochs,train_points,test_rel_l2,"
        "test_max_error,final_train_loss,wall_time_s,seed"
    )
    rows = [
        f"{r.dataset},{r.architecture},{r.mode},{r.epochs},{r.train_points},"
        f"{r.test_rel_l2:.6e},{r.test_max_error:.6e},{r.final_train_loss:.6e},"
        f"{r.wall_time_s:.1f},{r.seed}"
        for r in results
    ]
    return "\n".join([header, *rows]) + "\n"
