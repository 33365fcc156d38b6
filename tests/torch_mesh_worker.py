"""The ranks of the mesh tests (tests/test_torch_parallel.py).

Each rank is a process spawned by ``torch.multiprocessing`` that joins a
gloo process group on the CPU, runs every case of a spec on the port's
mesh and writes what it saw to ``<out>/rank<r>.pkl``. This module imports
no JAX: a spawned process imports it by name, and the port's ranks must
not pull JAX in.
"""

from __future__ import annotations

import pickle
import sys
from pathlib import Path

import torch
import torch.distributed as dist


def build(cfg, state=None):
    """(PDE, model) of a port config; ``state`` (numpy arrays by torch
    name) loaded into the model when given."""
    from pinnrl_tpu_torch.models import PINNModel
    from pinnrl_tpu_torch.pdes import create_pde

    model = PINNModel(cfg, seed=0)
    if state is not None:
        model.module.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return create_pde(cfg), model


def history(cfg, mesh=None, epochs: int = 3) -> dict:
    """Train ``cfg`` from seed 0 (under ``mesh`` when given): the history,
    the rows of every loss this rank computed, the final parameters."""
    from pinnrl_tpu_torch.training import PDETrainer

    pde, model = build(cfg)
    tr = PDETrainer(model, pde, cfg, mesh=mesh)
    rows = []
    loss = tr._loss_components

    def recording(params, x, t, generator, coeffs=None):
        rows.append(x.shape[0])
        return loss(params, x, t, generator, coeffs)

    tr._loss_components = recording
    tr.train(num_epochs=epochs, seed=0)
    return {"train_loss": tr.history["train_loss"], "val_loss": tr.history["val_loss"],
            "components": tr.history["loss_components"], "rows": rows,
            "params": {k: v.detach().numpy().copy() for k, v in tr.model.params.items()}}


def loss_and_grads(cfg, state, x, t, draws, mesh=None):
    """One loss of ``cfg`` on the global batch (x, t) with the BC/IC points
    ``draws`` = (xb, tb, xi, ti) (numpy): under ``mesh`` this rank's share,
    its value and gradients averaged over the ranks. (value, {name: grad})."""
    from pinnrl_tpu_torch.training import PDETrainer

    pde, model = build(cfg, state)
    xb, tb, xi, ti = (torch.from_numpy(a) for a in draws)
    pde._sample_boundary_points = lambda gen, n: (xb, tb)
    pde._sample_initial_points = lambda gen, n: (xi, ti)
    tr = PDETrainer(model, pde, cfg, mesh=mesh)
    params = {k: v.detach().clone().requires_grad_(True) for k, v in model.params.items()}
    losses = tr._sharded_loss(params, torch.from_numpy(x), torch.from_numpy(t),
                              torch.Generator().manual_seed(0))
    losses["total"].backward()
    tr._reduce_grads(list(params.values()))
    total = losses["total"].detach()
    if mesh is not None:
        total = mesh.mean(total)
    return float(total), {k: v.grad.numpy().copy() for k, v in params.items()}


def _cases(spec: dict, mesh) -> dict:
    from pinnrl_tpu_torch.parallel import make_mesh

    out = {"size": mesh.size, "rank": mesh.rank}
    for name, (cfg, epochs) in spec.get("histories", {}).items():
        out[f"history/{name}"] = history(cfg, mesh, epochs)
    for name, args in spec.get("losses", {}).items():
        out[f"loss/{name}"] = loss_and_grads(*args, mesh=mesh)
    try:
        make_mesh(mesh.size + 1, devices="cpu")
    except ValueError as e:
        out["too_many"] = str(e)
    sub = make_mesh(1, devices="cpu")
    out["sub"] = None if sub is None else (sub.size, sub.rank)
    out["jax_loaded"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "pinnrl_tpu"))
    return out


def rank_main(rank: int, world: int, init_file: str, out_dir: str, spec: dict) -> None:
    """One rank: join the group, run the spec's cases, write the results."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        from pinnrl_tpu_torch.parallel import make_mesh

        out = _cases(spec, make_mesh(devices="cpu"))
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def run_ranks(world: int, tmp: Path, spec: dict) -> list:
    """Spawn ``world`` ranks on ``spec``; each rank's results, in order."""
    import torch.multiprocessing as mp

    tmp.mkdir(parents=True, exist_ok=True)
    mp.spawn(rank_main, args=(world, str(tmp / "pg"), str(tmp), spec), nprocs=world, join=True)
    return [pickle.loads((tmp / f"rank{r}.pkl").read_bytes()) for r in range(world)]
