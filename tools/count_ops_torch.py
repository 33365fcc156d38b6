#!/usr/bin/env python3
"""Count what one Adam step of a convergence recipe dispatches, on the CPU:
an estimate of its device launches before a chip run.

    python3 tools/count_ops_torch.py [--recipe wave cahn_hilliard ...]

Each recipe is built by ``build_recipe_config`` on the CPU at its depth but
narrow width (Fourier trunks 16 wide with mapping 8, the attention trunk 8
wide with its 4 layers and heads; 256 points in batches of 128, 32 BC and
IC points: the operations a step dispatches do not depend on the widths or
the batch). For one warm Adam step it prints the operations dispatched (a
``TorchDispatchMode`` below autograd and ``torch.func``), views and
metadata operations left out, and the most frequent ones.

PERF.md holds its calibration against ``tools/profile_step_torch.py``'s
device launches per Adam step on the card. Imports no JAX.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

# Operations that launch nothing on a device: views, metadata, no-op casts.
_NO_LAUNCH = {
    "view", "_unsafe_view", "expand", "t", "transpose", "permute", "reshape", "select", "slice",
    "unsqueeze", "squeeze", "alias", "detach", "as_strided", "split", "split_with_sizes",
    "unbind", "_reshape_alias", "lift_fresh", "empty", "empty_like", "new_empty", "view_as",
    "narrow", "unflatten", "flatten", "movedim", "diagonal", "chunk", "is_same_size",
    "_has_same_storage_numel", "to", "_efficientzerotensor", "_is_zerotensor", "is_nonzero",
    "sym_size", "dim", "size", "stride",
}


def _trainer(key: str):
    import torch  # noqa: F401

    from pinnrl_tpu_torch.benchmarks.convergence import RECIPES, build_recipe_config
    from pinnrl_tpu_torch.models import PINNModel
    from pinnrl_tpu_torch.pdes import create_pde
    from pinnrl_tpu_torch.training import PDETrainer

    cfg = build_recipe_config(key, epochs=4, device="cpu")
    cfg.model.hidden_dims = [16] * len(RECIPES[key]["model"]["hidden_dims"])
    cfg.model.arch_params["mapping_size"] = 8
    cfg.model.arch_params.pop("feature_seed", None)
    if cfg.model.architecture == "attention":
        cfg.model.arch_params["hidden_dim"] = 8
    t = cfg.training
    t.num_collocation_points, t.batch_size = 256, 128
    t.num_boundary_points = t.num_initial_points = 32
    return PDETrainer(PINNModel(cfg, seed=0), create_pde(cfg), cfg)


def count(key: str) -> dict:
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name not in _NO_LAUNCH:
                self.ops[name] = self.ops.get(name, 0) + 1
            return func(*args, **(kwargs or {}))

    tr = _trainer(key)
    params = tr.model.params
    gen = torch.Generator().manual_seed(0)
    opt = tr._make_adam(1, 1, list(params.values()))
    tr._step(params, opt, gen, 128)  # warm
    with Ops() as ops:
        tr._step(params, opt, gen, 128)

    return {"ops": sum(ops.ops.values()), "top": sorted(ops.ops.items(), key=lambda kv: -kv[1])[:8]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--recipe", nargs="+", default=["wave", "pendulum", "cahn_hilliard",
                                                    "cahn_hilliard_dynamics",
                                                    "cahn_hilliard_biharmonic"])
    args = ap.parse_args()
    for key in args.recipe:
        res = count(key)
        print(f"[ops] {key}: {res['ops']} operations per Adam step; most frequent {res['top']}",
              flush=True)
    if "jax" in sys.modules:
        raise AssertionError("count_ops_torch imported jax")
    return 0


if __name__ == "__main__":
    sys.exit(main())
