#!/usr/bin/env python3
"""Train the port's convergence recipes at full length on one CUDA card and
report their accuracy.

    python3 tools/convergence_torch.py [--pde burgers heat ...] [--seed 0] [--epochs E]
        [--out build/convergence]

``--pde`` takes any key of the port's ``RECIPES`` (burgers, heat, kdv,
heat_2d, convection, allen_cahn, black_scholes, allen_cahn_dynamics, wave,
pendulum, pendulum_nonlinear, cahn_hilliard, cahn_hilliard_dynamics,
cahn_hilliard_biharmonic).

Each recipe runs as shipped through
``pinnrl_tpu_torch.benchmarks.convergence.run_convergence(key, seed=...,
device="cuda")`` (``--epochs`` cuts it). The script prints the results as
``results_to_csv`` gives them, the rel-L2 against the 1e-3 bar, the wall
time of each phase (the sum of its epochs' host-clock times), the L-BFGS
objective's evaluations per iteration, and the card's name and power
limit; it writes each run's per-epoch history to ``--out`` as JSON. It
imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

BAR = 1e-3  # rel-L2 (ROADMAP item 9)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pde", nargs="+", default=["burgers"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--epochs", type=int, default=None, help="cut the recipe to this many epochs")
    ap.add_argument("--out", default=str(REPO / "build" / "convergence"),
                    help="directory for the per-epoch histories (JSON)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("convergence_torch: no CUDA card", file=sys.stderr)
        return 2
    from chip_smoke import captured_trainers, nvidia_smi_line
    from pinnrl_tpu_torch.benchmarks.convergence import results_to_csv, run_convergence
    from pinnrl_tpu_torch.training.lbfgs import LBFGS

    card = nvidia_smi_line()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    results = []
    for key in args.pde:
        evals = LBFGS.evaluations
        with captured_trainers() as seen:
            res = run_convergence(key, seed=args.seed, epochs=args.epochs, device="cuda")
        (tr,) = seen
        hist = tr.history
        switch = tr.switch_epoch if tr.switch_epoch is not None else len(hist["train_loss"])
        iterations = len(hist["train_loss"]) - switch
        adam_s, lbfgs_s = sum(hist["epoch_time"][:switch]), sum(hist["epoch_time"][switch:])
        per_it = (LBFGS.evaluations - evals) / iterations if iterations else 0.0
        results.append(res)
        print(f"[convergence] {key} seed {args.seed}: rel_l2 {res.rel_l2:.4e} (bar {BAR:g}: "
              f"{'met' if res.rel_l2 < BAR else 'missed'}), max_error {res.max_error:.4e}, final "
              f"train loss {res.final_train_loss:.4e}; wall {res.wall_time_s:.1f} s (Adam {switch} "
              f"epochs {adam_s:.1f} s, L-BFGS {iterations} iterations {lbfgs_s:.1f} s, "
              f"{per_it:.2f} evaluations per iteration) ({card})", flush=True)
        (out / f"{key}_seed{args.seed}.json").write_text(json.dumps(
            {"card": card, "result": vars(res), "switch_epoch": tr.switch_epoch,
             "lbfgs_evaluations_per_iteration": per_it, "history": hist}))
    print(results_to_csv(results), end="")
    print(f"[card] {card}")
    if "jax" in sys.modules:
        raise AssertionError("convergence_torch imported jax")
    return 0


if __name__ == "__main__":
    sys.exit(main())
