"""Benchmark CLI (``pinnrl-benchmark``), as ``pinnrl_tpu.benchmarks.cli``.

    python -m pinnrl_tpu_torch.benchmarks.cli inverse --pde all --csv out.csv
    python -m pinnrl_tpu_torch.benchmarks.cli convergence --pde heat

``inverse`` and ``convergence`` run on the card unless ``--device cpu``;
``--csv`` appends rows to an existing file. ``convergence --time-marching``
raises naming ROADMAP item 13; ``fdm`` (item 11), ``sampling`` and
``operator`` (item 14) keep the JAX package's flags and raise naming their
items.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from pinnrl_tpu_torch.benchmarks.convergence import _unported


def _print_table(rows, headers):
    widths = [max(len(str(h)), *(len(str(r[i])) for r in rows)) for i, h in enumerate(headers)]
    fmt = "  ".join(f"{{:<{w}}}" for w in widths)
    print(fmt.format(*headers))
    print(fmt.format(*["-" * w for w in widths]))
    for r in rows:
        print(fmt.format(*[str(c) for c in r]))


def _write_csv(path: str, text: str) -> None:
    """Write a header+rows CSV; append the rows (no header) if the file
    exists, so multi-seed suites accumulate."""
    out = Path(path)
    if out.exists():
        with out.open("a") as f:
            f.write(text.split("\n", 1)[1])
    else:
        out.write_text(text)
    print(f"CSV written to {path}")


def _fdm_command(args) -> int:
    raise _unported("the FDM baselines (benchmarks/fdm.py)", 11)


def _sampling_command(args) -> int:
    raise _unported("the sampling benchmark", 14)


def _operator_command(args) -> int:
    raise _unported("the operator benchmark", 14)


def _inverse_command(args) -> int:
    from pinnrl_tpu_torch.benchmarks.inverse import RECIPES, results_to_csv, run_inverse

    pdes = list(RECIPES) if args.pde == "all" else [args.pde]
    results = []
    for p in pdes:
        results.extend(run_inverse(p, seed=args.seed, epochs=args.epochs, device=args.device))
    rows = [
        (r.pde, r.parameter, f"{r.true_value:g}", f"{r.initial_guess:g}",
         f"{r.identified:.5g}", f"{r.rel_error:.2e}", r.epochs, f"{r.wall_time_s:.0f}")
        for r in results
    ]
    _print_table(rows, ["pde", "param", "truth", "guess", "identified", "rel_err", "epochs",
                        "wall_s"])
    if args.csv:
        _write_csv(args.csv, results_to_csv(results))
    return 0


def _convergence_command(args) -> int:
    from pinnrl_tpu_torch.benchmarks.convergence import RECIPES, results_to_csv, run_convergence

    if args.time_marching:
        raise _unported("time-marching", 13)
    pdes = list(RECIPES) if args.pde == "all" else [args.pde]
    results = [run_convergence(p, seed=args.seed, epochs=args.epochs, device=args.device)
               for p in pdes]
    rows = [
        (r.pde, r.architecture, r.epochs, f"{r.rel_l2:.3e}", f"{r.max_error:.3e}",
         f"{r.wall_time_s:.0f}", f"{r.points_per_sec:.0f}")
        for r in results
    ]
    _print_table(rows, ["pde", "arch", "epochs", "rel_l2", "max_err", "wall_s", "pts/sec"])
    if args.csv:
        _write_csv(args.csv, results_to_csv(results))
    return 0


def main(argv=None) -> int:
    from pinnrl_tpu_torch.benchmarks.convergence import RECIPES as _CONV_RECIPES

    parser = argparse.ArgumentParser(prog="pinnrl-benchmark", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="command", required=True)

    p_fdm = sub.add_parser("fdm", help="Finite-difference baseline solves (not ported yet)")
    p_fdm.add_argument("--pde", choices=["heat", "wave", "all"], default="all")
    p_fdm.add_argument("--nx", type=int, default=None)
    p_fdm.add_argument("--nt", type=int, default=None)
    p_fdm.add_argument("--t-max", type=float, default=0.5)
    p_fdm.add_argument("--csv", default=None)
    p_fdm.set_defaults(func=_fdm_command)

    p_s = sub.add_parser("sampling", help="Collocation-strategy comparison (not ported yet)")
    p_s.add_argument("--pde", choices=["heat", "wave", "burgers", "kdv"], default="heat")
    p_s.add_argument("--strategies", default=None,
                     help="Comma list of uniform,stratified,residual_based,adaptive")
    p_s.add_argument("--epochs", type=int, default=200)
    p_s.add_argument("--batch", type=int, default=1024)
    p_s.add_argument("--lr", type=float, default=2e-3)
    p_s.add_argument("--seed", type=int, default=0)
    p_s.add_argument("--arch", default="fourier",
                     help="Model architecture for every strategy (e.g. fourier, resnet)")
    p_s.add_argument("--csv", default=None)
    p_s.set_defaults(func=_sampling_command)

    p_c = sub.add_parser("convergence", help="rel-L2 vs exact with tuned recipes")
    p_c.add_argument("--pde", choices=[*_CONV_RECIPES, "all"], default="heat")
    p_c.add_argument("--epochs", type=int, default=None, help="Override recipe epochs")
    p_c.add_argument("--seed", type=int, default=0)
    p_c.add_argument("--time-marching", type=int, default=0, metavar="N_WINDOWS",
                     help="Train N sequential time windows (not ported yet)")
    p_c.add_argument("--device", default="cuda", help="cuda | cpu")
    p_c.add_argument("--csv", default=None)
    p_c.set_defaults(func=_convergence_command)

    p_o = sub.add_parser("operator", help="Well-pipeline FNO operator run (not ported yet)")
    p_o.add_argument("--dataset", default="synthetic_heat_2d")
    p_o.add_argument("--arch", default=None, help="Override registry architecture")
    p_o.add_argument("--epochs", type=int, default=2000)
    p_o.add_argument("--traj", type=int, default=1)
    p_o.add_argument("--points", type=int, default=8192)
    p_o.add_argument("--seed", type=int, default=0)
    p_o.add_argument("--gridded", action="store_true")
    p_o.add_argument("--transfer", type=int, nargs="*", default=None, metavar="RES")
    p_o.add_argument("--csv", default=None)
    p_o.set_defaults(func=_operator_command)

    p_i = sub.add_parser("inverse", help="Coefficient-recovery accuracy (inverse mode)")
    p_i.add_argument("--pde", choices=["heat", "black_scholes", "all"], default="heat")
    p_i.add_argument("--epochs", type=int, default=None, help="Override recipe epochs")
    p_i.add_argument("--seed", type=int, default=0)
    p_i.add_argument("--device", default="cuda", help="cuda | cpu")
    p_i.add_argument("--csv", default=None)
    p_i.set_defaults(func=_inverse_command)

    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
