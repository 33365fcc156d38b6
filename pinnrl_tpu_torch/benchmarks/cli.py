"""Benchmark CLI (``pinnrl-benchmark``), as ``pinnrl_tpu.benchmarks.cli``.

    python -m pinnrl_tpu_torch.benchmarks.cli fdm
    python -m pinnrl_tpu_torch.benchmarks.cli sampling --pde burgers --csv out.csv
    python -m pinnrl_tpu_torch.benchmarks.cli operator --dataset synthetic_heat_2d
    python -m pinnrl_tpu_torch.benchmarks.cli operator --gridded --transfer 96
    python -m pinnrl_tpu_torch.benchmarks.cli inverse --pde all --csv out.csv
    python -m pinnrl_tpu_torch.benchmarks.cli convergence --pde heat
    python -m pinnrl_tpu_torch.benchmarks.cli convergence --pde kdv --time-marching 4

The JAX package's subcommands and flags; each runs on the card unless
``--device cpu``. ``--csv`` appends rows to an existing file (``fdm``
writes its file anew, as JAX's does). ``convergence --time-marching N``
trains N time windows (``run_time_marching``); ``--epochs`` is then the
total, split evenly across them.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


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
    from pinnrl_tpu_torch.benchmarks.fdm import solve_heat_1d, solve_wave_1d

    rows = []
    if args.pde in ("heat", "all"):
        r = solve_heat_1d(nx=args.nx or 51, nt=args.nt or 2001, t_max=args.t_max,
                          device=args.device)
        rows.append(("heat", r.scheme, f"{r.stability:.4f}", f"{r.l2_error:.3e}"))
    if args.pde in ("wave", "all"):
        r = solve_wave_1d(nx=args.nx or 101, nt=args.nt or 2001, t_max=args.t_max,
                          device=args.device)
        rows.append(("wave", r.scheme, f"{r.stability:.4f}", f"{r.l2_error:.3e}"))
    _print_table(rows, ["pde", "scheme", "stability", "l2_error"])
    if args.csv:
        Path(args.csv).write_text(
            "pde,scheme,stability,l2_error\n"
            + "\n".join(",".join(map(str, r)) for r in rows)
            + "\n"
        )
        print(f"CSV written to {args.csv}")
    return 0


def _sampling_command(args) -> int:
    from pinnrl_tpu_torch.benchmarks.sampling import results_to_csv, run_sampling_benchmark

    results = run_sampling_benchmark(
        pde=args.pde,
        strategies=args.strategies.split(",") if args.strategies else None,
        epochs=args.epochs,
        batch=args.batch,
        lr=args.lr,
        seed=args.seed,
        arch=args.arch,
        device=args.device,
    )
    rows = [
        (
            r.pde, r.architecture, r.strategy, f"{r.final_loss:.3e}",
            f"{r.l2_error:.3e}", f"{r.rel_l2:.3e}", f"{r.wall_time_s:.2f}",
            f"{r.points_per_sec:.0f}",
        )
        for r in results
    ]
    _print_table(rows, ["pde", "arch", "strategy", "final_loss", "l2_error", "rel_l2",
                        "wall_s", "pts/sec"])
    if args.csv:
        _write_csv(args.csv, results_to_csv(results))
    return 0


def _operator_command(args) -> int:
    from pinnrl_tpu_torch.benchmarks.operator import (
        results_to_csv,
        run_gridded_operator_benchmark,
        run_operator_benchmark,
    )

    if args.transfer is not None and not args.gridded:
        raise SystemExit(
            "pinnrl-benchmark operator: --transfer requires --gridded "
            "(resolution transfer is a property of the gridded FNO only)"
        )
    if args.gridded:
        results = run_gridded_operator_benchmark(
            dataset=args.dataset, epochs=args.epochs, seed=args.seed,
            transfer_resolutions=tuple(args.transfer or ()), device=args.device,
        )
    else:
        results = [run_operator_benchmark(
            dataset=args.dataset, arch=args.arch, epochs=args.epochs,
            n_traj=args.traj, n_points=args.points, seed=args.seed, device=args.device,
        )]
    _print_table(
        [(r.dataset, r.architecture, r.mode, r.epochs,
          f"{r.test_rel_l2:.3e}", f"{r.test_max_error:.3e}",
          f"{r.wall_time_s:.0f}") for r in results],
        ["dataset", "arch", "mode", "epochs", "test_rel_l2", "max_err", "wall_s"],
    )
    if args.csv:
        _write_csv(args.csv, results_to_csv(results))
    return 0


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
    from pinnrl_tpu_torch.benchmarks.convergence import (
        RECIPES,
        results_to_csv,
        run_convergence,
        run_time_marching,
    )

    pdes = list(RECIPES) if args.pde == "all" else [args.pde]
    if args.time_marching:
        # --epochs is the total, split evenly across the windows.
        per_window = max(args.epochs // args.time_marching, 1) if args.epochs else None
        results = [run_time_marching(p, seed=args.seed, n_windows=args.time_marching,
                                     epochs_per_window=per_window, device=args.device)
                   for p in pdes]
    else:
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

    p_fdm = sub.add_parser("fdm", help="Finite-difference baseline solves")
    p_fdm.add_argument("--pde", choices=["heat", "wave", "all"], default="all")
    p_fdm.add_argument("--nx", type=int, default=None)
    p_fdm.add_argument("--nt", type=int, default=None)
    p_fdm.add_argument("--t-max", type=float, default=0.5)
    p_fdm.add_argument("--device", default="cuda", help="cuda | cpu")
    p_fdm.add_argument("--csv", default=None)
    p_fdm.set_defaults(func=_fdm_command)

    p_s = sub.add_parser("sampling", help="Collocation-strategy comparison")
    p_s.add_argument("--pde", choices=["heat", "wave", "burgers", "kdv"], default="heat")
    p_s.add_argument("--strategies", default=None,
                     help="Comma list of uniform,stratified,residual_based,adaptive")
    p_s.add_argument("--epochs", type=int, default=200)
    p_s.add_argument("--batch", type=int, default=1024)
    p_s.add_argument("--lr", type=float, default=2e-3)
    p_s.add_argument("--seed", type=int, default=0)
    p_s.add_argument("--arch", default="fourier",
                     help="Model architecture for every strategy (e.g. fourier, resnet)")
    p_s.add_argument("--device", default="cuda", help="cuda | cpu")
    p_s.add_argument("--csv", default=None)
    p_s.set_defaults(func=_sampling_command)

    p_c = sub.add_parser("convergence", help="rel-L2 vs exact with tuned recipes")
    p_c.add_argument("--pde", choices=[*_CONV_RECIPES, "all"], default="heat")
    p_c.add_argument("--epochs", type=int, default=None, help="Override recipe epochs")
    p_c.add_argument("--seed", type=int, default=0)
    p_c.add_argument("--time-marching", type=int, default=0, metavar="N_WINDOWS",
                     help="Train N sequential time windows (IC inherited between windows)")
    p_c.add_argument("--device", default="cuda", help="cuda | cpu")
    p_c.add_argument("--csv", default=None)
    p_c.set_defaults(func=_convergence_command)

    p_o = sub.add_parser("operator", help="Well-pipeline FNO operator run")
    p_o.add_argument("--dataset", default="synthetic_heat_2d",
                     help="Well registry entry (synthetic_heat_2d works offline)")
    p_o.add_argument("--arch", default=None, help="Override registry architecture")
    p_o.add_argument("--epochs", type=int, default=2000)
    p_o.add_argument("--traj", type=int, default=1)
    p_o.add_argument("--points", type=int, default=8192)
    p_o.add_argument("--seed", type=int, default=0)
    p_o.add_argument("--gridded", action="store_true",
                     help="Gridded 2D FNO on whole-field time-advance pairs, evaluated on "
                          "held-out trajectories")
    p_o.add_argument("--transfer", type=int, nargs="*", default=None, metavar="RES",
                     help="(gridded only) also evaluate on the held-out trajectories "
                          "regenerated at these resolutions, e.g. --transfer 96 128")
    p_o.add_argument("--device", default="cuda", help="cuda | cpu")
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
