#!/usr/bin/env python3
"""The port's multi-seed sampling study beside the JAX package's.

    python3 tools/sampling_seeds_torch.py PORT_CSV [--jax benchmark_results/sampling_r3.csv]
        [--pde burgers] [--strategies uniform residual_based]

Both CSVs are ``benchmarks.cli sampling --csv`` rows (the port's from
``python -m pinnrl_tpu_torch.benchmarks.cli sampling ... --seed K --csv
PORT_CSV`` for each seed). For ``--pde`` and each of ``--strategies`` it
prints, per package, the seeds, the median, quartiles (``statistics.quantiles``,
n=4) and maximum rel-L2 and the geometric mean; the port's geometric mean over
JAX's with a 95% bootstrap interval (the two packages' seeds resampled
independently: their random streams differ, so seed k of one is not seed k
of the other); and, per package, ``scripts/sampling_stats.py``'s paired
ratio of geometric means of each strategy over the first with its 95%
bootstrap interval. Standard library only.
"""

from __future__ import annotations

import argparse
import csv
import math
import random
import statistics
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))

import sampling_stats  # noqa: E402  (scripts/, stdlib only)


def rel_l2(path: str, pde: str, strategy: str) -> dict:
    """{seed: rel_l2} of ``strategy``'s rows for ``pde``."""
    with open(path) as f:
        return {int(r["seed"]): float(r["rel_l2"]) for r in csv.DictReader(f)
                if r["pde"] == pde and r["strategy"] == strategy}


def shift_ci(a, b, n_boot: int = 20000, seed: int = 7):
    """geomean(a) / geomean(b) and its 95% bootstrap interval, a and b
    resampled independently."""
    rng = random.Random(seed)
    la, lb = [math.log(x) for x in a], [math.log(x) for x in b]
    ratios = sorted(math.exp(statistics.fmean(rng.choice(la) for _ in la)
                             - statistics.fmean(rng.choice(lb) for _ in lb))
                    for _ in range(n_boot))
    point = math.exp(statistics.fmean(la) - statistics.fmean(lb))
    return point, ratios[int(0.025 * n_boot)], ratios[int(0.975 * n_boot) - 1]


def paired_ratio(base: dict, other: dict):
    """sampling_stats' paired ratio of geomeans (other over base) on the seeds
    both have, its 95% interval and the seeds where other wins."""
    seeds = sorted(set(base) & set(other))
    logr = [math.log(other[s] / base[s]) for s in seeds]
    lo, hi = sampling_stats.bootstrap_ci(logr, lambda v: math.exp(sum(v) / len(v)))
    return math.exp(sum(logr) / len(logr)), lo, hi, sum(v < 0 for v in logr), len(logr)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("port_csv")
    ap.add_argument("--jax", default=str(REPO / "benchmark_results" / "sampling_r3.csv"))
    ap.add_argument("--pde", default="burgers")
    ap.add_argument("--strategies", nargs="+", default=["uniform", "residual_based"])
    args = ap.parse_args()
    runs = {pkg: {s: rel_l2(path, args.pde, s) for s in args.strategies}
            for pkg, path in (("port", args.port_csv), ("jax", args.jax))}
    print(f"{args.pde}: rel-L2 per strategy ({args.port_csv} against {args.jax})")
    for s in args.strategies:
        for pkg in ("port", "jax"):
            xs = sorted(runs[pkg][s].values())
            q1, med, q3 = statistics.quantiles(xs, n=4)
            print(f"  {s:<16} {pkg:<4} seeds {len(xs):2d}  median {med:.4e}  q1 {q1:.4e}  "
                  f"q3 {q3:.4e}  max {xs[-1]:.4e}  geomean {sampling_stats.geomean(xs):.4e}")
        ratio, lo, hi = shift_ci(list(runs["port"][s].values()), list(runs["jax"][s].values()))
        print(f"  {s:<16} port / jax geomean {ratio:.3f} [{lo:.3f}, {hi:.3f}] (95% bootstrap)"
              + ("  (excludes 1: shifted)" if hi < 1.0 or lo > 1.0 else ""))
    base = args.strategies[0]
    for s in args.strategies[1:]:
        for pkg in ("port", "jax"):
            ratio, lo, hi, wins, n = paired_ratio(runs[pkg][base], runs[pkg][s])
            print(f"  {pkg:<4} {s} / {base} paired geomean ratio {ratio:.3f} [{lo:.3f}, {hi:.3f}]"
                  f", {s} better on {wins}/{n} seeds")
    return 0


if __name__ == "__main__":
    sys.exit(main())
