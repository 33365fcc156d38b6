"""Benchmarks: the convergence harness (recipe builder and runner), the
inverse-problem harness and the benchmark CLI (``benchmarks/cli.py``).

The FDM baselines (item 11) and the sampling and operator harnesses (item
14) are not ported yet.
"""

from pinnrl_tpu_torch.benchmarks.convergence import (  # noqa: F401
    RECIPES,
    ConvergenceResult,
    build_recipe_config,
    results_to_csv,
    run_convergence,
)
