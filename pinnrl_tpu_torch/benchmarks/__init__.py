"""Benchmarks: the convergence harness (recipe builder and runner), the
inverse-problem, sampling-strategy and operator harnesses, the FDM
baselines (``benchmarks/fdm.py``) and the benchmark CLI
(``benchmarks/cli.py``)."""

from pinnrl_tpu_torch.benchmarks.convergence import (  # noqa: F401
    RECIPES,
    ConvergenceResult,
    build_recipe_config,
    results_to_csv,
    run_convergence,
)
