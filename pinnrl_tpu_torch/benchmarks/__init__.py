"""Benchmarks: the convergence harness's recipe builder and runner.

The FDM baselines, the sampling/inverse/operator harnesses and the CLI are
ROADMAP item 14.
"""

from pinnrl_tpu_torch.benchmarks.convergence import (  # noqa: F401
    RECIPES,
    ConvergenceResult,
    build_recipe_config,
    results_to_csv,
    run_convergence,
)
