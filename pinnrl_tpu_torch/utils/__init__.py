"""Utilities: the experiment-directory file protocol and logging setup."""

from pinnrl_tpu_torch.utils.io import (  # noqa: F401
    save_live_snapshot,
    save_training_metrics,
    write_config_snapshot,
)
from pinnrl_tpu_torch.utils.logging import setup_logging  # noqa: F401
