"""Training loop (Adam phase; see trainer.py for what is not ported yet)."""

from pinnrl_tpu_torch.training.trainer import PDETrainer  # noqa: F401
