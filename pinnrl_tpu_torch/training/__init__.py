"""Training: the loop (``trainer.py``: Adam, L-BFGS, the inverse and data
modes, experiment directories), L-BFGS (``lbfgs.py``) and the training CLI
(``train.py``)."""

from pinnrl_tpu_torch.training.trainer import PDETrainer  # noqa: F401
