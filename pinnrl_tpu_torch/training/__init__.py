"""Training: the loop (``trainer.py``: Adam, L-BFGS, the inverse and data
modes, experiment directories, adaptive weights, the plateau schedule, EMA,
checkpoints), adaptive loss weights (``adaptive_weights.py``), L-BFGS
(``lbfgs.py``), multi-stage correction training (``multistage.py``) and
the training CLI (``train.py``)."""

from pinnrl_tpu_torch.training.trainer import PDETrainer  # noqa: F401
from pinnrl_tpu_torch.training.multistage import (  # noqa: F401
    MultiStageResult,
    StageSpec,
    correction_model,
    run_multistage,
)
