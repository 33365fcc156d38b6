"""Multi-stage PINN training: a frozen base solution plus scaled correction
networks, as ``pinnrl_tpu.training.multistage``.

Stage 0 trains a PINN as usual. Each later stage freezes the predictor
below it and trains a new network on the same physics losses through the
composed predictor

    u(z) = u_base(z) + eps * net(z)

where ``eps`` is the magnitude of the previous stage's error, so the new
network's O(1) output is pre-scaled to the error it corrects (Wang & Lai,
"Multi-stage neural networks", 2023).

The composition is the new model's ``output_transform``, so the trainer,
the derivative engine and every sampling strategy run it unchanged; with an
output transform neither the stacked-jet bundle nor kernel 1 attaches, and
the residual runs on the nested-jvp engine. The base enters as detached
clones of its parameters (``requires_grad=False``), held by no optimizer:
the trainer updates parameters in place, and a later stage must not move the
base. Input tangents still flow through the base (it is not run under
``torch.no_grad``), because the residual differentiates the composed
predictor.
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from pinnrl_tpu_torch.config import Config
from pinnrl_tpu_torch.models import PINNModel
from pinnrl_tpu_torch.pdes import create_pde
from pinnrl_tpu_torch.training.trainer import PDETrainer

__all__ = ["StageSpec", "MultiStageResult", "correction_model", "run_multistage"]


@dataclass
class StageSpec:
    """Overrides for one correction stage (all optional).

    ``eps``: the correction's amplitude; None: automatic (the RMS error
    against the exact solution where there is one, else the square root of
    the stage's final train loss). ``scale_mult`` multiplies the previous
    stage's Fourier-feature ``scale`` (the error is of higher frequency than
    the solution).
    """

    epochs: Optional[int] = None
    eps: Optional[float] = None
    scale: Optional[float] = None
    scale_mult: float = 2.0
    mapping_size: Optional[int] = None
    hidden_dims: Optional[List[int]] = None
    learning_rate: Optional[float] = None
    optimizer: Optional[str] = None
    extra_model: Dict[str, Any] = field(default_factory=dict)


@dataclass
class MultiStageResult:
    apply_fn: Callable
    params: Any
    models: List[PINNModel]
    stage_metrics: List[Dict[str, float]]
    eps_history: List[float]


def correction_model(config: Config, base_apply: Callable, base_params, eps: float,
                     seed: int = 0) -> PINNModel:
    """A ``PINNModel`` whose output is ``base_apply(base_params, z) + eps *
    net(z)``, the base frozen (see the module docstring): the trainer
    optimizes only the new model's parameters."""
    model = PINNModel(config, seed=seed)
    frozen = {k: v.detach().clone().requires_grad_(False) for k, v in base_params.items()}

    def transform(z, out):
        return base_apply(frozen, z) + eps * out

    model.output_transform = transform
    return model


def _stage_config(cfg: Config, spec: StageSpec) -> Config:
    cfg2 = copy.deepcopy(cfg)
    t = cfg2.training
    if spec.epochs is not None:
        t.num_epochs = spec.epochs
        t.validation_frequency = max(spec.epochs // 4, 1)
    if spec.learning_rate is not None:
        t.optimizer_config.learning_rate = spec.learning_rate
    if spec.optimizer is not None:
        t.optimizer = spec.optimizer
    ap = cfg2.model.arch_params
    if spec.scale is not None:
        ap["scale"] = spec.scale
    elif "scale" in ap:
        ap["scale"] = float(ap["scale"]) * spec.scale_mult
    if spec.mapping_size is not None:
        ap["mapping_size"] = spec.mapping_size
    if spec.hidden_dims is not None:
        cfg2.model.hidden_dims = list(spec.hidden_dims)
    ap.update(spec.extra_model)
    # A correction stage trains one fresh network on a fixed predictor below it.
    t.ensemble_size = 1
    return cfg2


def _auto_eps(pde, apply_fn, params, final_train_loss: float) -> float:
    """The error's magnitude, for the next correction stage."""
    val = pde.validate(apply_fn, params, num_points=4096)
    l2 = val.get("l2_error", float("nan"))  # the mean squared error
    if math.isfinite(l2) and l2 > 0.0:
        return math.sqrt(l2)
    if math.isfinite(final_train_loss) and final_train_loss > 0.0:
        return math.sqrt(final_train_loss)
    return 1e-3


def run_multistage(cfg: Config, stages: List[StageSpec], seed: int = 0,
                   pde=None) -> MultiStageResult:
    """Train stage 0 from ``cfg``, then each correction stage in ``stages``.

    Returns the last stage's composed predictor: ``apply_fn(params, z)``
    evaluates the base and every correction (each stage's transform closes
    over the whole predictor below it).
    """
    pde = pde if pde is not None else create_pde(cfg)
    model = PINNModel(cfg, seed=seed)
    trainer = PDETrainer(model, pde, cfg)
    res = trainer.train(seed=seed)
    params = trainer._final_state["params"]["net"]

    models = [model]
    metrics = [pde.validate(model.apply, params, num_points=20000)]
    eps_hist: List[float] = []
    apply_fn, cur_params = model.apply, params
    final_loss = res["final_train_loss"]

    for i, spec in enumerate(stages):
        eps = spec.eps if spec.eps is not None else _auto_eps(pde, apply_fn, cur_params, final_loss)
        eps_hist.append(float(eps))
        cfg_i = _stage_config(cfg, spec)
        stage_seed = seed + 101 * (i + 1)
        m = correction_model(cfg_i, apply_fn, cur_params, float(eps), seed=stage_seed)
        tr = PDETrainer(m, pde, cfg_i)
        res = tr.train(seed=stage_seed)
        cur_params = tr._final_state["params"]["net"]
        apply_fn = m.apply
        final_loss = res["final_train_loss"]
        models.append(m)
        metrics.append(pde.validate(apply_fn, cur_params, num_points=20000))

    return MultiStageResult(apply_fn=apply_fn, params=cur_params, models=models,
                            stage_metrics=metrics, eps_history=eps_hist)
