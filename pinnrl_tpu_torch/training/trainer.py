"""PDETrainer: the Adam training loop of the port.

Each step samples uniform collocation points, computes the loss components
(the residual through the fused kernel when attached, BC and IC through
``model.apply``), back-propagates, clips by global norm and takes an Adam
step — the JAX package's scanned step, run eagerly. Losses stay on the
device during an epoch; the host reads them once per epoch.

Not ported yet (each raises NotImplementedError naming its ROADMAP item):
L-BFGS and the adam_lbfgs switch (item 8), RAR sampling (item 7), the RL
agent, adaptive loss weights, EMA, ensembles, inverse mode and hard-IC
(item 13), the plateau scheduler, profiling, experiment directories and
checkpoints (item 9), and device meshes (item 14).
"""

from __future__ import annotations

import logging
import math
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from pinnrl_tpu_torch.config import Config
from pinnrl_tpu_torch.models import PINNModel
from pinnrl_tpu_torch.pdes.base import PDEBase

logger = logging.getLogger(__name__)

_COMPONENTS = ("residual", "boundary", "initial", "smoothness", "data")


def _unported(what: str, item: int):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP item {item})")


def cosine_decay(init_value: float, decay_steps: int, alpha: float) -> Callable[[int], float]:
    """optax.cosine_decay_schedule in closed form: the learning rate at
    optimizer step ``count`` (0-based)."""

    def schedule(count: int) -> float:
        frac = min(count, decay_steps) / decay_steps
        cosine = 0.5 * (1.0 + math.cos(math.pi * frac))
        return init_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


class AdamStep:
    """clip_by_global_norm -> Adam (or decoupled AdamW) with a per-step
    learning-rate schedule, as the JAX package's optax chain.

    Clipping follows optax: scale = min(1, max_norm / ||g||) with no
    epsilon (``torch.nn.utils.clip_grad_norm_`` adds 1e-6). The scale stays
    on the device, so a step does not wait for the host.
    """

    def __init__(self, params: List[torch.Tensor], schedule: Callable[[int], float],
                 clip_norm: float, beta1: float, beta2: float, weight_decay: float) -> None:
        self.params = params
        self.schedule = schedule
        self.clip_norm = float(clip_norm)
        cls = torch.optim.AdamW if weight_decay and weight_decay > 0 else torch.optim.Adam
        self.optimizer = cls(params, lr=schedule(0), betas=(beta1, beta2), eps=1e-8,
                             weight_decay=float(weight_decay or 0.0))
        self.count = 0

    def step(self) -> None:
        grads = [p.grad for p in self.params]
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        scale = torch.clamp(self.clip_norm / norm, max=1.0)
        torch._foreach_mul_(grads, scale)
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.count)
        self.optimizer.step()
        self.count += 1


class PDETrainer:
    """Trains a PINN on a PDE problem with Adam."""

    def __init__(self, model: PINNModel, pde: PDEBase, config: Config,
                 rl_agent: Optional[Any] = None, mesh: Optional[Any] = None) -> None:
        t = config.training
        if rl_agent is not None:
            raise _unported("the RL sampling agent", 13)
        if mesh is not None:
            raise _unported("device-mesh data parallelism", 14)
        if t.optimizer != "adam":
            raise _unported(f"optimizer {t.optimizer!r}", 8)
        if t.collocation_distribution == "residual_based":
            raise _unported("residual-based (RAR) sampling", 7)
        if t.collocation_distribution != "uniform":
            raise _unported(f"{t.collocation_distribution!r} sampling", 13)
        if t.adaptive_weights.enabled:
            raise _unported("adaptive loss weights", 13)
        if float(t.param_ema) > 0.0:
            raise _unported("EMA weight averaging", 13)
        if int(t.ensemble_size) > 1:
            raise _unported("deep ensembles", 13)
        if t.mode != "forward":
            raise _unported(f"training mode {t.mode!r}", 13)
        if getattr(config.model, "hard_ic", False):
            raise _unported("the hard-IC output transform", 13)
        if t.scheduler_type == "reduce_lr":
            raise _unported("the plateau scheduler", 9)
        if t.profile_dir:
            raise _unported("profiler traces", 9)
        if t.residual_dtype != "float32":
            raise _unported("float64 residuals", 8)

        self.model = model
        self.pde = pde
        self.config = config
        self.tcfg = t
        self.device = model.device
        self.strategy = t.collocation_distribution
        self.optimizer_name = t.optimizer
        self.fast_bundle_active = pde.attach_fast_bundle(model, enable=t.get("stacked_jet", "auto"))
        self.fused_kernel_active = pde.attach_fused_residual_kernel(
            model, enable=t.get("fused_residual_kernel", "auto")
        )
        self.history: Dict[str, Any] = {
            "train_loss": [],
            "val_loss": [],
            "learning_rate": [],
            "epoch_time": [],
            "loss_components": {k: [] for k in _COMPONENTS},
        }

    # ------------------------------------------------------------------ #
    # Optimizer construction
    # ------------------------------------------------------------------ #

    def _make_lr_schedule(self, num_epochs: int, steps_per_epoch: int) -> Callable[[int], float]:
        oc = self.tcfg.optimizer_config
        if self.tcfg.scheduler_type == "cosine":
            return cosine_decay(
                oc.learning_rate,
                max(num_epochs * steps_per_epoch, 1),
                self.tcfg.lr_scheduler.eta_min / max(oc.learning_rate, 1e-12),
            )
        return lambda count: oc.learning_rate

    def _make_adam(self, num_epochs: int, steps_per_epoch: int, params: List[torch.Tensor]) -> AdamStep:
        oc = self.tcfg.optimizer_config
        return AdamStep(
            params,
            self._make_lr_schedule(num_epochs, steps_per_epoch),
            self.tcfg.gradient_clip_norm,
            oc.beta1,
            oc.beta2,
            oc.weight_decay,
        )

    # ------------------------------------------------------------------ #
    # One step
    # ------------------------------------------------------------------ #

    def _loss_components(self, params: Dict[str, torch.Tensor], x, t, generator):
        return self.pde.compute_loss(self.model.apply, params, x, t, coeffs={}, generator=generator)

    def _step(self, params: Dict[str, torch.Tensor], opt: AdamStep, generator: torch.Generator,
              batch_size: int) -> torch.Tensor:
        """sample -> loss -> backward -> clip -> Adam. Returns the detached
        [total, residual, boundary, initial, smoothness, data] on the device."""
        x, t = self.pde.generate_collocation_points(generator, batch_size, self.strategy)
        losses = self._loss_components(params, x, t, generator)
        for p in opt.params:
            p.grad = None
        losses["total"].backward()
        opt.step()
        return torch.stack([losses["total"]] + [losses[k] for k in _COMPONENTS]).detach()

    @torch.no_grad()
    def _val_loss(self, params, generator: torch.Generator) -> float:
        x, t = self.pde.generate_collocation_points(
            generator, self.config.evaluation.num_points, "uniform"
        )
        return float(self._loss_components(params, x, t, generator)["total"])

    # ------------------------------------------------------------------ #
    # Training loop
    # ------------------------------------------------------------------ #

    def train(self, num_epochs: Optional[int] = None, batch_size: Optional[int] = None,
              num_points: Optional[int] = None, experiment_dir: Optional[str] = None,
              seed: int = 0, resume_from: Optional[str] = None) -> Dict[str, Any]:
        if experiment_dir is not None:
            raise _unported("experiment directories", 9)
        if resume_from is not None:
            raise _unported("checkpoint resume", 9)
        t = self.tcfg
        num_epochs = num_epochs or t.num_epochs
        batch_size = batch_size or t.batch_size
        num_points = num_points or t.num_collocation_points
        batch_size = min(batch_size, num_points)
        steps_per_epoch = max(num_points // batch_size, 1)

        params = self.model.params
        opt = self._make_adam(num_epochs, steps_per_epoch, list(params.values()))
        gen = torch.Generator(device=self.device).manual_seed(seed)
        val_gen = torch.Generator(device=self.device).manual_seed(10_000 + seed)

        es = t.early_stopping
        best_val = float("inf")
        patience_count = 0
        status = "completed"
        start_time = time.time()
        val_every = max(int(t.validation_frequency), 1)
        for epoch in range(num_epochs):
            t0 = time.time()
            per_step = [self._step(params, opt, gen, batch_size) for _ in range(steps_per_epoch)]
            means = torch.stack(per_step).mean(dim=0).tolist()  # one host read per epoch
            self.history["train_loss"].append(means[0])
            for k, v in zip(_COMPONENTS, means[1:]):
                self.history["loss_components"][k].append(v)
            self.history["epoch_time"].append(time.time() - t0)
            self.history["learning_rate"].append(opt.schedule((epoch + 1) * steps_per_epoch))
            if not np.isfinite(means[0]):
                logger.warning("Non-finite loss at epoch %d; stopping", epoch + 1)
                status = "failed"
                break
            if (epoch + 1) % val_every and epoch + 1 != num_epochs:
                continue
            val_loss = self._val_loss(params, val_gen)
            self.history["val_loss"].append(val_loss)
            logger.info("epoch %d/%d train=%.4e val=%.4e", epoch + 1, num_epochs, means[0], val_loss)
            if es.enabled:
                if val_loss < best_val - es.min_delta:
                    best_val, patience_count = val_loss, 0
                else:
                    patience_count += 1
                    if patience_count >= es.patience:
                        logger.info("Early stopping at epoch %d", epoch + 1)
                        break

        self._final_state = {
            "params": {"net": params, "coeffs": {}},
            "opt_state": opt.optimizer.state_dict(),
        }
        return {
            "history": self.history,
            "final_train_loss": self.history["train_loss"][-1] if self.history["train_loss"] else None,
            "best_val_loss": best_val if best_val < float("inf") else None,
            "identified_parameters": {},
            "true_parameters": self.pde.true_parameters,
            "wall_time_s": time.time() - start_time,
            "status": status,
        }
