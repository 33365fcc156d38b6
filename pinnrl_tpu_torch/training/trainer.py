"""PDETrainer: the training loop of the port (Adam, L-BFGS, and Adam then
L-BFGS).

An Adam step samples collocation points (uniform, stratified, RAR, or
RL-adaptive through the DQN agent's scores), computes the loss components
(the residual through the fused kernel when attached, BC and IC through
``model.apply``), back-propagates, clips by global norm and takes an Adam
step — the JAX package's scanned step, run eagerly. With an agent, the step
then rewards the agent on the updated parameters and takes its DQN update.
Losses stay on the device during an epoch; the host reads them once per
epoch, and nothing in an Adam step reads a device value back.

In the inverse and data modes the PDE's trainable coefficients
(``pde.init_coeffs()``, 0-d tensors) are optimized with the network: Adam
and L-BFGS take them as leaves beside the network's (first, as
``jax.tree_util`` orders ``{"coeffs", "net"}``), clipping takes the global
norm over both, and every loss, RAR score, RL reward and validation loss
reads them live. The epoch's host read also takes their values
(``history["param_<name>"]``).

Given ``experiment_dir``, ``train`` writes the JAX package's
experiment-directory protocol (``utils/io.py``): ``.running`` (removed at
the end and on failure), ``visualizations/``, ``config.yaml`` (the
``to_dict()`` snapshot as JSON text, which YAML readers take as is),
``metadata.json``, ``experiment.log``, and at each validation
``history.json``, ``metrics.json`` and ``live_snapshot.npz``; at the end
the final model as ``final_model.npz`` (flax path names) and the agent's
state as ``rl_agent.npz``.

``optimizer="adam_lbfgs"`` switches at ``int(adam_lbfgs_switch_ratio *
num_epochs)`` to one L-BFGS iteration per epoch (``training/lbfgs.py``) on
a deterministic objective: one fixed uniform batch of ``lbfgs.batch_size``
(default: every collocation point) and fixed BC/IC points, both drawn from
seeds of the run's seed and the round, redrawn with the optimizer restarted
every ``lbfgs.resample_every`` epochs of the phase. ``phase2_optimizer=
"adam"`` runs a fresh Adam on fresh batches instead. Validation runs at the
ends of the JAX package's chunks: every ``validation_frequency`` epochs,
counted afresh from the switch and from each resample round.

Not ported yet (each raises NotImplementedError naming its ROADMAP item):
float64 residuals (item 8b), adaptive loss weights, EMA, ensembles and
hard-IC (item 13), the plateau scheduler, profiling, checkpoints and resume
(item 9), the plots and report of an experiment directory (items 14 and
11; logged, not raised), and device meshes (item 14).
"""

from __future__ import annotations

import json
import logging
import math
import time
from datetime import datetime
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from pinnrl_tpu_torch.config import Config
from pinnrl_tpu_torch.models import PINNModel
from pinnrl_tpu_torch.pdes.base import PDEBase
from pinnrl_tpu_torch.training.lbfgs import LBFGS
from pinnrl_tpu_torch.utils.io import (
    save_live_snapshot,
    save_training_metrics,
    write_config_snapshot,
)

logger = logging.getLogger(__name__)

_COMPONENTS = ("residual", "boundary", "initial", "smoothness", "data")


def _unported(what: str, item):
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
    on the device, so a step does not wait for the host. A leaf that got no
    gradient steps with a zero one, as optax treats it (torch's optimizers
    would skip it).
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

    def state_dict(self) -> dict:
        return self.optimizer.state_dict()

    def step(self) -> None:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        scale = torch.clamp(self.clip_norm / norm, max=1.0)
        torch._foreach_mul_(grads, scale)
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.count)
        self.optimizer.step()
        self.count += 1


class PDETrainer:
    """Trains a PINN on a PDE problem with Adam, L-BFGS or Adam then L-BFGS
    (and, given ``rl_agent``, an ``rl.RLAgent`` that chooses the collocation
    points of the Adam steps)."""

    def __init__(self, model: PINNModel, pde: PDEBase, config: Config,
                 rl_agent: Optional[Any] = None, mesh: Optional[Any] = None) -> None:
        t = config.training
        if rl_agent is not None and rl_agent.device != model.device:
            raise ValueError(f"the RL agent is on {rl_agent.device}, the model on {model.device}")
        if mesh is not None:
            raise _unported("device-mesh data parallelism", 14)
        if t.adaptive_weights.enabled:
            raise _unported("adaptive loss weights", 13)
        if float(t.param_ema) > 0.0:
            raise _unported("EMA weight averaging", 13)
        if int(t.ensemble_size) > 1:
            raise _unported("deep ensembles", 13)
        if getattr(config.model, "hard_ic", False):
            raise _unported("the hard-IC output transform", 13)
        if t.scheduler_type == "reduce_lr":
            raise _unported("the plateau scheduler", 9)
        if t.profile_dir:
            raise _unported("profiler traces", 9)
        if t.residual_dtype != "float32":
            raise _unported("float64 residuals", "8b")

        self.model = model
        self.pde = pde
        self.config = config
        self.tcfg = t
        self.device = model.device
        self.rl_agent = rl_agent
        # Attaching an agent forces adaptive sampling.
        self.strategy = "adaptive" if rl_agent is not None else t.collocation_distribution
        self._rl_state = None
        self.optimizer_name = t.optimizer
        self.fast_bundle_active = pde.attach_fast_bundle(model, enable=t.get("stacked_jet", "auto"))
        self.fused_kernel_active = pde.attach_fused_residual_kernel(
            model, enable=t.get("fused_residual_kernel", "auto")
        )
        # The live trainable coefficients (empty in forward mode); train()
        # restarts them from the initial guesses.
        self.coeffs = self._init_coeffs()
        self.history: Dict[str, Any] = {
            "train_loss": [],
            "val_loss": [],
            "learning_rate": [],
            "epoch_time": [],
            "loss_components": {k: [] for k in _COMPONENTS},
        }
        for name in pde.trainable_parameters:
            self.history[f"param_{name}"] = []

    def _init_coeffs(self) -> Dict[str, torch.Tensor]:
        return {k: v.requires_grad_(True) for k, v in self.pde.init_coeffs().items()}

    def _leaves(self, params: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
        """What the optimizers update: the coefficients (by name), then the
        network's leaves."""
        return [self.coeffs[k] for k in sorted(self.coeffs)] + list(params.values())

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

    def _make_lbfgs(self, params: List[torch.Tensor]) -> LBFGS:
        """optax.lbfgs(memory_size=lbfgs.history_size) with a 25-step zoom
        line search, as the JAX package builds it; neither reads the config's
        max_iter, tolerance_grad, tolerance_change or line_search_fn."""
        return LBFGS(params, self.tcfg.lbfgs.history_size, max_linesearch_steps=25)

    def _lbfgs_batch(self, seed: int, round_index: int, n: int):
        """One L-BFGS round's fixed objective: a uniform batch of ``n``
        points and the seed of its BC/IC points, both from the run's seed and
        the round (the JAX package folds the round into PRNGKey(0xF1EED ^
        seed)), whatever the sampling strategy of the Adam steps."""
        batch_seed, loss_seed = (int(v) for v in np.random.SeedSequence(
            [(0xF1EED ^ seed) & 0xFFFFFFFF, round_index]).generate_state(2))
        x, t = self.pde.generate_collocation_points(
            torch.Generator(device=self.device).manual_seed(batch_seed), n, "uniform")
        return x, t, loss_seed

    # ------------------------------------------------------------------ #
    # One step
    # ------------------------------------------------------------------ #

    def _loss_components(self, params: Dict[str, torch.Tensor], x, t, generator):
        return self.pde.compute_loss(self.model.apply, params, x, t, coeffs=self.coeffs,
                                     generator=generator)

    def _sample(self, generator: torch.Generator, n: int, params: Dict[str, torch.Tensor]):
        if self.strategy == "residual_based":
            def residual_fn(xx, tt):
                return self.pde.residual_score(self.model.apply, params, xx, tt, self.coeffs)

            with torch.no_grad():
                return self.pde.generate_collocation_points(generator, n, "residual_based",
                                                            residual_fn=residual_fn)
        if self.strategy == "adaptive" and self.rl_agent is not None:
            return self.pde.generate_collocation_points(
                generator, n, "adaptive",
                score_fn=self.rl_agent.score_fn(self._rl_state, generator))
        return self.pde.generate_collocation_points(generator, n, self.strategy)

    def _init_rl_state(self, seed: int):
        """The agent's initial state: weights from a CPU generator seeded
        with ``seed``."""
        return self.rl_agent.init(torch.Generator().manual_seed(seed))

    def _rl_update(self, params, x, t, losses, generator: torch.Generator) -> None:
        """Reward the agent on the updated parameters and take its update:
        per-point |residual| of the first ``min(128, batch)`` points plus the
        step's BC and IC losses, as bandit transitions (done = 1)."""
        n_push = min(128, x.shape[0])
        with torch.no_grad():
            pts = torch.cat([x[:n_push], t[:n_push]], dim=-1)
            res = self.pde.residual_score(self.model.apply, params, x[:n_push], t[:n_push],
                                          self.coeffs)
            reward = self.rl_agent.compute_reward(res, losses["boundary"].detach(),
                                                  losses["initial"].detach())
        done = torch.ones((), device=x.device)
        self._rl_state = self.rl_agent.update(self._rl_state, pts, reward, pts, done, generator)

    def _step(self, params: Dict[str, torch.Tensor], opt: AdamStep, generator: torch.Generator,
              batch_size: int) -> torch.Tensor:
        """sample -> loss -> backward -> clip -> Adam (-> the agent's update).
        Returns the detached [total, residual, boundary, initial, smoothness,
        data] on the device."""
        x, t = self._sample(generator, batch_size, params)
        losses = self._loss_components(params, x, t, generator)
        for p in opt.params:
            p.grad = None
        losses["total"].backward()
        opt.step()
        if self.rl_agent is not None:
            self._rl_update(params, x, t, losses, generator)
        return torch.stack([losses["total"]] + [losses[k] for k in _COMPONENTS]).detach()

    def _lbfgs_step(self, params: Dict[str, torch.Tensor], opt: LBFGS, batch,
                    generator: torch.Generator) -> torch.Tensor:
        """One L-BFGS iteration on the round's ``batch`` = (x, t, BC/IC seed)
        (-> the agent's update). Returns the components at the starting
        point, as ``_step`` does."""
        x, t, loss_seed = batch
        loss_gen = torch.Generator(device=self.device)

        def objective():
            # Reseeded at every evaluation: the line search sees one function.
            losses = self._loss_components(params, x, t, loss_gen.manual_seed(loss_seed))
            grads = torch.autograd.grad(losses["total"], opt.params, allow_unused=True,
                                        materialize_grads=True)
            return losses["total"], grads, losses

        losses = opt.step(objective)[2]
        if self.rl_agent is not None:
            self._rl_update(params, x, t, losses, generator)
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
        if resume_from is not None:
            raise _unported("checkpoint resume", 9)
        t = self.tcfg
        num_epochs = num_epochs or t.num_epochs
        batch_size = batch_size or t.batch_size
        num_points = num_points or t.num_collocation_points
        # L-BFGS runs on one fixed batch per round: every collocation point
        # unless training.lbfgs.batch_size caps it.
        lbfgs_bs = min(t.lbfgs.batch_size or num_points, num_points)
        if self.optimizer_name == "lbfgs":
            batch_size = lbfgs_bs
        batch_size = min(batch_size, num_points)
        steps_per_epoch = max(num_points // batch_size, 1)
        # The switch against the horizon train() was given.
        self.switch_epoch = (int(t.adam_lbfgs_switch_ratio * num_epochs)
                             if self.optimizer_name == "adam_lbfgs" else None)

        exp = Path(experiment_dir) if experiment_dir else None
        log_handler = None
        if exp:
            exp.mkdir(parents=True, exist_ok=True)
            (exp / "visualizations").mkdir(exist_ok=True)
            (exp / ".running").touch()
            if not (exp / "config.yaml").exists():
                write_config_snapshot(exp / "config.yaml", self.config)
            self._write_metadata(exp, status="running", num_epochs=num_epochs, identified=False)
            log_handler = logging.FileHandler(exp / "experiment.log")
            logger.addHandler(log_handler)

        params = self.model.params
        self.coeffs = self._init_coeffs()
        leaves = self._leaves(params)
        names = list(self.pde.trainable_parameters)
        lbfgs_mode = self.optimizer_name == "lbfgs"
        # Phase-1 Adam anneals its cosine over its own phase.
        adam_epochs = self.switch_epoch or num_epochs
        opt = (self._make_lbfgs(leaves) if lbfgs_mode
               else self._make_adam(adam_epochs, steps_per_epoch, leaves))
        lr_schedule = self._make_lr_schedule(adam_epochs, steps_per_epoch)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        val_gen = torch.Generator(device=self.device).manual_seed(10_000 + seed)
        if self.rl_agent is not None:
            self._rl_state = self._init_rl_state(seed)

        switched = lbfgs_mode or self.switch_epoch is None
        phase_start = self.switch_epoch or 0
        resample = t.lbfgs.resample_every
        batch = None  # the L-BFGS round's (x, t, BC/IC seed)
        es = t.early_stopping
        best_val = float("inf")
        patience_count = 0
        status = "completed"
        start_time = time.time()
        val_every = max(int(t.validation_frequency), 1)
        epoch = 0
        stop = False
        try:
            while epoch < num_epochs and not stop:
                if not switched and epoch >= self.switch_epoch:
                    switched = True
                    steps_per_epoch = 1
                    logger.info("Switching optimizer: adam -> %s at epoch %d",
                                t.phase2_optimizer, epoch)
                    if t.phase2_optimizer == "lbfgs":
                        opt, lbfgs_mode = self._make_lbfgs(leaves), True
                    else:
                        # Fresh batches and a fresh Adam, its cosine to 0 over the rest.
                        batch_size = lbfgs_bs
                        opt = AdamStep(leaves, cosine_decay(t.phase2_learning_rate,
                                                            max(num_epochs - epoch, 1), 0.0),
                                       t.gradient_clip_norm, 0.9, 0.999, 0.0)
                if lbfgs_mode:
                    done_in_phase = epoch - phase_start
                    if batch is None or (resample and done_in_phase > 0
                                         and done_in_phase % resample == 0):
                        if batch is not None:
                            opt = self._make_lbfgs(leaves)  # a new round restarts the optimizer
                        batch = self._lbfgs_batch(
                            seed, done_in_phase // resample if resample else 0, lbfgs_bs)
                # Validation ends each chunk of the JAX package's loop: every
                # validation_frequency epochs, clipped at the switch and at rounds.
                chunk = min(val_every, num_epochs - epoch)
                if not switched:
                    chunk = min(chunk, max(self.switch_epoch - epoch, 1))
                if lbfgs_mode and resample:
                    next_round = phase_start + ((epoch - phase_start) // resample + 1) * resample
                    chunk = min(chunk, max(next_round - epoch, 1))
                for _ in range(chunk):
                    t0 = time.time()
                    if lbfgs_mode:
                        per_step = [self._lbfgs_step(params, opt, batch, gen)
                                    for _ in range(steps_per_epoch)]
                    else:
                        per_step = [self._step(params, opt, gen, batch_size)
                                    for _ in range(steps_per_epoch)]
                    if self.rl_agent is not None:
                        # Once per epoch, so exploration anneals over the run's horizon.
                        self._rl_state = self.rl_agent.update_epsilon(self._rl_state)
                    row = torch.stack(per_step).mean(dim=0)
                    if names:
                        row = torch.cat([row, torch.stack([self.coeffs[k].detach() for k in names])])
                    values = row.tolist()  # one host read per epoch
                    means, coeff_values = values[:1 + len(_COMPONENTS)], values[1 + len(_COMPONENTS):]
                    self.history["train_loss"].append(means[0])
                    for k, v in zip(_COMPONENTS, means[1:]):
                        self.history["loss_components"][k].append(v)
                    for k, v in zip(names, coeff_values):
                        self.history[f"param_{k}"].append(v)
                    self.history["epoch_time"].append(time.time() - t0)
                    # As the JAX package records it: the phase-1 schedule at the
                    # epoch's end, after the switch too (ROADMAP queue 3).
                    self.history["learning_rate"].append(lr_schedule((epoch + 1) * steps_per_epoch))
                    epoch += 1
                    if not np.isfinite(means[0]):
                        logger.warning("Non-finite loss at epoch %d; stopping", epoch)
                        status = "failed"
                        stop = True
                        break
                if stop:
                    break
                val_loss = self._val_loss(params, val_gen)
                self.history["val_loss"].append(val_loss)
                logger.info("epoch %d/%d train=%.4e val=%.4e", epoch, num_epochs,
                            self.history["train_loss"][-1], val_loss)
                if exp:
                    save_training_metrics(exp, self.history)
                    self._write_metadata(exp, status="running", num_epochs=num_epochs,
                                         current_epoch=epoch)
                    save_live_snapshot(exp, self.pde, self.model,
                                       {"net": params, "coeffs": self.coeffs}, grid=60)
                if es.enabled:
                    if val_loss < best_val - es.min_delta:
                        best_val, patience_count = val_loss, 0
                    else:
                        patience_count += 1
                        if patience_count >= es.patience:
                            logger.info("Early stopping at epoch %d", epoch)
                            stop = True
        except Exception:
            if exp:
                (exp / ".running").unlink(missing_ok=True)
            raise
        finally:
            # Detach the run's log handler: one per call would pile up.
            if log_handler is not None:
                logger.removeHandler(log_handler)
                log_handler.close()

        wall = time.time() - start_time
        identified = self.pde.canonicalize_coeffs(
            self.pde.get_trainable_parameter_values(self.coeffs))
        result = {
            "history": self.history,
            "final_train_loss": self.history["train_loss"][-1] if self.history["train_loss"] else None,
            "best_val_loss": best_val if best_val < float("inf") else None,
            "identified_parameters": identified,
            "true_parameters": self.pde.true_parameters,
            "wall_time_s": wall,
            "status": status,
        }
        if exp:
            if self.config.evaluation.save_plots:
                logger.info("evaluation.save_plots: the plots and report.html (ROADMAP item 14) "
                            "and heat's fdm_comparison.json (item 11) are not ported yet")
            save_training_metrics(exp, self.history)
            self._write_metadata(exp, status=status, num_epochs=num_epochs,
                                 current_epoch=len(self.history["train_loss"]), wall_time_s=wall)
            self.model.save_state(str(exp / "final_model.npz"))
            if self.rl_agent is not None:
                self.rl_agent.save_state(str(exp / "rl_agent.npz"), self._rl_state)
            (exp / ".running").unlink(missing_ok=True)
        self._final_state = {
            "params": {"net": params, "coeffs": self.coeffs},
            "opt_state": opt.state_dict(),
            "rl": self._rl_state,
        }
        return result

    # ------------------------------------------------------------------ #
    # Experiment metadata
    # ------------------------------------------------------------------ #

    def _write_metadata(self, exp: Path, status: str, num_epochs: int, current_epoch: int = 0,
                        wall_time_s: Optional[float] = None, identified: bool = True) -> None:
        """metadata.json, merged into what is there, with the JAX package's
        keys; ``identified_parameters`` reads the live coefficients (not
        before the first epoch, as in the JAX package)."""
        meta_path = exp / "metadata.json"
        meta = {}
        if meta_path.exists():
            try:
                meta = json.loads(meta_path.read_text())
            except ValueError:
                meta = {}
        meta.update({
            "status": status,
            "pde_type": self.pde.pde_type,
            "architecture": self.model.architecture_name,
            "mode": self.tcfg.mode,
            "optimizer": self.optimizer_name,
            "rl_enabled": self.rl_agent is not None,
            "sampling_strategy": self.strategy,
            "num_epochs": num_epochs,
            "current_epoch": current_epoch,
            "parameters": {
                k: (list(v) if isinstance(v, (list, tuple))
                    else v if isinstance(v, (str, bool)) else float(v))
                for k, v in self.pde.parameters.items()
            },
            "trainable_parameters": self.pde.trainable_parameters,
            "true_parameters": self.pde.true_parameters,
            "timestamp": datetime.now().isoformat(),
            "num_model_parameters": self.model.count_parameters(),
        })
        if identified and self.coeffs:
            meta["identified_parameters"] = self.pde.get_trainable_parameter_values(self.coeffs)
        if wall_time_s is not None:
            meta["wall_time_s"] = wall_time_s
        meta_path.write_text(json.dumps(meta, indent=2, default=str))
