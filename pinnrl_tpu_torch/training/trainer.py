"""PDETrainer: the training loop of the port (Adam, L-BFGS, and Adam then
L-BFGS).

An Adam step samples collocation points (uniform, stratified, RAR, or
RL-adaptive through the DQN agent's scores), computes the loss components
(the residual through the fused kernel when attached, BC and IC through
``model.apply``), back-propagates, clips by global norm and takes an Adam
step — the JAX package's scanned step. With an agent, the step then
rewards the agent on the updated parameters and takes its DQN update.
Each phase runs its steps through a step program
(``training/step_program.py``): on the card every phase captures its step
as CUDA graphs and replays them once per step, an L-BFGS iteration as its
start, its line-search trial under an IF node (replayed 25 times) and its
finish (``step_path`` says which phases: device meshes stay eager). Each step's row of
losses and weights goes into a device buffer; nothing in a step reads a
device value back, and the host reads a chunk's epoch rows, the plateau
scale and the last points once, at the chunk's end, as the JAX package
reads its chunk's metrics; a non-finite loss stops the run there.

In the inverse and data modes the PDE's trainable coefficients
(``pde.init_coeffs()``, 0-d tensors) are optimized with the network: Adam
and L-BFGS take them as leaves beside the network's (first, as
``jax.tree_util`` orders ``{"coeffs", "net"}``), clipping takes the global
norm over both, and every loss, RAR score, RL reward and validation loss
reads them live. The epoch's host read also takes their values
(``history["param_<name>"]``).

The levers, each as the JAX package runs it:

- adaptive loss weights (``training.adaptive_weights``, RBW or LRW;
  ``adaptive_weights.py``): the weights are updated from the step's
  component losses (RBW) or from the global norms of the residual, boundary
  and initial gradients (LRW: one ``torch.autograd.grad`` per component on
  the step's one forward), detached, and weight the total that is
  back-propagated; ``history["adaptive_weights"]`` holds each epoch's mean
  weights, padded to 4. Off under a pure ``"lbfgs"`` optimizer; refused with
  an L-BFGS phase 2 (the JAX package crashes there at the switch);
- ``scheduler_type="reduce_lr"``: optax's ``reduce_on_plateau(factor,
  patience, accumulation_size=1)`` (rtol 1e-4) on each step's total before
  the update, its scale on the device inside ``AdamStep``; the
  ``learning_rate`` history reads ``learning_rate * scale`` at each
  validation (1 after a switch, as JAX's L-BFGS state has no scale);
- ``param_ema``: a zero-initialized shadow of the network updated after
  every Adam step and debiased by ``1 - d^n`` when read; phase 2 starts from
  the average (and restarts the shadow), and a run whose last phase is
  stochastic ends on it;
- ``model.hard_ic``: the PDE's ``hard_ic_transform`` installed as the
  model's output transform before the bundle and kernel 1 are attached (so
  neither is, and the residual runs on the nested-jvp engine);
- ``profile_dir``: one ``torch.profiler`` trace (CUDA activities on the
  card) of the first chunk after the start, exported as a Chrome trace
  (``trace_epoch<E>.json``; JAX writes a TensorBoard trace);
- checkpoints: with ``experiment_dir``, every validation writes
  ``checkpoint.npz`` (the parameters and coefficients by the bridge's flax
  paths; Adam's moments, step counts and plateau state, or L-BFGS's memory;
  the adaptive-weight state; the EMA shadow and count; the agent's arrays;
  the training and validation generators' states) and ``checkpoint.json``
  (the epoch and the history). ``train(resume_from=...)`` restores them
  and continues the same stream. An optimizer state that does not match
  the run's first optimizer (an L-BFGS-phase checkpoint loaded into an Adam
  template) keeps the fresh one and logs it, as JAX's fallback does. The
  L-BFGS rounds' batches derive from ``seed``: a resumed run with the same
  seed keeps its batches, one with another seed draws fresh ones (JAX folds
  the seed into its restored round key to the same end).

Given ``experiment_dir``, ``train`` writes the JAX package's
experiment-directory protocol (``utils/io.py``): ``.running`` (removed at
the end and on failure), ``visualizations/``, ``config.yaml`` (the
``to_dict()`` snapshot as JSON text, which YAML readers take as is),
``metadata.json``, ``experiment.log``, and at each validation
``history.json``, ``metrics.json``, ``live_snapshot.npz`` and the
checkpoint; at the end the final model as ``final_model.npz`` (flax path
names) and the agent's state as ``rl_agent.npz``.

``optimizer="adam_lbfgs"`` switches at ``int(adam_lbfgs_switch_ratio *
num_epochs)`` to one L-BFGS iteration per epoch (``training/lbfgs.py``) on
a deterministic objective: one fixed uniform batch of ``lbfgs.batch_size``
(default: every collocation point) and fixed BC/IC points, both drawn from
seeds of the run's seed and the round, redrawn with the optimizer restarted
every ``lbfgs.resample_every`` epochs of the phase. ``phase2_optimizer=
"adam"`` runs a fresh Adam on fresh batches instead. Validation runs at the
ends of the JAX package's chunks: every ``validation_frequency`` epochs,
counted afresh from the switch and from each resample round.

With ``evaluation.save_plots`` the end of a run with an experiment
directory writes the JAX package's plots under ``visualizations/``
(training history, solution, collocation evolution from the points of the
last step before each validation, the agent's Q density; each returns None
without matplotlib), heat's ``fdm_comparison.json`` in one dimension, and
``report.html`` (``utils/plotting.py``).

Deep ensembles (``training.ensemble_size`` E > 1) train E members at once
under the JAX package's constraints (``_validate_ensemble``: Adam only, no
DQN, no adaptive weights, a cosine or constant schedule): every parameter,
coefficient, Adam moment and EMA shadow carries a leading member axis;
member m draws its initial weights from a generator seeded from the run's
seed and m, and its batches and BC/IC points from its own device generator;
the members' residual terms come from one call for all of them, as the JAX
package vmaps its step over the member axis: where kernel 1 is attached,
one member-batched kernel-1 call per step and per validation (each kernel
runs every member on its member axis, ``fused_step._loss_and_grads``);
otherwise one ``torch.func.vmap`` of the residual loss over the stacked
members, where kernels 2 and 3 launch once per layer for all members
(``member_path``, fixed at construction). The BC and IC terms run member
by member, and clipping takes each member's own global norm. The history
holds member means, validation is the member mean on one shared batch, and
the final model (``model.ensemble``) predicts the member mean.

Float64 residuals (``training.residual_dtype="float64"``): when the L-BFGS
phase starts (at the start under ``optimizer="lbfgs"``, at the switch of
``adam_lbfgs`` with either phase-2 optimizer), the network's parameters and
the PDE's coefficients are cast to float64 in place and the phase's
optimizer and EMA shadow are built on them; the phase's batches, its BC/IC
draws (``pde.dtype``) and its validation points follow. Kernels 1-3 send
float64 to their plain versions by the JAX kernels' dtype gate; the DQN
agent stays float32 (its inputs are cast to it). At the end
``model.params`` are float32 again; ``_final_state`` keeps the float64
parameters, which validation reads. Checkpoints keep the dtype, and a run
resumed in the phase continues in float64. The phase runs on the card:
the JAX package moves it to the host only because XLA:TPU has no float64.

Device meshes (``mesh=parallel.make_mesh()``): one process per device.
Every rank draws the same global batch (padded to a multiple of the mesh
size) and computes the loss on its own rows; the gradient (and, inside the
L-BFGS objective, the value) is averaged over the ranks before clipping,
so every rank takes the unsharded step. The parameters start from rank
0's; rank 0 alone writes the experiment directory. Kernel 1 stays attached
on each rank, except under causal weights, whose weights need the global
batch (``Mesh.causal_loss``).
"""

from __future__ import annotations

import contextlib
import json
import logging
import math
import time
from datetime import datetime
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from pinnrl_tpu_torch.config import Config
from pinnrl_tpu_torch.models import PINNModel
from pinnrl_tpu_torch.parallel.mesh import Mesh, pad_to_multiple, replicate, shard_batch
from pinnrl_tpu_torch.pdes.base import PDEBase
from pinnrl_tpu_torch.training.adaptive_weights import AdaptiveLossWeights, AdaptiveWeightState
from pinnrl_tpu_torch.training.lbfgs import LBFGS
from pinnrl_tpu_torch.training.step_program import Search, StepProgram, step_path
from pinnrl_tpu_torch.utils.io import (
    save_live_snapshot,
    save_training_metrics,
    write_config_snapshot,
)

logger = logging.getLogger(__name__)

_COMPONENTS = ("residual", "boundary", "initial", "smoothness", "data")
_AW_FIELDS = ("running", "weights", "prev_weights", "initialized")
# optax.contrib.reduce_on_plateau's defaults besides factor and patience.
_PLATEAU_RTOL = 1e-4


def _same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two devices are one ("cuda" without an index is the current
    card)."""
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    current = torch.cuda.current_device()
    return (current if a.index is None else a.index) == (current if b.index is None else b.index)


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
    learning-rate schedule, as the JAX package's optax chain; with
    ``plateau=(factor, patience)``, optax's ``reduce_on_plateau`` after it.

    Clipping follows optax: scale = min(1, max_norm / ||g||) with no
    epsilon (``torch.nn.utils.clip_grad_norm_`` adds 1e-6); ``clip_norm``
    None does not clip (a bare ``optax.adam``). With ``members`` E > 0 every
    leaf carries a leading member axis, and each member is clipped by its
    own global norm (Adam is elementwise, so each member steps as alone).
    The scale stays on the device, so a step does not wait for the host. A leaf that got no
    gradient steps with a zero one, as optax treats it (torch's optimizers
    would skip it).

    The plateau state (scale, best value, plateau count) is device tensors,
    updated in place. Each step reads the value handed to ``step``
    (accumulation size 1), updates the scale first and steps at ``scale *
    lr``: scaling the Adam update, AdamW's decay term included, as optax
    scales the chain's output.

    A step is ``prepare`` (the host writes the learning rate of step
    ``count``), ``apply`` (the device work) and ``advance`` (``count`` + 1, a
    host int that the checkpoint reads). With ``capturable`` and under a
    plateau, on the card, the optimizer is torch's ``capturable`` Adam and
    its learning rate the device tensor ``lr``, so a captured ``apply``
    replays at every count: inside a capture ``step`` records ``apply``
    alone and sets ``captured``, and the step program prepares and advances
    around each replay. The trainer asks for it on every path, so that its
    eager phases (a mesh, L-BFGS's agent) compute what its replayed ones
    do; the harnesses, which never capture, keep the host-lr Adam, as does
    the CPU, where torch's capturable Adam is not available.
    """

    def __init__(self, params: List[torch.Tensor], schedule: Callable[[int], float],
                 clip_norm: Optional[float], beta1: float, beta2: float,
                 weight_decay: float, plateau: Optional[Tuple[float, int]] = None,
                 members: int = 0, capturable: bool = False) -> None:
        self.params = params
        self.members = int(members)
        self.schedule = schedule
        self.clip_norm = None if clip_norm is None else float(clip_norm)
        self.plateau = plateau
        cls = torch.optim.AdamW if weight_decay and weight_decay > 0 else torch.optim.Adam
        device = params[0].device
        capturable = device.type == "cuda" and (capturable or plateau is not None)
        # The learning rate of the step at ``count``, and what the optimizer
        # reads (scale * lr under a plateau): device tensors when capturable.
        self.lr = torch.full((), schedule(0), device=device) if capturable else None
        self._host_lr = schedule(0)
        self._group_lr = self.lr
        if plateau is not None:
            self.scale = torch.ones((), device=device)
            self.best = torch.full((), float("inf"), device=device)
            self.plateau_count = torch.zeros((), dtype=torch.int32, device=device)
            if capturable:
                self._group_lr = self.lr.clone()
        self.optimizer = cls(params, lr=schedule(0), betas=(beta1, beta2), eps=1e-8,
                             weight_decay=float(weight_decay or 0.0), capturable=capturable)
        if capturable:
            for group in self.optimizer.param_groups:
                group["lr"] = self._group_lr
        self.count = 0
        self.captured = False

    def state_dict(self) -> dict:
        return self.optimizer.state_dict()

    def _update_scale(self, value: torch.Tensor) -> None:
        """reduce_on_plateau's ``_update_scale`` (cooldown 0, atol 0,
        min_scale 0) on one value, in place."""
        factor, patience = self.plateau
        value = value.detach().to(self.best.dtype)
        improved = value < (1 - _PLATEAU_RTOL) * self.best
        count = torch.where(improved, 0, self.plateau_count + 1)
        hit = count == patience
        self.best.copy_(torch.where(improved, value, self.best))
        self.plateau_count.copy_(torch.where(hit, 0, count))
        self.scale.copy_(torch.clamp(torch.where(hit, self.scale * factor, self.scale), min=0.0))

    def prepare(self) -> None:
        """Write the learning rate of the step at ``count``."""
        value = self.schedule(self.count)
        if self.lr is not None:
            self.lr.fill_(value)
        else:
            self._host_lr = value

    def apply(self, value: Optional[torch.Tensor] = None) -> None:
        """Clip, update the plateau scale on ``value`` and step, on the
        device."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.clip_norm is not None:
            grads = [p.grad for p in self.params]
            if self.members:
                E = self.members
                sq = torch.stack([torch.sum(g.reshape(E, -1) ** 2, dim=1) for g in grads]).sum(0)
                scale = torch.clamp(self.clip_norm / torch.sqrt(sq), max=1.0)
                for g in grads:
                    g.mul_(scale.reshape((E,) + (1,) * (g.ndim - 1)))
            else:
                norm = torch.linalg.vector_norm(
                    torch.stack([torch.linalg.vector_norm(g) for g in grads]))
                torch._foreach_mul_(grads, torch.clamp(self.clip_norm / norm, max=1.0))
        if self.plateau is not None:
            self._update_scale(value)
        if self.lr is not None:
            if self.plateau is not None:
                self._group_lr.copy_(self.scale * self.lr)
        else:
            lr = self.scale * self._host_lr if self.plateau is not None else self._host_lr
            for group in self.optimizer.param_groups:
                group["lr"] = lr
        self.optimizer.step()

    def advance(self) -> None:
        self.count += 1

    def step(self, value: Optional[torch.Tensor] = None) -> None:
        """``prepare``, ``apply``, ``advance``; inside a CUDA-graph capture
        ``apply`` alone (and ``captured`` is set)."""
        capturing = self.lr is not None and torch.cuda.is_current_stream_capturing()
        if not capturing:
            self.prepare()
        self.apply(value)
        if capturing:
            self.captured = True
        else:
            self.advance()

    def arrays(self, names: List[str]) -> Dict[str, np.ndarray]:
        """The state as numpy arrays: per leaf (``names``, in the order of
        ``params``) Adam's moments and step count, the step counter and the
        plateau state."""
        out = {"count": np.asarray(self.count)}
        for name, p in zip(names, self.params):
            for key, value in self.optimizer.state.get(p, {}).items():
                out[f"adam/{name}/{key}"] = value.detach().cpu().numpy()
        if self.plateau is not None:
            for key in ("scale", "best", "plateau_count"):
                out[f"plateau/{key}"] = getattr(self, key).cpu().numpy()
        return out

    @torch.no_grad()
    def load_state(self, p: torch.Tensor, saved: Dict[str, np.ndarray]) -> None:
        """Leaf ``p``'s Adam state from numpy arrays: the step count on the
        device where the optimizer is capturable, on the host otherwise."""
        capturable = self.optimizer.param_groups[0]["capturable"]
        self.optimizer.state[p] = {k: torch.as_tensor(v).to(p.device if k != "step" or capturable
                                                            else "cpu") for k, v in saved.items()}

    @torch.no_grad()
    def load_arrays(self, arrays: Dict[str, np.ndarray], names: List[str]) -> None:
        """Restore what ``arrays`` wrote; raises KeyError on a state of
        another shape of optimizer."""
        if (self.plateau is not None) != ("plateau/scale" in arrays):
            raise KeyError("the plateau state does not match")
        state = {}
        for name, p in zip(names, self.params):
            saved = {key.rsplit("/", 1)[1]: v for key, v in arrays.items()
                     if key.startswith(f"adam/{name}/")}
            if not saved and int(arrays["count"]) > 0:
                raise KeyError(f"no Adam state for {name}")
            if saved:
                state[p] = saved
        for p, saved in state.items():
            self.load_state(p, saved)
        self.count = int(arrays["count"])
        if self.plateau is not None:
            for key in ("scale", "best", "plateau_count"):
                getattr(self, key).copy_(torch.as_tensor(arrays[f"plateau/{key}"]))


class PDETrainer:
    """Trains a PINN on a PDE problem with Adam, L-BFGS or Adam then L-BFGS
    (and, given ``rl_agent``, an ``rl.RLAgent`` that chooses the collocation
    points of the Adam steps)."""

    def __init__(self, model: PINNModel, pde: PDEBase, config: Config,
                 rl_agent: Optional[Any] = None, mesh: Optional[Mesh] = None) -> None:
        t = config.training
        if rl_agent is not None and rl_agent.device != model.device:
            raise ValueError(f"the RL agent is on {rl_agent.device}, the model on {model.device}")
        if mesh is not None and not _same_device(mesh.device, model.device):
            raise ValueError(f"the mesh's device is {mesh.device}, the model's {model.device}")
        self.mesh = mesh
        # The parameters' dtype: float64 from the start of a float64 phase.
        self._dtype = torch.float32
        # Adaptive weights are off under pure L-BFGS, as in the JAX package.
        aw = t.adaptive_weights
        self.aw_enabled = bool(aw.enabled and t.optimizer != "lbfgs")
        if self.aw_enabled and t.optimizer == "adam_lbfgs" and t.phase2_optimizer == "lbfgs":
            # The JAX package trains the Adam phase, then crashes at the switch
            # (its adaptive step calls the line search without grad and value_fn).
            raise ValueError("adaptive_weights cannot be combined with optimizer='adam_lbfgs' "
                             "and phase2_optimizer='lbfgs' (the L-BFGS phase takes no adaptive "
                             "weights); use phase2_optimizer='adam' or disable adaptive_weights")
        self.adaptive_weights = AdaptiveLossWeights(
            strategy=aw.strategy, alpha=aw.alpha, eps=float(aw.eps),
            initial_weights=list(aw.initial_weights)[:3] if aw.initial_weights else None,
            num_components=3, device=model.device)
        self._ema_decay = float(t.param_ema)

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
        # Hard IC first: with an output transform neither the bundle nor
        # kernel 1 attaches.
        if getattr(config.model, "hard_ic", False) and model.output_transform is None:
            model.output_transform = pde.hard_ic_transform()
        self.fast_bundle_active = pde.attach_fast_bundle(model, enable=t.get("stacked_jet", "auto"))
        fused_enable = t.get("fused_residual_kernel", "auto")
        if mesh is not None and pde.causal_eps() > 0.0:
            # Causal weights take the global batch (Mesh.causal_loss); kernel 1
            # weighs the points it is given.
            if fused_enable in (True, "on"):
                raise ValueError(
                    "fused_residual_kernel cannot be combined with a device mesh under causal "
                    "weights: the weights need the global batch")
            fused_enable = "off"
        self.fused_kernel_active = pde.attach_fused_residual_kernel(model, enable=fused_enable)
        # The live trainable coefficients (empty in forward mode); train()
        # restarts them from the initial guesses.
        self.coeffs = self._init_coeffs()
        self._aw_state = self.adaptive_weights.init()
        # The EMA shadow (None when EMA is off) and its count, a host int.
        self._ema_shadow: Optional[List[torch.Tensor]] = None
        self._ema_n = 0
        self.members = int(t.ensemble_size) if int(t.ensemble_size) > 1 else 0
        # How an ensemble's residual terms are computed, all members at once:
        # "kernel1", one member-batched kernel-1 call (kernel 1 attached and no
        # live coefficients, compute_loss's own condition), or "vmap", one
        # torch.func.vmap of the residual loss over the stacked members.
        self.member_path = (("kernel1" if self.fused_kernel_active and not self.coeffs else "vmap")
                            if self.members else None)
        # The last step's first 64 points (64, d + 1), kept at each
        # validation (the collocation-evolution plot).
        self._last_pts: Optional[torch.Tensor] = None
        self.points_history: List[np.ndarray] = []
        # The last run's step programs, in order (``step_program.step_path``
        # says which capture their step).
        self.programs: List[StepProgram] = []
        self.history: Dict[str, Any] = {
            "train_loss": [],
            "val_loss": [],
            "learning_rate": [],
            "epoch_time": [],
            "loss_components": {k: [] for k in _COMPONENTS},
            "adaptive_weights": [],
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
            plateau=((self.tcfg.lr_scheduler.factor, int(self.tcfg.lr_scheduler.patience))
                     if self.tcfg.scheduler_type == "reduce_lr" else None),
            members=self.members,
            capturable=True,
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
        return x.to(self._dtype), t.to(self._dtype), loss_seed

    # ------------------------------------------------------------------ #
    # One step
    # ------------------------------------------------------------------ #

    def _loss_components(self, params: Dict[str, torch.Tensor], x, t, generator, coeffs=None,
                         residual_loss=None):
        return self.pde.compute_loss(self.model.apply, params, x, t,
                                     coeffs=self.coeffs if coeffs is None else coeffs,
                                     generator=generator, residual_loss=residual_loss)

    def _sharded_loss(self, params: Dict[str, torch.Tensor], x, t, generator):
        """The loss components on this rank's rows of the global batch (x,
        t): the whole batch without a mesh."""
        if self.mesh is None:
            return self._loss_components(params, x, t, generator)
        xs, ts = shard_batch(self.mesh, x, t)
        self.pde.mesh = self.mesh
        try:
            return self._loss_components(params, xs, ts, generator)
        finally:
            self.pde.mesh = None

    def _reduce_grads(self, leaves: List[torch.Tensor]) -> None:
        """Average the leaves' gradients over the mesh (a leaf without one
        counts zero, as optax treats it)."""
        if self.mesh is None:
            return
        for p in leaves:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.mesh.all_reduce_mean([p.grad for p in leaves])

    def _sample(self, generator: torch.Generator, n: int, params: Dict[str, torch.Tensor],
                coeffs=None):
        coeffs = self.coeffs if coeffs is None else coeffs
        if self.strategy == "residual_based":
            def residual_fn(xx, tt):
                return self.pde.residual_score(self.model.apply, params, xx, tt, coeffs)

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
        return self.rl_agent.init(torch.Generator().manual_seed(seed), capturable=True)

    def _rl_update(self, params, x, t, losses, generator: torch.Generator) -> None:
        """Reward the agent on the updated parameters and take its update:
        per-point |residual| of the first ``min(128, batch)`` points plus the
        step's BC and IC losses, as bandit transitions (done = 1)."""
        n_push = min(128, x.shape[0])
        with torch.no_grad():
            # The agent stays float32 when the parameters are float64.
            pts = torch.cat([x[:n_push], t[:n_push]], dim=-1).float()
            res = self.pde.residual_score(self.model.apply, params, x[:n_push], t[:n_push],
                                          self.coeffs).float()
            reward = self.rl_agent.compute_reward(res, losses["boundary"].detach().float(),
                                                  losses["initial"].detach().float())
        done = torch.ones((), device=x.device)
        self._rl_state = self.rl_agent.update(self._rl_state, pts, reward, pts, done, generator)

    def _weighted_total(self, losses: Dict[str, torch.Tensor], w: torch.Tensor) -> torch.Tensor:
        """The adaptive-weight total: w . [residual, boundary, initial] plus
        the statically weighted smoothness, gPINN, mass, mu-H2 and data
        terms, as the JAX package's ``_weighted_total``."""
        lw = self.pde._loss_weights()
        smooth_w = float(lw.get("smoothness", 0.0))
        data_w = float(lw.get("data", 1.0))
        mode = self.pde._training_mode()
        physics = 0.0 if mode == "data_only" else 1.0
        if mode in ("inverse", "data_only", "data_augmented") and data_w <= 0.0:
            data_w = 1.0
        return (
            physics * w[0] * losses["residual"]
            + physics * w[1] * losses["boundary"]
            + physics * w[2] * losses["initial"]
            + smooth_w * losses["smoothness"]
            + physics * float(lw.get("gpinn", 0.0)) * losses.get("gpinn", 0.0)
            + physics * float(lw.get("mass", 0.0)) * losses.get("mass", 0.0)
            + physics * float(lw.get("mu_h2", 0.0)) * losses.get("mu_h2", 0.0)
            + data_w * losses["data"]
        )

    def _adaptive_total(self, losses: Dict[str, torch.Tensor], leaves: List[torch.Tensor]):
        """Advance the adaptive weights on this step's components (RBW: the
        losses; LRW: the global norms of their gradients over every
        optimized leaf) and return (the weighted total, the weights). The
        graph is kept for the weighted backward: kernel 1's gradients are
        the ones its forward saved, so it launches once per step."""
        comps = [losses["residual"], losses["boundary"], losses["initial"]]
        if self.adaptive_weights.strategy == "lrw":
            sq = []
            for c in comps:
                if not c.requires_grad:
                    sq.append(torch.zeros((), device=c.device))
                    continue
                grads = torch.autograd.grad(c, leaves, retain_graph=True, allow_unused=True,
                                            materialize_grads=True)
                if self.mesh is not None:
                    grads = self.mesh.all_reduce_mean(grads)
                sq.append(sum(torch.sum(g * g) for g in grads))
            values = torch.sqrt(torch.stack(sq))
        else:
            values = torch.stack(comps).detach()
            if self.mesh is not None:
                values = self.mesh.mean(values)
        new = self.adaptive_weights.update(self._aw_state, values)
        for f in _AW_FIELDS:  # in place: a replayed step reads these buffers
            getattr(self._aw_state, f).copy_(getattr(new, f))
        w = self.adaptive_weights.get_weights(self._aw_state).detach()
        return self._weighted_total(losses, w), w

    def _row(self, total: torch.Tensor, losses: Dict[str, torch.Tensor],
             weights: torch.Tensor) -> torch.Tensor:
        """[total, residual, boundary, initial, smoothness, data, w0, w1, w2],
        detached, on the device."""
        return torch.cat([torch.stack([total] + [losses[k] for k in _COMPONENTS]).detach(),
                          weights.detach()])

    @torch.no_grad()
    def _keep_points(self, x: torch.Tensor, t: torch.Tensor) -> None:
        """The batch's first 64 points (x, t), into ``_last_pts`` in place
        (a replayed step refreshes them)."""
        pts = torch.cat([x[:64], t[:64]], dim=-1)
        last = self._last_pts
        if last is None or last.shape != pts.shape or last.dtype != pts.dtype:
            self._last_pts = pts
        else:
            last.copy_(pts)

    def _step(self, params: Dict[str, torch.Tensor], opt: AdamStep, generator: torch.Generator,
              batch_size: int) -> torch.Tensor:
        """sample -> loss -> backward -> clip -> Adam (-> EMA -> the agent's
        update). Returns ``_row`` of the step."""
        x, t = self._sample(generator, batch_size, params)
        x, t = x.to(self._dtype), t.to(self._dtype)
        self._keep_points(x, t)
        losses = self._sharded_loss(params, x, t, generator)
        for p in opt.params:
            p.grad = None
        if self.aw_enabled:
            total, weights = self._adaptive_total(losses, opt.params)
        else:
            total, weights = losses["total"], self.adaptive_weights.get_weights(self._aw_state)
        total.backward()
        self._reduce_grads(opt.params)
        value = total.detach()
        if self.mesh is not None and opt.plateau is not None:
            value = self.mesh.mean(value)  # the plateau reads the global total
        opt.step(value)
        self._ema_update(params)
        if self.rl_agent is not None:
            self._rl_update(params, x, t, losses, generator)
        return self._row(total, losses, weights)

    def _member(self, params: Dict[str, torch.Tensor], m: int):
        """Member m's parameters and coefficients: views of the stacked
        leaves, so their gradients land in the stack."""
        return {k: v[m] for k, v in params.items()}, {k: v[m] for k, v in self.coeffs.items()}

    def _member_residual_losses(self, params: Dict[str, torch.Tensor],
                                batches: List[Tuple[torch.Tensor, torch.Tensor]]) -> torch.Tensor:
        """Every member's residual term (E,) on its batch (x, t), from one
        call for all members (``member_path``): the member-batched kernel-1
        call on z (E, N, d+1), each member's points sorted by time under
        causal weights as ``compute_loss`` sorts them; or one
        ``torch.func.vmap`` of the residual loss over the stacked leaves,
        coefficients and batches."""
        xs = torch.stack([x for x, _ in batches])
        ts = torch.stack([t for _, t in batches])
        if self.member_path == "kernel1":
            z = torch.cat([xs, ts], dim=-1)
            if self.pde.causal_eps() > 0.0:
                order = torch.argsort(ts[..., 0], dim=1, stable=True)
                z = torch.gather(z, 1, order[..., None].expand_as(z))
            return self.pde._fused_residual_loss(params, z)

        def residual_loss(p, c, x, t):
            return self.pde._residual_loss(
                self.pde.compute_residual(self.model.apply, p, x, t, c), t)

        return torch.func.vmap(residual_loss)(params, self.coeffs, xs, ts)

    def _ensemble_step(self, params: Dict[str, torch.Tensor], opt: AdamStep,
                       gens: List[torch.Generator], batch_size: int) -> torch.Tensor:
        """One Adam step of every member, each on its own batch and BC/IC
        points from its own generator (each generator draws the batch, then
        the BC and IC points, as a single model's does): the residual terms of
        all members from one call (``_member_residual_losses``), the BC/IC
        terms member by member, the members' totals summed for one backward
        (their gradients are disjoint), then the member-wise clipped Adam
        step. Returns the members' mean ``_row``."""
        for p in opt.params:
            p.grad = None
        weights = self.adaptive_weights.get_weights(self._aw_state)
        members = [self._member(params, m) for m in range(len(gens))]
        batches = [self._sample(gen, batch_size, pm, cm) for gen, (pm, cm) in zip(gens, members)]
        self._keep_points(*batches[0])
        residuals = self._member_residual_losses(params, batches)
        rows, total = [], 0.0
        for m, gen in enumerate(gens):
            (pm, cm), (x, t) = members[m], batches[m]
            losses = self._loss_components(pm, x, t, gen, cm, residual_loss=residuals[m])
            total = total + losses["total"]
            rows.append(self._row(losses["total"], losses, weights))
        total.backward()
        opt.step()
        self._ema_update(params)
        return torch.stack(rows).mean(dim=0)

    def _start_program(self, params: Dict[str, torch.Tensor], opt, gens: List[torch.Generator],
                       batch_size: int, batch, epoch: int, val_every: int,
                       steps_per_epoch: int) -> StepProgram:
        """The step program of a phase (or an L-BFGS round) that starts at
        ``epoch``: its path by ``step_path``, logged."""
        lbfgs = isinstance(opt, LBFGS)
        path, why = step_path(self.device, lbfgs, self.mesh)
        search = None
        if lbfgs:
            name = "L-BFGS"
            start, trial, finish, reseed, loss_gen = self._lbfgs_pieces(params, opt, batch, gens[0])
            search = Search(start, trial, finish, opt.active, opt.max_linesearch_steps, reseed,
                            [loss_gen])

            def body():
                return self._lbfgs_step(params, opt, batch, gens[0])
        elif self.members:
            name = "ensemble Adam"

            def body():
                return self._ensemble_step(params, opt, gens, batch_size)
        else:
            name = "Adam"

            def body():
                return self._step(params, opt, gens[0], batch_size)
        agent = self.rl_agent
        optimizers = ([] if lbfgs else [opt]) + ([self._rl_state.opt_state] if agent is not None
                                                 else [])
        program = StepProgram(
            body, path, self.device, capacity=val_every * steps_per_epoch, epochs=val_every,
            generators=gens, optimizers=optimizers,
            counters=[(self, "_ema_n")],
            ready=(lambda: agent.settled(self._rl_state)) if agent is not None else (lambda: True),
            name=name, search=search)
        logger.info("%s phase at epoch %d: %s steps (%s)", name, epoch, path, why)
        self.programs.append(program)
        return program

    def _end_program(self, program: Optional[StepProgram], leaves: List[torch.Tensor]) -> None:
        """Release a phase's program; a captured one's gradients live in its
        graph's memory."""
        if program is None:
            return
        if program.graph is not None:
            for p in leaves + (list(self._rl_state.policy_params.values())
                               if self._rl_state is not None else []):
                p.grad = None
        program.release()

    def _read_chunk(self, program: StepProgram, chunk: int, opt):
        """The chunk's epoch rows, the plateau scale (1 without one) and the
        last step's first 64 points, in one host read; the replays' kernel
        launches (the program's tally) are read with them and settled."""
        plateau = isinstance(opt, AdamStep) and opt.plateau is not None
        pts = self._last_pts
        tally = program.tally
        parts = [program.epochs[:chunk].reshape(-1)]
        parts += [opt.scale.reshape(1)] if plateau else []
        parts += [pts.reshape(-1)] if pts is not None else []
        parts += [tally] if tally is not None else []
        flat = torch.cat([v.double() for v in parts]).tolist()
        if tally is not None:
            program.settle(flat[len(flat) - tally.numel():])
            flat = flat[:len(flat) - tally.numel()]
        width = program.epochs.shape[1]
        rows = [flat[i * width:(i + 1) * width] for i in range(chunk)]
        k = chunk * width
        scale = flat[k] if plateau else 1.0
        if pts is not None:
            dtype = np.float64 if pts.dtype == torch.float64 else np.float32
            pts = np.asarray(flat[k + plateau:], dtype=dtype).reshape(tuple(pts.shape))
        return rows, scale, pts

    def _lbfgs_pieces(self, params: Dict[str, torch.Tensor], opt: LBFGS, batch,
                      generator: torch.Generator):
        """One L-BFGS iteration on the round's ``batch`` = (x, t, BC/IC seed)
        as ``LBFGS``'s pieces: ``start`` (the objective at the iteration's
        point, whose ``_row`` it keeps in a buffer), ``trial``, and ``finish``
        (-> the agent's update; returns the row); then ``reseed`` and the
        objective's generator. The objective draws its BC/IC points from that
        generator reseeded at every evaluation, so the line search sees one
        function; a captured evaluation cannot reseed, and the step program
        calls ``reseed`` before each replay instead."""
        x, t, loss_seed = batch
        loss_gen = torch.Generator(device=self.device)
        row: List[torch.Tensor] = []  # the iteration's row, a buffer written in place

        def reseed():
            loss_gen.manual_seed(loss_seed)

        def objective():
            if not (self.device.type == "cuda" and torch.cuda.is_current_stream_capturing()):
                reseed()
            losses = self._sharded_loss(params, x, t, loss_gen)
            value = losses["total"]
            grads = torch.autograd.grad(value, opt.params, allow_unused=True,
                                        materialize_grads=True)
            if self.mesh is not None:
                # Every rank's line search sees the global objective.
                value, *grads = self.mesh.all_reduce_mean([value.detach()] + list(grads))
            return value, grads, losses

        def start():
            self._keep_points(x, t)
            losses = opt.start(objective)[2]
            new = self._row(losses["total"], losses,
                            self.adaptive_weights.get_weights(self._aw_state))
            if row:
                row[0].copy_(new)
            else:
                row.append(new)

        def trial():
            opt.trial(objective)

        def finish():
            opt.finish()
            if self.rl_agent is not None:
                # The BC and IC losses at the iteration's start: the row's.
                self._rl_update(params, x, t, {k: row[0][1 + _COMPONENTS.index(k)]
                                               for k in ("boundary", "initial")}, generator)
            return row[0]

        return start, trial, finish, reseed, loss_gen

    def _lbfgs_step(self, params: Dict[str, torch.Tensor], opt: LBFGS, batch,
                    generator: torch.Generator) -> torch.Tensor:
        """One eager L-BFGS iteration on the round's ``batch`` (-> the agent's
        update). Returns ``_row`` at the starting point."""
        start, trial, finish, _, _ = self._lbfgs_pieces(params, opt, batch, generator)
        start()
        opt.search(trial)
        return finish()

    # ------------------------------------------------------------------ #
    # Float64 phase and mesh rank
    # ------------------------------------------------------------------ #

    @torch.no_grad()
    def _maybe_promote_f64(self, params: Dict[str, torch.Tensor]) -> None:
        """Cast the network's parameters and the coefficients to float64 in
        place when ``training.residual_dtype == "float64"`` (the JAX
        package's ``_maybe_promote_f64``); the PDE's draws follow."""
        if self.tcfg.residual_dtype != "float64":
            return
        for p in list(params.values()) + list(self.coeffs.values()):
            p.grad = None
            p.data = p.data.to(torch.float64)
        self._dtype = self.pde.dtype = torch.float64

    @torch.no_grad()
    def _demote_f32(self, params: Dict[str, torch.Tensor]) -> None:
        """Cast float64 parameters back to float32 in place."""
        for p in params.values():
            if p.dtype == torch.float64:
                p.grad = None
                p.data = p.data.to(torch.float32)
        self._dtype = self.pde.dtype = torch.float32

    def _is_writer(self) -> bool:
        """Whether this process writes files: always without a mesh, rank 0
        under one."""
        return self.mesh is None or self.mesh.rank == 0

    # ------------------------------------------------------------------ #
    # EMA of the network's parameters
    # ------------------------------------------------------------------ #

    def _ema_init(self, params: Dict[str, torch.Tensor]) -> None:
        """A zero shadow (None when EMA is off) and a zero count."""
        self._ema_shadow = ([torch.zeros_like(p) for p in params.values()]
                            if self._ema_decay > 0.0 else None)
        self._ema_n = 0

    @torch.no_grad()
    def _ema_update(self, params: Dict[str, torch.Tensor]) -> None:
        """The shadow in place; the count on the host (the step program
        advances it per replay)."""
        if self._ema_shadow is None:
            return
        d = self._ema_decay
        torch._foreach_mul_(self._ema_shadow, d)
        torch._foreach_add_(self._ema_shadow, [p.detach() for p in params.values()],
                            alpha=1.0 - d)
        self._ema_n += 1

    def _ema_read(self) -> Optional[List[torch.Tensor]]:
        """The debiased average shadow / (1 - d^n); None before any update."""
        if self._ema_shadow is None or self._ema_n == 0:
            return None
        denom = 1.0 - self._ema_decay ** self._ema_n
        return [s / denom for s in self._ema_shadow]

    @torch.no_grad()
    def _ema_apply(self, params: Dict[str, torch.Tensor]) -> None:
        """Write the debiased average into the network's parameters."""
        avg = self._ema_read()
        if avg is not None:
            torch._foreach_copy_(list(params.values()), avg)

    @torch.no_grad()
    def _val_loss(self, params, generator: torch.Generator) -> float:
        """The validation loss on fresh uniform points; an ensemble's is the
        members' mean on one shared batch (the same points and BC/IC draws
        for every member), the residual terms from one call for all members
        (``_member_residual_losses``)."""
        x, t = self.pde.generate_collocation_points(
            generator, self.config.evaluation.num_points, "uniform"
        )
        x, t = x.to(self._dtype), t.to(self._dtype)
        if not self.members:
            return float(self._loss_components(params, x, t, generator)["total"])
        residuals = self._member_residual_losses(params, [(x, t)] * self.members)
        start = generator.get_state()
        totals = []
        for m in range(self.members):
            generator.set_state(start)
            pm, cm = self._member(params, m)
            totals.append(self._loss_components(pm, x, t, generator, cm,
                                                residual_loss=residuals[m])["total"])
        return float(torch.stack(totals).mean())

    # ------------------------------------------------------------------ #
    # Deep ensemble (training.ensemble_size > 1)
    # ------------------------------------------------------------------ #

    def _validate_ensemble(self) -> None:
        """The JAX package's constraints on ensemble training, with its
        messages: Adam only, no DQN, no adaptive weights, no mesh, a cosine
        or constant schedule, float32 residuals."""
        t = self.tcfg
        bad = []
        if self.optimizer_name != "adam":
            bad.append("optimizer must be 'adam'")
        if self.strategy == "adaptive":
            bad.append("collocation_distribution 'adaptive' (DQN) unsupported")
        if self.aw_enabled:
            bad.append("adaptive_weights must be disabled")
        if self.mesh is not None:
            bad.append("device-mesh data parallelism unsupported")
        if t.scheduler_type not in ("cosine", "constant"):
            bad.append(f"scheduler_type {t.scheduler_type!r} unsupported")
        if t.residual_dtype != "float32":
            bad.append("residual_dtype must be float32")
        if bad:
            raise ValueError("training.ensemble_size > 1 constraints violated: " + "; ".join(bad))

    def _member_seeds(self, seed: int, stream: int) -> List[int]:
        """One seed per member, derived from the run's seed, the member and
        the stream (0: initial weights, 1: training draws)."""
        return [int(np.random.SeedSequence([seed & 0xFFFFFFFF, m, stream]).generate_state(1)[0])
                for m in range(self.members)]

    def _stack_ensemble(self, seed: int) -> Dict[str, torch.Tensor]:
        """Fresh stacked members: member m's weights from a CPU generator
        seeded from (seed, m), as one model's are; the fixed buffers (a
        non-trainable Fourier basis) stay the model's, shared, as JAX's
        constants are."""
        from pinnrl_tpu_torch.models import create_module

        inits = [dict(create_module(self.model.config, torch.Generator().manual_seed(s))
                      .named_parameters()) for s in self._member_seeds(seed, 0)]
        return {k: torch.stack([mod[k].detach() for mod in inits]).to(self.device)
                .requires_grad_(True) for k in inits[0]}

    # ------------------------------------------------------------------ #
    # Training loop
    # ------------------------------------------------------------------ #

    def train(self, num_epochs: Optional[int] = None, batch_size: Optional[int] = None,
              num_points: Optional[int] = None, experiment_dir: Optional[str] = None,
              seed: int = 0, resume_from: Optional[str] = None) -> Dict[str, Any]:
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
        if self.mesh is not None:
            # Every rank takes an equal share of the global batch.
            batch_size = pad_to_multiple(batch_size, self.mesh.size)
            lbfgs_bs = pad_to_multiple(lbfgs_bs, self.mesh.size)
        steps_per_epoch = max(num_points // batch_size, 1)
        # The switch against the horizon train() was given.
        self.switch_epoch = (int(t.adam_lbfgs_switch_ratio * num_epochs)
                             if self.optimizer_name == "adam_lbfgs" else None)

        # Under a mesh rank 0 alone writes the experiment directory.
        exp = Path(experiment_dir) if experiment_dir and self._is_writer() else None
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

        # A run starts in float32 (one that failed in its float64 phase left
        # the parameters float64).
        self._demote_f32(self.model.params)
        self.coeffs = self._init_coeffs()
        if self.members:
            self._validate_ensemble()
            self.model.ensemble = self._stack_ensemble(seed)
            self.coeffs = {k: v.detach().repeat(self.members).requires_grad_(True)
                           for k, v in self.coeffs.items()}
        params = self.model.params
        leaves = self._leaves(params)
        names = list(self.pde.trainable_parameters)
        lbfgs_mode = self.optimizer_name == "lbfgs"
        if lbfgs_mode:
            self._maybe_promote_f64(params)
        # Phase-1 Adam anneals its cosine over its own phase.
        adam_epochs = self.switch_epoch or num_epochs
        opt = (self._make_lbfgs(leaves) if lbfgs_mode
               else self._make_adam(adam_epochs, steps_per_epoch, leaves))
        cosine = t.scheduler_type == "cosine"
        lr_schedule = self._make_lr_schedule(adam_epochs, steps_per_epoch)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        # An ensemble's members draw from their own generators.
        gens = ([torch.Generator(device=self.device).manual_seed(s)
                 for s in self._member_seeds(seed, 1)] if self.members else [gen])
        val_gen = torch.Generator(device=self.device).manual_seed(10_000 + seed)
        if self.rl_agent is not None:
            self._rl_state = self._init_rl_state(seed)
        self._aw_state = self.adaptive_weights.init()
        self._ema_init(params)

        start_epoch = 0
        if resume_from:
            start_epoch = self._load_checkpoint(resume_from, params, opt, gens, val_gen)
            logger.info("Resumed from %s at epoch %d", resume_from, start_epoch)
        if self.mesh is not None:
            replicate(self.mesh, leaves)  # rank 0's parameters on every rank

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
        epoch = start_epoch
        profiled = False
        stop = False
        program, program_for = None, None
        self.programs = []
        n_loss = 1 + len(_COMPONENTS)
        reduce = self.mesh.mean if self.mesh is not None else (lambda row: row)
        try:
            while epoch < num_epochs and not stop:
                if not switched and epoch >= self.switch_epoch:
                    switched = True
                    steps_per_epoch = 1
                    logger.info("Switching optimizer: adam -> %s at epoch %d",
                                t.phase2_optimizer, epoch)
                    # Phase 2 starts from the averaged iterate, promoted to
                    # float64 for a float64 phase, with a fresh shadow.
                    self._ema_apply(params)
                    self._maybe_promote_f64(params)
                    self._ema_init(params)
                    if t.phase2_optimizer == "lbfgs":
                        opt, lbfgs_mode = self._make_lbfgs(leaves), True
                    else:
                        # Fresh batches and a fresh Adam, its cosine to 0 over the rest.
                        batch_size = lbfgs_bs
                        opt = AdamStep(leaves, cosine_decay(t.phase2_learning_rate,
                                                            max(num_epochs - epoch, 1), 0.0),
                                       t.gradient_clip_norm, 0.9, 0.999, 0.0, capturable=True)
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
                if program_for is None or program_for[0] is not opt or program_for[1] is not batch:
                    # A phase (or an L-BFGS round) starts: its own step program.
                    self._end_program(program, leaves)
                    program = self._start_program(params, opt, gens, batch_size, batch, epoch,
                                                  val_every, steps_per_epoch)
                    program_for = (opt, batch)
                # One trace, of the first chunk after the start.
                profile = bool(t.profile_dir) and not profiled and epoch > start_epoch
                trace_epoch = epoch
                program.start_chunk()
                t0 = time.time()
                with (self._profiler() if profile else contextlib.nullcontext()) as prof:
                    for e in range(chunk):
                        for _ in range(steps_per_epoch):
                            program.run()
                        if self.rl_agent is not None:
                            # Once per epoch, so exploration anneals over the run's horizon.
                            self.rl_agent.update_epsilon(self._rl_state)
                        # An ensemble's coefficients: their member mean.
                        program.end_epoch(e, steps_per_epoch, reduce,
                                          torch.stack([self.coeffs[k].detach().mean()
                                                       for k in names]) if names else None)
                    rows, scale, pts = self._read_chunk(program, chunk, opt)
                    if profile and self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                chunk_time = time.time() - t0
                if profile:
                    profiled = True
                    trace_dir = Path(t.profile_dir)
                    trace_dir.mkdir(parents=True, exist_ok=True)
                    prof.export_chrome_trace(str(trace_dir / f"trace_epoch{trace_epoch}.json"))
                    logger.info("Profiler trace written to %s", trace_dir)
                # learning_rate * the plateau scale at the chunk's end, as JAX reads
                # its optimizer state (1 for L-BFGS and phase-2 Adam).
                lr_now = t.optimizer_config.learning_rate * scale
                for values in rows:
                    means, weights = values[:n_loss], values[n_loss:n_loss + 3]
                    self.history["train_loss"].append(means[0])
                    for k, v in zip(_COMPONENTS, means[1:]):
                        self.history["loss_components"][k].append(v)
                    self.history["adaptive_weights"].append(weights + [0.0])
                    for k, v in zip(names, values[n_loss + 3:]):
                        self.history[f"param_{k}"].append(v)
                    self.history["epoch_time"].append(chunk_time / chunk)
                    # As the JAX package records it: the phase-1 cosine at the
                    # epoch's end, after the switch too (ROADMAP queue 3).
                    self.history["learning_rate"].append(
                        lr_schedule((epoch + 1) * steps_per_epoch) if cosine else lr_now)
                    epoch += 1
                # As the JAX package's loop: the chunk's last loss, at its end.
                if not np.isfinite(self.history["train_loss"][-1]):
                    logger.warning("Non-finite loss at epoch %d; stopping", epoch)
                    status = "failed"
                    break
                if pts is not None:
                    self.points_history.append(pts)
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
                    self._save_checkpoint(exp / "checkpoint.npz", epoch, params, opt, gens, val_gen)
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
            self._end_program(program, leaves)
            # Detach the run's log handler: one per call would pile up.
            if log_handler is not None:
                logger.removeHandler(log_handler)
                log_handler.close()
            self.pde.dtype = torch.float32

        wall = time.time() - start_time
        if not lbfgs_mode:
            # The averaged iterate is the final model when the last phase is
            # stochastic (an L-BFGS phase started from it).
            self._ema_apply(params)
        # The final state keeps a float64 phase's precision; the model's
        # parameters are float32 again, as the JAX package's are.
        final_net = params
        if self._dtype == torch.float64:
            final_net = {k: v.detach().clone() for k, v in params.items()}
            self._demote_f32(params)
        # An ensemble's identified values are the member means.
        identified = self.pde.canonicalize_coeffs(self.pde.get_trainable_parameter_values(
            {k: v.detach().mean() for k, v in self.coeffs.items()}))
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
                self._save_final_plots(exp, final_net)
            save_training_metrics(exp, self.history)
            self._write_metadata(exp, status=status, num_epochs=num_epochs,
                                 current_epoch=len(self.history["train_loss"]), wall_time_s=wall)
            self.model.save_state(str(exp / "final_model.npz"))
            if self.rl_agent is not None:
                self.rl_agent.save_state(str(exp / "rl_agent.npz"), self._rl_state)
            (exp / ".running").unlink(missing_ok=True)
        self._final_state = {
            "params": {"net": final_net, "coeffs": self.coeffs},
            "opt_state": opt.state_dict(),
            "rl": self._rl_state,
        }
        return result

    def _save_final_plots(self, exp: Path, params: Dict[str, torch.Tensor]) -> None:
        """The JAX package's final plots, heat's FDM cross-check in one
        dimension, then ``report.html``."""
        from pinnrl_tpu_torch.utils.plotting import (
            create_interactive_report,
            plot_collocation_evolution,
            plot_q_density,
            plot_solution,
            plot_training_history,
        )

        viz = exp / "visualizations"
        plot_training_history(self.history, viz / "training_history.png")
        plot_solution(self.pde, self.model, params, viz / "solution.png")
        if self.points_history:
            plot_collocation_evolution(self.points_history, self.pde.domain, self.pde.time_domain,
                                       viz / "collocation_evolution.png")
        if self.rl_agent is not None and self._rl_state is not None:
            plot_q_density(self.rl_agent, self._rl_state, self.pde.domain, self.pde.time_domain,
                           viz / "rl_q_density.png")
        if self.pde.pde_type == "heat" and self.pde.dimension == 1:
            try:
                from pinnrl_tpu_torch.numerical_solvers import HeatEquationFDM

                cmp = HeatEquationFDM(self.pde, nx=101).compare_with_pinn(self.model.apply, params)
                (exp / "fdm_comparison.json").write_text(json.dumps(cmp, indent=2))
            except Exception:
                logger.exception("FDM comparison failed")
        create_interactive_report(exp)

    def _profiler(self):
        """``torch.profiler`` over the CPU, and the card when on one."""
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=activities)

    # ------------------------------------------------------------------ #
    # Checkpoint / resume
    # ------------------------------------------------------------------ #

    def _opt_names(self, params: Dict[str, torch.Tensor]) -> List[str]:
        """Names of the optimized leaves, in ``_leaves`` order."""
        return [f"coeffs.{k}" for k in sorted(self.coeffs)] + list(params)

    def _save_checkpoint(self, path: Path, epoch: int, params, opt, gens: List[torch.Generator],
                         val_gen: torch.Generator) -> None:
        """``checkpoint.npz`` and its ``checkpoint.json`` sidecar (the epoch
        and the history, which an ``.npz`` does not hold)."""
        from pinnrl_tpu_torch.models.bridge import flat_flax_arrays

        arrays = dict(flat_flax_arrays({**self.model.module.state_dict(), **params},
                                       self.model._leaf_ndim))
        for k, v in self.coeffs.items():
            arrays[f"coeffs/{k}"] = v.detach().cpu().numpy()
        kind = "lbfgs" if isinstance(opt, LBFGS) else "adam"
        arrays["opt/kind"] = np.asarray(kind)
        for k, v in opt.arrays(self._opt_names(params)).items():
            arrays[f"opt/{k}"] = v
        for f in _AW_FIELDS:
            arrays[f"aw/{f}"] = getattr(self._aw_state, f).cpu().numpy()
        if self._ema_shadow is not None:
            n = self._ema_n
            # One count per member (all members step together).
            arrays["ema/n"] = np.full(self.members, n) if self.members else np.asarray(n)
            for name, v in zip(params, self._ema_shadow):
                arrays[f"ema/{name}"] = v.cpu().numpy()
        if self.rl_agent is not None:
            for k, v in self.rl_agent.state_arrays(self._rl_state).items():
                arrays[f"rl/{k}"] = v
        for m, gen in enumerate(gens):
            arrays["gen/train" if m == 0 else f"gen/train{m}"] = gen.get_state().numpy()
        arrays["gen/val"] = val_gen.get_state().numpy()
        path = Path(path)
        with open(path, "wb") as f:
            np.savez(f, **arrays)
        path.with_suffix(".json").write_text(json.dumps({"epoch": epoch, "history": self.history},
                                                        default=str))

    @torch.no_grad()
    def _load_checkpoint(self, path: str, params, opt, gens: List[torch.Generator],
                         val_gen: torch.Generator) -> int:
        """Restore what ``_save_checkpoint`` wrote into this run's state (in
        place) and return the epoch. An optimizer state of another kind
        than ``opt`` keeps ``opt`` fresh, logged."""
        from pinnrl_tpu_torch.models.bridge import state_from_flat_flax

        path = Path(path)
        with np.load(path) as data:
            arrays = {k: data[k] for k in data.files}
        state = state_from_flat_flax({k: v for k, v in arrays.items()
                                      if k.startswith(("params/", "constants/"))})
        if any(state[k].dtype == torch.float64 for k in params):
            # A checkpoint of the float64 phase: the run continues in float64.
            self._maybe_promote_f64(params)
        if self.members:
            for k, v in params.items():  # in place: the optimizer holds these leaves
                v.copy_(state.pop(k))
            self.model.module.load_state_dict(state, strict=False)
        else:
            self.model.module.load_state_dict(state, strict=True)
        for k, v in self.coeffs.items():
            v.copy_(torch.as_tensor(arrays[f"coeffs/{k}"]))
        kind = "lbfgs" if isinstance(opt, LBFGS) else "adam"
        opt_arrays = {k[len("opt/"):]: v for k, v in arrays.items() if k.startswith("opt/")}
        try:
            if str(opt_arrays.pop("kind")) != kind:
                raise KeyError(f"a {kind} template")
            opt.load_arrays(opt_arrays, self._opt_names(params))
        except KeyError as e:
            # As the JAX package's fallback: e.g. an L-BFGS-phase checkpoint
            # into the run's first (Adam) optimizer, which the switch replaces.
            logger.warning("checkpoint: could not restore 'opt_state' (%s); keeping fresh state", e)
        self._aw_state = AdaptiveWeightState(**{
            f: torch.as_tensor(arrays[f"aw/{f}"]).to(self.device) for f in _AW_FIELDS})
        if self._ema_shadow is not None and "ema/n" in arrays:
            self._ema_shadow = [torch.as_tensor(arrays[f"ema/{name}"]).to(self.device)
                                for name in params]
            self._ema_n = int(np.max(arrays["ema/n"]))
        if self.rl_agent is not None:
            self._rl_state = self.rl_agent.load_arrays(
                {k[len("rl/"):]: v for k, v in arrays.items() if k.startswith("rl/")},
                self._rl_state)
        for m, gen in enumerate(gens):
            gen.set_state(torch.from_numpy(arrays["gen/train" if m == 0 else f"gen/train{m}"]))
        val_gen.set_state(torch.from_numpy(arrays["gen/val"]))
        side = json.loads(path.with_suffix(".json").read_text())
        self.history = side["history"]
        return int(side["epoch"])

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
            meta["identified_parameters"] = self.pde.get_trainable_parameter_values(
                {k: v.detach().mean() for k, v in self.coeffs.items()})
        if wall_time_s is not None:
            meta["wall_time_s"] = wall_time_s
        meta_path.write_text(json.dumps(meta, indent=2, default=str))
