"""Typed configuration: JSON/YAML -> dataclasses with validation.

The same dataclasses, schema, overlay precedence (PDE-specific block >
architecture block > dataclass defaults) and dict-like access as
``pinnrl_tpu.config``, with no JAX import. Defaults come from
``defaults.json``, a snapshot of ``pinnrl_tpu/config/config.yaml`` (a test
keeps the two equal), so the port needs neither JAX nor PyYAML to load them.
Device resolution asks torch for a CUDA card and never falls back.
"""

from __future__ import annotations

import copy
import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

_DEFAULT_JSON = Path(__file__).parent / "defaults.json"

VALID_ARCHITECTURES = (
    "feedforward",
    "resnet",
    "siren",
    "fourier",
    "attention",
    "autoencoder",
    "fno",
)
VALID_PDES = (
    "heat",
    "wave",
    "burgers",
    "convection",
    "kdv",
    "allen_cahn",
    "cahn_hilliard",
    "black_scholes",
    "pendulum",
    "heat_2d",
)
VALID_MODES = ("forward", "inverse", "data_only", "data_augmented")
VALID_OPTIMIZERS = ("adam", "lbfgs", "adam_lbfgs")
VALID_LOSS_FUNCTIONS = ("mse", "mae", "huber")
VALID_STRATEGIES = ("uniform", "stratified", "residual_based", "adaptive")


class _DictAccess:
    """Dict-like access mixin: PDE/training code accepts dicts or dataclasses.

    (reference: pinnrl/config/__init__.py:159-169,247-253,382-388)
    """

    def get(self, key: str, default: Any = None) -> Any:
        return getattr(self, key, default)

    def __getitem__(self, key: str) -> Any:
        try:
            return getattr(self, key)
        except AttributeError as exc:
            raise KeyError(key) from exc

    def __contains__(self, key: str) -> bool:
        return hasattr(self, key)


def _asdict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _asdict(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: _asdict(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_asdict(v) for v in obj]
    return obj


@dataclass
class LearningRateSchedulerConfig(_DictAccess):
    """Cosine / plateau LR schedule settings (reference: config/__init__.py:12-40)."""

    scheduler_type: str = "cosine"
    # ReduceLROnPlateau-style parameters
    factor: float = 0.5
    patience: int = 50
    min_lr: float = 1.0e-6
    # Cosine parameters
    T_max: int = 400
    eta_min: float = 1.0e-7

    def __post_init__(self) -> None:
        if self.scheduler_type not in ("cosine", "reduce_lr", "none"):
            raise ValueError(f"Unknown scheduler_type: {self.scheduler_type!r}")


@dataclass
class EarlyStoppingConfig(_DictAccess):
    enabled: bool = True
    patience: int = 100
    min_delta: float = 1e-7
    monitor: str = "val_loss"


@dataclass
class LBFGSConfig(_DictAccess):
    """L-BFGS hyper-parameters (reference: config/__init__.py LBFGSConfig)."""

    history_size: int = 50
    max_iter: int = 20
    line_search_fn: str = "strong_wolfe"
    tolerance_grad: float = 1.0e-7
    tolerance_change: float = 1.0e-9
    # Fixed-batch size for the L-BFGS phase; None = full collocation set
    # (reference parity). Set it when the full-batch objective does not fit
    # in HBM — e.g. the float64 residual polish triples live memory (f64
    # buffers + zoom-linesearch value_fn copies), and a 40k-point KdV batch
    # needs ~22G on a 16G v5e chip.
    batch_size: Optional[int] = None
    # Resample the fixed L-BFGS batch (collocation + BC/IC keys) every N
    # epochs and restart the optimizer state — a sample-average
    # approximation with restarts. Guards against overfitting a small fixed
    # batch: the KdV f64 polish drove its frozen 2048-point objective to
    # 7e-8 while validation rel-L2 stalled at 5e-3. None = one fixed batch
    # for the whole phase (reference parity).
    resample_every: Optional[int] = None


@dataclass
class AdaptiveWeightsConfig(_DictAccess):
    enabled: bool = False
    strategy: str = "rbw"  # "lrw" | "rbw"
    alpha: float = 0.7
    eps: float = 1e-6
    initial_weights: List[float] = field(default_factory=lambda: [0.3, 0.4, 0.3])

    def __post_init__(self) -> None:
        if self.strategy not in ("lrw", "rbw"):
            raise ValueError(f"adaptive_weights.strategy must be lrw|rbw, got {self.strategy!r}")


@dataclass
class OptimizerConfig(_DictAccess):
    name: str = "adam"
    learning_rate: float = 0.005
    beta1: float = 0.9
    beta2: float = 0.999
    weight_decay: float = 0.0005


@dataclass
class TrainingConfig(_DictAccess):
    """Training loop settings (reference: config/__init__.py TrainingConfig)."""

    num_epochs: int = 3000
    batch_size: int = 2048
    num_collocation_points: int = 5000
    num_boundary_points: int = 5000
    num_initial_points: int = 5000
    collocation_distribution: str = "uniform"
    validation_frequency: int = 10
    mode: str = "forward"
    optimizer: str = "adam"
    adam_lbfgs_switch_ratio: float = 0.7
    loss_function: str = "mse"
    huber_delta: float = 1.0
    gradient_clip_norm: float = 1.0
    # Causal residual weighting (Wang et al., "Respecting causality is all
    # you need"): weight residuals at time t by exp(-eps * accumulated
    # earlier-time residual), so the solution is learned front-to-back.
    # 0.0 disables. New capability beyond the reference.
    causal_eps: float = 0.0
    # Dtype for loss/residual evaluation during the (deterministic, full
    # batch) L-BFGS phase. "float64" polishes past the f32 noise floor of
    # high-order derivatives (3rd-order KdV, 4th-order Cahn-Hilliard);
    # requires jax x64 (the trainer enables it at the phase switch). New
    # capability beyond the reference.
    residual_dtype: str = "float32"
    # Optimizer for the post-switch phase of adam_lbfgs: "lbfgs" (default,
    # reference parity: deterministic fixed-batch quasi-Newton) or "adam"
    # (fresh per-step batches at phase2_learning_rate). With
    # residual_dtype=float64, phase-2 adam is the noise-floor escape that
    # actually generalizes: a fixed-batch f64 L-BFGS polish drives its own
    # batch to ~1e-7 while whole-domain rel-L2 stalls (overfit), whereas
    # fresh f64 batches keep lowering the true objective. New capability.
    phase2_optimizer: str = "lbfgs"
    phase2_learning_rate: float = 1.0e-4
    scheduler_type: str = "cosine"
    # Deep-ensemble training (new capability beyond the reference):
    # ensemble_size E > 1 trains E independently-initialized copies of the
    # network in ONE fused program — the whole epoch scan is jax.vmap'd over
    # a stacked parameter pytree, so the members run as a single batched
    # XLA computation (near-free on the MXU at PINN-sized matmuls) — and
    # predicts with the ensemble MEAN. Averaging M decorrelated error
    # fields cuts the init-lottery variance that dominates dispersive
    # problems (KdV) at the ~1e-3 rel-L2 scale. Members see independent
    # collocation/BC/IC batches and independent optimizer states.
    ensemble_size: int = 1
    # Polyak/EMA weight averaging (new capability beyond the reference):
    # decay d > 0 tracks ema = d*ema + (1-d)*params alongside every adam
    # step (free on-device; one extra params-sized buffer). The averaged
    # iterate smooths SGD noise; a phase-2 L-BFGS polish starts FROM the
    # EMA iterate, otherwise the EMA is the final model. 0 disables.
    param_ema: float = 0.0
    # When set, capture ONE jax.profiler trace (XLA ops + HLO, viewable in
    # TensorBoard/Perfetto) of the second epoch chunk — the first chunk is
    # compile + warmup — into this directory. New capability beyond the
    # reference (it has no profiler hooks; SURVEY §5.1).
    profile_dir: Optional[str] = None
    # Stacked-jet residual fast path (ops/jet_mlp.py): transports ALL
    # derivative streams through ONE matmul per Dense layer instead of
    # per-point nested jvp chains. "auto" (default) enables it whenever the
    # PDE/model pair supports it; true forces (error if unsupported); false
    # disables. Numerically identical to the generic path (f32 roundoff).
    stacked_jet: Any = "auto"
    loss_weights: Dict[str, float] = field(
        default_factory=lambda: {
            "residual": 15.0,
            "boundary": 20.0,
            "initial": 10.0,
            "smoothness": 0.1,
            "data": 10.0,
        }
    )
    optimizer_config: OptimizerConfig = field(default_factory=OptimizerConfig)
    adaptive_weights: AdaptiveWeightsConfig = field(default_factory=AdaptiveWeightsConfig)
    early_stopping: EarlyStoppingConfig = field(default_factory=EarlyStoppingConfig)
    lr_scheduler: LearningRateSchedulerConfig = field(
        default_factory=LearningRateSchedulerConfig
    )
    lbfgs: LBFGSConfig = field(default_factory=LBFGSConfig)

    def __post_init__(self) -> None:
        if self.mode not in VALID_MODES:
            raise ValueError(f"training.mode must be one of {VALID_MODES}, got {self.mode!r}")
        if self.optimizer not in VALID_OPTIMIZERS:
            raise ValueError(
                f"training.optimizer must be one of {VALID_OPTIMIZERS}, got {self.optimizer!r}"
            )
        if self.loss_function not in VALID_LOSS_FUNCTIONS:
            raise ValueError(
                f"training.loss_function must be one of {VALID_LOSS_FUNCTIONS}, "
                f"got {self.loss_function!r}"
            )
        if self.collocation_distribution not in VALID_STRATEGIES:
            raise ValueError(
                f"training.collocation_distribution must be one of {VALID_STRATEGIES}, "
                f"got {self.collocation_distribution!r}"
            )
        if self.residual_dtype not in ("float32", "float64"):
            raise ValueError(
                "training.residual_dtype must be float32 or float64, "
                f"got {self.residual_dtype!r}"
            )
        if int(self.ensemble_size) < 1:
            raise ValueError(
                f"training.ensemble_size must be >= 1, got {self.ensemble_size!r}"
            )
        if self.stacked_jet not in (True, False, "auto", "on", "off"):
            raise ValueError(
                "training.stacked_jet must be true, false, or 'auto', "
                f"got {self.stacked_jet!r}"
            )
        if not (0.0 <= float(self.param_ema) < 1.0):
            raise ValueError(
                f"training.param_ema must be in [0, 1), got {self.param_ema!r}"
            )
        # Normalize legacy "pde" key to "residual" (reference: config/__init__.py:523-527).
        if "pde" in self.loss_weights and "residual" not in self.loss_weights:
            self.loss_weights["residual"] = self.loss_weights.pop("pde")


@dataclass
class ModelConfig(_DictAccess):
    """Architecture hyper-parameters (reference: config/__init__.py ModelConfig).

    Architecture-specific extras (omega_0, mapping_size, modes, ...) land in
    ``arch_params``; ``hidden_dims`` is derived from ``hidden_dim``/``num_blocks``
    when only those are given, matching the reference's custom ``__init__``.
    """

    architecture: str = "feedforward"
    input_dim: int = 2
    output_dim: int = 1
    hidden_dims: List[int] = field(default_factory=lambda: [128] * 7)
    activation: str = "tanh"
    dropout: float = 0.0
    layer_norm: bool = True
    # Hard initial-condition imposition: compose u = u0(x) [+ (t-t0) v0(x)]
    # + ramp(t) * net so the IC holds exactly (see PDEBase.hard_ic_transform).
    hard_ic: bool = False
    arch_params: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.architecture not in VALID_ARCHITECTURES:
            raise ValueError(
                f"Unknown architecture {self.architecture!r}; valid: {VALID_ARCHITECTURES}"
            )
        hd = self.arch_params.get("hidden_dim")
        nb = self.arch_params.get("num_blocks", self.arch_params.get("num_layers"))
        if hd is not None and not self.arch_params.get("_hidden_dims_explicit", False):
            self.hidden_dims = [int(hd)] * int(nb or len(self.hidden_dims) or 4)

    @property
    def hidden_dim(self) -> int:
        return int(self.arch_params.get("hidden_dim", self.hidden_dims[0]))

    @property
    def num_blocks(self) -> int:
        return int(
            self.arch_params.get(
                "num_blocks", self.arch_params.get("num_layers", len(self.hidden_dims))
            )
        )


@dataclass
class RLConfig(_DictAccess):
    """DQN adaptive-sampling agent settings (reference: config/__init__.py RLConfig)."""

    enabled: bool = False
    state_dim: int = 2
    action_dim: int = 1
    hidden_dim: int = 512
    learning_rate: float = 0.001
    gamma: float = 0.99
    epsilon_start: float = 1.0
    epsilon_end: float = 0.01
    epsilon_decay: float = 0.995
    memory_size: int = 10000
    batch_size: int = 124
    target_update: int = 100
    reward_weights: Dict[str, float] = field(
        default_factory=lambda: {
            "residual": 1.0,
            "boundary": 1.0,
            "initial": 1.0,
            "exploration": 0.1,
        }
    )


@dataclass
class EvaluationConfig(_DictAccess):
    num_points: int = 1000
    metrics: List[str] = field(
        default_factory=lambda: ["l2_error", "max_error", "mean_error"]
    )
    save_plots: bool = True
    plot_frequency: int = 10


@dataclass
class LoggingConfig(_DictAccess):
    level: str = "INFO"
    save_tensorboard: bool = False
    log_frequency: int = 100


@dataclass
class PathsConfig(_DictAccess):
    results_dir: str = "experiments"


@dataclass
class PDESettings(_DictAccess):
    """Per-PDE block from YAML (reference: pde_configs entries in config.yaml:59-300)."""

    name: str = "Heat Equation"
    pde_type: str = "heat"
    architecture: str = "fourier"
    input_dim: int = 2
    output_dim: int = 1
    dimension: int = 1
    parameters: Dict[str, Any] = field(default_factory=lambda: {"alpha": 0.01})
    domain: List[List[float]] = field(default_factory=lambda: [[0.0, 2.0]])
    time_domain: List[float] = field(default_factory=lambda: [0.0, 10.0])
    initial_condition: Dict[str, Any] = field(
        default_factory=lambda: {"type": "sin_exp_decay", "amplitude": 1.0, "frequency": 2.0}
    )
    boundary_conditions: Dict[str, Any] = field(default_factory=lambda: {"periodic": {}})
    exact_solution: Dict[str, Any] = field(
        default_factory=lambda: {"type": "sin_exp_decay", "amplitude": 1.0, "frequency": 2.0}
    )
    trainable_parameters: List[str] = field(default_factory=list)
    parameter_initial_guesses: Dict[str, float] = field(default_factory=dict)
    observation_data: Optional[Any] = None
    observation_noise: float = 0.0
    num_observation_points: int = 200
    observation_seed: int = 0


def _normalize_domain(domain: Any) -> List[List[float]]:
    """``[min,max]`` or ``[[min,max],...]`` -> list of pairs (reference: pde_base.py:144-158)."""
    if domain is None:
        return [[0.0, 1.0]]
    if (
        isinstance(domain, Sequence)
        and len(domain) == 2
        and all(isinstance(v, (int, float)) for v in domain)
    ):
        return [[float(domain[0]), float(domain[1])]]
    return [[float(lo), float(hi)] for lo, hi in domain]


class Config(_DictAccess):
    """Top-level config: YAML + overrides -> validated dataclasses.

    Overlay precedence (reference: config/__init__.py:405-463, train.py:527-547):
    explicit overrides > pde_configs[pde_type] > architectures[arch] > defaults.
    """

    def __init__(
        self,
        config_path: Optional[str] = None,
        config_dict: Optional[Dict[str, Any]] = None,
        pde_type: Optional[str] = None,
        architecture: Optional[str] = None,
        device: Optional[str] = None,
    ) -> None:
        if config_dict is None:
            raw = _read_config_file(Path(config_path) if config_path else _DEFAULT_JSON)
        else:
            raw = copy.deepcopy(config_dict)
        self.raw = raw

        self.pde_type = pde_type or raw.get("pde_type", "heat")
        if self.pde_type not in VALID_PDES:
            raise ValueError(f"Unknown pde_type {self.pde_type!r}; valid: {VALID_PDES}")

        pde_block = copy.deepcopy(raw.get("pde_configs", {}).get(self.pde_type, {}))
        pde_block.setdefault("pde_type", self.pde_type)
        arch = architecture or pde_block.get("architecture", raw.get("architecture", "feedforward"))

        # PDE settings.
        pde_fields = {f.name for f in dataclasses.fields(PDESettings)}
        pde_kwargs = {k: v for k, v in pde_block.items() if k in pde_fields}
        pde_kwargs["architecture"] = arch
        if "time_domain" not in pde_kwargs and "t_domain" in pde_block:
            pde_kwargs["time_domain"] = pde_block["t_domain"]
        if "domain" in pde_kwargs:
            pde_kwargs["domain"] = _normalize_domain(pde_kwargs["domain"])
        self.pde = PDESettings(**pde_kwargs)

        # Model settings: architecture block + PDE input/output dims.
        arch_block = copy.deepcopy(raw.get("architectures", {}).get(arch, {}))
        model_kwargs: Dict[str, Any] = {
            "architecture": arch,
            "input_dim": int(pde_block.get("input_dim", self.pde.dimension + 1)),
            "output_dim": int(pde_block.get("output_dim", 1)),
        }
        known = {"hidden_dims", "activation", "dropout", "layer_norm"}
        arch_params: Dict[str, Any] = {}
        for k, v in arch_block.items():
            if k in known:
                model_kwargs[k] = v
            else:
                arch_params[k] = v
        if "hidden_dims" in model_kwargs:
            arch_params["_hidden_dims_explicit"] = True
        model_kwargs["arch_params"] = arch_params
        self.model = ModelConfig(**model_kwargs)

        # Training settings.
        train_block = copy.deepcopy(raw.get("training", {}))
        self.training = self._build_training(train_block)

        # RL / evaluation / logging / paths.
        self.rl = _build_simple(RLConfig, raw.get("rl", {}))
        self.evaluation = _build_simple(EvaluationConfig, raw.get("evaluation", {}))
        self.logging = _build_simple(LoggingConfig, raw.get("logging", {}))
        self.paths = _build_simple(PathsConfig, raw.get("paths", {}))

        self.device = self._resolve_device(device or raw.get("device", "cuda"))
        self._validate()

    @classmethod
    def from_snapshot(cls, d: Dict[str, Any]) -> "Config":
        """Rebuild a Config from a ``to_dict()`` snapshot — the config.yaml
        each experiment dir saves. This lets the dashboard reconstruct the
        trained model + PDE exactly, with no state-dict shape-inference hack
        (the reference infers hyperparams from tensor shapes,
        reference: dashboard.py:2428-2501)."""
        self = cls.__new__(cls)
        self.raw = copy.deepcopy(d)
        self.pde_type = d.get("pde_type", "heat")
        if self.pde_type not in VALID_PDES:
            raise ValueError(f"Unknown pde_type {self.pde_type!r}; valid: {VALID_PDES}")

        pde_fields = {f.name for f in dataclasses.fields(PDESettings)}
        pde_kwargs = {k: v for k, v in (d.get("pde") or {}).items() if k in pde_fields}
        if "domain" in pde_kwargs:
            pde_kwargs["domain"] = _normalize_domain(pde_kwargs["domain"])
        self.pde = PDESettings(**pde_kwargs)

        model_fields = {f.name for f in dataclasses.fields(ModelConfig)}
        model_kwargs = {
            k: v for k, v in (d.get("model") or {}).items() if k in model_fields
        }
        # Snapshot hidden_dims are authoritative — stop __post_init__ from
        # re-deriving them out of arch_params.hidden_dim.
        if "hidden_dims" in model_kwargs:
            model_kwargs.setdefault("arch_params", {})["_hidden_dims_explicit"] = True
        self.model = ModelConfig(**model_kwargs)
        self.training = self._build_training(dict(d.get("training") or {}))
        self.rl = _build_simple(RLConfig, d.get("rl", {}))
        self.evaluation = _build_simple(EvaluationConfig, d.get("evaluation", {}))
        self.logging = _build_simple(LoggingConfig, d.get("logging", {}))
        self.paths = _build_simple(PathsConfig, d.get("paths", {}))
        self.device = self._resolve_device(d.get("device", "cuda"))
        self._validate()
        return self

    @staticmethod
    def _build_training(block: Dict[str, Any]) -> TrainingConfig:
        block = dict(block)
        opt_block = dict(block.pop("optimizer_config", {}) or {})
        # Top-level training.learning_rate/weight_decay are the reference's
        # flat spelling (reference: config/__init__.py:514-521) — fold them
        # into optimizer_config unless the nested block already sets them.
        for flat_key in ("learning_rate", "weight_decay"):
            if flat_key in block:
                opt_block.setdefault(flat_key, block.pop(flat_key))
        aw_block = block.pop("adaptive_weights", {}) or {}
        es_block = block.pop("early_stopping", {}) or {}
        lbfgs_block = block.pop("lbfgs", {}) or {}
        sched_type = block.get("scheduler_type", "cosine")
        reduce_lr = block.pop("reduce_lr_params", {}) or {}
        cosine = block.pop("cosine_params", {}) or {}
        # A to_dict() snapshot nests the scheduler under "lr_scheduler".
        sched_block = block.pop("lr_scheduler", {}) or {}
        sched = _build_simple(
            LearningRateSchedulerConfig,
            {"scheduler_type": sched_type, **sched_block, **reduce_lr, **cosine},
        )
        fields = {f.name for f in dataclasses.fields(TrainingConfig)}
        kwargs = {k: v for k, v in block.items() if k in fields}
        kwargs["optimizer_config"] = _build_simple(OptimizerConfig, opt_block)
        kwargs["adaptive_weights"] = _build_simple(AdaptiveWeightsConfig, aw_block)
        kwargs["early_stopping"] = _build_simple(EarlyStoppingConfig, es_block)
        kwargs["lbfgs"] = _build_simple(LBFGSConfig, lbfgs_block)
        kwargs["lr_scheduler"] = sched
        return TrainingConfig(**kwargs)

    @staticmethod
    def _resolve_device(requested: str) -> str:
        """Resolve the torch device name. No fallback: an accelerator that
        is asked for and absent raises.

        ``"tpu"`` (the shared defaults' spelling of "the accelerator") and
        ``"gpu"`` mean ``"cuda"``; ``"cuda:N"`` keeps its index.
        """
        import torch

        requested = (requested or "cuda").lower()
        if requested == "cpu":
            return "cpu"
        if requested in ("tpu", "gpu"):
            requested = "cuda"
        if requested == "cuda" or requested.startswith("cuda:"):
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"device {requested!r} requested but torch.cuda.is_available() "
                    "is False; pass device='cpu' to run on the host"
                )
            return requested
        raise ValueError(f"Unknown device {requested!r}; valid: cpu, cuda, cuda:N")

    def _validate(self) -> None:
        """Cross-field validation (reference: config/__init__.py:612-674)."""
        t = self.training
        if t.num_epochs <= 0:
            raise ValueError("training.num_epochs must be positive")
        if t.batch_size <= 0:
            raise ValueError("training.batch_size must be positive")
        if t.num_collocation_points <= 0:
            raise ValueError("training.num_collocation_points must be positive")
        if not 0.0 < t.adam_lbfgs_switch_ratio < 1.0:
            raise ValueError("training.adam_lbfgs_switch_ratio must be in (0,1)")
        if t.lbfgs.batch_size is not None and t.lbfgs.batch_size <= 0:
            raise ValueError("training.lbfgs.batch_size must be positive or None")
        if t.lbfgs.resample_every is not None and t.lbfgs.resample_every <= 0:
            raise ValueError("training.lbfgs.resample_every must be positive or None")
        if t.phase2_optimizer not in ("lbfgs", "adam"):
            raise ValueError(
                f"training.phase2_optimizer must be lbfgs or adam, got {t.phase2_optimizer!r}"
            )
        if self.model.input_dim != self.pde.dimension + 1:
            raise ValueError(
                f"model.input_dim ({self.model.input_dim}) must equal pde.dimension+1 "
                f"({self.pde.dimension + 1})"
            )
        for lo, hi in self.pde.domain:
            if hi <= lo:
                raise ValueError(f"Invalid spatial domain [{lo}, {hi}]")
        if self.pde.time_domain[1] <= self.pde.time_domain[0]:
            raise ValueError(f"Invalid time domain {self.pde.time_domain}")
        if t.mode == "inverse" and not self.pde.trainable_parameters:
            raise ValueError("inverse mode requires pde.trainable_parameters")
        for name in self.pde.trainable_parameters:
            if name not in self.pde.parameters:
                raise ValueError(f"trainable parameter {name!r} not in pde.parameters")

    def to_dict(self) -> Dict[str, Any]:
        return {
            "pde_type": self.pde_type,
            "device": self.device,
            "pde": _asdict(self.pde),
            "model": _asdict(self.model),
            "training": _asdict(self.training),
            "rl": _asdict(self.rl),
            "evaluation": _asdict(self.evaluation),
            "logging": _asdict(self.logging),
            "paths": _asdict(self.paths),
        }


def _build_simple(cls: type, block: Dict[str, Any]):
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in (block or {}).items() if k in fields})


def load_config(
    config_path: Optional[str] = None,
    pde_type: Optional[str] = None,
    architecture: Optional[str] = None,
    **kwargs: Any,
) -> Config:
    """Convenience loader with the default (JSON snapshot) configuration."""
    return Config(config_path=config_path, pde_type=pde_type, architecture=architecture, **kwargs)


def _read_config_file(path: Path) -> Dict[str, Any]:
    """JSON by suffix; anything else is YAML, which needs PyYAML."""
    if path.suffix == ".json":
        with open(path) as f:
            return json.load(f) or {}
    try:
        import yaml
    except ImportError as exc:
        raise ImportError(
            f"reading the YAML config {str(path)!r} needs PyYAML; "
            "install it or pass a .json config_path"
        ) from exc
    with open(path) as f:
        return yaml.safe_load(f) or {}
