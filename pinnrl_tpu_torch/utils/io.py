"""Experiment-directory file protocol, as ``pinnrl_tpu.utils.io``.

The on-disk contract the dashboard and outside tooling read:
``history.json``, ``metrics.json`` and ``live_snapshot.npz`` (60x60
``u_pred`` and ``residual`` grids) in the JAX package's formats, and
``config.yaml``: the ``Config.to_dict()`` snapshot written as JSON text
(``write_config_snapshot``), which YAML readers parse as it is, so the
card's machine needs no PyYAML to write it and JAX's ``Config.from_snapshot``
reads it unchanged.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

logger = logging.getLogger(__name__)


def _to_serializable(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {k: _to_serializable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_serializable(v) for v in obj]
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().tolist()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    return obj


def save_training_metrics(experiment_dir: str | Path, history: Dict[str, Any]) -> None:
    """Write history.json and metrics.json."""
    exp = Path(experiment_dir)
    exp.mkdir(parents=True, exist_ok=True)
    hist = _to_serializable(history)
    (exp / "history.json").write_text(json.dumps(hist, default=str))
    metrics = {
        "final_train_loss": hist["train_loss"][-1] if hist.get("train_loss") else None,
        "final_val_loss": hist["val_loss"][-1] if hist.get("val_loss") else None,
        "num_epochs_run": len(hist.get("train_loss", [])),
        "loss_components": {
            k: (v[-1] if v else None) for k, v in hist.get("loss_components", {}).items()
        },
    }
    (exp / "metrics.json").write_text(json.dumps(metrics, default=str))


@torch.no_grad()
def save_live_snapshot(experiment_dir: str | Path, pde, model, params: Dict[str, Any],
                       grid: int = 60) -> None:
    """60x60 prediction and residual grids for live monitoring: the x-t
    plane in one dimension, the x1-x2 plane at mid-time (other axes at
    their midpoints) in more. Best effort, as in the JAX package: a failure
    is logged with its traceback and training goes on."""
    try:
        exp = Path(experiment_dir)
        net = params["net"] if "net" in params else params
        coeffs = params.get("coeffs")
        dev = model.device
        xs = torch.linspace(pde.domain[0][0], pde.domain[0][1], grid, device=dev)
        if pde.dimension == 1:
            ts = torch.linspace(pde.time_domain[0], pde.time_domain[1], grid, device=dev)
            X, T = torch.meshgrid(xs, ts, indexing="ij")
            x_flat, t_flat = X.reshape(-1, 1), T.reshape(-1, 1)
            second = ts
        else:
            ys = torch.linspace(pde.domain[1][0], pde.domain[1][1], grid, device=dev)
            X, Y = torch.meshgrid(xs, ys, indexing="ij")
            extra = [torch.full((grid * grid, 1), 0.5 * (lo + hi), device=dev)
                     for lo, hi in pde.domain[2:]]
            x_flat = torch.cat([X.reshape(-1, 1), Y.reshape(-1, 1), *extra], dim=1)
            t_flat = torch.full((grid * grid, 1),
                                0.5 * (pde.time_domain[0] + pde.time_domain[1]), device=dev)
            second = ys
        u = model.apply(net, torch.cat([x_flat, t_flat], dim=-1))
        u = u.reshape(grid, grid, -1)[..., 0]
        res = pde.compute_residual(model.apply, net, x_flat, t_flat, coeffs).reshape(grid, grid)
        np.savez(
            exp / "live_snapshot.npz",
            u_pred=u.cpu().numpy(),
            residual=res.cpu().numpy(),
            x=xs.cpu().numpy(),
            y_or_t=second.cpu().numpy(),
            dimension=pde.dimension,
        )
    except Exception:  # monitoring must not stop training
        logger.exception("live snapshot failed")


def _yaml_float(v: float) -> str:
    """A float as JSON text that YAML 1.1 readers also take as a float:
    exponent forms get a decimal point (``1e-07`` -> ``1.0e-07``)."""
    text = json.dumps(v)
    if "e" in text and "." not in text.split("e")[0]:
        mantissa, exponent = text.split("e")
        text = f"{mantissa}.0e{exponent}"
    return text


def _json_text(obj: Any, indent: int = 0) -> str:
    pad, inner = "  " * indent, "  " * (indent + 1)
    if isinstance(obj, dict):
        if not obj:
            return "{}"
        items = [f"{inner}{json.dumps(str(k))}: {_json_text(v, indent + 1)}" for k, v in obj.items()]
        return "{\n" + ",\n".join(items) + "\n" + pad + "}"
    if isinstance(obj, (list, tuple)):
        if not obj:
            return "[]"
        return "[" + ", ".join(_json_text(v, indent + 1) for v in obj) + "]"
    if isinstance(obj, float):
        return _yaml_float(obj)
    return json.dumps(obj, default=str)


def write_config_snapshot(path: str | Path, config) -> None:
    """``config.to_dict()`` as JSON text (see the module docstring); arrays
    (observations given as data) become lists."""
    Path(path).write_text(_json_text(_to_serializable(config.to_dict())) + "\n")
