"""Final plots and the self-contained HTML report of an experiment
directory, as ``pinnrl_tpu.utils.plotting``: static matplotlib PNGs under
``visualizations/`` and ``report.html`` (inline SVG, no script).

The plots take the port's model, PDE and agent, evaluate on their device
and move the results to numpy for matplotlib. Every function is
best-effort: without matplotlib (the card's machine has none) a plot
returns None, and no failure stops a training run. ``create_interactive_
report`` needs no matplotlib; its HTML equals the JAX package's for the
same ``metadata.json`` and ``history.json``.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None without matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return None
    return plt


def _save(plt, fig, out_path) -> Path:
    fig.tight_layout()
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


def _np(t) -> np.ndarray:
    return np.asarray(t.detach().cpu() if isinstance(t, torch.Tensor) else t)


def plot_training_history(history: Dict[str, Any], out_path: str | Path) -> Optional[Path]:
    """Loss curves, the loss components and the learning rate."""
    plt = _pyplot()
    if plt is None or not history.get("train_loss"):
        return None
    try:
        fig, axes = plt.subplots(1, 3, figsize=(15, 4))
        epochs = np.arange(1, len(history["train_loss"]) + 1)
        axes[0].semilogy(epochs, history["train_loss"], label="train")
        if history.get("val_loss"):
            val_x = np.linspace(1, len(epochs), len(history["val_loss"]))
            axes[0].semilogy(val_x, history["val_loss"], label="val")
        axes[0].set_title("loss"), axes[0].legend(), axes[0].set_xlabel("epoch")
        for name, vals in (history.get("loss_components") or {}).items():
            if vals and any(v > 0 for v in vals):
                axes[1].semilogy(epochs[: len(vals)], vals, label=name)
        axes[1].set_title("components"), axes[1].legend(fontsize=8)
        if history.get("learning_rate"):
            axes[2].semilogy(epochs[: len(history["learning_rate"])], history["learning_rate"])
        axes[2].set_title("learning rate"), axes[2].set_xlabel("epoch")
        return _save(plt, fig, out_path)
    except Exception:
        logger.exception("plot_training_history failed")
        return None


def plot_solution(pde, model, params, out_path: str | Path, grid: int = 100,
                  times: int = 4) -> Optional[Path]:
    """Exact against predicted (1-D) or predicted and |error| (N-D) at
    ``times`` time slices."""
    plt = _pyplot()
    if plt is None:
        return None
    try:
        dev = model.device
        t_slices = np.linspace(pde.time_domain[0], pde.time_domain[1], times)
        if pde.dimension == 1:
            xs = np.linspace(pde.domain[0][0], pde.domain[0][1], grid)
            fig, axes = plt.subplots(1, times, figsize=(4 * times, 3.2), sharey=True)
            for ax, tv in zip(np.atleast_1d(axes), t_slices):
                x = torch.as_tensor(xs.reshape(-1, 1), dtype=torch.float32, device=dev)
                t = torch.full_like(x, float(tv))
                with torch.no_grad():
                    pred = _np(model.apply(params, torch.cat([x, t], -1))).reshape(-1)
                    exact = pde.exact_solution(x, t)
                ax.plot(xs, pred, label="PINN")
                if exact is not None:
                    ax.plot(xs, _np(exact).reshape(-1), "--", label="exact")
                ax.set_title(f"t={tv:.2f}")
            np.atleast_1d(axes)[0].legend()
        else:
            xs = np.linspace(pde.domain[0][0], pde.domain[0][1], grid)
            ys = np.linspace(pde.domain[1][0], pde.domain[1][1], grid)
            X, Y = np.meshgrid(xs, ys, indexing="ij")
            fig, axes = plt.subplots(2, times, figsize=(3.6 * times, 6.4))
            for col, tv in enumerate(t_slices):
                pts = np.stack([X.reshape(-1), Y.reshape(-1)], -1).astype(np.float32)
                extra = np.full(
                    (pts.shape[0], pde.dimension - 2),
                    [0.5 * (lo + hi) for lo, hi in pde.domain[2:]],
                    np.float32,
                ) if pde.dimension > 2 else np.zeros((pts.shape[0], 0), np.float32)
                z = torch.as_tensor(np.concatenate(
                    [pts, extra, np.full((pts.shape[0], 1), tv, np.float32)], -1), device=dev)
                with torch.no_grad():
                    pred = _np(model.apply(params, z)).reshape(grid, grid, -1)[..., 0]
                    exact = pde.exact_solution(z[:, :-1], z[:, -1:])
                axes[0, col].imshow(pred.T, origin="lower", aspect="auto")
                axes[0, col].set_title(f"pred t={tv:.2f}")
                if exact is not None:
                    err = np.abs(pred - _np(exact).reshape(grid, grid))
                    axes[1, col].imshow(err.T, origin="lower", aspect="auto", cmap="magma")
                    axes[1, col].set_title("|error|")
        return _save(plt, fig, out_path)
    except Exception:
        logger.exception("plot_solution failed")
        return None


def plot_collocation_evolution(points_history, domain, time_domain,
                               out_path: str | Path) -> Optional[Path]:
    """2x2 heat maps of the collocation density over the training phases."""
    plt = _pyplot()
    if plt is None or not points_history:
        return None
    try:
        n = len(points_history)
        idxs = [0, n // 3, 2 * n // 3, n - 1][: max(min(4, n), 1)]
        fig, axes = plt.subplots(2, 2, figsize=(9, 8))
        for ax, i in zip(axes.ravel(), idxs):
            pts = _np(points_history[i])
            ax.hist2d(pts[:, 0], pts[:, -1], bins=40, range=[list(domain[0]), list(time_domain)])
            ax.set_title(f"phase {i + 1}/{n}")
            ax.set_xlabel("x"), ax.set_ylabel("t")
        for ax in axes.ravel()[len(idxs):]:
            ax.axis("off")
        return _save(plt, fig, out_path)
    except Exception:
        logger.exception("plot_collocation_evolution failed")
        return None


def plot_architecture_comparison(histories: Dict[str, Dict[str, Any]],
                                 out_path: str | Path) -> Optional[Path]:
    """Train losses of several runs, overlaid."""
    plt = _pyplot()
    if plt is None or not histories:
        return None
    try:
        fig, ax = plt.subplots(figsize=(8, 4.5))
        for name, hist in histories.items():
            if hist.get("train_loss"):
                ax.semilogy(hist["train_loss"], label=name)
        ax.set_xlabel("epoch"), ax.set_ylabel("train loss"), ax.legend()
        return _save(plt, fig, out_path)
    except Exception:
        logger.exception("plot_architecture_comparison failed")
        return None


def plot_q_density(agent, agent_state, domain, time_domain, out_path: str | Path,
                   grid: int = 100) -> Optional[Path]:
    """The DQN policy's Q-values over the (x, t) plane: where the agent
    wants to sample (its plain forward, not the scorer kernel, as JAX's
    plot applies the network)."""
    plt = _pyplot()
    if plt is None:
        return None
    try:
        from pinnrl_tpu_torch.sampling.strategies import make_grid

        pts = make_grid(domain, time_domain, grid, device=agent.device)
        with torch.no_grad():
            q = _np(agent.apply(agent_state.policy_params, pts))[..., 0].reshape(grid, grid)
        fig, ax = plt.subplots(figsize=(6, 4.5))
        im = ax.imshow(q.T, origin="lower", aspect="auto",
                       extent=[domain[0][0], domain[0][1], time_domain[0], time_domain[1]])
        fig.colorbar(im, label="Q(s)")
        ax.set_xlabel("x"), ax.set_ylabel("t")
        ax.set_title(f"DQN sampling preference (eps={float(agent_state.epsilon):.3f})")
        return _save(plt, fig, out_path)
    except Exception:
        logger.exception("plot_q_density failed")
        return None


def create_interactive_report(experiment_dir: str | Path,
                              out_path: Optional[str | Path] = None) -> Optional[Path]:
    """A self-contained HTML report of an experiment directory: the training
    loss as an inline SVG polyline (log scale), each identified parameter's
    final value beside its true one, and the metadata table."""
    exp = Path(experiment_dir)
    out_path = Path(out_path) if out_path else exp / "report.html"
    try:
        meta = (json.loads((exp / "metadata.json").read_text())
                if (exp / "metadata.json").exists() else {})
        hist = (json.loads((exp / "history.json").read_text())
                if (exp / "history.json").exists() else {})
        losses = hist.get("train_loss", [])

        def svg_curve(ys, w=640, h=240):
            vals = [v for v in ys if v and v > 0]
            if not vals:
                return "<em>no data</em>"
            lv = [np.log10(v) for v in vals]
            lo, hi = min(lv), max(lv)
            span = (hi - lo) or 1.0
            pts = " ".join(
                f"{20 + i / max(len(lv) - 1, 1) * (w - 40):.1f},"
                f"{h - 20 - (v - lo) / span * (h - 40):.1f}"
                for i, v in enumerate(lv)
            )
            return (
                f'<svg width="{w}" height="{h}" style="background:#f7f8fa">'
                f'<polyline fill="none" stroke="#2563eb" stroke-width="1.5" points="{pts}"/></svg>'
            )

        rows = "".join(
            f"<tr><td>{k}</td><td>{json.dumps(v, default=str)}</td></tr>"
            for k, v in meta.items()
            if k not in ("traceback",)
        )
        param_sections = ""
        for k in hist:
            if k.startswith("param_"):
                param_sections += (
                    f"<h3>{k}</h3><p>final: {hist[k][-1]:.6g}"
                    f" (true: {meta.get('true_parameters', {}).get(k[6:], '?')})</p>"
                )
        html = f"""<!DOCTYPE html><html><head><meta charset="utf-8">
<title>pinnrl-tpu report: {exp.name}</title>
<style>body{{font:14px system-ui;margin:2rem auto;max-width:860px;color:#1b2430}}
table{{border-collapse:collapse}}td{{border:1px solid #d6dbe3;padding:4px 10px}}</style>
</head><body>
<h1>Experiment report</h1><h2>{exp.name}</h2>
<h3>Training loss (log scale)</h3>{svg_curve(losses)}
{param_sections}
<h3>Metadata</h3><table>{rows}</table>
</body></html>"""
        out_path.write_text(html)
        return out_path
    except Exception:
        logger.exception("create_interactive_report failed")
        return None
