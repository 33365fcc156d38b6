"""Dashboard backend: JSON APIs over the experiment file protocol + launcher.

Endpoints (the JAX package's, over the same experiment directories):
- GET  /                       -> the single-page app (dashboard/app.html)
- GET  /api/meta               -> PDE registry, architectures, Well datasets
- GET  /api/experiments        -> experiment list with stale-.running cleanup
- GET  /api/experiment/<name>/history   -> history.json
- GET  /api/experiment/<name>/snapshot  -> live_snapshot.npz as JSON
- GET  /api/experiment/<name>/metadata  -> metadata.json
- GET  /api/experiment/<name>/solution  -> the solution explorer's payload
- GET  /api/experiment/<name>/viz[/<png>] -> the saved plots
- GET  /api/experiment/<name>/report    -> report.html (made when absent)
- POST /api/launch             -> spawn a detached ``pinnrl_tpu_torch``
                                  training run

The port reads its own formats: ``config.yaml`` is JSON text and the model
``final_model.npz`` (``utils/io.py``, ``PINNModel.save_state``), and the
meta endpoint reads ``config/defaults.json``, so the server needs no
PyYAML. The solution explorer evaluates the model on the server's device
(the card unless the server was started with ``device="cpu"``), and
launched runs train there.
"""

from __future__ import annotations

import json
import logging
import subprocess
import sys
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

logger = logging.getLogger(__name__)

_APP_HTML = Path(__file__).parent / "app.html"
STALE_RUNNING_AGE_S = 3600  # a .running marker older than this is stale


def _read_json(path: Path) -> Optional[Dict[str, Any]]:
    try:
        return json.loads(path.read_text())
    except Exception:
        return None


def get_experiments(results_dir: Path) -> List[Dict[str, Any]]:
    """Scan experiment dirs; clean up stale .running markers."""
    out = []
    if not results_dir.exists():
        return out
    for exp in sorted(results_dir.iterdir(), reverse=True):
        if not exp.is_dir():
            continue
        meta = _read_json(exp / "metadata.json") or {}
        running_marker = exp / ".running"
        running = running_marker.exists()
        if running:
            stale = (
                meta.get("status") in ("completed", "failed")
                or time.time() - running_marker.stat().st_mtime > STALE_RUNNING_AGE_S
            )
            if stale:
                running_marker.unlink(missing_ok=True)
                running = False
        metrics = _read_json(exp / "metrics.json") or {}
        out.append(
            {
                "name": exp.name,
                "status": "running" if running else meta.get("status", "unknown"),
                "pde_type": meta.get("pde_type"),
                "architecture": meta.get("architecture"),
                "mode": meta.get("mode"),
                "rl_enabled": meta.get("rl_enabled", False),
                "num_epochs": meta.get("num_epochs"),
                "current_epoch": meta.get("current_epoch", 0),
                "final_train_loss": metrics.get("final_train_loss"),
                "final_val_loss": metrics.get("final_val_loss"),
                "trainable_parameters": meta.get("trainable_parameters", []),
                "true_parameters": meta.get("true_parameters", {}),
                "identified_parameters": meta.get("identified_parameters", {}),
                "timestamp": meta.get("timestamp"),
            }
        )
    return out


def load_snapshot(exp_dir: Path) -> Optional[Dict[str, Any]]:
    snap_path = exp_dir / "live_snapshot.npz"
    if not snap_path.exists():
        return None
    try:
        with np.load(snap_path) as snap:
            return {
                "u_pred": snap["u_pred"].tolist(),
                "residual": snap["residual"].tolist(),
                "x": snap["x"].tolist(),
                "y_or_t": snap["y_or_t"].tolist(),
                "dimension": int(snap["dimension"]),
            }
    except Exception:
        return None


_SOLUTION_CACHE: Dict[str, Dict[str, Any]] = {}


def _field(model, pde, x_flat, times, shape) -> tuple:
    """(predicted, exact) fields at each time of ``times`` on the points
    ``x_flat``, as nested lists of ``shape``; exact None where the PDE has
    no exact solution."""
    import torch

    u_pred, u_exact = [], []
    with torch.no_grad():
        for tv in times:
            t_flat = torch.full((x_flat.shape[0], 1), float(tv), device=x_flat.device)
            pred = model.apply(model.params, torch.cat([x_flat, t_flat], dim=-1))
            pred = pred.reshape(x_flat.shape[0], -1)[:, 0]
            u_pred.append(pred.cpu().numpy().reshape(shape).tolist())
            ex = pde.exact_solution(x_flat, t_flat)
            u_exact.append(None if ex is None else ex.cpu().numpy().reshape(shape).tolist())
    return u_pred, (u_exact if any(e is not None for e in u_exact) else None)


def load_solution(exp_dir: Path, grid: int = 80, n_times: int = 9,
                  device: Optional[str] = None) -> Optional[Dict[str, Any]]:
    """Solution explorer payload: exact-vs-predicted field at a ladder of
    time slices, from the saved ``final_model.npz`` and the experiment's
    config snapshot, evaluated on ``device`` (the card unless "cpu").
    Payloads are cached by the model file's mtime, the 8 most recent."""
    from pinnrl_tpu_torch.config import resolve_device

    device = resolve_device(device)
    cfg_path = exp_dir / "config.yaml"
    model_path = exp_dir / "final_model.npz"
    if not cfg_path.exists() or not model_path.exists():
        return None
    # Keyed by the model's mtime, so a re-run into the same directory
    # invalidates the payload.
    cache_key = f"{exp_dir}:{model_path.stat().st_mtime_ns}:{device}:{grid}:{n_times}"
    cached = _SOLUTION_CACHE.get(cache_key)
    if cached is not None:
        return cached
    try:
        import torch

        from pinnrl_tpu_torch.config import Config
        from pinnrl_tpu_torch.models import PINNModel
        from pinnrl_tpu_torch.pdes import create_pde

        cfg = Config.from_snapshot({**json.loads(cfg_path.read_text()), "device": device})
        pde = create_pde(cfg)
        model = PINNModel(cfg, seed=0)
        model.load_state(str(model_path))

        t0, t1 = pde.time_domain
        times = np.linspace(t0, t1, n_times)
        xs = np.linspace(pde.domain[0][0], pde.domain[0][1], grid)
        if pde.dimension == 1:
            pts = xs.reshape(-1, 1)
            shape, extra = (-1,), {}
        else:
            ys = np.linspace(pde.domain[1][0], pde.domain[1][1], grid)
            X, Y = np.meshgrid(xs, ys, indexing="ij")
            pts = np.stack([X.reshape(-1), Y.reshape(-1)], axis=-1)
            shape, extra = (grid, grid), {"y": ys.tolist()}
        x_flat = torch.as_tensor(pts, dtype=torch.float32, device=model.device)
        u_pred, u_exact = _field(model, pde, x_flat, times, shape)
        payload = {"dimension": 1 if pde.dimension == 1 else 2, "x": xs.tolist(), **extra,
                   "times": times.tolist(), "u_pred": u_pred, "u_exact": u_exact}
        while len(_SOLUTION_CACHE) >= 8:
            _SOLUTION_CACHE.pop(next(iter(_SOLUTION_CACHE)))
        _SOLUTION_CACHE[cache_key] = payload
        return payload
    except Exception:
        logger.exception("solution explorer failed for %s", exp_dir)
        return None


def launch_trainer(params: Dict[str, Any], results_dir: Path,
                   device: Optional[str] = None) -> Dict[str, Any]:
    """Build a ``python -m pinnrl_tpu_torch.training.train`` command on
    ``device`` (the card unless "cpu") and spawn it detached."""
    cmd = [sys.executable, "-m", "pinnrl_tpu_torch.training.train",
           "--pde", str(params.get("pde", "heat")),
           "--results-dir", str(results_dir),
           "--device", str(device or "cuda")]
    if params.get("arch"):
        cmd += ["--arch", str(params["arch"])]
    for flag, key in [
        ("--epochs", "epochs"), ("--batch-size", "batch_size"),
        ("--collocation-points", "collocation_points"), ("--lr", "lr"),
        ("--optimizer", "optimizer"), ("--mode", "mode"),
        ("--loss-function", "loss_function"), ("--sampling", "sampling"),
        ("--dataset", "dataset"), ("--obs-points", "obs_points"),
        ("--obs-noise", "obs_noise"), ("--obs-path", "obs_path"),
    ]:
        if params.get(key) not in (None, "", False):
            cmd += [flag, str(params[key])]
    if params.get("rl"):
        cmd.append("--rl")
    for name in params.get("identify", []) or []:
        cmd += ["--identify", str(name)]
    for spec in params.get("initial_guess", []) or []:
        cmd += ["--initial-guess", str(spec)]

    results_dir.mkdir(parents=True, exist_ok=True)
    log_path = results_dir / "trainer_launch.log"
    with open(log_path, "ab") as log:
        proc = subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT, start_new_session=True
        )
    logger.info("Launched trainer pid=%d: %s", proc.pid, " ".join(cmd))
    return {"pid": proc.pid, "command": cmd, "process": proc}


def meta() -> Dict[str, Any]:
    """The New Training form's choices: PDEs, each PDE's coefficients (for
    the initial-guess inputs), architectures, Well datasets, strategies,
    optimizers and modes."""
    from pinnrl_tpu_torch.config import _DEFAULT_JSON, VALID_ARCHITECTURES
    from pinnrl_tpu_torch.datasets import WELL_REGISTRY
    from pinnrl_tpu_torch.pdes import PDE_REGISTRY

    raw = json.loads(Path(_DEFAULT_JSON).read_text())
    return {
        "pdes": PDE_REGISTRY,
        "pde_parameters": {k: (v or {}).get("parameters", {})
                           for k, v in (raw.get("pde_configs") or {}).items()},
        "architectures": list(VALID_ARCHITECTURES),
        "datasets": {
            k: {
                "description": v.description,
                "dims": v.n_spatial_dims,
                "fields": list(v.fields),
                "mode": v.recommended_mode,
                "architecture": v.default_architecture,
            }
            for k, v in WELL_REGISTRY.items()
        },
        "strategies": ["uniform", "stratified", "residual_based", "adaptive"],
        "optimizers": ["adam", "lbfgs", "adam_lbfgs"],
        "modes": ["forward", "inverse", "data_only", "data_augmented"],
    }


class _Handler(BaseHTTPRequestHandler):
    server_version = "pinnrl-tpu-torch-dashboard"
    results_dir: Path = Path("experiments")
    device: str = "cuda"

    def log_message(self, fmt, *args):  # quiet
        logger.debug(fmt, *args)

    def _send(self, code: int, body: bytes, ctype: str = "application/json"):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, obj, code: int = 200):
        self._send(code, json.dumps(obj, default=str).encode())

    def do_GET(self):  # noqa: N802
        path = self.path.split("?")[0]
        if path in ("/", "/index.html"):
            self._send(200, _APP_HTML.read_bytes(), "text/html; charset=utf-8")
        elif path == "/api/meta":
            self._json(meta())
        elif path == "/api/experiments":
            self._json(get_experiments(self.results_dir))
        elif path.startswith("/api/experiment/"):
            parts = path.split("/")
            if len(parts) < 5:
                self._json({"error": "bad path"}, 400)
                return
            name, what = parts[3], parts[4]
            exp = self.results_dir / name
            if not exp.is_dir() or "/" in name or ".." in name:
                self._json({"error": "not found"}, 404)
            elif what == "history":
                self._json(_read_json(exp / "history.json") or {})
            elif what == "snapshot":
                self._json(load_snapshot(exp) or {"error": "no snapshot"})
            elif what == "metadata":
                self._json(_read_json(exp / "metadata.json") or {})
            elif what == "solution":
                self._json(load_solution(exp, device=self.device) or {"error": "no final model"})
            elif what == "viz":
                self._viz(exp / "visualizations", parts[5] if len(parts) >= 6 else "")
            elif what == "report":
                report = exp / "report.html"
                if not report.exists():
                    from pinnrl_tpu_torch.utils.plotting import create_interactive_report

                    create_interactive_report(exp)
                if report.exists():
                    self._send(200, report.read_bytes(), "text/html; charset=utf-8")
                else:
                    self._json({"error": "no report"}, 404)
            else:
                self._json({"error": "unknown endpoint"}, 404)
        else:
            self._json({"error": "not found"}, 404)

    def _viz(self, viz: Path, fname: str) -> None:
        """The saved plots: their names, or one PNG."""
        if not fname:
            names = sorted(p.name for p in viz.glob("*.png")) if viz.is_dir() else []
            self._json({"images": names})
            return
        target = viz / fname
        if "/" in fname or ".." in fname or not target.exists() or target.suffix != ".png":
            self._json({"error": "not found"}, 404)
        else:
            self._send(200, target.read_bytes(), "image/png")

    def do_POST(self):  # noqa: N802
        if self.path.split("?")[0] == "/api/launch":
            length = int(self.headers.get("Content-Length", 0))
            try:
                params = json.loads(self.rfile.read(length) or b"{}")
                info = launch_trainer(params, self.results_dir, self.device)
                self.server.launched.append(info.pop("process"))
                self._json({"ok": True, **info})
            except Exception as exc:
                self._json({"ok": False, "error": str(exc)}, 500)
        else:
            self._json({"error": "not found"}, 404)


class DashboardServer:
    """The dashboard on ``port``, its solution explorer and launched runs on
    ``device`` (``config.resolve_device``: the card unless "cpu")."""

    def __init__(self, results_dir: str = "experiments", port: int = 8050,
                 device: Optional[str] = None):
        from pinnrl_tpu_torch.config import resolve_device

        self.results_dir = Path(results_dir)
        self.port = port
        self.device = resolve_device(device)
        handler = type("Handler", (_Handler,),
                       {"results_dir": self.results_dir, "device": self.device})
        self.httpd = ThreadingHTTPServer(("0.0.0.0", port), handler)
        # The runs /api/launch started (subprocess.Popen objects).
        self.httpd.launched = []

    @property
    def launched(self) -> list:
        return self.httpd.launched

    def serve_forever(self):
        logger.info("Dashboard at http://localhost:%d", self.port)
        self.httpd.serve_forever()

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def run_dashboard(results_dir: str = "experiments", port: int = 8050,
                  device: Optional[str] = None, max_tries: int = 10):
    """Serve on the first free port of [port, port + max_tries)."""
    for i in range(max_tries):
        try:
            server = DashboardServer(results_dir, port + i, device=device)
        except OSError:
            continue
        print(f"pinnrl-tpu-torch dashboard: http://localhost:{port + i} (device {server.device})")
        server.serve_forever()
        return
    raise RuntimeError(f"No free port in [{port}, {port + max_tries})")
