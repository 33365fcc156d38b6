"""The port's dashboard server (``pinnrl_tpu_torch/dashboard``): the JAX
suite's cases (tests/test_dashboard.py) against the port's server on the
CPU, and the solution explorer's payload against the JAX server's for the
same trained parameters (1e-5 relative to max: the same float32 forward in
two libraries)."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
from torch_parity_helpers import bridge, rel_to_max

from pinnrl_tpu_torch.dashboard.server import (
    DashboardServer,
    get_experiments,
    launch_trainer,
    load_snapshot,
    load_solution,
)

NAME = "20260101_000000_heat_fourier_norl"


@pytest.fixture
def exp_dir(tmp_path):
    exp = tmp_path / NAME
    exp.mkdir(parents=True)
    (exp / "metadata.json").write_text(json.dumps({
        "status": "completed", "pde_type": "heat", "architecture": "fourier",
        "mode": "forward", "rl_enabled": False, "num_epochs": 10,
        "current_epoch": 10, "trainable_parameters": [],
        "true_parameters": {}, "timestamp": "2026-01-01T00:00:00",
    }))
    (exp / "history.json").write_text(json.dumps({
        "train_loss": [1.0, 0.5], "val_loss": [0.9],
        "loss_components": {"residual": [0.5, 0.2]},
    }))
    (exp / "metrics.json").write_text(json.dumps({
        "final_train_loss": 0.5, "final_val_loss": 0.9,
    }))
    np.savez(exp / "live_snapshot.npz",
             u_pred=np.zeros((60, 60)), residual=np.ones((60, 60)),
             x=np.linspace(0, 1, 60), y_or_t=np.linspace(0, 1, 60),
             dimension=np.asarray(1))
    return tmp_path


@pytest.fixture
def server(exp_dir):
    srv = None
    for port in range(18150, 18170):
        try:
            srv = DashboardServer(results_dir=str(exp_dir), port=port, device="cpu")
            break
        except OSError:
            continue
    assert srv is not None
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    yield f"http://localhost:{srv.port}"
    srv.shutdown()


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read()


def test_index_html(server):
    status, body = _get(server + "/")
    assert status == 200
    assert b"pinnrl-tpu" in body
    assert b"Monitor" in body


def test_api_meta(server):
    status, body = _get(server + "/api/meta")
    meta = json.loads(body)
    assert "heat" in meta["pdes"]
    assert "fourier" in meta["architectures"]
    assert "active_matter" in meta["datasets"]


def test_api_meta_equals_jax(server):
    """The same form choices as the JAX server's (which reads the YAML)."""
    from pinnrl_tpu.dashboard.server import DashboardServer as JaxServer

    srv = None
    for port in range(18170, 18190):
        try:
            srv = JaxServer(results_dir="unused", port=port)
            break
        except OSError:
            continue
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        _, ref = _get(f"http://localhost:{srv.port}/api/meta")
    finally:
        srv.shutdown()
    _, got = _get(server + "/api/meta")
    assert json.loads(got) == json.loads(ref)


def test_api_experiments(server):
    _, body = _get(server + "/api/experiments")
    exps = json.loads(body)
    assert len(exps) == 1
    assert exps[0]["status"] == "completed"
    assert exps[0]["final_train_loss"] == 0.5


def test_api_history_and_snapshot(server):
    _, body = _get(f"{server}/api/experiment/{NAME}/history")
    assert json.loads(body)["train_loss"] == [1.0, 0.5]
    _, body = _get(f"{server}/api/experiment/{NAME}/snapshot")
    snap = json.loads(body)
    assert len(snap["u_pred"]) == 60
    assert snap["dimension"] == 1


def test_api_unknown_experiment(server):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(server + "/api/experiment/nonexistent/history")
    assert ei.value.code == 404


def test_stale_running_cleanup(exp_dir):
    exp = exp_dir / NAME
    (exp / ".running").touch()  # completed metadata + marker -> stale
    exps = get_experiments(exp_dir)
    assert exps[0]["status"] == "completed"
    assert not (exp / ".running").exists()


def test_load_snapshot_missing(tmp_path):
    assert load_snapshot(tmp_path) is None


def test_launch_trainer_command(tmp_path, monkeypatch):
    captured = {}

    class FakeProc:
        pid = 4242

    def fake_popen(cmd, **kw):
        captured["cmd"] = cmd
        return FakeProc()

    monkeypatch.setattr("subprocess.Popen", fake_popen)
    info = launch_trainer(
        {"pde": "burgers", "arch": "resnet", "epochs": 5, "rl": True,
         "identify": ["nu"], "initial_guess": ["nu=0.1"]},
        tmp_path, device="cpu",
    )
    cmd = captured["cmd"]
    assert info["pid"] == 4242
    assert cmd[1:3] == ["-m", "pinnrl_tpu_torch.training.train"]
    assert "--pde" in cmd and "burgers" in cmd
    assert cmd[cmd.index("--device") + 1] == "cpu"
    assert "--rl" in cmd
    assert "--identify" in cmd and "nu" in cmd
    assert "--initial-guess" in cmd and "nu=0.1" in cmd


def _tiny_port_config(**training):
    from pinnrl_tpu_torch.config import load_config

    cfg = load_config(pde_type="heat", architecture="fourier", device="cpu")
    cfg.model.hidden_dims = [16, 16]
    cfg.model.arch_params["mapping_size"] = 8
    t = cfg.training
    t.num_epochs, t.batch_size, t.num_collocation_points = 2, 32, 64
    t.num_boundary_points = t.num_initial_points = 32
    t.validation_frequency = 1
    return cfg


def test_solution_explorer_from_real_experiment(tmp_path):
    """A tiny completed training run of the port is explorable through
    load_solution, rebuilt from its config snapshot and final_model.npz."""
    from pinnrl_tpu_torch.models import PINNModel
    from pinnrl_tpu_torch.pdes import create_pde
    from pinnrl_tpu_torch.training import PDETrainer

    cfg = _tiny_port_config()
    exp = tmp_path / "exp1"
    PDETrainer(PINNModel(cfg), create_pde(cfg), cfg).train(experiment_dir=str(exp))

    payload = load_solution(exp, grid=16, n_times=3, device="cpu")
    assert payload is not None
    assert payload["dimension"] == 1
    assert len(payload["times"]) == 3
    assert len(payload["u_pred"]) == 3
    assert len(payload["u_pred"][0]) == 16
    assert payload["u_exact"] is not None  # heat has an exact solution
    assert np.isfinite(np.asarray(payload["u_pred"])).all()
    # Cached on second call (same object).
    assert load_solution(exp, grid=16, n_times=3, device="cpu") is payload


def test_solution_explorer_missing_artifacts(tmp_path):
    empty = tmp_path / "no_exp"
    empty.mkdir()
    assert load_solution(empty, device="cpu") is None


def test_report_endpoint_serves_html(server):
    status, body = _get(server + f"/api/experiment/{NAME}/report")
    assert status == 200
    assert b"<html" in body.lower() or b"<!doctype" in body.lower()


def test_spa_has_report_link_and_true_param_line(server):
    _, body = _get(server + "/")
    assert b"report-link" in body
    assert b"/report" in body
    assert b"true_parameters" in body
    assert b"stroke-dasharray" in body


@pytest.mark.parametrize("dim", [1, 2])
def test_solution_payload_matches_jax_server(tmp_path, dim):
    """The JAX server's payload for a JAX experiment (its config snapshot and
    ``final_model.msgpack``) against the port's for the same parameters (bridged into ``final_model.npz``) and
    the same config (the JAX snapshot as the port's JSON-text
    config.yaml): grids and times equal, fields 1e-5 relative to max."""
    import yaml

    from pinnrl_tpu.dashboard.server import load_solution as jax_load_solution
    from pinnrl_tpu.models import PINNModel as JaxModel
    from pinnrl_tpu_torch.config import Config
    from pinnrl_tpu_torch.models import PINNModel
    from pinnrl_tpu_torch.utils.io import write_config_snapshot
    from tests.test_utils import tiny_config

    jcfg = tiny_config(pde_type="heat" if dim == 1 else "heat_2d", architecture="fourier",
                       num_epochs=1)
    jmodel = JaxModel(jcfg)
    jexp = tmp_path / "jax"
    jexp.mkdir()
    (jexp / "config.yaml").write_text(yaml.safe_dump(jcfg.to_dict(), default_flow_style=False))
    jmodel.save_state(str(jexp / "final_model.msgpack"))
    ref = jax_load_solution(jexp, grid=12, n_times=3)

    snapshot = yaml.safe_load((jexp / "config.yaml").read_text())
    tcfg = Config.from_snapshot({**snapshot, "device": "cpu"})
    texp = tmp_path / "port"
    texp.mkdir()
    write_config_snapshot(texp / "config.yaml", tcfg)
    tmodel = PINNModel(tcfg)
    bridge(jmodel, tmodel)
    tmodel.save_state(str(texp / "final_model.npz"))
    got = load_solution(texp, grid=12, n_times=3, device="cpu")

    assert got["dimension"] == ref["dimension"] == (1 if dim == 1 else 2)
    for k in ("x", "y", "times"):
        assert got.get(k) == ref.get(k), k
    assert rel_to_max(np.asarray(got["u_pred"]), np.asarray(ref["u_pred"])) < 1e-5
    assert rel_to_max(np.asarray(got["u_exact"]), np.asarray(ref["u_exact"])) < 1e-5


def test_dashboard_main_parses_device(monkeypatch):
    from pinnrl_tpu_torch import main as dash_main
    from pinnrl_tpu_torch import dashboard

    seen = {}
    monkeypatch.setattr(dashboard, "run_dashboard", lambda **kw: seen.update(kw))
    assert dash_main.main(["--no-browser", "--port", "8123", "--results-dir", "r",
                           "--device", "cpu"]) == 0
    assert seen == {"results_dir": "r", "port": 8123, "device": "cpu"}
