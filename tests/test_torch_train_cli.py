"""The port's training CLI and experiment directory against pinnrl_tpu's.

``build_config`` gives the JAX package's config for the same flags (device
aside); a tiny run writes the JAX package's file set but for the deliberate
differences below; the failure protocol; and the saved model loads into
the JAX package's flax model and gives the port's outputs (float32, 1e-5
relative to max).

Deliberate differences in the directory: ``final_model.npz`` and
``rl_agent.npz`` for ``.msgpack``, no ``checkpoint.msgpack`` /
``checkpoint.json`` (resume, ROADMAP item 9), no plots (item 14) and no
``adaptive_weights`` history (item 13). The tiny runs turn plots off in
both, so the JAX run writes none either.
"""

import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
import torch_parity_helpers  # noqa: F401  (pins torch's CPU threads per worker)

from pinnrl_tpu.config import Config as JaxConfig
from pinnrl_tpu.models import PINNModel as JaxModel
from pinnrl_tpu.training import train as jax_train
from pinnrl_tpu_torch.config import Config
from pinnrl_tpu_torch.models import PINNModel
from pinnrl_tpu_torch.models.bridge import state_from_flat_flax
from pinnrl_tpu_torch.training import train
from pinnrl_tpu_torch.utils.io import write_config_snapshot

REPO = Path(__file__).resolve().parent.parent
OUT_TOL = 1e-5

ARGVS = [
    ["--pde", "heat", "--mode", "inverse", "--identify", "alpha", "--initial-guess", "alpha=0.5",
     "--obs-noise", "0.01"],
    ["--pde", "Black-Scholes Equation", "--identify", "sigma", "--identify", "r",
     "--initial-guess", "sigma=0.4", "--initial-guess", "r=0.02", "--obs-points", "500",
     "--obs-path", "obs.npz"],
    ["--pde", "burgers", "--arch", "fourier", "--rl", "--epochs", "4", "--lr", "1e-3",
     "--batch-size", "64", "--optimizer", "adam_lbfgs"],
    ["--pde", "kdv", "--sampling", "residual_based", "--loss-function", "huber",
     "--huber-delta", "0.5", "--collocation-points", "100", "--boundary-points", "10",
     "--initial-points", "12", "--results-dir", "out", "--seed", "3"],
    ["--pde", "heat-2d", "--mode", "data_augmented", "--loss-function", "mae"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=[a[1] for a in ARGVS])
def test_build_config_matches_jax(argv):
    a = jax_train.build_config(jax_train.parse_args(argv)).to_dict()
    b = train.build_config(train.parse_args(argv + ["--device", "cpu"])).to_dict()
    assert b.pop("device") == "cpu"
    a.pop("device")
    assert a == b


def test_flags_resolve_and_refuse_as_jax():
    for name in ("heat", "Heat Equation", "heat-2d", "KdV Equation", "black scholes"):
        assert train.resolve_pde_key(name) == jax_train.resolve_pde_key(name)
    with pytest.raises(ValueError, match="Unknown PDE"):
        train.resolve_pde_key("navier_stokes")
    with pytest.raises(ValueError, match="inverse mode requires"):
        train.build_config(train.parse_args(["--pde", "heat", "--mode", "inverse",
                                             "--device", "cpu"]))
    argv = ["--pde", "heat_2d", "--dataset", "synthetic_heat_2d"]
    well = train.build_config(train.parse_args(argv + ["--device", "cpu"]))
    assert well.training.mode == "data_only" and well.pde.observation_data["source"] == "well"
    assert well.to_dict()["pde"] == jax_train.build_config(jax_train.parse_args(argv)).to_dict()["pde"]
    with pytest.raises(KeyError, match="Unknown Well dataset"):
        train.build_config(train.parse_args(["--pde", "heat", "--dataset", "x", "--device", "cpu"]))
    cfg = train.build_config(train.parse_args(["--pde", "heat", "--profile-dir", "p",
                                               "--device", "cpu"]))
    assert cfg.training.profile_dir == "p"  # profiler traces are ported: the trainer builds
    train.PDETrainer(PINNModel(cfg), train.create_pde(cfg), cfg)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            train.build_config(train.parse_args(["--pde", "heat"]))


def _tiny_config(path: Path) -> str:
    """The shipped defaults with a narrow Fourier trunk and a narrow agent,
    plots off, written as JSON text that both packages read."""
    raw = json.loads((REPO / "pinnrl_tpu_torch/config/defaults.json").read_text())
    raw["architectures"]["fourier"].update({"hidden_dims": [16, 16], "mapping_size": 8})
    raw["rl"]["hidden_dim"] = 16
    raw["rl"]["memory_size"] = 256
    raw["evaluation"]["save_plots"] = False
    raw["evaluation"]["num_points"] = 64

    class _Snapshot:
        def to_dict(self):
            return raw

    write_config_snapshot(path, _Snapshot())
    return str(path)


TINY = ["--pde", "heat", "--identify", "alpha", "--initial-guess", "alpha=0.5", "--rl",
        "--epochs", "2", "--collocation-points", "256", "--batch-size", "128",
        "--boundary-points", "32", "--initial-points", "32", "--obs-points", "64",
        "--obs-noise", "0.01"]


def _run(module, tmp_path, tag, extra=()):
    out = tmp_path / tag
    argv = TINY + ["--config", _tiny_config(tmp_path / "tiny.yaml"), "--results-dir", str(out),
                   *extra]
    assert module.main(argv) == 0
    (exp,) = out.iterdir()
    return exp


def _files(exp: Path):
    return {p.relative_to(exp).as_posix() for p in exp.rglob("*")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    return _run(jax_train, tmp, "jax"), _run(train, tmp, "torch", ["--device", "cpu"])


def test_experiment_directory_has_the_jax_file_set(runs):
    jexp, texp = runs
    swap = {"final_model.msgpack": "final_model.npz", "rl_agent.msgpack": "rl_agent.npz",
            "checkpoint.msgpack": "checkpoint.npz"}
    want = {swap.get(f, f) for f in _files(jexp)}
    assert _files(texp) == want
    assert ".running" not in _files(texp) and "visualizations" in _files(texp)
    jmeta, tmeta = (json.loads((e / "metadata.json").read_text()) for e in runs)
    assert sorted(tmeta) == sorted(jmeta)
    assert tmeta["status"] == jmeta["status"] == "completed"
    assert tmeta["mode"] == "inverse" and tmeta["rl_enabled"] and tmeta["current_epoch"] == 2
    assert set(tmeta["identified_parameters"]) == {"alpha"}
    jhist, thist = (json.loads((e / "history.json").read_text()) for e in runs)
    assert sorted(thist) == sorted(jhist)
    assert len(thist["param_alpha"]) == 2
    jmet, tmet = (json.loads((e / "metrics.json").read_text()) for e in runs)
    assert sorted(tmet) == sorted(jmet) and tmet["num_epochs_run"] == 2
    with np.load(texp / "live_snapshot.npz") as t, np.load(jexp / "live_snapshot.npz") as j:
        assert sorted(t.files) == sorted(j.files)
        assert t["u_pred"].shape == t["residual"].shape == (60, 60)
    assert "epoch 2/2" in (texp / "experiment.log").read_text()


def test_config_snapshot_reads_back_in_both_packages(runs, monkeypatch):
    """config.yaml is JSON text: the JAX package's YAML reader and the port's
    reader (without PyYAML) rebuild the same config from it."""
    from pinnrl_tpu_torch.config import _read_config_file

    _, texp = runs
    snap = yaml.safe_load((texp / "config.yaml").read_text())
    monkeypatch.setitem(sys.modules, "yaml", None)
    read = _read_config_file(texp / "config.yaml")
    assert read == snap
    a = JaxConfig.from_snapshot(snap).to_dict()
    b = Config.from_snapshot(read).to_dict()
    a.pop("device"), b.pop("device")
    assert a == b


def test_saved_model_gives_jax_the_ports_outputs(runs):
    """final_model.npz (flax path names) into the JAX package's model, built
    from the run's own config.yaml: the same outputs as the port's model
    loaded from it."""
    _, texp = runs
    snap = yaml.safe_load((texp / "config.yaml").read_text())
    with np.load(texp / "final_model.npz") as data:
        flat = {k: data[k] for k in data.files}
    trees = {}
    for key, value in flat.items():
        *parents, leaf = key.split("/")
        node = trees
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    jmodel = JaxModel(JaxConfig.from_snapshot(snap))
    jmodel.params = trees["params"]
    jmodel.constants = {"constants": trees["constants"]}
    cfg = Config.from_snapshot(snap)
    tmodel = PINNModel(cfg, seed=5)
    tmodel.load_state(str(texp / "final_model.npz"))
    assert all(torch.equal(tmodel.module.state_dict()[k], v)
               for k, v in state_from_flat_flax(flat).items())
    z = np.random.default_rng(0).random((50, 2)).astype(np.float32) * np.array([2.0, 10.0], np.float32)
    ref = np.asarray(jmodel.apply(jmodel.params, jnp.asarray(z)))
    got = tmodel.apply(tmodel.params, torch.from_numpy(z)).detach().numpy()
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < OUT_TOL
    assert json.loads((texp / "final_model.json").read_text())["architecture"] == "fourier"


def test_agent_state_reloads_from_the_run(runs):
    from pinnrl_tpu_torch.rl import RLAgent

    _, texp = runs
    agent = RLAgent(hidden_dim=16, memory_size=256, device="cpu")
    state = agent.load_state(str(texp / "rl_agent.npz"), agent.init(torch.Generator().manual_seed(1)))
    assert state.steps == 4 and state.size == 256  # 4 steps x 128 points, capped at the memory
    assert float(state.epsilon) == pytest.approx(0.995 ** 2)


def test_failure_protocol(tmp_path, monkeypatch):
    """A run that raises records status, error and traceback in
    metadata.json, removes .running and re-raises."""
    def boom(self, **kwargs):
        (Path(kwargs["experiment_dir"]) / ".running").touch()
        raise RuntimeError("boom")

    monkeypatch.setattr(train.PDETrainer, "train", boom)
    with pytest.raises(RuntimeError, match="boom"):
        _run(train, tmp_path, "fail", ["--device", "cpu"])
    (exp,) = (tmp_path / "fail").iterdir()
    meta = json.loads((exp / "metadata.json").read_text())
    assert meta["status"] == "failed" and meta["error"] == "boom" and "RuntimeError" in meta["traceback"]
    assert not (exp / ".running").exists() and (exp / "config.yaml").exists()


def test_trainer_failure_removes_running_and_detaches_its_log(tmp_path, monkeypatch):
    from pinnrl_tpu_torch.training import trainer as trainer_mod

    cfg = train.build_config(train.parse_args(
        ["--pde", "heat", "--config", _tiny_config(tmp_path / "tiny.yaml"), "--epochs", "1",
         "--collocation-points", "64", "--batch-size", "64", "--device", "cpu"]))
    tr = trainer_mod.PDETrainer(PINNModel(cfg), train.create_pde(cfg), cfg)
    monkeypatch.setattr(tr, "_step", lambda *a: (_ for _ in ()).throw(RuntimeError("step")))
    handlers = list(trainer_mod.logger.handlers)
    with pytest.raises(RuntimeError, match="step"):
        tr.train(experiment_dir=str(tmp_path / "exp"))
    assert not (tmp_path / "exp" / ".running").exists()
    assert json.loads((tmp_path / "exp" / "metadata.json").read_text())["status"] == "running"
    assert trainer_mod.logger.handlers == handlers
