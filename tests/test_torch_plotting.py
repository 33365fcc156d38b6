"""The experiment's plots, report and heat's FDM comparison
(``pinnrl_tpu_torch/utils/plotting.py``, ``PDETrainer._save_final_plots``)
against the JAX package on the CPU: the PNGs are written where matplotlib
imports and every plot returns None where it does not (the card's
machine); ``report.html`` is byte-equal to JAX's for the same
``metadata.json`` and ``history.json``; a heat 1-D run through the
training CLI writes ``fdm_comparison.json`` equal to JAX's comparison of
the run's final parameters (1e-5 absolute, as tests/test_torch_fdm.py holds
``compare_with_pinn``: the float32 stencils round apart by ~1e-6 over the
full solve, the network is evaluated in another order) and
``report.html``."""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_helpers import pde_pair

from pinnrl_tpu.utils import plotting as jax_plotting
from pinnrl_tpu_torch.rl import RLAgent
from pinnrl_tpu_torch.utils import plotting

REPO = Path(__file__).resolve().parent.parent
HISTORY = {"train_loss": [3.0, 1.5, 0.75, 0.5], "val_loss": [2.0, 0.6],
           "learning_rate": [1e-3, 9e-4, 8e-4, 7e-4],
           "loss_components": {"residual": [1.0, 0.5, 0.2, 0.1], "boundary": [0.5, 0.2, 0.1, 0.05],
                               "initial": [0.0, 0.0, 0.0, 0.0]},
           "param_alpha": [0.5, 0.3, 0.2, 0.1025]}
META = {"status": "completed", "pde_type": "heat", "architecture": "fourier", "num_epochs": 4,
        "true_parameters": {"alpha": 0.1}, "traceback": "hidden", "parameters": {"alpha": 0.1}}


def _small_heat():
    pair = pde_pair("heat", hidden=(8, 8), mapping=4)
    return pair.tpde, pair.tmodel


def _all_plots(out: Path):
    pde, model = _small_heat()
    agent = RLAgent(hidden_dim=8, device="cpu")
    state = agent.init(torch.Generator().manual_seed(0))
    pts = [np.random.default_rng(i).random((64, 2)).astype(np.float32) for i in range(5)]
    return {
        "training_history.png": plotting.plot_training_history(HISTORY, out / "training_history.png"),
        "solution.png": plotting.plot_solution(pde, model, model.params, out / "solution.png",
                                               grid=16, times=2),
        "collocation_evolution.png": plotting.plot_collocation_evolution(
            pts, pde.domain, pde.time_domain, out / "collocation_evolution.png"),
        "rl_q_density.png": plotting.plot_q_density(agent, state, pde.domain, pde.time_domain,
                                                    out / "rl_q_density.png", grid=12),
        "compare.png": plotting.plot_architecture_comparison({"a": HISTORY, "b": HISTORY},
                                                            out / "compare.png"),
    }


def test_plots_are_written_with_matplotlib(tmp_path):
    pytest.importorskip("matplotlib")
    written = _all_plots(tmp_path)
    for name, path in written.items():
        assert path == tmp_path / name and path.stat().st_size > 1000, name
        assert path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_plots_return_none_without_matplotlib(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    assert plotting._pyplot() is None
    written = _all_plots(tmp_path)
    assert all(v is None for v in written.values())
    assert list(tmp_path.iterdir()) == []
    # The report needs no matplotlib.
    (tmp_path / "metadata.json").write_text(json.dumps(META))
    assert plotting.create_interactive_report(tmp_path) == tmp_path / "report.html"


def test_solution_plot_in_two_dimensions(tmp_path):
    pytest.importorskip("matplotlib")
    pair = pde_pair("heat", hidden=(8,), mapping=4, dim=2)
    out = plotting.plot_solution(pair.tpde, pair.tmodel, pair.tmodel.params, tmp_path / "s.png",
                                 grid=8, times=2)
    assert out is not None and out.exists()


@pytest.mark.parametrize("files", ["both", "metadata", "history", "none"])
def test_report_is_byte_equal_to_jax(tmp_path, files):
    exp = tmp_path / "exp_0"
    exp.mkdir()
    if files in ("both", "metadata"):
        (exp / "metadata.json").write_text(json.dumps(META, indent=2))
    if files in ("both", "history"):
        (exp / "history.json").write_text(json.dumps(HISTORY))
    ref = jax_plotting.create_interactive_report(exp, exp / "jax.html")
    got = plotting.create_interactive_report(exp)
    assert got == exp / "report.html"
    assert got.read_bytes() == ref.read_bytes()


def _cli_config(path: Path) -> str:
    from pinnrl_tpu_torch.utils.io import write_config_snapshot

    raw = json.loads((REPO / "pinnrl_tpu_torch/config/defaults.json").read_text())
    raw["architectures"]["fourier"].update({"hidden_dims": [8, 8], "mapping_size": 4})
    raw["evaluation"]["save_plots"] = True
    raw["evaluation"]["num_points"] = 64

    class _Snapshot:
        def to_dict(self):
            return raw

    write_config_snapshot(path, _Snapshot())
    return str(path)


def test_heat_cli_run_writes_report_and_the_jax_fdm_comparison(tmp_path):
    from pinnrl_tpu.models import PINNModel as JaxModel
    from pinnrl_tpu.numerical_solvers import HeatEquationFDM as JaxFDM
    from pinnrl_tpu.pdes import create_pde as jax_create_pde
    from pinnrl_tpu_torch.config import Config
    from pinnrl_tpu_torch.models import PINNModel
    from pinnrl_tpu_torch.models.bridge import params_to_flax
    from pinnrl_tpu_torch.training import train

    argv = ["--pde", "heat", "--arch", "fourier", "--epochs", "2", "--collocation-points", "128",
            "--batch-size", "64", "--boundary-points", "16", "--initial-points", "16",
            "--config", _cli_config(tmp_path / "cfg.yaml"), "--results-dir", str(tmp_path / "out"),
            "--device", "cpu"]
    assert train.main(argv) == 0
    (exp,) = (tmp_path / "out").iterdir()
    files = {p.relative_to(exp).as_posix() for p in exp.rglob("*")}
    assert {"report.html", "fdm_comparison.json", "visualizations/training_history.png",
            "visualizations/solution.png", "visualizations/collocation_evolution.png"} <= files
    cmp = json.loads((exp / "fdm_comparison.json").read_text())
    # JAX's comparison of the run's final parameters.
    cfg = Config.from_snapshot(json.loads((exp / "config.yaml").read_text()))
    cfg.device = "cpu"
    model = PINNModel(cfg)
    model.load_state(str(exp / "final_model.npz"))
    from pinnrl_tpu.config import Config as JaxConfig

    jcfg = JaxConfig.from_snapshot(json.loads((exp / "config.yaml").read_text()))
    jmodel = JaxModel(jcfg, seed=0)
    tree, constants = params_to_flax(model.module.state_dict())
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jmodel.constants = jax.tree_util.tree_map(jnp.asarray, constants)  # the run's basis
    ref = JaxFDM(jax_create_pde(jcfg), nx=101).compare_with_pinn(jmodel.apply, jparams)
    assert sorted(cmp) == sorted(ref)
    for k, v in ref.items():
        assert abs(cmp[k] - float(v)) <= 1e-5, k
    html = (exp / "report.html").read_text()
    assert exp.name in html and "<polyline" in html
