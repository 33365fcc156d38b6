"""The port's operator harness (``benchmarks/operator.py``), the Well
observation spec, ``train --dataset`` and the ``operator`` subcommand
against ``pinnrl_tpu``, on the offline ``synthetic_heat_2d`` entry (its
cache written into a temporary ``PINNRL_WELL_CACHE``).

Tolerances (each with its reason):
- configs equal field by field (the device aside), observations and pairs
  bit-equal (both packages read the same numpy arrays);
- the point-wise FNO's data_only loss 1e-5 relative and its gradients 1e-4
  relative to max (float32; the FFT against JAX's DFT matmuls);
- one unclipped Adam step of the gridded FNO 1e-4 absolute on every
  parameter (optax.adam against the port's Adam on bridged weights);
- CSV text equal.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_train_cli import _tiny_config
from torch_parity_helpers import inject_points, jax_bc_ic_points, rel_to_max

import pinnrl_tpu.benchmarks.operator as jax_operator
import pinnrl_tpu.models.fno_grid as jax_fno_grid
from pinnrl_tpu.benchmarks import cli as jax_cli
from pinnrl_tpu.datasets.synthetic import ensure_synthetic_well_cache as jax_ensure_cache
from pinnrl_tpu.training import train as jax_train
from pinnrl_tpu_torch.benchmarks import cli, operator
from pinnrl_tpu_torch.datasets.synthetic import ensure_synthetic_well_cache
from pinnrl_tpu_torch.models.bridge import params_from_flax
from pinnrl_tpu_torch.models.fno_grid import GridFNO2D
from pinnrl_tpu_torch.training import train

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
STEP_TOL = 1e-4


@pytest.fixture(autouse=True)
def _tmp_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("PINNRL_WELL_CACHE", str(tmp_path / "well"))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


class _Stop(Exception):
    pass


def _captured(module, monkeypatch, **kw):
    """The (cfg, pde, model) ``module.run_operator_benchmark`` hands its
    trainer, without training."""
    seen = {}

    def trainer(model, pde, cfg, *a, **k):
        seen.update(cfg=cfg, pde=pde, model=model)
        raise _Stop

    monkeypatch.setattr(module, "PDETrainer", trainer)
    with pytest.raises(_Stop):
        module.run_operator_benchmark(**kw)
    return seen


def test_pointwise_run_poses_the_jax_config_and_observations(monkeypatch):
    """The registry overlay (FNO 256x4, 16 modes, data_only, the entry's
    domain and dimensions, batch and points), and the train observations
    read from the cache both packages write."""
    kw = dict(epochs=8, n_points=300, seed=2)
    ref = _captured(jax_operator, monkeypatch, **kw)
    got = _captured(operator, monkeypatch, device="cpu", **kw)
    a, b = ref["cfg"].to_dict(), got["cfg"].to_dict()
    a.pop("device"), b.pop("device")
    assert a == b
    assert got["cfg"].model.architecture == "fno" and got["cfg"].training.mode == "data_only"
    assert got["model"].module.num_blocks == 4
    for x, y in zip(got["pde"].observations, ref["pde"].observations):
        assert x.shape == y.shape and np.array_equal(x.numpy(), np.asarray(y))


def test_pointwise_data_only_loss_matches_jax(monkeypatch):
    """The data_only loss (the residual through the FNO gated off, the data
    term on the observations) and its gradients on bridged parameters, at a
    small FNO width."""
    kw = dict(epochs=2, n_points=256, seed=0)
    ref = _captured(jax_operator, monkeypatch, **kw)
    jcfg = ref["cfg"]
    got = _captured(operator, monkeypatch, device="cpu", **kw)
    tcfg = got["cfg"]
    for cfg in (jcfg, tcfg):
        cfg.model.arch_params.update({"hidden_dim": 16, "num_blocks": 2, "modes": 4})
    from pinnrl_tpu.models import PINNModel as JaxModel
    from pinnrl_tpu.pdes import create_pde as jax_create_pde
    from pinnrl_tpu_torch.models import PINNModel
    from pinnrl_tpu_torch.pdes import create_pde

    jpde, jmodel = jax_create_pde(jcfg), JaxModel(jcfg, seed=0)
    tpde, tmodel = create_pde(tcfg), PINNModel(tcfg, seed=0)
    tmodel.module.load_state_dict(params_from_flax(_np(jmodel.params)), strict=True)
    rng = np.random.default_rng(9)
    x = (rng.random((64, 2)) * np.pi).astype(np.float32)
    t = rng.random((64, 1)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    (jl, jlosses), jg = jax.value_and_grad(
        lambda p: (lambda L: (L["total"], L))(jpde.compute_loss(jmodel.apply, p, x, t, key=key)),
        has_aux=True)(jmodel.params)
    inject_points(monkeypatch, tpde, *jax_bc_ic_points(jpde, key, 64))
    params = {k: v.detach().requires_grad_(True) for k, v in tmodel.params.items()}
    losses = tpde.compute_loss(tmodel.apply, params, torch.from_numpy(x), torch.from_numpy(t))
    assert abs(float(losses["data"]) - float(jlosses["data"])) / float(jlosses["data"]) < LOSS_TOL
    assert abs(float(losses["total"]) - float(jl)) / float(jl) < LOSS_TOL
    grads = torch.autograd.grad(losses["total"], list(params.values()))
    ref_g = params_from_flax(_np(jg))
    for name, g in zip(params, grads):
        assert rel_to_max(g, ref_g[name]) < GRAD_TOL, name


def test_pointwise_run_on_the_cpu_and_its_csv():
    r = operator.run_operator_benchmark(epochs=2, n_traj=1, n_points=256, device="cpu")
    assert (r.dataset, r.architecture, r.mode, r.epochs) == ("synthetic_heat_2d", "fno",
                                                            "data_only", 2)
    assert np.isfinite(r.test_rel_l2) and np.isfinite(r.final_train_loss) and r.wall_time_s > 0
    assert "synthetic_heat_2d,fno,data_only,2,256," in operator.results_to_csv([r])


def test_make_pairs_equal_jax():
    from pinnrl_tpu_torch.datasets.synthetic import generate_heat_2d_trajectory

    trajs = [generate_heat_2d_trajectory(i, n_steps=5, nx=8, ny=6) for i in range(3)]
    for a, b in zip(operator.make_pairs(trajs),
                    (np.concatenate([tr[:-1] for tr in trajs]), np.concatenate([tr[1:] for tr in trajs]))):
        assert a.dtype == np.float32 and np.array_equal(a, b)


def test_gridded_adam_step_matches_optax():
    """The gridded harness's step (MSE on a batch of pairs, Adam with the
    cosine schedule, no clipping) on bridged weights."""
    from pinnrl_tpu_torch.training.trainer import AdamStep, cosine_decay

    rng = np.random.default_rng(3)
    a = rng.standard_normal((4, 16, 16, 1)).astype(np.float32)
    u = rng.standard_normal((4, 16, 16, 1)).astype(np.float32)
    jfno = jax_fno_grid.GridFNO2D(width=8, modes=4, num_blocks=2)
    jp = jfno.init(jax.random.PRNGKey(0), jnp.asarray(a[:1]))
    opt = optax.adam(optax.cosine_decay_schedule(2e-3, 10))
    state = opt.init(jp)
    tfno = GridFNO2D(width=8, modes=4, num_blocks=2, grid=(16, 16))
    tfno.load_state_dict(params_from_flax(_np(jp["params"])), strict=True)
    params = list(tfno.parameters())
    topt = AdamStep(params, cosine_decay(2e-3, 10, 0.0), None, 0.9, 0.999, 0.0)
    for _ in range(3):
        loss, g = jax.value_and_grad(lambda p: jnp.mean((jfno.apply(p, a) - u) ** 2))(jp)
        updates, state = opt.update(g, state)
        jp = optax.apply_updates(jp, updates)
        tloss = torch.mean((tfno(torch.from_numpy(a)) - torch.from_numpy(u)) ** 2)
        for p in params:
            p.grad = None
        tloss.backward()
        topt.step()
        assert abs(float(tloss.detach()) - float(loss)) / float(loss) < LOSS_TOL
    ref = params_from_flax(_np(jp["params"]))
    for name, p in tfno.named_parameters():
        assert float((p.detach() - ref[name]).abs().max()) < STEP_TOL, name


@pytest.mark.parametrize("epochs,want", [(3, 3), (50, 50), (75, 100)])
def test_gridded_step_accounting_equals_jax(monkeypatch, epochs, want):
    """ceil(epochs / inner) * inner steps run, inner = min(50, epochs)
    (operator.py:193-198); the steps counted on the optimizer."""
    from pinnrl_tpu_torch.training import trainer

    calls = []
    real = trainer.AdamStep.step
    monkeypatch.setattr(trainer.AdamStep, "step", lambda self: calls.append(1) or real(self))
    rs = operator.run_gridded_operator_benchmark(epochs=epochs, n_traj_train=1, n_traj_test=1,
                                                 width=4, modes=2, num_blocks=1, device="cpu")
    assert len(calls) == want == rs[0].epochs


def test_gridded_run_with_transfer_rows():
    rs = operator.run_gridded_operator_benchmark(epochs=20, width=8, modes=6, num_blocks=2,
                                                 transfer_resolutions=(64,), device="cpu")
    assert [r.dataset for r in rs] == ["synthetic_heat_2d(gridded)",
                                       "synthetic_heat_2d(gridded,transfer64)"]
    for r in rs:
        assert (r.architecture, r.mode, r.epochs, r.train_points) == ("grid_fno2d", "operator",
                                                                      20, 10 * 23 * 48 * 48)
        assert np.isfinite(r.test_rel_l2) and np.isfinite(r.final_train_loss)
    assert rs[0].final_train_loss == rs[1].final_train_loss


def test_results_to_csv_equals_jax():
    rows = [("synthetic_heat_2d", "fno", "data_only", 2000, 8192, 2.3e-3, 0.0123, 1.5e-6, 123.45, 0),
            ("synthetic_heat_2d(gridded,transfer96)", "grid_fno2d", "operator", 1500, 529920,
             8.1e-3, float("nan"), 1e-9, 0.04, 3)]
    got = operator.results_to_csv([operator.OperatorResult(*r) for r in rows])
    assert got == jax_operator.results_to_csv([jax_operator.OperatorResult(*r) for r in rows])


def test_operator_subcommand_as_jax(tmp_path, capsys):
    """--transfer without --gridded is refused with JAX's message; the
    point-wise and gridded runs print their table and append their CSV."""
    argv = ["operator", "--transfer", "64"]
    with pytest.raises(SystemExit) as got:
        cli.main(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit) as want:
        jax_cli.main(argv)
    assert str(got.value) == str(want.value)
    out = tmp_path / "op.csv"
    assert cli.main(["operator", "--epochs", "2", "--traj", "1", "--points", "256", "--device",
                     "cpu", "--csv", str(out)]) == 0
    assert cli.main(["operator", "--gridded", "--epochs", "2", "--transfer", "64", "--device",
                     "cpu", "--csv", str(out)]) == 0
    assert "test_rel_l2" in capsys.readouterr().out
    lines = out.read_text().strip().split("\n")
    assert lines[0].startswith("dataset,architecture,mode,epochs") and len(lines) == 4
    # The transfer row's dataset holds a comma, unquoted, as JAX writes it.
    assert [ln.split(",")[0] for ln in lines[1:]] == [
        "synthetic_heat_2d", "synthetic_heat_2d(gridded)", "synthetic_heat_2d(gridded"]


def test_well_observation_spec_loads_as_jax():
    """A {"source": "well", ...} observation spec reads the slice through
    load_well_slice, as the JAX package's PDE does."""
    from pinnrl_tpu.config import load_config as jax_load_config
    from pinnrl_tpu.pdes import create_pde as jax_create_pde
    from pinnrl_tpu_torch.config import load_config
    from pinnrl_tpu_torch.pdes import create_pde

    jax_ensure_cache(split="test", n_traj=2, n_points=128, seed=1)
    spec = {"source": "well", "name": "synthetic_heat_2d", "split": "test", "n_traj": 2,
            "n_points": 128, "seed": 1, "base": None}
    jcfg, tcfg = jax_load_config(pde_type="heat_2d"), load_config(pde_type="heat_2d", device="cpu")
    jcfg.pde.observation_data = tcfg.pde.observation_data = spec
    for a, b in zip(create_pde(tcfg).observations, jax_create_pde(jcfg).observations):
        assert a.shape == b.shape and np.array_equal(a.numpy(), np.asarray(b))


def _dataset_argv(tmp_path, results):
    return ["--pde", "heat_2d", "--dataset", "synthetic_heat_2d", "--dataset-points", "256",
            "--epochs", "2", "--collocation-points", "256", "--batch-size", "128",
            "--boundary-points", "32", "--initial-points", "32",
            "--config", _tiny_config(tmp_path / "tiny.yaml"), "--results-dir", str(results)]


def test_train_dataset_builds_the_jax_config(tmp_path):
    argv = _dataset_argv(tmp_path, tmp_path / "r") + ["--dataset-seed", "3", "--dataset-traj", "2"]
    a = jax_train.build_config(jax_train.parse_args(argv)).to_dict()
    b = train.build_config(train.parse_args(argv + ["--device", "cpu"])).to_dict()
    a.pop("device"), b.pop("device")
    assert a == b and b["training"]["mode"] == "data_only"
    assert b["pde"]["observation_data"]["seed"] == 3
    kept = train.build_config(train.parse_args(argv + ["--mode", "data_augmented", "--device",
                                                      "cpu"]))
    assert kept.training.mode == "data_augmented"
    with pytest.raises(KeyError, match="Unknown Well dataset"):
        train.build_config(train.parse_args(["--pde", "heat", "--dataset", "nope", "--device",
                                             "cpu"]))


def test_train_dataset_runs_on_the_cpu(tmp_path):
    """``train --dataset synthetic_heat_2d --epochs 2 --device cpu`` on the
    cache: the experiment directory named by the dataset, data_only, finite
    losses, the JAX package's file set (its plots off)."""
    ensure_synthetic_well_cache(split="train", n_traj=1, n_points=256, seed=0)
    assert train.main(_dataset_argv(tmp_path, tmp_path / "torch") + ["--device", "cpu"]) == 0
    assert jax_train.main(_dataset_argv(tmp_path, tmp_path / "jax")) == 0
    (texp,), (jexp,) = (tmp_path / "torch").iterdir(), (tmp_path / "jax").iterdir()
    assert "_synthetic_heat_2d_fourier_norl" in texp.name
    meta = json.loads((texp / "metadata.json").read_text())
    assert meta["status"] == "completed" and meta["mode"] == "data_only"
    hist = json.loads((texp / "history.json").read_text())
    assert len(hist["train_loss"]) == 2 and all(np.isfinite(hist["train_loss"]))
    assert all(np.isfinite(hist["loss_components"]["data"]))
    swap = {"final_model.msgpack": "final_model.npz"}
    want = {swap.get(p.name, p.name) for p in jexp.iterdir()} - {"checkpoint.msgpack",
                                                                 "checkpoint.json"}
    assert {p.name for p in texp.iterdir()} == want
