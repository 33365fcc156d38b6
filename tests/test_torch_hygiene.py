"""The port stands alone: no JAX import, config defaults equal the JAX
package's YAML, no silent device fallback, CPU tensors never launch a
kernel, and unported features raise."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

REPO = Path(__file__).resolve().parent.parent


def test_port_imports_without_jax():
    """Importing every module of pinnrl_tpu_torch pulls in neither jax nor
    triton, and needs no nvcc (nothing is built at import)."""
    code = (
        "import pkgutil, importlib, sys\n"
        "import pinnrl_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(pinnrl_tpu_torch.__path__, 'pinnrl_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) >= 21 and 'pinnrl_tpu_torch.rl.dqn' in mods, mods\n"
        "assert {'pinnrl_tpu_torch.pdes.kdv', 'pinnrl_tpu_torch.benchmarks.convergence'} <= set(mods)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'pinnrl_tpu', 'triton')]\n"
        "assert not bad, bad\n"
        "from pinnrl_tpu_torch.ops.kernels import _build\n"
        "assert not _build._LOADED\n"
        "print('ok', len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_defaults_snapshot_equals_yaml():
    snap = json.loads((REPO / "pinnrl_tpu_torch/config/defaults.json").read_text())
    ref = yaml.safe_load((REPO / "pinnrl_tpu/config/config.yaml").read_text())
    assert snap == ref


def test_config_matches_jax_config():
    """The same overlays give the same dataclasses (device aside)."""
    from pinnrl_tpu.config import load_config as jax_load_config
    from pinnrl_tpu_torch.config import load_config

    for pde, arch in (("burgers", "fourier"), ("heat", "feedforward"), ("kdv", None)):
        a = jax_load_config(pde_type=pde, architecture=arch).to_dict()
        b = load_config(pde_type=pde, architecture=arch, device="cpu").to_dict()
        a.pop("device"), b.pop("device")
        assert a == b


def test_cuda_device_without_card_raises():
    from pinnrl_tpu_torch.config import load_config

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for dev in ("cuda", "cuda:0", "gpu", "tpu"):
        with pytest.raises(RuntimeError, match="is_available"):
            load_config(pde_type="burgers", device=dev)
    with pytest.raises(ValueError, match="Unknown device"):
        load_config(pde_type="burgers", device="mps")
    assert load_config(pde_type="burgers", device="cpu").device == "cpu"


def test_yaml_config_needs_pyyaml(monkeypatch):
    from pinnrl_tpu_torch.config import load_config

    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="PyYAML"):
        load_config(config_path=str(REPO / "pinnrl_tpu/config/config.yaml"), device="cpu")
    cfg = load_config(config_path=str(REPO / "pinnrl_tpu_torch/config/defaults.json"),
                      pde_type="burgers", device="cpu")
    assert cfg.pde_type == "burgers"


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors every wrapper runs its plain version: the launch
    counters stay 0 and the results equal the plain functions exactly."""
    from pinnrl_tpu_torch.ops.jet_mlp import make_bundle_fn
    from pinnrl_tpu_torch.ops.kernels import fourier_feats, fused_step, mlp
    from pinnrl_tpu_torch.rl import RLAgent
    from torch_parity_helpers import burgers_pair, points

    counters = (fourier_feats.fourier_features, fused_step.fused_residual_loss, mlp.fused_mlp_score)
    before = tuple(c.launches for c in counters)
    x = torch.from_numpy(np.random.default_rng(0).random((16, 2), np.float32))
    B = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 8)).astype(np.float32))
    assert torch.equal(fourier_feats.fourier_features(x, B), fourier_feats.fourier_features_plain(x, B))

    pair = burgers_pair()
    fn = fused_step.make_fused_residual_loss(pair.tmodel, pair.tpde)
    xs, ts = points(0, 64)
    z = torch.from_numpy(np.concatenate([xs, ts], axis=1))
    bundle_fn = make_bundle_fn(pair.tmodel, 1, 2, 1)
    ref = fused_step.fused_residual_loss_plain(bundle_fn, pair.tpde, pair.tmodel.params, z)
    assert torch.equal(fn(pair.tmodel.params, z), ref)
    q_params = RLAgent(hidden_dim=16).init(torch.Generator().manual_seed(0)).policy_params
    with torch.no_grad():
        assert torch.equal(mlp.fused_mlp_score(z, q_params), mlp.fused_mlp_score_plain(z, q_params))
    after = tuple(c.launches for c in counters)
    assert before == after == (0, 0, 0)


def test_wrappers_reject_other_devices():
    from pinnrl_tpu_torch.ops.kernels import fourier_feats, mlp
    from pinnrl_tpu_torch.rl import RLAgent

    x = torch.zeros((4, 2), device="meta")
    with pytest.raises(ValueError, match="unsupported devices"):
        fourier_feats.fourier_features(x, torch.zeros((2, 8), device="meta"))
    q_params = RLAgent(hidden_dim=16).init(torch.Generator().manual_seed(0)).policy_params
    with pytest.raises(ValueError, match="unsupported device"):
        mlp.fused_mlp_score(x, q_params)


def test_unported_features_raise():
    from pinnrl_tpu_torch.config import load_config
    from pinnrl_tpu_torch.models import PINNModel
    from pinnrl_tpu_torch.pdes import create_pde
    from pinnrl_tpu_torch.training import PDETrainer

    with pytest.raises(ValueError, match="not ported yet"):
        PINNModel(load_config(pde_type="burgers", architecture="siren", device="cpu"))
    with pytest.raises(ValueError, match="ROADMAP item 11"):
        create_pde(load_config(pde_type="heat", device="cpu"))
    cfg = load_config(pde_type="burgers", architecture="fourier", device="cpu")
    cfg.model.hidden_dims = [8]
    cfg.model.arch_params["mapping_size"] = 4
    cfg.model.arch_params["modified"] = True
    with pytest.raises(NotImplementedError, match="ROADMAP item 12"):
        PINNModel(cfg)
    cfg.model.arch_params["modified"] = False
    model, pde = PINNModel(cfg), create_pde(cfg)
    for field, value, item in (("optimizer", "adam_lbfgs", 8),
                               ("scheduler_type", "reduce_lr", 9),
                               ("param_ema", 0.9, 13), ("ensemble_size", 2, 13)):
        old = getattr(cfg.training, field)
        setattr(cfg.training, field, value)
        with pytest.raises(NotImplementedError, match=f"ROADMAP item {item}"):
            PDETrainer(model, pde, cfg)
        setattr(cfg.training, field, old)
    trainer = PDETrainer(model, pde, cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP item 9"):
        trainer.train(num_epochs=1, experiment_dir="unused")
