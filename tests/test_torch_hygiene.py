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
        "assert len(mods) >= 25 and 'pinnrl_tpu_torch.rl.dqn' in mods, mods\n"
        "assert {'pinnrl_tpu_torch.pdes.kdv', 'pinnrl_tpu_torch.benchmarks.convergence',\n"
        "        'pinnrl_tpu_torch.ops.kernels.siren', 'pinnrl_tpu_torch.models.siren',\n"
        "        'pinnrl_tpu_torch.ops.derivatives', 'pinnrl_tpu_torch.pdes.heat',\n"
        "        'pinnrl_tpu_torch.training.lbfgs', 'pinnrl_tpu_torch.pdes.cahn_hilliard',\n"
        "        'pinnrl_tpu_torch.models.attention', 'pinnrl_tpu_torch.training.train',\n"
        "        'pinnrl_tpu_torch.benchmarks.inverse', 'pinnrl_tpu_torch.benchmarks.cli',\n"
        "        'pinnrl_tpu_torch.utils.io', 'pinnrl_tpu_torch.benchmarks.sampling',\n"
        "        'pinnrl_tpu_torch.benchmarks.fdm', 'pinnrl_tpu_torch.benchmarks.operator',\n"
        "        'pinnrl_tpu_torch.datasets.registry', 'pinnrl_tpu_torch.datasets.well_loader',\n"
        "        'pinnrl_tpu_torch.datasets.synthetic', 'pinnrl_tpu_torch.models.fno',\n"
        "        'pinnrl_tpu_torch.models.fno_grid',\n"
        "        'pinnrl_tpu_torch.numerical_solvers.heat_fdm',\n"
        "        'pinnrl_tpu_torch.training.adaptive_weights',\n"
        "        'pinnrl_tpu_torch.training.multistage', 'pinnrl_tpu_torch.parallel.mesh',\n"
        "        'pinnrl_tpu_torch.dashboard.server', 'pinnrl_tpu_torch.main'} <= set(mods)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'pinnrl_tpu', 'triton', 'the_well')]\n"
        "assert not bad, bad\n"
        "from pinnrl_tpu_torch.ops.kernels import _build\n"
        "assert not _build._LOADED\n"
        "print('ok', len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_no_source_imports_jax_or_the_jax_package():
    """No module of pinnrl_tpu_torch, not chip_smoke.py and not the mesh
    tests' rank module imports jax, flax, optax or pinnrl_tpu, at any depth
    of the file (lazy imports included)."""
    import ast

    banned = {"jax", "jaxlib", "flax", "optax", "pinnrl_tpu"}
    files = sorted((REPO / "pinnrl_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py",
                                                                 REPO / "tests/torch_mesh_worker.py"]
    assert len(files) > 40
    assert {"mesh.py", "server.py", "main.py"} <= {p.name for p in files}
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            assert not {n.split(".")[0] for n in names} & banned, (path, names)


def test_defaults_snapshot_equals_yaml():
    snap = json.loads((REPO / "pinnrl_tpu_torch/config/defaults.json").read_text())
    ref = yaml.safe_load((REPO / "pinnrl_tpu/config/config.yaml").read_text())
    assert snap == ref


def test_random_ic_table_equals_jax_draws():
    """The series the former table held (seed 0, 16 modes, d = 1-3) are,
    bit for bit, the draws of the JAX package's ``random`` IC: W x 4,
    phase, amp / sqrt(n_modes), now from the threefry replica."""
    import jax
    import jax.numpy as jnp

    from pinnrl_tpu_torch.pdes.base import random_ic_basis

    for dim in (1, 2, 3):
        seed, modes = 0, 16
        k_w, k_p, k_a = jax.random.split(jax.random.PRNGKey(seed), 3)
        ref = {"W": jax.random.normal(k_w, (dim, modes)) * 4.0,
               "phase": jax.random.uniform(k_p, (modes,), maxval=2 * jnp.pi),
               "amp": jax.random.normal(k_a, (modes,)) / jnp.sqrt(modes)}
        for (name, value), got in zip(ref.items(), random_ic_basis(seed, modes, dim)):
            assert got.numpy().tobytes() == np.asarray(value, np.float32).tobytes(), (dim, name)


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
    q_params = RLAgent(hidden_dim=16, device="cpu").init(torch.Generator().manual_seed(0)).policy_params
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
    q_params = RLAgent(hidden_dim=16, device="cpu").init(torch.Generator().manual_seed(0)).policy_params
    with pytest.raises(ValueError, match="unsupported device"):
        mlp.fused_mlp_score(x, q_params)


def test_unported_features_raise():
    from pinnrl_tpu_torch.config import load_config
    from pinnrl_tpu_torch.models import PINNModel
    from pinnrl_tpu_torch.pdes import create_pde
    from pinnrl_tpu_torch.training import PDETrainer

    # SIREN, ResNet, heat, heat_2d, wave and the pendulum are ported: all build.
    siren = PINNModel(load_config(pde_type="burgers", architecture="siren", device="cpu"))
    assert siren.architecture_name == "siren" and "SIRENLayer_6.kernel" in siren.params
    assert create_pde(load_config(pde_type="heat", device="cpu")).pde_type == "heat"
    resnet = PINNModel(load_config(pde_type="burgers", architecture="resnet", device="cpu"))
    assert resnet.architecture_name == "resnet" and "ResNetBlock_6.Dense_1.weight" in resnet.params
    # The autoencoder is ported; an unknown architecture raises JAX's ValueError.
    auto = PINNModel(load_config(pde_type="burgers", architecture="autoencoder", device="cpu"))
    assert auto.architecture_name == "autoencoder" and "to_latent.weight" in auto.params
    bad = load_config(pde_type="burgers", architecture="autoencoder", device="cpu")
    bad.model.architecture = "transformer"
    with pytest.raises(ValueError, match="Unknown architecture 'transformer'"):
        PINNModel(bad)
    assert create_pde(load_config(pde_type="heat_2d", device="cpu")).dimension == 2
    assert create_pde(load_config(pde_type="wave", device="cpu")).pde_type == "wave"
    assert create_pde(load_config(pde_type="pendulum", device="cpu")).pde_type == "pendulum"
    # Cahn-Hilliard, the attention trunk and the Neumann loss are ported.
    assert create_pde(load_config(pde_type="cahn_hilliard", device="cpu")).pde_type == "cahn_hilliard"
    attention = load_config(pde_type="burgers", architecture="attention", device="cpu")
    attention.model.arch_params.update({"hidden_dim": 8, "num_layers": 1, "num_heads": 2})
    assert PINNModel(attention).architecture_name == "attention"
    neumann = load_config(pde_type="burgers", architecture="fourier", device="cpu")
    neumann.pde.boundary_conditions = {"neumann": {"value": 0.0}}
    neumann.model.hidden_dims = [8]
    neumann.model.arch_params["mapping_size"] = 4
    n_pde = create_pde(neumann)
    n_model = PINNModel(neumann)
    n_losses = n_pde.compute_loss(n_model.apply, n_model.params, torch.zeros(8, 1),
                                  torch.zeros(8, 1))
    assert bool(torch.isfinite(n_losses["boundary"]))
    # gPINN and the smoothness penalty are ported (item 10.2, item 13).
    neumann.training.loss_weights.update({"gpinn": 0.1, "smoothness": 0.1})
    g_losses = create_pde(neumann).compute_loss(n_model.apply, n_model.params, torch.rand(8, 1),
                                                torch.rand(8, 1))
    assert float(g_losses["gpinn"]) > 0.0 and float(g_losses["smoothness"]) > 0.0
    cfg = load_config(pde_type="burgers", architecture="fourier", device="cpu")
    cfg.model.hidden_dims = [8]
    cfg.model.arch_params["mapping_size"] = 4
    # The modified trunk, deep ensembles (items 12, 13), float64 residuals
    # (8b) and meshes (14c) are ported.
    cfg.model.arch_params["modified"] = True
    assert "enc_u.weight" in PINNModel(cfg).params
    cfg.model.arch_params["modified"] = False
    model, pde = PINNModel(cfg), create_pde(cfg)
    cfg.training.ensemble_size = 2
    assert PDETrainer(model, pde, cfg).members == 2
    cfg.training.ensemble_size = 1
    cfg.training.residual_dtype = "float64"
    assert PDETrainer(model, pde, cfg)._dtype == torch.float32  # float64 from the phase on
    cfg.training.residual_dtype = "float32"
    from pinnrl_tpu_torch.parallel import Mesh

    mesh = Mesh(size=1, rank=0, device=torch.device("cpu"), group=None)
    assert PDETrainer(model, pde, cfg, mesh=mesh).mesh is mesh
    with pytest.raises(ValueError, match="mesh's device"):
        PDETrainer(model, pde, cfg, mesh=Mesh(size=1, rank=0, device=torch.device("meta"),
                                              group=None))
    # The plateau scheduler, EMA, adaptive weights, hard-IC and profiler
    # traces are ported: each trainer builds.
    for field, value in (("scheduler_type", "reduce_lr"), ("param_ema", 0.9),
                         ("profile_dir", "unused")):
        old = getattr(cfg.training, field)
        setattr(cfg.training, field, value)
        PDETrainer(model, pde, cfg)
        setattr(cfg.training, field, old)
    cfg.training.adaptive_weights.enabled = True
    assert PDETrainer(model, pde, cfg).aw_enabled
    cfg.training.adaptive_weights.enabled = False
    cfg.model.hard_ic = True
    hard = PINNModel(cfg)
    assert not PDETrainer(hard, pde, cfg).fused_kernel_active and hard.output_transform is not None
