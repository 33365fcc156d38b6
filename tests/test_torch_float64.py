"""Float64 residuals (``training.residual_dtype="float64"``) in the port
against the JAX package.

Tolerances:
- one float64 loss and each parameter gradient on a fixed batch against
  JAX's under x64, on the same BC/IC draws: 1e-10 relative (to max for the
  gradients); the same operations in float64;
- dtypes: exact. The phase's parameters, batches and draws are float64;
  ``model.params`` end float32 and ``_final_state`` keeps float64;
- kernels 2 and 3: float64 reaches the plain version by the JAX kernels'
  dtype gate, float32 the CUDA launch (a dispatch test with stand-in
  tensors: the card's side is in ``chip_smoke.py``).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_helpers import (burgers_pair, heat_pair, inject_periodic_draws, inject_points,
                                  jax_bc_ic_points, jax_grad_rels, points, siren_kdv_pair,
                                  HEAT_DOMAIN, KDV_DOMAIN)

from pinnrl_tpu.training import PDETrainer as JaxTrainer
from pinnrl_tpu_torch.config import load_config
from pinnrl_tpu_torch.models import PINNModel
from pinnrl_tpu_torch.ops.kernels import fourier_feats, siren
from pinnrl_tpu_torch.pdes import create_pde
from pinnrl_tpu_torch.training import PDETrainer

F64_TOL = 1e-10


def _f64_tree(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float64)), tree)


def _case(name):
    """(pair, (x, t) float64 arrays) of one small problem."""
    if name == "burgers":
        return burgers_pair(hidden=(16, 16), mapping=8), points(3, 128)
    if name == "heat":
        return heat_pair(), points(4, 128, **HEAT_DOMAIN)
    return siren_kdv_pair(hidden=(16, 16)), points(5, 96, **KDV_DOMAIN)


@pytest.mark.parametrize("name", ["burgers", "heat", "siren_kdv"])
def test_float64_loss_and_gradients_match_jax_x64(monkeypatch, name):
    pair, (x, t) = _case(name)
    x, t = x.astype(np.float64), t.astype(np.float64)
    key = jax.random.PRNGKey(11)
    jtr = JaxTrainer(pair.jmodel, pair.jpde, pair.jcfg)
    ttr = PDETrainer(pair.tmodel, pair.tpde, pair.tcfg)
    with jax.enable_x64(True):
        jparams = {"net": _f64_tree(pair.jmodel.params), "coeffs": {}}

        def total(p):
            return jtr._loss_components(p, jnp.asarray(x), jnp.asarray(t), key)["total"]

        l_j, g_j = jax.jit(jax.value_and_grad(total))(jparams)
        assert l_j.dtype == jnp.float64
        # The draws JAX's loss took, in float64 as x64 makes them.
        if name == "heat":
            inject_periodic_draws(monkeypatch, pair, key, 128)
        else:
            inject_points(monkeypatch, pair.tpde, *jax_bc_ic_points(pair.jpde, key, x.shape[0]))
    params = {k: v.detach().double().requires_grad_(True) for k, v in pair.tmodel.params.items()}
    losses = ttr._loss_components(params, torch.from_numpy(x), torch.from_numpy(t), None)
    assert losses["total"].dtype == torch.float64
    losses["total"].backward()
    assert abs(float(losses["total"]) - float(l_j)) <= F64_TOL * abs(float(l_j))
    rels = jax_grad_rels({k: v.grad for k, v in params.items()}, g_j["net"])
    assert max(rels.values()) < F64_TOL, rels


def _tiny(**training):
    """The JAX suite's tiny heat config (tests/test_utils.py) in the port."""
    cfg = load_config(pde_type="heat", architecture="feedforward", device="cpu")
    cfg.model.hidden_dims = [16, 16]
    t = cfg.training
    t.num_epochs, t.batch_size, t.num_collocation_points = 2, 32, 64
    t.num_boundary_points = t.num_initial_points = 32
    t.validation_frequency = 1
    for k, v in training.items():
        setattr(t, k, v)
    return cfg


def _recording_trainer(monkeypatch, cfg):
    """A trainer whose every loss records (phase, parameter dtype, batch
    dtype, BC/IC draw dtype, kernel 1 used)."""
    tr = PDETrainer(PINNModel(cfg, seed=0), create_pde(cfg), cfg)
    seen = []
    loss = tr._loss_components

    def recording(params, x, t, generator, coeffs=None):
        out = loss(params, x, t, generator, coeffs)
        seen.append((next(iter(params.values())).dtype, x.dtype, tr.pde.dtype))
        return out

    monkeypatch.setattr(tr, "_loss_components", recording)
    return tr, seen


def test_adam_lbfgs_float64_phase(monkeypatch):
    """tests/test_trainer.py's f64 polish: Adam in float32, the L-BFGS
    phase in float64 on float64 batches and draws, kernel 1 on every Adam
    loss and never in the phase; float32 model parameters at the end and a
    float64 final state."""
    cfg = _tiny(optimizer="adam_lbfgs", num_epochs=4, residual_dtype="float64")
    cfg.training.adam_lbfgs_switch_ratio = 0.5
    cfg.model.architecture = "fourier"
    cfg.model.arch_params.update({"mapping_size": 8, "periodic": True})
    tr, seen = _recording_trainer(monkeypatch, cfg)
    assert tr.fused_kernel_active
    calls = []
    fused = tr.pde._fused_residual_loss
    monkeypatch.setattr(tr.pde, "_fused_residual_loss",
                        lambda p, z: calls.append(len(seen)) or fused(p, z))
    res = tr.train()
    assert res["status"] == "completed" and np.isfinite(res["final_train_loss"])
    f32 = (torch.float32,) * 3
    f64 = (torch.float64,) * 3
    # Adam: 2 epochs of 2 steps and a validation each; then the phase.
    adam = [f32] * 3 + [f32] * 3
    assert seen[:6] == adam and len(seen) > 6 and all(s == f64 for s in seen[6:]), seen
    assert calls == [0, 1, 2, 3, 4, 5]
    assert all(v.dtype == torch.float64 for v in tr._final_state["params"]["net"].values())
    assert all(v.dtype == torch.float32 for v in tr.model.params.values())
    assert tr.pde.dtype == torch.float32
    # The final state evaluates in float64; the model in float32.
    z = torch.rand((16, 2), generator=torch.Generator().manual_seed(0)) * torch.tensor([2.0, 1.0])
    assert tr.model.apply(tr._final_state["params"]["net"], z).dtype == torch.float64
    assert tr.model(z).dtype == torch.float32


def test_phase2_adam_float64_finetune(monkeypatch):
    """tests/test_trainer.py's phase-2 Adam fine-tune: fresh float64
    batches after the switch."""
    cfg = _tiny(optimizer="adam_lbfgs", num_epochs=6, residual_dtype="float64",
                phase2_optimizer="adam", phase2_learning_rate=1e-4)
    cfg.training.adam_lbfgs_switch_ratio = 0.5
    cfg.training.lbfgs.batch_size = 16
    tr, seen = _recording_trainer(monkeypatch, cfg)
    res = tr.train()
    assert res["status"] == "completed" and np.isfinite(res["final_train_loss"])
    assert len(tr.history["train_loss"]) == 6
    phase = seen[-6:]  # 3 epochs of one step of 16 and a validation each
    assert all(s == (torch.float64,) * 3 for s in phase), seen
    assert all(v.dtype == torch.float64 for v in tr._final_state["params"]["net"].values())
    assert all(v.dtype == torch.float32 for v in tr.model.params.values())


def test_pure_lbfgs_float64_from_the_start(monkeypatch):
    cfg = _tiny(optimizer="lbfgs", num_epochs=2, residual_dtype="float64")
    cfg.training.lbfgs.batch_size = 16
    tr, seen = _recording_trainer(monkeypatch, cfg)
    assert tr.train()["status"] == "completed"
    assert seen and all(s == (torch.float64,) * 3 for s in seen)


@pytest.mark.parametrize("optimizer", ["adam_lbfgs", "lbfgs"])
def test_checkpoint_in_the_float64_phase_resumes_in_float64(monkeypatch, tmp_path, caplog,
                                                            optimizer):
    """A checkpoint of the float64 phase holds float64 parameters and
    optimizer state; a run resumed from it continues in float64 (at the
    switch's fresh L-BFGS, or on the restored L-BFGS memory)."""
    cfg = _tiny(optimizer=optimizer, num_epochs=4, residual_dtype="float64")
    cfg.training.adam_lbfgs_switch_ratio = 0.5
    first = PDETrainer(PINNModel(cfg, seed=0), create_pde(cfg), cfg)
    first.train(experiment_dir=str(tmp_path / "exp"))
    with np.load(tmp_path / "exp" / "checkpoint.npz") as data:
        assert data["params/Dense_0/kernel"].dtype == np.float64
        assert data["opt/lbfgs/s_memory"].dtype == np.float64
        assert str(data["opt/kind"]) == "lbfgs"
    final = first._final_state["params"]["net"]

    cfg2 = _tiny(optimizer=optimizer, num_epochs=6, residual_dtype="float64")
    cfg2.training.adam_lbfgs_switch_ratio = 0.5
    tr, seen = _recording_trainer(monkeypatch, cfg2)
    restored = {}
    load = tr._load_checkpoint

    def loading(*args):
        epoch = load(*args)
        restored.update({k: v.detach().clone() for k, v in tr.model.params.items()})
        return epoch

    monkeypatch.setattr(tr, "_load_checkpoint", loading)
    res = tr.train(resume_from=str(tmp_path / "exp" / "checkpoint.npz"))
    assert res["status"] == "completed" and len(tr.history["train_loss"]) == 6
    # Pure L-BFGS restores its float64 memory; adam_lbfgs's Adam template
    # keeps its fresh state, and the switch builds the phase's L-BFGS.
    assert ("could not restore" in caplog.text) == (optimizer == "adam_lbfgs")
    for k, v in final.items():
        assert restored[k].dtype == torch.float64 and torch.equal(restored[k], v), k
    assert seen and all(s == (torch.float64,) * 3 for s in seen), seen
    assert all(v.dtype == torch.float32 for v in tr.model.params.values())


def test_float64_ensemble_refused_as_in_jax():
    pair = burgers_pair(hidden=(8,), mapping=4)
    for cfg in (pair.jcfg, pair.tcfg):
        cfg.training.ensemble_size = 2
        cfg.training.residual_dtype = "float64"
    with pytest.raises(ValueError) as ref:
        JaxTrainer(pair.jmodel, pair.jpde, pair.jcfg)._validate_ensemble()
    tt = PDETrainer(pair.tmodel, pair.tpde, pair.tcfg)
    with pytest.raises(ValueError) as got:
        tt.train(num_epochs=1)
    assert str(got.value) == str(ref.value)
    assert "residual_dtype must be float32" in str(got.value)


# ------------------------------------------------------------ kernels 2, 3


def _cuda_like(dtype):
    """A stand-in for a CUDA tensor: what the wrappers' dispatch reads."""
    return SimpleNamespace(is_cpu=False, is_cuda=True, dtype=dtype, device=torch.device("cuda"),
                           requires_grad=False)


@pytest.mark.parametrize("x_dtype,b_dtype,route", [
    (torch.float32, torch.float32, "cuda"),
    (torch.float64, torch.float32, "plain"),
    (torch.float32, torch.float64, "plain"),
    (torch.float64, torch.float64, "plain"),
])
def test_fourier_features_dtype_gate(monkeypatch, x_dtype, b_dtype, route):
    calls = []
    monkeypatch.setattr(fourier_feats, "fourier_features_plain", lambda x, B, s: calls.append("plain"))
    monkeypatch.setattr(fourier_feats, "fourier_features_cuda", lambda x, B, s: calls.append("cuda"))
    monkeypatch.setattr(fourier_feats, "needs_rules", lambda x, B: False)
    before = fourier_feats.fourier_features.plain_f64
    fourier_feats.fourier_features(_cuda_like(x_dtype), _cuda_like(b_dtype), True)
    assert calls == [route]
    assert fourier_feats.fourier_features.plain_f64 - before == (route == "plain")


@pytest.mark.parametrize("x_dtype,w_dtype,route", [
    (torch.float32, torch.float32, "cuda"),
    (torch.float64, torch.float32, "plain"),
    (torch.float32, torch.float64, "plain"),
    (torch.float64, torch.float64, "plain"),
])
def test_siren_layer_dtype_gate(monkeypatch, x_dtype, w_dtype, route):
    calls = []
    monkeypatch.setattr(siren, "siren_layer_plain", lambda x, W, b, om: calls.append("plain"))
    monkeypatch.setattr(siren, "_SirenFn",
                        SimpleNamespace(apply=lambda x, W, b, om, launch: calls.append(
                            "cuda" if launch is siren.siren_layer_cuda else launch)))
    before = siren.siren_layer.plain_f64
    siren.siren_layer(_cuda_like(x_dtype), _cuda_like(w_dtype), _cuda_like(w_dtype), 30.0)
    assert calls == [route]
    assert siren.siren_layer.plain_f64 - before == (route == "plain")


def test_plain_versions_promote_mixed_dtypes():
    """float32 points into a float64 basis or layer give float64, as jnp
    promotes them."""
    g = torch.Generator().manual_seed(0)
    x = torch.rand((8, 2), generator=g)
    B = torch.randn((2, 4), generator=g, dtype=torch.float64)
    got = fourier_feats.fourier_features_plain(x, B, True)
    assert got.dtype == torch.float64
    assert torch.equal(got, fourier_feats.fourier_features_plain(x.double(), B, True))
    W, b = torch.randn((2, 4), generator=g, dtype=torch.float64), torch.zeros(4, dtype=torch.float64)
    got = siren.siren_layer_plain(x, W, b, 30.0)
    assert got.dtype == torch.float64
    assert torch.equal(got, siren.siren_layer_plain(x.double(), W, b, 30.0))
