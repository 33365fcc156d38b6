"""Multi-stage correction training in the port (``training/multistage.py``)
against pinnrl_tpu's: JAX's six tests of ``tests/test_multistage.py`` on the
port, and the composed predictor, its input tangents and the frozen base
against JAX's on bridged weights."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch_parity_helpers import bridge

from pinnrl_tpu.models import PINNModel as JaxModel
from pinnrl_tpu.training.multistage import correction_model as jax_correction_model
from pinnrl_tpu_torch.config import load_config
from pinnrl_tpu_torch.models import PINNModel
from pinnrl_tpu_torch.pdes import create_pde
from pinnrl_tpu_torch.training import PDETrainer, StageSpec, correction_model, run_multistage
from pinnrl_tpu_torch.training.multistage import _auto_eps, _stage_config
from tests.test_utils import tiny_config as jax_tiny_config


def tiny_config(pde_type="heat", architecture="fourier", **training_overrides):
    """``tests.test_utils.tiny_config`` in the port, on the CPU."""
    cfg = load_config(pde_type=pde_type, architecture=architecture, device="cpu")
    cfg.model.hidden_dims = [16, 16]
    cfg.model.arch_params.setdefault("mapping_size", 8)
    t = cfg.training
    t.num_epochs, t.batch_size, t.num_collocation_points = 2, 32, 64
    t.num_boundary_points = t.num_initial_points = 32
    t.validation_frequency = 1
    for k, v in training_overrides.items():
        setattr(t, k, v)
    return cfg


def _trained_base(cfg):
    pde = create_pde(cfg)
    model = PINNModel(cfg, seed=0)
    trainer = PDETrainer(model, pde, cfg)
    res = trainer.train(seed=0)
    return pde, model, trainer._final_state["params"]["net"], res


def test_correction_model_eps_zero_is_identity():
    cfg = tiny_config()
    pde, model, params, _ = _trained_base(cfg)
    m2 = correction_model(cfg, model.apply, params, eps=0.0, seed=7)
    z = torch.linspace(0.0, 1.0, 10).reshape(5, 2)
    with torch.no_grad():
        np.testing.assert_allclose(m2.apply(m2.params, z).numpy(), model.apply(params, z).numpy(),
                                   rtol=1e-6)


def test_correction_model_composes_additively():
    cfg = tiny_config()
    pde, model, params, _ = _trained_base(cfg)
    z = torch.rand((8, 2), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        base = model.apply(params, z)
        m_full = correction_model(cfg, model.apply, params, eps=1.0, seed=7)
        m_half = correction_model(cfg, model.apply, params, eps=0.5, seed=7)
        raw = m_full.apply(m_full.params, z) - base
        np.testing.assert_allclose((m_half.apply(m_half.params, z) - base).numpy(),
                                   (0.5 * raw).numpy(), rtol=1e-5, atol=1e-7)


def test_input_tangents_flow_through_frozen_base():
    cfg = tiny_config()
    pde, model, params, _ = _trained_base(cfg)
    m2 = correction_model(cfg, model.apply, params, eps=0.0, seed=7)
    z0 = torch.tensor([0.4, 0.1])
    g_base = torch.func.jacfwd(lambda z: model.apply(params, z))(z0)
    g_comp = torch.func.jacfwd(lambda z: m2.apply(m2.params, z))(z0)
    np.testing.assert_allclose(g_comp.detach().numpy(), g_base.detach().numpy(), rtol=1e-5)
    assert float(g_base.detach().abs().sum()) > 0.0


def test_run_multistage_end_to_end():
    cfg = tiny_config()
    res = run_multistage(cfg, [StageSpec(epochs=2)], seed=0)
    assert len(res.models) == 2 and len(res.stage_metrics) == 2 and len(res.eps_history) == 1
    assert res.eps_history[0] > 0.0
    assert all(np.isfinite(m["rel_l2"]) for m in res.stage_metrics)
    z = torch.rand((16, 2), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        assert bool(torch.isfinite(res.apply_fn(res.params, z)).all())


def test_stage_config_overrides():
    cfg = tiny_config()
    cfg.model.arch_params["scale"] = 1.0
    cfg2 = _stage_config(cfg, StageSpec(epochs=5, learning_rate=1e-4, mapping_size=4))
    assert cfg2.training.num_epochs == 5
    assert cfg2.training.optimizer_config.learning_rate == 1e-4
    assert cfg2.model.arch_params["mapping_size"] == 4
    assert cfg2.model.arch_params["scale"] == 2.0  # scale_mult 2 by default
    assert cfg.training.num_epochs == 2 and cfg.model.arch_params["scale"] == 1.0


def test_auto_eps_uses_validation_error():
    cfg = tiny_config()
    pde, model, params, res = _trained_base(cfg)
    eps = _auto_eps(pde, model.apply, params, res["final_train_loss"])
    assert eps == np.sqrt(pde.validate(model.apply, params, num_points=4096)["l2_error"])


def _bridged_pair():
    """A base and a correction model in both packages on the same weights:
    the correction's base is the bridged base."""
    jcfg, tcfg = jax_tiny_config(architecture="fourier"), tiny_config()
    jbase, tbase = JaxModel(jcfg, seed=0), PINNModel(tcfg, seed=0)
    bridge(jbase, tbase)
    jcorr = jax_correction_model(jcfg, jbase.apply, jbase.params, eps=0.3, seed=7)
    tcorr = correction_model(tcfg, tbase.apply, tbase.params, eps=0.3, seed=7)
    bridge(jcorr, tcorr)
    return jcorr, tcorr, tbase


def test_composed_predictor_and_tangents_match_jax():
    """The composed predictor at 1e-6 and its input tangents (d/dx, d/dt)
    through the frozen base against ``jax.jvp`` at 1e-5."""
    jcorr, tcorr, _ = _bridged_pair()
    z = np.random.default_rng(4).random((64, 2)).astype(np.float32)
    ref = np.asarray(jcorr.apply(jcorr.params, jnp.asarray(z)))
    with torch.no_grad():
        got = tcorr.apply(tcorr.params, torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())
    for axis in range(2):
        e = np.zeros_like(z)
        e[:, axis] = 1.0
        dj = jax.jvp(lambda zz: jcorr.apply(jcorr.params, zz), (jnp.asarray(z),),
                     (jnp.asarray(e),))[1]
        dt = torch.func.jvp(lambda zz: tcorr.apply(tcorr.params, zz), (torch.from_numpy(z),),
                            (torch.from_numpy(e),))[1]
        np.testing.assert_allclose(dt.detach().numpy(), np.asarray(dj), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(np.asarray(dj)).max()))


def test_correction_training_leaves_the_base_unchanged():
    """The correction stage's training moves its own network only: the
    composed predictor minus eps times the raw network is still the base,
    and the base model's parameters are as they were."""
    jcorr, tcorr, tbase = _bridged_pair()
    before = {k: v.detach().clone() for k, v in tbase.params.items()}
    cfg = tiny_config()
    trainer = PDETrainer(tcorr, create_pde(cfg), cfg)
    assert not trainer.fused_kernel_active and not trainer.fast_bundle_active
    corr_before = {k: v.detach().clone() for k, v in tcorr.params.items()}
    trainer.train(seed=0)
    assert any(not torch.equal(v, corr_before[k]) for k, v in tcorr.params.items())
    for k, v in tbase.params.items():
        assert torch.equal(v, before[k]), k
    z = torch.rand((32, 2), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        composed = tcorr.apply(tcorr.params, z)
        transform, tcorr.output_transform = tcorr.output_transform, None
        raw = tcorr.apply(tcorr.params, z)
        tcorr.output_transform = transform
        base = tbase.apply(before, z)
    np.testing.assert_allclose((composed - 0.3 * raw).numpy(), base.numpy(), rtol=0, atol=1e-6)
