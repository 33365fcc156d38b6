"""The ResNet trunk: the port against pinnrl_tpu on bridged weights (nested
parameter names), under the generic engine (nested jvp to order 2), and
the shipped defaults that name it (pendulum, Burgers).

Tolerances:
- forward: 1e-6 relative to max (float32, the same operations);
- residuals (order 2, plain-op LayerNorm inside the jvps): 1e-5 relative to
  max (tests/test_torch_jet.py's bound for orders <= 2);
- compute_loss: each component 1e-5 relative and each parameter gradient
  1e-4 relative to its max, the JAX suite's fused-kernel bounds
  (tests/test_pallas_parity_tpu.py:152-155).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_helpers import (_pair, jax_grad_rels, inject_points, jax_bc_ic_points,
                                  jax_velocity_points, points, rel_to_max, torch_params)

from pinnrl_tpu_torch.models import PINNModel
from pinnrl_tpu_torch.models.bridge import params_from_flax, params_to_flax
from pinnrl_tpu_torch.models.resnet import ResNet
from pinnrl_tpu_torch.training import PDETrainer

N = 64
DOMAINS = {"burgers": dict(domain=((-1.0, 1.0),), time_domain=(0.0, 1.0)),
           "pendulum": dict(domain=((0.0, 3.14159),), time_domain=(0.0, 10.0))}


def _t(a):
    return torch.from_numpy(np.array(a))


def resnet_pair(pde_type, hidden=32, blocks=2, seed=0):
    """The shipped ``pde_type`` block on its ResNet default at ``hidden`` x
    ``blocks`` in both packages, bridged, LayerNorm scale/bias jittered;
    BC/IC counts 32 each."""
    from pinnrl_tpu.config import load_config as jax_load_config
    from pinnrl_tpu_torch.config import load_config

    cfgs = [jax_load_config(pde_type=pde_type, architecture="resnet"),
            load_config(pde_type=pde_type, architecture="resnet", device="cpu")]
    for cfg in cfgs:
        cfg.model.arch_params.update({"hidden_dim": hidden, "num_blocks": blocks})
        cfg.training.num_boundary_points = cfg.training.num_initial_points = 32
    return _pair(*cfgs, seed=seed, jitter_ln=True)


def test_forward_matches_jax():
    pair = resnet_pair("burgers", blocks=3)
    assert isinstance(pair.tmodel.module, ResNet)
    assert "ResNetBlock_2.LayerNorm_1.weight" in pair.tmodel.params
    x, t = points(1, N, **DOMAINS["burgers"])
    z = np.concatenate([x, t], axis=1)
    ref = pair.jmodel.apply(pair.jmodel.params, jnp.asarray(z))
    with torch.no_grad():
        got = pair.tmodel.apply(pair.tmodel.params, torch.from_numpy(z))
    assert got.shape == ref.shape == (N, 1)
    assert rel_to_max(got, np.asarray(ref)) < 1e-6


def test_bridge_round_trip_of_a_resnet_tree_is_exact():
    pair = resnet_pair("burgers")
    tree = jax.tree_util.tree_map(np.asarray, pair.jmodel.params)
    back, constants = params_to_flax(params_from_flax(tree))
    assert constants == {}
    flat = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    back_flat = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert sorted(map(jax.tree_util.keystr, flat)) == sorted(map(jax.tree_util.keystr, back_flat))
    by_name = {jax.tree_util.keystr(p): v for p, v in back_flat.items()}
    for p, v in flat.items():
        assert np.array_equal(by_name[jax.tree_util.keystr(p)], v)
    # The flat names of the other trunks keep their rule.
    assert sorted(params_from_flax({"Dense_0": {"kernel": np.ones((2, 3), np.float32)}})) == [
        "Dense_0.weight"]


@pytest.mark.parametrize("pde_type", ["burgers", "pendulum"])
def test_residual_through_nested_jvp_matches_jax(pde_type):
    """ResNet has no stacked-jet bundle: the residual runs on the generic
    engine (two nested jvps) in both packages."""
    pair = resnet_pair(pde_type)
    assert not pair.jpde.attach_fast_bundle(pair.jmodel)
    assert not pair.tpde.attach_fast_bundle(pair.tmodel)
    x, t = points(5, N, **DOMAINS[pde_type])
    ref = pair.jpde.compute_residual(pair.jmodel.apply, pair.jmodel.params, jnp.asarray(x),
                                     jnp.asarray(t))
    with torch.no_grad():
        got = pair.tpde.compute_residual(pair.tmodel.apply, pair.tmodel.params, _t(x), _t(t))
    assert got.shape == (N, 1)
    assert rel_to_max(got, np.asarray(ref)) < 1e-5


@pytest.mark.parametrize("pde_type", ["burgers", "pendulum"])
def test_compute_loss_and_gradients_match_jax(monkeypatch, pde_type):
    """Pendulum's shipped block (small-angle IC, its "periodic"-typed
    Dirichlet entry a zero target) adds the velocity IC."""
    pair = resnet_pair(pde_type)
    x, t = points(21, N, **DOMAINS[pde_type])
    key = jax.random.PRNGKey(4)

    def jtotal(p):
        losses = pair.jpde.compute_loss(pair.jmodel.apply, p, jnp.asarray(x), jnp.asarray(t), key=key)
        return losses["total"], losses

    (_, ref), g_j = jax.value_and_grad(jtotal, has_aux=True)(pair.jmodel.params)
    velocity = jax_velocity_points(pair.jpde, key, N) if pde_type == "pendulum" else None
    inject_points(monkeypatch, pair.tpde, *jax_bc_ic_points(pair.jpde, key, N), velocity=velocity)
    params = torch_params(pair.tmodel)
    got = pair.tpde.compute_loss(pair.tmodel.apply, params, _t(x), _t(t))
    for k in ("residual", "boundary", "initial", "total"):
        assert abs(float(got[k].detach()) - float(ref[k])) / abs(float(ref[k])) < 1e-5, k
    grads = dict(zip(params, torch.autograd.grad(got["total"], list(params.values()))))
    for name, rel in jax_grad_rels(grads, g_j).items():
        assert rel < 1e-4, name


def test_shipped_pendulum_default_builds_resnet_512x7():
    """``load_config(pde_type="pendulum")`` names a ResNet 512 x 7: the port
    builds the JAX package's parameter tree, shape for shape."""
    from pinnrl_tpu.config import load_config as jax_load_config
    from pinnrl_tpu.models import PINNModel as JaxModel
    from pinnrl_tpu_torch.config import load_config

    tcfg = load_config(pde_type="pendulum", device="cpu")
    assert tcfg.model.architecture == "resnet"
    assert (tcfg.model.hidden_dim, tcfg.model.num_blocks) == (512, 7)
    tmodel = PINNModel(tcfg, seed=0)
    jparams = JaxModel(jax_load_config(pde_type="pendulum"), seed=0).params
    shapes, _ = params_to_flax(tmodel.params)
    assert (jax.tree_util.tree_map(np.shape, shapes)
            == jax.tree_util.tree_map(np.shape, jax.tree_util.tree_map(np.asarray, jparams)))
    assert tmodel.count_parameters() == sum(np.size(v) for v in jax.tree_util.tree_leaves(jparams))


def test_shipped_pendulum_trains_on_the_generic_engine():
    """Two Adam epochs of the shipped pendulum block on a narrow ResNet: the
    generic path, finite losses."""
    pair = resnet_pair("pendulum", hidden=16)
    t = pair.tcfg.training
    t.num_collocation_points, t.batch_size = 128, 64
    pair.tcfg.evaluation.num_points = 64
    trainer = PDETrainer(pair.tmodel, pair.tpde, pair.tcfg)
    assert not trainer.fast_bundle_active and not trainer.fused_kernel_active
    hist = trainer.train(num_epochs=2, seed=0)["history"]
    assert len(hist["train_loss"]) == 2
    assert all(np.isfinite(v) for v in hist["train_loss"] + hist["val_loss"])


def test_dropout_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP item 12"):
        ResNet(2, 1, hidden_dim=8, num_blocks=1, dropout=0.1)
