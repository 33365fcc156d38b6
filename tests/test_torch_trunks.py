"""The trunk options ported in the autoencoder / modified-MLP slice
against the JAX package on bridged parameters (CPU, small widths): the
autoencoder and the modified Fourier trunk, each with and without
LayerNorm (forward, and the residual loss with every parameter gradient on
the generic engine); the bridge's names for them and for a trainable basis;
dropout (identity with ``deterministic=True`` on every trunk that has it,
the keep rate and the 1/(1-p) scaling with ``False``); and
``PDEBase.compute_derivatives``.

Tolerances: forward 1e-6 relative to max; loss 1e-5 relative and gradients
1e-4 relative to each gradient's max (tests/test_pallas_parity_tpu.py:
152-155); derivatives 1e-5 relative to max per key (nested jvps in another
order than JAX's vmapped ones)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_helpers import (inject_points, jax_bc_ic_points, jax_grad_rels, pde_pair,
                                  points, rel_to_max, torch_params)

from pinnrl_tpu_torch.models import PINNModel
from pinnrl_tpu_torch.models.autoencoder import AutoEncoder
from pinnrl_tpu_torch.models.base import dropout
from pinnrl_tpu_torch.models.bridge import (flat_flax_arrays, params_from_flax, params_to_flax,
                                            state_from_flat_flax)

N = 64
BURGERS = dict(domain=((-1.0, 1.0),), time_domain=(0.0, 1.0))
TRUNKS = [("autoencoder", {}, True), ("autoencoder", {}, False),
          ("fourier", {"modified": True}, True), ("fourier", {"modified": True}, False)]


def _t(a):
    return torch.from_numpy(np.array(a))


def trunk_pair(arch, arch_params, layer_norm, seed=0, **kw):
    auto = arch == "autoencoder"
    return pde_pair("burgers", arch=arch, hidden=(16, 24, 16) if auto else (24, 24), mapping=8,
                    layer_norm=layer_norm, arch_params=dict(arch_params, **(
                        {"latent_dim": 6} if auto else {})), seed=seed, **kw)


@pytest.mark.parametrize("arch,arch_params,layer_norm", TRUNKS)
def test_forward_matches_jax(arch, arch_params, layer_norm):
    pair = trunk_pair(arch, arch_params, layer_norm)
    x, t = points(1, N, **BURGERS)
    z = np.concatenate([x, t], axis=1)
    ref = np.asarray(pair.jmodel.apply(pair.jmodel.params, jnp.asarray(z)))
    with torch.no_grad():
        got = pair.tmodel.apply(pair.tmodel.params, _t(z))
    assert got.shape == ref.shape == (N, 1)
    assert rel_to_max(got, ref) < 1e-6


@pytest.mark.parametrize("arch,arch_params,layer_norm", TRUNKS)
def test_residual_loss_and_gradients_match_jax(monkeypatch, arch, arch_params, layer_norm):
    """Neither trunk has a stacked-jet bundle: the residual runs on the
    generic engine in both packages, kernel 1 never."""
    pair = trunk_pair(arch, arch_params, layer_norm)
    assert not pair.tpde.attach_fast_bundle(pair.tmodel)
    assert not pair.tpde.attach_fused_residual_kernel(pair.tmodel)
    x, t = points(21, N, **BURGERS)
    key = jax.random.PRNGKey(4)

    def jtotal(p):
        losses = pair.jpde.compute_loss(pair.jmodel.apply, p, jnp.asarray(x), jnp.asarray(t),
                                        key=key)
        return losses["total"], losses

    (_, ref), g_j = jax.value_and_grad(jtotal, has_aux=True)(pair.jmodel.params)
    inject_points(monkeypatch, pair.tpde, *jax_bc_ic_points(pair.jpde, key, N))
    params = torch_params(pair.tmodel)
    got = pair.tpde.compute_loss(pair.tmodel.apply, params, _t(x), _t(t))
    for k in ("residual", "boundary", "initial", "total"):
        assert abs(float(got[k].detach()) - float(ref[k])) / abs(float(ref[k])) < 1e-5, k
    grads = dict(zip(params, torch.autograd.grad(got["total"], list(params.values()))))
    for name, rel in jax_grad_rels(grads, g_j).items():
        assert rel < 1e-4, name


def test_autoencoder_default_widths_and_names():
    """The shipped autoencoder block: 124/248/124, latent 64, flax's names."""
    from pinnrl_tpu_torch.config import load_config

    cfg = load_config(pde_type="burgers", architecture="autoencoder", device="cpu")
    module = PINNModel(cfg).module
    assert isinstance(module, AutoEncoder)
    shapes = {k: tuple(v.shape) for k, v in module.named_parameters()}
    assert shapes["encoder_layers_0.weight"] == (cfg.model.hidden_dims[0], 2)
    assert shapes["to_latent.weight"] == (64, cfg.model.hidden_dims[-1])
    assert shapes["decoder_layers_0.weight"] == (cfg.model.hidden_dims[-1], 64)
    assert shapes["to_output.weight"] == (1, cfg.model.hidden_dims[0])
    assert ("encoder_norms_2.weight" in shapes) == bool(cfg.model.layer_norm)


def test_modified_trunk_refuses_uneven_widths_as_jax():
    from pinnrl_tpu_torch.config import load_config

    cfg = load_config(pde_type="burgers", architecture="fourier", device="cpu")
    cfg.model.hidden_dims = [16, 8]
    cfg.model.arch_params.update({"mapping_size": 4, "modified": True})
    with pytest.raises(ValueError, match=r"modified MLP needs uniform hidden widths, got \(16, 8\)"):
        PINNModel(cfg)


@pytest.mark.parametrize("arch,arch_params", [("autoencoder", {}), ("fourier", {"modified": True}),
                                              ("fourier", {"trainable_features": True}),
                                              ("fourier", {"modified": True,
                                                           "trainable_features": True})])
def test_bridge_round_trip_is_exact(arch, arch_params):
    pair = trunk_pair(arch, arch_params, True)
    tree = jax.tree_util.tree_map(np.asarray, pair.jmodel.params)
    consts = jax.tree_util.tree_map(np.asarray, pair.jmodel.constants)
    state = params_from_flax(tree, consts)
    names = set(pair.tmodel.params)
    assert names == set(k for k in state if k in names) and names <= set(state)
    back, constants = params_to_flax(state, names)
    flat = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    bflat = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(back)[0]}
    assert sorted(flat) == sorted(bflat)
    for k, v in flat.items():
        assert np.array_equal(bflat[k], v), k
    trainable = arch_params.get("trainable_features", False)
    assert ("FourierFeatures_0" in back) == (trainable and arch == "fourier")
    assert bool(constants) == (arch == "fourier" and not trainable)


def test_trainable_basis_is_a_parameter_and_saves_under_params(tmp_path):
    pair = trunk_pair("fourier", {"trainable_features": True}, True)
    model = pair.tmodel
    assert "FourierFeatures_0.B" in model.params and "FourierFeatures_0.B" not in model.constants
    path = tmp_path / "final_model.npz"
    model.save_state(str(path))
    with np.load(path) as data:
        keys = set(data.files)
        assert "params/FourierFeatures_0/B" in keys
        assert not any(k.startswith("constants/") for k in keys)
        np.testing.assert_array_equal(
            data["params/FourierFeatures_0/B"],
            np.asarray(pair.jmodel.params["FourierFeatures_0"]["B"]))
    other = trunk_pair("fourier", {"trainable_features": True}, True, seed=3).tmodel
    other.load_state(str(path))
    for k, v in model.params.items():
        assert torch.equal(other.params[k], v), k
    flat = flat_flax_arrays(model.module.state_dict(), model.params)
    assert sorted(state_from_flat_flax(flat)) == sorted(model.module.state_dict())


def test_trainable_basis_takes_a_gradient_from_the_generic_engine():
    """The modified trunk with a trainable basis: B's gradient equals
    JAX's (kernel 2's vjp rule with gB on the plain path here)."""
    pair = trunk_pair("fourier", {"modified": True, "trainable_features": True}, True)
    x, t = points(8, N, **BURGERS)
    ref, g_j = jax.value_and_grad(lambda p: jnp.mean(pair.jpde.compute_residual(
        pair.jmodel.apply, p, jnp.asarray(x), jnp.asarray(t)) ** 2))(pair.jmodel.params)
    params = torch_params(pair.tmodel)
    got = torch.mean(pair.tpde.compute_residual(pair.tmodel.apply, params, _t(x), _t(t)) ** 2)
    assert abs(float(got.detach()) - float(ref)) / abs(float(ref)) < 1e-5
    grads = dict(zip(params, torch.autograd.grad(got, list(params.values()))))
    rels = jax_grad_rels(grads, g_j)
    assert "['FourierFeatures_0']['B']" in rels
    for name, rel in rels.items():
        assert rel < 1e-4, name


# ------------------------------------------------------------------ dropout

DROPOUT_TRUNKS = [("feedforward", {}), ("fourier", {}), ("fourier", {"modified": True}),
                  ("resnet", {}), ("autoencoder", {}), ("attention", {}), ("fno", {})]


def _dropout_pair(arch, arch_params, rate):
    from pinnrl_tpu.config import load_config as jax_load_config
    from pinnrl_tpu_torch.config import load_config
    from torch_parity_helpers import _pair

    extra = {"resnet": {"hidden_dim": 16, "num_blocks": 2},
             "attention": {"hidden_dim": 8, "num_layers": 1, "num_heads": 2},
             "fno": {"hidden_dim": 8, "num_blocks": 1, "modes": 4}}.get(arch, {})
    cfgs = [jax_load_config(pde_type="burgers", architecture=arch),
            load_config(pde_type="burgers", architecture=arch, device="cpu")]
    for cfg in cfgs:
        cfg.model.hidden_dims = [16, 16, 16] if arch == "autoencoder" else [16, 16]
        cfg.model.dropout = rate
        cfg.model.arch_params.update({"mapping_size": 8, "latent_dim": 4, **extra, **arch_params})
    return _pair(*cfgs, seed=0, jitter_ln=False)


@pytest.mark.parametrize("arch,arch_params", DROPOUT_TRUNKS)
def test_dropout_is_identity_when_deterministic_as_jax(arch, arch_params):
    pair = _dropout_pair(arch, arch_params, 0.3)
    x, t = points(2, N, **BURGERS)
    z = np.concatenate([x, t], axis=1)
    ref = np.asarray(pair.jmodel.apply(pair.jmodel.params, jnp.asarray(z), deterministic=True))
    with torch.no_grad():
        got = pair.tmodel.apply(pair.tmodel.params, _t(z), deterministic=True)
        plain = pair.tmodel.apply(pair.tmodel.params, _t(z))
    assert torch.equal(got, plain)
    assert rel_to_max(got, ref) < 1e-5


@pytest.mark.parametrize("arch,arch_params", DROPOUT_TRUNKS)
def test_dropout_draws_need_a_generator(arch, arch_params):
    """``deterministic=False`` draws the masks from the caller's generator
    (the same generator state gives the same output) and raises without
    one where the trunk applies dropout; JAX's autoencoder, attention and
    FNO trunks take the rate and apply none, and so do the port's."""
    pair = _dropout_pair(arch, arch_params, 0.3)
    model = pair.tmodel
    z = _t(np.concatenate(points(3, N, **BURGERS), axis=1))
    applies = arch in ("feedforward", "fourier", "resnet")
    with torch.no_grad():
        det = model.apply(model.params, z)
        if applies:
            with pytest.raises(ValueError, match="needs a torch.Generator"):
                model.apply(model.params, z, deterministic=False)
        a = model.apply(model.params, z, False, torch.Generator().manual_seed(5))
        b = model.apply(model.params, z, False, torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    assert torch.equal(a, det) != applies


def test_dropout_keep_rate_and_scale():
    """flax's Dropout: each entry kept with probability 1 - p and scaled by
    1 / (1 - p), zero otherwise."""
    p = 0.3
    x = torch.full((400, 500), 2.0)
    out = dropout(x, p, False, torch.Generator().manual_seed(0))
    kept = out != 0
    assert abs(float(kept.float().mean()) - (1 - p)) < 0.005  # 200k draws: sd ~0.001
    assert torch.allclose(out[kept], torch.tensor(2.0 / (1 - p)))
    assert torch.equal(dropout(x, p, True, None), x)
    assert torch.equal(dropout(x, 0.0, False, None), x)
    assert not dropout(x, 1.0, False, torch.Generator()).any()


def test_jax_dropout_statistics_match():
    """The same statistics from flax's Dropout (its masks come from
    threefry, the port's from torch: distributions, not bits)."""
    import flax.linen as nn

    x = jnp.full((400, 500), 2.0)
    out = np.asarray(nn.Dropout(0.3, deterministic=False).apply(
        {}, x, rngs={"dropout": jax.random.PRNGKey(0)}))
    kept = out != 0
    assert abs(kept.mean() - 0.7) < 0.005 and np.allclose(out[kept], 2.0 / 0.7)


# ------------------------------------------------------- compute_derivatives


@pytest.mark.parametrize("pde_type,dim,spatial,temporal", [
    ("burgers", 1, (1, 2), (1,)), ("heat", 2, (1, 2), (1, 2)), ("burgers", 1, (1, 2, 3), (1,))])
def test_compute_derivatives_matches_jax(pde_type, dim, spatial, temporal):
    pair = pde_pair(pde_type, hidden=(16, 16), mapping=8, dim=dim if dim > 1 else None)
    dom = dict(domain=tuple(tuple(d) for d in pair.tcfg.pde.domain),
               time_domain=tuple(pair.tcfg.pde.time_domain))
    x, t = points(7, 32, **dom)
    ref = pair.jpde.compute_derivatives(pair.jmodel.apply, pair.jmodel.params, jnp.asarray(x),
                                        jnp.asarray(t), spatial, temporal)
    got = pair.tpde.compute_derivatives(pair.tmodel.apply, pair.tmodel.params, _t(x), _t(t),
                                        spatial, temporal)
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        assert got[k].shape == (32, 1) == v.shape, k
        assert rel_to_max(got[k], np.asarray(v)) < 1e-5, k
