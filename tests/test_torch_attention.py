"""The attention trunk: the port against pinnrl_tpu's ``AttentionNetwork``
on bridged weights (nested flax names), under the generic engine, and the
Cahn-Hilliard headline's loss on it.

Tolerances:
- forward: 1e-6 relative to max (float32, the same operations; the
  softmax over one key is exactly 1 on both sides);
- the order-1 and order-2 jvps of the 2-channel restriction: 1e-5 relative
  to max (tests/test_torch_jet.py's bound for orders <= 2);
- compute_loss of the headline's mixed 2-D form (Dirichlet and Neumann
  BCs): each component 1e-5 relative and each parameter gradient 1e-4
  relative to its max (tests/test_pallas_parity_tpu.py:152-155); the query
  and key projections' gradients, 0 in exact arithmetic (the softmax over
  one key is constant), below 1e-9 of the largest gradient on both sides;
- the bridge round trip and the shipped parameter tree: exact.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_helpers import (ch_pair, inject_loss_draws, jax_grad_rels, jax_loss_draws,
                                  points, rel_to_max, torch_params)

from pinnrl_tpu.ops.derivatives import directional_derivative as jax_dd
from pinnrl_tpu_torch.models import PINNModel
from pinnrl_tpu_torch.models.attention import AttentionNetwork
from pinnrl_tpu_torch.models.base import ACTIVATIONS
from pinnrl_tpu_torch.models.bridge import params_from_flax, params_to_flax
from pinnrl_tpu_torch.ops.derivatives import directional_derivative

SMALL = {"hidden_dim": 16, "num_layers": 2, "num_heads": 4}
DOMAIN = dict(domain=((-0.5, 0.5), (-0.5, 0.5)), time_domain=(0.0, 1.0))


def _t(a):
    return torch.from_numpy(np.array(a))


def attention_pair(arch_params=SMALL):
    """The headline recipe's problem (mixed form, 2-D standing interface,
    Dirichlet and zero-Neumann) on a small attention trunk, bridged."""
    return ch_pair("mixed", 2, arch="attention", arch_params=arch_params)


def test_forward_matches_jax():
    pair = attention_pair()
    assert isinstance(pair.tmodel.module, AttentionNetwork)
    assert "SelfAttention_1.Dense_3.weight" in pair.tmodel.params
    assert "FeedForwardBlock_1.LayerNorm_0.bias" in pair.tmodel.params
    x, t = points(1, 64, **DOMAIN)
    z = np.concatenate([x, t], axis=1)
    ref = np.asarray(pair.jmodel.apply(pair.jmodel.params, jnp.asarray(z)))
    with torch.no_grad():
        got = pair.tmodel.apply(pair.tmodel.params, torch.from_numpy(z))
    assert got.shape == ref.shape == (64, 2)
    assert rel_to_max(got, ref) < 1e-6


def test_bridge_round_trip_of_an_attention_tree_is_exact():
    pair = attention_pair()
    tree = jax.tree_util.tree_map(np.asarray, pair.jmodel.params)
    assert sorted(tree) == ["Dense_0", "Dense_1", "FeedForwardBlock_0", "FeedForwardBlock_1",
                            "SelfAttention_0", "SelfAttention_1"]
    assert sorted(tree["SelfAttention_0"]) == ["Dense_0", "Dense_1", "Dense_2", "Dense_3",
                                               "LayerNorm_0"]
    back, constants = params_to_flax(params_from_flax(tree))
    assert constants == {}
    flat = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    back_flat = {jax.tree_util.keystr(p): v
                 for p, v in jax.tree_util.tree_flatten_with_path(back)[0]}
    assert sorted(flat) == sorted(back_flat)
    for k, v in flat.items():
        assert np.array_equal(back_flat[k], v), k


@pytest.mark.parametrize("axis,order", [(0, 2), (1, 2), (2, 1)])
def test_nested_jvp_of_the_two_channel_restriction_matches_jax(axis, order):
    """jvps of z -> net(z)[:2] (the mixed residual's uvec), batched here,
    per point under vmap in JAX."""
    pair = attention_pair()
    x, t = points(5, 32, **DOMAIN)
    z = np.concatenate([x, t], axis=1)

    def uvec_j(zz):
        return jnp.reshape(pair.jmodel.apply(pair.jmodel.params, zz), (-1,))[:2]

    ref = jax.jit(jax.vmap(lambda zz: jax_dd(uvec_j, zz, axis, order)[order - 1]))(jnp.asarray(z))

    def uvec(zz):
        return pair.tmodel.apply(pair.tmodel.params, zz).reshape(zz.shape[0], -1)[:, :2]

    with torch.no_grad():
        got = directional_derivative(uvec, torch.from_numpy(z), axis, order)[order - 1]
    assert got.shape == (32, 2)
    assert rel_to_max(got, np.asarray(ref)) < 1e-5


def test_headline_compute_loss_and_gradients_match_jax(monkeypatch):
    """The headline's loss (mixed residual, Dirichlet exact trace, Neumann
    zero, stationary IC) on JAX's draws, with every gradient."""
    pair = attention_pair({"hidden_dim": 8, "num_layers": 1, "num_heads": 2})
    assert list(pair.tpde.boundary_conditions) == ["dirichlet", "neumann", "initial"]
    x, t = points(21, 32, **DOMAIN)
    key = jax.random.PRNGKey(4)

    def total(p):
        losses = pair.jpde.compute_loss(pair.jmodel.apply, p, jnp.asarray(x), jnp.asarray(t),
                                        key=key)
        return losses["total"], losses

    (_, ref), g_j = jax.jit(jax.value_and_grad(total, has_aux=True))(pair.jmodel.params)
    inject_loss_draws(monkeypatch, pair.tpde, jax_loss_draws(pair.jpde, key, 32))
    params = torch_params(pair.tmodel)
    got = pair.tpde.compute_loss(pair.tmodel.apply, params, _t(x), _t(t))
    assert sorted(got) == sorted(ref)
    for k in ("residual", "boundary", "initial", "total"):
        assert abs(float(got[k].detach()) - float(ref[k])) / abs(float(ref[k])) < 1e-5, k
    grads = dict(zip(params, torch.autograd.grad(got["total"], list(params.values()))))
    # The softmax over one key is constant: the query and key projections
    # get no gradient (exactly 0 here, rounding noise in JAX).
    scale = max(float(g.abs().max()) for g in grads.values())
    zero = [n for n in grads if re.match(r"SelfAttention_\d+\.Dense_[01]\.", n)]
    assert len(zero) == 4
    for name in zero:
        assert float(grads[name].abs().max()) < 1e-9 * scale, name
    rels = jax_grad_rels(grads, g_j)
    for path, g in jax.tree_util.tree_flatten_with_path(g_j)[0]:
        name = jax.tree_util.keystr(path)
        if re.match(r"\['SelfAttention_\d+'\]\['Dense_[01]'\]", name):
            assert float(np.abs(np.asarray(g)).max()) < 1e-9 * scale, name
        else:
            assert rels[name] < 1e-4, name


def test_headline_recipe_builds_the_jax_tree():
    """The headline recipe's trunk: width 124 from arch_params (its
    hidden_dims are unused), 4 layers, 4 heads of 31, tanh-approximate GELU,
    output 2: the JAX package's parameter tree, shape for shape."""
    from pinnrl_tpu.benchmarks import convergence as jax_conv
    from pinnrl_tpu.models import PINNModel as JaxModel
    from pinnrl_tpu_torch.benchmarks import convergence

    cfg = convergence.build_recipe_config("cahn_hilliard", device="cpu")
    model = PINNModel(cfg, seed=0)
    module = model.module
    assert cfg.model.architecture == "attention" and module.num_layers == 4
    assert module.SelfAttention_0.hidden_dim == 124 and module.SelfAttention_0.num_heads == 4
    assert module.FeedForwardBlock_0.act is ACTIVATIONS["gelu"]
    jparams = JaxModel(jax_conv.build_recipe_config("cahn_hilliard"), seed=0).params
    shapes, _ = params_to_flax(model.params)
    assert (jax.tree_util.tree_map(np.shape, shapes)
            == jax.tree_util.tree_map(np.shape, jax.tree_util.tree_map(np.asarray, jparams)))
    assert model.count_parameters() == sum(np.size(v) for v in jax.tree_util.tree_leaves(jparams))


def test_init_draws_normal_002_from_the_generator():
    """Every Dense kernel from normal(0.02), every bias zero, LayerNorm at
    (1, 0); the same seed gives the same weights."""
    a = AttentionNetwork(3, 2, hidden_dim=64, num_layers=2, generator=torch.Generator().manual_seed(1))
    b = AttentionNetwork(3, 2, hidden_dim=64, num_layers=2, generator=torch.Generator().manual_seed(1))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
        if "LayerNorm" in name:
            assert torch.equal(p, torch.ones_like(p) if name.endswith("weight") else torch.zeros_like(p))
        elif name.endswith("bias"):
            assert not p.any(), name
        elif p.numel() >= 4096:
            assert abs(float(p.detach().std()) - 0.02) < 0.002, name
            assert abs(float(p.detach().mean())) < 0.002, name


def test_tanh_maps_to_gelu_and_dropout_raises():
    from pinnrl_tpu_torch.config import load_config

    cfg = load_config(pde_type="burgers", architecture="attention", device="cpu")
    cfg.model.activation = "tanh"
    cfg.model.arch_params.update({"hidden_dim": 8, "num_layers": 1, "num_heads": 2})
    assert PINNModel(cfg).module.FeedForwardBlock_0.act is ACTIVATIONS["gelu"]
    # JAX's attention trunk takes dropout and applies none: neither does the
    # port's, even with deterministic=False.
    net = AttentionNetwork(2, 1, hidden_dim=8, num_layers=1, num_heads=2, dropout=0.1,
                           generator=torch.Generator().manual_seed(0))
    x = torch.rand(6, 2)
    assert torch.equal(net(x), net(x, deterministic=False))
