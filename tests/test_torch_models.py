"""Parameter bridge and model forward: the port against pinnrl_tpu.

Tolerance: the forward agrees to 1e-5 relative to the output's max (f32;
flax's LayerNorm uses the fast variance E[h^2] - mu^2, torch's the
two-pass variance, and the products accumulate in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_helpers import burgers_pair, points, rel_to_max

from pinnrl_tpu_torch.models import count_parameters
from pinnrl_tpu_torch.models.bridge import params_from_flax, params_to_flax

FWD_TOL = 1e-5


@pytest.mark.parametrize("arch,periodic,layer_norm", [
    ("fourier", True, True),
    ("fourier", False, True),
    ("fourier", True, False),
    ("feedforward", True, True),
])
def test_forward_matches_jax(arch, periodic, layer_norm):
    pair = burgers_pair(arch=arch, periodic=periodic, layer_norm=layer_norm)
    x, t = points(3, 200)
    z = np.concatenate([x, t], axis=1)
    ref = np.asarray(pair.jmodel.apply(pair.jmodel.params, jnp.asarray(z)))
    got = pair.tmodel.apply(pair.tmodel.params, torch.from_numpy(z))
    assert got.shape == ref.shape
    assert rel_to_max(got, ref) < FWD_TOL


def test_bridge_round_trip_is_exact():
    pair = burgers_pair()
    params_np = jax.tree_util.tree_map(np.asarray, pair.jmodel.params)
    consts_np = jax.tree_util.tree_map(np.asarray, pair.jmodel.constants)
    state = params_from_flax(params_np, consts_np)
    back_params, back_consts = params_to_flax(state)
    flat_a = jax.tree_util.tree_leaves_with_path(params_np)
    flat_b = jax.tree_util.tree_leaves_with_path(back_params)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.shape == b.shape and np.array_equal(a, b)
    np.testing.assert_array_equal(
        back_consts["constants"]["FourierFeatures_0"]["B"],
        consts_np["constants"]["FourierFeatures_0"]["B"],
    )
    # Dense kernels are transposed into torch's (out, in) layout.
    assert tuple(state["Dense_0.weight"].shape) == params_np["Dense_0"]["kernel"].shape[::-1]
    assert count_parameters(pair.tmodel.params) == pair.jmodel.count_parameters()


def test_recipe_width_parameter_layout():
    """The recipe's 256x3 / mapping 128 trunk: ~199k parameters, the leaves
    and shapes that the flax names map onto."""
    from pinnrl_tpu_torch.config import load_config
    from pinnrl_tpu_torch.models import PINNModel

    cfg = load_config(pde_type="burgers", architecture="fourier", device="cpu")
    cfg.model.hidden_dims = [256, 256, 256]
    cfg.model.arch_params.update({"mapping_size": 128, "scale": 2.0})
    model = PINNModel(cfg, seed=0)
    shapes = {k: tuple(v.shape) for k, v in model.params.items()}
    assert shapes["Dense_0.weight"] == (256, 256)
    assert shapes["Dense_3.weight"] == (1, 256)
    assert shapes["LayerNorm_2.weight"] == (256,)
    assert tuple(model.constants["FourierFeatures_0.B"].shape) == (2, 128)
    assert model.count_parameters() == 3 * (256 * 256 + 256 + 2 * 256) + 257


def test_init_statistics_follow_flax():
    """lecun-normal kernels (std ~ 1/sqrt(fan_in)), zero biases, LayerNorm
    (1, 0), B ~ N(0, scale^2); a seed reproduces the weights."""
    from pinnrl_tpu_torch.config import load_config
    from pinnrl_tpu_torch.models import PINNModel

    cfg = load_config(pde_type="burgers", architecture="fourier", device="cpu")
    cfg.model.hidden_dims = [256, 256]
    cfg.model.arch_params.update({"mapping_size": 128, "scale": 2.0})
    a, b = PINNModel(cfg, seed=1), PINNModel(cfg, seed=1)
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k])
    w = a.params["Dense_1.weight"].detach()
    assert abs(float(w.std()) * 16.0 - 1.0) < 0.05
    assert float(w.abs().max()) <= 2.0 / 0.87962566103423978 / 16.0 + 1e-6
    assert float(a.params["Dense_1.bias"].detach().abs().max()) == 0.0
    assert torch.equal(a.params["LayerNorm_0.weight"], torch.ones(256))
    assert abs(float(a.constants["FourierFeatures_0.B"].std()) / 2.0 - 1.0) < 0.15
    assert a.module.LayerNorm_0.eps == 1e-6
