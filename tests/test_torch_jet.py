"""Stacked-jet bundle: value and every derivative stream against
pinnrl_tpu.ops.jet_mlp.make_bundle_fn, orders 1-3, LayerNorm on and off.

Tolerances (relative to each stream's max): 1e-5 for orders <= 2; 1e-4 for
order 3, whose Taylor terms amplify f32 rounding (the bound of the JAX
suite's own fast-path test).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_helpers import burgers_pair, points, rel_to_max

from pinnrl_tpu.ops import jet_mlp as jax_jet
from pinnrl_tpu_torch.ops import jet_mlp


@pytest.mark.parametrize("spatial_order", [1, 2, 3])
@pytest.mark.parametrize("layer_norm", [True, False])
@pytest.mark.parametrize("arch", ["fourier", "feedforward"])
def test_bundle_matches_jax(spatial_order, layer_norm, arch):
    pair = burgers_pair(arch=arch, layer_norm=layer_norm)
    x, t = points(5, 96)
    z = np.concatenate([x, t], axis=1)
    jf = jax_jet.make_bundle_fn(pair.jmodel, 1, spatial_order=spatial_order, temporal_order=1)
    tf = jet_mlp.make_bundle_fn(pair.tmodel, 1, spatial_order=spatial_order, temporal_order=1)
    v_j, s_j = jf(pair.jmodel.params, jnp.asarray(z))
    with torch.no_grad():
        v_t, s_t = tf(pair.tmodel.params, torch.from_numpy(z))
    assert rel_to_max(v_t, v_j) < 1e-5
    assert sorted(s_t) == sorted(s_j)
    for ax in s_j:
        assert len(s_t[ax]) == len(s_j[ax])
        for k, (a, b) in enumerate(zip(s_t[ax], s_j[ax]), start=1):
            tol = 1e-5 if k <= 2 else 1e-4
            assert rel_to_max(a, b) < tol, (ax, k)


def test_transport_block_matches_jax():
    rng = np.random.default_rng(0)
    h0 = rng.standard_normal((16, 24)).astype(np.float32)
    g1 = [rng.standard_normal((16, 24)).astype(np.float32) for _ in range(3)]
    g2 = [rng.standard_normal((16, 24)).astype(np.float32)]
    gamma = (1.0 + 0.1 * rng.standard_normal(24)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(24)).astype(np.float32)
    for ln in (True, False):
        a_j, outs_j = jax_jet._transport_block(
            jnp.asarray(h0), [[jnp.asarray(a) for a in g1], [jnp.asarray(g2[0])]],
            jnp.asarray(gamma) if ln else None, jnp.asarray(beta) if ln else None, "tanh")
        a_t, outs_t = jet_mlp._transport_block(
            torch.from_numpy(h0), [[torch.from_numpy(a) for a in g1], [torch.from_numpy(g2[0])]],
            torch.from_numpy(gamma) if ln else None, torch.from_numpy(beta) if ln else None, "tanh")
        assert rel_to_max(a_t, a_j) < 1e-5
        for grp_t, grp_j in zip(outs_t, outs_j):
            for k, (a, b) in enumerate(zip(grp_t, grp_j), start=1):
                assert rel_to_max(a, b) < (1e-5 if k <= 2 else 1e-4)


def test_bundle_view_missing_order_raises():
    view = jet_mlp.BundleView(torch.zeros(3), {0: [torch.zeros(3)]})
    with pytest.raises(KeyError):
        view.directional(0, 2)
    with pytest.raises(KeyError):
        view.directional(1, 1)


def test_supports_and_unported_routes():
    from pinnrl_tpu_torch.ops.derivatives import directional_derivative

    pair = burgers_pair()
    assert jet_mlp.supports(pair.tmodel, pair.tpde)
    pair.tmodel.config.activation = "softplus"
    assert not jet_mlp.supports(pair.tmodel)
    # make_bundle_fn refuses what supports() refuses (the generic
    # engine runs it), naming the activations it transports.
    with pytest.raises(ValueError, match="transports.*'tanh'.*not 'softplus'.*generic engine"):
        jet_mlp.make_bundle_fn(pair.tmodel, 1, 2, 1)
    # Any other point function takes the generic engine (nested jvp), which
    # names its modes.
    z = torch.tensor([[0.5, 2.0], [1.5, -1.0]])
    (d1,) = directional_derivative(lambda zz: zz[:, 0] ** 2 * zz[:, 1], z, 0, 1)
    assert torch.allclose(d1, 2.0 * z[:, 0] * z[:, 1])
    with pytest.raises(ValueError, match="Unknown derivative mode"):
        directional_derivative(lambda zz: zz[:, 0], z, 0, 1, mode="taylor")
