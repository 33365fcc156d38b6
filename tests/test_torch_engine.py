"""The generic derivative engine (``ops/derivatives.py``, nested jvp batched
over N) against ``pinnrl_tpu.ops.derivatives`` (per point, under vmap), on
a bridged SIREN (8x3, omega 30) and a bridged Fourier MLP (16x2, LayerNorm,
tanh).

Tolerances, as tests/test_derivatives.py holds the JAX engine: 1e-4
relative to max at orders 1-2 and 1e-3 at orders 3-4 (f32; each order
multiplies rounding, by omega on the SIREN).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_helpers import KDV_DOMAIN, burgers_pair, points, rel_to_max, siren_kdv_pair

from pinnrl_tpu.ops import derivatives as jd
from pinnrl_tpu_torch.ops import derivatives as td
from pinnrl_tpu_torch.ops.jet_mlp import BundleView


def _tol(order):
    return 1e-4 if order <= 2 else 1e-3


def _net(arch):
    """(pair, z) for one of the two networks, with 64 points in its domain."""
    if arch == "siren":
        pair = siren_kdv_pair(hidden=(8, 8, 8))
        x, t = points(1, 64, **KDV_DOMAIN)
    else:
        pair = burgers_pair(hidden=(16, 16))
        x, t = points(1, 64)
    return pair, np.concatenate([x, t], axis=1)


def _scalar_fns(pair):
    u_j = pair.jpde._scalar_u(pair.jmodel.apply, pair.jmodel.params)
    u_t = pair.tpde._scalar_u(pair.tmodel.apply, pair.tmodel.params)
    return u_j, u_t


@pytest.mark.parametrize("arch,order", [("siren", 1), ("siren", 2), ("siren", 3),
                                        ("fourier", 1), ("fourier", 2), ("fourier", 3),
                                        ("fourier", 4)])
@pytest.mark.parametrize("axis", [0, 1])
def test_directional_derivative_matches_jax(arch, order, axis):
    pair, z = _net(arch)
    u_j, u_t = _scalar_fns(pair)
    ref = jax.vmap(lambda zz: jnp.stack(jd.directional_derivative(u_j, zz, axis, order)))(jnp.asarray(z))
    with torch.no_grad():
        got = td.directional_derivative(u_t, torch.from_numpy(z), axis, order)
    assert len(got) == order
    for k, g in enumerate(got):
        assert g.shape == (64,)
        assert rel_to_max(g, np.asarray(ref[:, k])) < _tol(k + 1), k + 1


@pytest.mark.parametrize("arch", ["siren", "fourier"])
def test_laplacian_and_hvp_diag_match_jax(arch):
    pair, z = _net(arch)
    u_j, u_t = _scalar_fns(pair)
    zj, zt = jnp.asarray(z), torch.from_numpy(z)
    lap_j = jax.vmap(lambda zz: jd.laplacian(u_j, zz, [0]))(zj)
    hvp_j = jax.vmap(lambda zz: jd.hvp_diag(u_j, zz, [0, 1]))(zj)
    with torch.no_grad():
        lap_t = td.laplacian(u_t, zt, [0])
        hvp_t = td.hvp_diag(u_t, zt, [0, 1])
    assert lap_t.shape == (64,) and hvp_t.shape == (64, 2)
    assert rel_to_max(lap_t, np.asarray(lap_j)) < 1e-4
    for k in range(2):
        assert rel_to_max(hvp_t[:, k], np.asarray(hvp_j[:, k])) < 1e-4


@pytest.mark.parametrize("arch,jax_mode", [("siren", "jvp"), ("fourier", "jvp"), ("fourier", "jet")])
@pytest.mark.parametrize("mode", ["jvp", "jet", "auto"])
def test_derivative_bundle_matches_jax(arch, jax_mode, mode):
    """Keys and values of the bundle at spatial orders (1, 2, 3) and temporal
    orders (1, 2); the port's every mode against JAX's jvp and jet modes."""
    pair, z = _net(arch)
    u_j, u_t = _scalar_fns(pair)
    ref = jax.vmap(lambda zz: jd.derivative_bundle(u_j, zz, 1, (1, 2, 3), (1, 2), mode=jax_mode))(
        jnp.asarray(z))
    with torch.no_grad():
        got = td.derivative_bundle(u_t, torch.from_numpy(z), 1, (1, 2, 3), (1, 2), mode=mode)
    assert sorted(got) == sorted(ref) == sorted(["u", "dt", "dt2", "dx", "dx2", "dx3", "laplacian"])
    orders = {"u": 0, "dt": 1, "dt2": 2, "dx": 1, "dx2": 2, "dx3": 3, "laplacian": 2}
    for k, v in got.items():
        assert v.shape == (64,)
        assert rel_to_max(v, np.asarray(ref[k])) < _tol(max(orders[k], 1)), k


def test_batched_bundle_and_nd_keys_match_jax():
    """The batch API on a bridged network, and the N-D key names on a
    closed-form function of (x1, x2, t)."""
    pair, z = _net("fourier")
    ref = jd.batched_derivative_bundle(pair.jmodel.apply, pair.jmodel.params, jnp.asarray(z[:, :1]),
                                       jnp.asarray(z[:, 1:]), 1, (1, 2), (1,), mode="jvp")
    with torch.no_grad():
        got = td.batched_derivative_bundle(pair.tmodel.apply, pair.tmodel.params,
                                           torch.from_numpy(z[:, :1]), torch.from_numpy(z[:, 1:]),
                                           1, (1, 2), (1,))
    assert sorted(got) == sorted(ref)
    for k, v in got.items():
        assert v.shape == (64, 1)
        assert rel_to_max(v, np.asarray(ref[k])) < 1e-4, k

    z3 = np.random.default_rng(2).random((32, 3)).astype(np.float32)

    def fj(zz):
        return jnp.sin(2.0 * zz[0]) * zz[1] ** 3 * jnp.exp(-zz[2])

    def ft(zz):
        return torch.sin(2.0 * zz[:, 0]) * zz[:, 1] ** 3 * torch.exp(-zz[:, 2])

    ref = jax.vmap(lambda zz: jd.derivative_bundle(fj, zz, 2, (1, 2, 3), (1,), mode="jvp"))(
        jnp.asarray(z3))
    got = td.derivative_bundle(ft, torch.from_numpy(z3), 2, (1, 2, 3), (1,))
    assert sorted(got) == sorted(ref)
    assert {"dx1", "dx1x1", "dx1x1x1", "dx2", "dx2x2", "dx2x2x2", "laplacian"} <= set(got)
    for k, v in got.items():
        assert rel_to_max(v, np.asarray(ref[k])) < 1e-5, k


def test_bundle_view_branch_returns_the_streams():
    streams = {0: [torch.full((3,), 1.0), torch.full((3,), 2.0)], 1: [torch.full((3,), 3.0)]}
    view = BundleView(torch.zeros(3), streams)
    z = torch.zeros(3, 2)
    assert td.directional_derivative(view, z, 0, 2) == streams[0]
    assert torch.equal(td.laplacian(view, z, [0]), streams[0][1])
    assert torch.equal(td.hvp_diag(view, z, [0]), streams[0][1].reshape(3, 1))


def test_value_and_derivative_is_one_jvp():
    pair, z = _net("siren")
    u_j, u_t = _scalar_fns(pair)
    with torch.no_grad():
        val, d1 = td.value_and_derivative(u_t, torch.from_numpy(z), 0)
    assert rel_to_max(val, np.asarray(jax.vmap(u_j)(jnp.asarray(z)))) < 1e-5
    ref = jax.vmap(lambda zz: jd.directional_derivative(u_j, zz, 0, 1)[0])(jnp.asarray(z))
    assert rel_to_max(d1, np.asarray(ref)) < 1e-4
    with pytest.raises(ValueError, match="Unknown derivative mode"):
        td.derivative_bundle(u_t, torch.from_numpy(z), 1, mode="taylor")


def test_layer_norm_nests_under_jvp():
    """The networks' LayerNorm inside a torch.func transform (plain ops):
    its value equals nn.LayerNorm's, and its second derivative under nested
    jvp equals a central finite difference of the first, in float64 to
    1e-6 relative to max."""
    from pinnrl_tpu_torch.models.base import layer_norm

    torch.manual_seed(0)
    norm = torch.nn.LayerNorm(8, eps=1e-6).double()
    with torch.no_grad():
        norm.weight.add_(0.1 * torch.randn(8, dtype=torch.float64))
        norm.bias.add_(0.1 * torch.randn(8, dtype=torch.float64))
    x = torch.randn(5, 8, dtype=torch.float64)
    v = torch.randn(5, 8, dtype=torch.float64)

    def f(h):
        return torch.tanh(layer_norm(norm, h)).sum(-1)

    def d1(h):
        return torch.func.jvp(f, (h,), (v,))[1]

    with torch.no_grad():
        assert rel_to_max(torch.func.jvp(lambda h: layer_norm(norm, h), (x,), (v,))[0], norm(x)) < 1e-12
        d2 = torch.func.jvp(d1, (x,), (v,))[1]
        eps = 1e-5
        fd = (d1(x + eps * v) - d1(x - eps * v)) / (2 * eps)
    assert rel_to_max(d2, fd) < 1e-6


@pytest.mark.parametrize("arch", ["siren", "fourier"])
def test_nested_jvp_takes_every_order_from_one_nest(arch):
    """``directional_derivative`` to order k evaluates the network once (one
    nest of k jvps, the lower orders from its primals) and gives, for a
    scalar and a 2-channel restriction, exactly what a separate nest per
    order gives, values and parameter gradients alike."""
    pair, z = _net(arch)
    zt = torch.from_numpy(z)
    calls = [0]

    def uvec(zz):
        calls[0] += 1
        out = pair.tmodel.apply(pair.tmodel.params, zz).reshape(zz.shape[0], -1)
        return torch.cat([out, 2.0 * out**2], dim=1)

    def per_order(u, v, order):
        fn = u
        for _ in range(order):
            fn = (lambda prev: lambda zz: torch.func.jvp(prev, (zz,), (v,))[1])(fn)
        return fn(zt)

    params = [p for p in pair.tmodel.params.values() if p.requires_grad]
    for u in (lambda zz: uvec(zz)[:, 0], uvec):
        for axis, order in ((0, 1), (0, 3), (1, 2)):
            calls[0] = 0
            got = td.directional_derivative(u, zt, axis, order)
            assert calls[0] == 1 and len(got) == order
            for k, g in enumerate(got):
                ref = per_order(u, td._tangent(zt, axis), k + 1)
                assert torch.equal(g, ref), (axis, order, k + 1)
                g_got = torch.autograd.grad(g.sum(), params, retain_graph=True)
                g_ref = torch.autograd.grad(ref.sum(), params)
                assert all(torch.equal(a, b) for a, b in zip(g_got, g_ref)), (axis, order, k + 1)
