"""Kernel 1's activation scope: the stacked-jet bundle and kernel 1's
launcher (its plain twins) with tanh, gelu, sigmoid, silu and sin, against
pinnrl_tpu; softplus's refusal; the rewritten tanh reverse.

Tolerances:
- (a) the derivative table (``jet_mlp.ACTIVATION_DERIVATIVES``) against
  ``torch.func.jvp`` nested to order 4, float64, y in [-8, 8]: 1e-11
  relative to each order's max (gelu's order 4 composes tanh's four
  derivatives through Faa di Bruno: ~1e-13 apart);
- (b) the bundle against ``pinnrl_tpu.ops.jet_mlp.make_bundle_fn`` (JAX
  transports these activations through ``jax.experimental.jet``): 1e-5
  relative to max on the value and on every stream;
- (c) kernel 1's launcher with its plain twins against JAX's Pallas kernel
  in interpret mode (tile 32), LayerNorm on for every PDE and off for
  Burgers: the JAX suite's bounds, loss 1e-5 and gradients 1e-4 relative,
  causal 1e-4 and 1e-3, order 3 2e-4 on the loss
  (tests/test_pallas_parity_tpu.py:126-215);
- (d) softplus: both of the port's gates refuse it, and its generic-engine
  residual equals JAX's generic engine to 1e-5 relative to max;
- (e) the reverse in d0..d4 form against the tanh-only formulas it
  replaced (G_y0 = G_a0 (1 - a0^2) with G_a0 from a0 = tanh(y0)): 1e-6
  relative to max, in float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_helpers import (FUSED_TOLS, launcher_vs_jax_kernel, pde_pair, points, rel_to_max,
                                  sorted_z)

from pinnrl_tpu.ops import jet_mlp as jax_jet
from pinnrl_tpu_torch.models.base import ACTIVATIONS
from pinnrl_tpu_torch.ops import jet_mlp
from pinnrl_tpu_torch.ops.kernels import fused_step

NEW_ACTS = ["gelu", "sigmoid", "silu", "sin"]


def _domain(pair):
    return dict(domain=tuple(tuple(d) for d in pair.tcfg.pde.domain),
                time_domain=tuple(pair.tcfg.pde.time_domain))


# --------------------------------------------------------------- (a) table


@pytest.mark.parametrize("act", sorted(jet_mlp.ACTIVATION_DERIVATIVES))
def test_derivative_table_matches_nested_jvp(act):
    y = torch.linspace(-8.0, 8.0, 801, dtype=torch.float64)
    d = jet_mlp.activation_derivatives(act, y, 4)
    f = ACTIVATIONS[act]
    for k in range(5):
        assert rel_to_max(d[k], f(y)) < 1e-11, k
        f = (lambda g: lambda v: torch.func.jvp(g, (v,), (torch.ones_like(v),))[1])(f)
    with pytest.raises(ValueError, match="order 4"):
        jet_mlp.activation_derivatives(act, y, 5)


# -------------------------------------------------------------- (b) bundle

BUNDLE_CASES = {
    "burgers": dict(pde_type="burgers"),
    "kdv": dict(pde_type="kdv", scale=0.75),
    "wave": dict(pde_type="wave", scale=0.35),
    "heat_2d": dict(pde_type="heat_2d"),
    "feedforward": dict(pde_type="burgers", arch="feedforward"),
}


@pytest.mark.parametrize("layer_norm", [True, False])
@pytest.mark.parametrize("case", sorted(BUNDLE_CASES))
@pytest.mark.parametrize("act", NEW_ACTS)
def test_bundle_matches_jax(act, case, layer_norm):
    """Value and every stream: x-order 2 (Burgers, heat_2d's two axes), 3
    (KdV) and temporal order 2 (wave), Fourier and feedforward trunks."""
    kw = dict(BUNDLE_CASES[case])
    pair = pde_pair(kw.pop("pde_type"), hidden=(16, 16), mapping=8, layer_norm=layer_norm,
                    activation=act, **kw)
    jpde, tpde = pair.jpde, pair.tpde
    assert jet_mlp.supports(pair.tmodel, tpde) and jax_jet.supports(pair.jmodel)
    orders = (tpde.dimension, max(tpde.spatial_orders), max(tpde.temporal_orders))
    assert orders == (jpde.dimension, max(jpde.spatial_orders), max(jpde.temporal_orders))
    x, t = points(3, 48, **_domain(pair))
    z = np.concatenate([x, t], axis=1)
    jf = jax_jet.make_bundle_fn(pair.jmodel, orders[0], spatial_order=orders[1],
                                temporal_order=orders[2])
    tf = jet_mlp.make_bundle_fn(pair.tmodel, *orders)
    v_j, s_j = jf(pair.jmodel.params, jnp.asarray(z))
    with torch.no_grad():
        v_t, s_t = tf(pair.tmodel.params, torch.from_numpy(z))
    assert rel_to_max(v_t, v_j) < 1e-5
    assert sorted(s_t) == sorted(s_j)
    for ax in s_j:
        assert len(s_t[ax]) == len(s_j[ax])
        for k, (a, b) in enumerate(zip(s_t[ax], s_j[ax]), start=1):
            assert rel_to_max(a, b) < 1e-5, (ax, k)


# ----------------------------------------------------------- (c) kernel 1

KERNEL_CASES = {
    "burgers": dict(pde_type="burgers"),
    "kdv_causal": dict(pde_type="kdv", scale=0.75, causal_eps=1.0),
    "heat_2d": dict(pde_type="heat_2d"),
    "convection": dict(pde_type="convection"),
}


# LayerNorm off on Burgers only: (b) takes it off on KdV, wave, heat_2d and
# the feedforward trunk, and the per-activation transport cases of
# tests/test_torch_kernels_cuda.py at every x-order and d.
@pytest.mark.parametrize("case, layer_norm",
                         [(c, True) for c in sorted(KERNEL_CASES)] + [("burgers", False)])
@pytest.mark.parametrize("act", NEW_ACTS)
def test_kernel1_launcher_matches_jax_interpret_kernel(act, case, layer_norm):
    kw = dict(KERNEL_CASES[case])
    pair = pde_pair(kw.pop("pde_type"), hidden=(16, 16), mapping=8, layer_norm=layer_norm,
                    activation=act, **kw)
    assert fused_step.supports(pair.tmodel, pair.tpde, pair.tcfg.training)
    spec = fused_step._spec(pair.tmodel, pair.tpde)
    assert spec.activation == act
    loss_rel, grad_rels = launcher_vs_jax_kernel(pair, sorted_z(7, 64, _domain(pair)))
    loss_tol, grad_tol = FUSED_TOLS[kw.get("causal_eps", 0.0)]
    if max(pair.tpde.spatial_orders) == 3:
        loss_tol = max(loss_tol, 2e-4)
    assert loss_rel < loss_tol
    for name, rel in grad_rels.items():
        assert rel < grad_tol, name


# ------------------------------------------------------------ (d) softplus


def test_softplus_takes_the_generic_engine_as_jax_does():
    """JAX's gate admits softplus but its bundle fails (``jet`` leaks a
    tracer through softplus's ``custom_jvp``); the port refuses it in both
    gates and runs JAX's generic engine, as ``stacked_jet: false`` does."""
    pair = pde_pair("burgers", hidden=(16, 16), mapping=8, activation="softplus")
    jpde, tpde, tmodel = pair.jpde, pair.tpde, pair.tmodel
    assert jax_jet.supports(pair.jmodel)
    assert not jet_mlp.supports(tmodel, tpde)
    assert not fused_step.supports(tmodel, tpde, pair.tcfg.training)
    assert not tpde.attach_fast_bundle(tmodel)
    for refused in ("relu", "softplus"):
        tmodel.config.activation = refused
        assert not fused_step.supports(tmodel, tpde)
        with pytest.raises(ValueError, match="unsupported"):
            tpde.attach_fused_residual_kernel(tmodel, enable="on")
    tmodel.config.activation = "softplus"
    x, t = points(5, 64, **_domain(pair))
    ref = jpde.compute_residual(pair.jmodel.apply, pair.jmodel.params, jnp.asarray(x),
                                jnp.asarray(t))
    with torch.no_grad():
        got = tpde.compute_residual(tmodel.apply, tmodel.params, torch.from_numpy(x),
                                    torch.from_numpy(t))
    assert got.shape == ref.shape and rel_to_max(got, ref) < 1e-5


@pytest.mark.parametrize("act", ["tanh", "gelu", "sigmoid", "silu", "swish", "sin", "softplus",
                                 "relu", "elu"])
@pytest.mark.parametrize("arch", ["fourier", "feedforward"])
def test_supports_matches_the_reference_for_every_activation(arch, act):
    """Both gates against JAX's on a trunk wide enough for the reference's
    width gate (128): equal for every activation but softplus, which the
    port refuses by decision."""
    from pinnrl_tpu.ops.kernels import fused_step as jax_fused

    pair = pde_pair("burgers", arch=arch, hidden=(128, 128), mapping=64, activation=act)
    ref_bundle = jax_jet.supports(pair.jmodel)
    ref_kernel = jax_fused.supports(pair.jmodel, pair.jpde, pair.jcfg.training)
    assert ref_bundle == ref_kernel == (act not in ("relu", "elu"))
    want = ref_kernel and act != "softplus"
    assert jet_mlp.supports(pair.tmodel, pair.tpde) == want
    assert fused_step.supports(pair.tmodel, pair.tpde, pair.tcfg.training) == want


def test_every_bundle_activation_attaches_kernel1():
    for act in NEW_ACTS + ["swish", "tanh"]:
        pair = pde_pair("burgers", hidden=(16, 16), mapping=8, activation=act)
        assert pair.tpde.attach_fused_residual_kernel(pair.tmodel, enable="on"), act


# --------------------------------------------------- (e) the tanh reverse


def _tanh_reverse_value_row(H, GA, n, dim):
    """G_y0 by the tanh-only formulas: G_a0 gathers -2 a0 G_d1 + (4 a0^2 - 2
    d1) G_d2 + (4 a0 (1 - 3 a0^2) + 12 a0 d1) G_d3 per group, then
    G_y0 = G_a0 d1 (no LayerNorm: y = h)."""
    h0, hx, ht = fused_step._split_streams(H, n, dim)
    Ga0, Gox, Got = fused_step._split_streams(GA, n, dim)
    a0 = torch.tanh(h0)
    d1 = 1.0 - a0 * a0
    Ga = Ga0 - 2.0 * a0 * (Got * ht)
    for y, Go in zip(hx, Gox):
        K = len(y)
        if K == 1:
            Ga = Ga - 2.0 * a0 * (Go[0] * y[0])
            continue
        Ga = Ga - 2.0 * a0 * (Go[0] * y[0] + Go[1] * y[1]) + Go[1] * y[0] * y[0] * (
            4.0 * a0 * a0 - 2.0 * d1)
        if K == 3:
            y1, y2, y3 = y
            Ga = Ga + Go[2] * (-2.0 * a0 * y3 + 3.0 * y1 * y2 * (4.0 * a0 * a0 - 2.0 * d1)
                               + y1 * y1 * y1 * (4.0 * a0 * (1.0 - 3.0 * a0 * a0) + 12.0 * a0 * d1))
    return Ga * d1


@pytest.mark.parametrize("x_order", [1, 2, 3])
@pytest.mark.parametrize("dim", [1, 2, 3])
def test_tanh_reverse_equals_the_formulas_it_replaced(dim, x_order):
    gen = torch.Generator().manual_seed(10 * dim + x_order)
    n, width = 12, 24
    H = torch.randn(((2 + dim * x_order) * n, width), generator=gen, dtype=torch.float64)
    GA = torch.randn(H.shape, generator=gen, dtype=torch.float64)
    GH, _, _ = fused_step._transport_bwd_plain(H, None, None, GA, n, dim, "tanh")
    assert rel_to_max(GH[:n], _tanh_reverse_value_row(H, GA, n, dim)) < 1e-6


@pytest.mark.parametrize("layer_norm", [True, False])
@pytest.mark.parametrize("x_order", [1, 2, 3])
@pytest.mark.parametrize("act", NEW_ACTS)
def test_transport_backward_matches_autograd(act, x_order, layer_norm):
    """The hand-derived reverse (the CUDA kernel's specification) against
    autograd through the forward twin, float64, two x-groups."""
    gen = torch.Generator().manual_seed(x_order)
    n, width, dim = 10, 24, 2
    H = torch.randn(((2 + dim * x_order) * n, width), generator=gen, dtype=torch.float64)
    GA = torch.randn(H.shape, generator=gen, dtype=torch.float64)
    g = (1.0 + 0.2 * torch.randn(width, generator=gen, dtype=torch.float64)).requires_grad_(True)
    b = (0.2 * torch.randn(width, generator=gen, dtype=torch.float64)).requires_grad_(True)
    g, b = (g, b) if layer_norm else (None, None)
    Hl = H.clone().requires_grad_(True)
    out = fused_step._transport_fwd_plain(Hl, g, b, n, dim, act)
    leaves = [Hl] + ([g, b] if layer_norm else [])
    ref = torch.autograd.grad(out, leaves, GA)
    with torch.no_grad():
        GH, Gg, Gb = fused_step._transport_bwd_plain(H, g, b, GA, n, dim, act)
    assert rel_to_max(GH, ref[0]) < 1e-10
    if layer_norm:
        assert rel_to_max(Gg.sum(0), ref[1]) < 1e-10 and rel_to_max(Gb.sum(0), ref[2]) < 1e-10
