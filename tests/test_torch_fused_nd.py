"""Kernel 1 in four or more space dimensions: the launcher run with its
plain twins (``_TorchOps``, whose arithmetic the ``*_nd`` CUDA kernels
evaluate) against the JAX Pallas kernel in interpret mode (tile 32), and the
group walk the d >= 4 transport kernels are built on against the whole
transport.

Tolerances: ``FUSED_TOLS`` (loss 1e-5 relative and gradients 1e-4 relative
to max; causal 1e-4 and 1e-3: the JAX suite's bounds for its fused kernel).
The group walk in float64: 1e-12 relative to max (only rounding separates
it from the whole reverse).
"""

import numpy as np
import pytest
import torch
from torch_parity_helpers import (FUSED_TOLS, launcher_vs_jax_kernel, pde_pair, rel_to_max,
                                  sorted_z)

from pinnrl_tpu_torch.ops.kernels import fused_step

RESIDUALS = ("burgers", "heat", "kdv", "convection", "allen_cahn", "black_scholes")
VELOCITY_4D = [0.5, -1.5, 1.0, 0.25]


def _check(pair, causal_eps=0.0, seed=5, n=96):
    domain = dict(domain=tuple(map(tuple, pair.tcfg.pde.domain)),
                  time_domain=tuple(pair.tcfg.pde.time_domain))
    loss_rel, grad_rels = launcher_vs_jax_kernel(pair, sorted_z(seed, n, domain))
    loss_tol, grad_tol = FUSED_TOLS[causal_eps]
    assert loss_rel < loss_tol
    for name, rel in grad_rels.items():
        assert rel < grad_tol, name


@pytest.mark.parametrize("pde_type", RESIDUALS)
@pytest.mark.parametrize("arch", ["fourier", "feedforward"])
def test_launcher_matches_jax_kernel_in_four_dimensions(pde_type, arch):
    """Every residual of kernel 1 in four space dimensions (convection with
    four distinct velocities; Black-Scholes reading S along each axis) on
    both trunks."""
    over = {"parameters": {"velocity": VELOCITY_4D}} if pde_type == "convection" else None
    pair = pde_pair(pde_type, arch=arch, pde=over, dim=4)
    spec = fused_step._spec(pair.tmodel, pair.tpde)
    assert spec.dimension == 4 and fused_step.supports(pair.tmodel, pair.tpde)
    if pde_type == "convection":
        assert spec.velocity == tuple(VELOCITY_4D)
    _check(pair)


@pytest.mark.parametrize("pde_type", ["heat", "kdv"])
def test_launcher_matches_jax_kernel_in_five_dimensions(pde_type):
    """Heat (12 stacked streams) and KdV (17, the widest x-order) in five
    space dimensions."""
    pair = pde_pair(pde_type, dim=5)
    assert fused_step._spec(pair.tmodel, pair.tpde).dimension == 5
    _check(pair)


VARIANTS_4D = {
    "causal": dict(causal_eps=1.0),
    "frame": dict(frame=0.7),
    "trainable_basis": dict(arch_params={"trainable_features": True}),
    "gelu": dict(activation="gelu"),
}


@pytest.mark.parametrize("case", sorted(VARIANTS_4D))
def test_launcher_variants_in_four_dimensions(case):
    """Heat in four dimensions causal, in a co-moving frame of speed 0.7,
    with a trainable basis (dL/dB from the embedding's cotangent) and with
    gelu."""
    kw = VARIANTS_4D[case]
    pair = pde_pair("heat", dim=4, **kw)
    spec = fused_step._spec(pair.tmodel, pair.tpde)
    assert spec.trainable_basis == (case == "trainable_basis")
    assert spec.frame_speed == kw.get("frame") and spec.activation == kw.get("activation", "tanh")
    _check(pair, causal_eps=kw.get("causal_eps", 0.0))


@pytest.mark.parametrize("act", ["tanh", "sin"])
@pytest.mark.parametrize("layer_norm", [True, False])
@pytest.mark.parametrize("x_order", [1, 2, 3])
def test_group_walk_equals_the_whole_transport(x_order, layer_norm, act):
    """What transport_fwd_nd_kernel and transport_bwd_nd_kernel rest on:
    each x-group's outputs are the one-group transport of [value; group;
    t1], and the reverse, linear in the output cotangents, is the sum over
    the groups of the one-group reverse with the value and t cotangents
    given to group 0 only (the group streams' rows from their own group,
    the t-stream's from group 0)."""
    rng = np.random.default_rng(19)
    n, width, dim = 6, 24, 5
    streams = 2 + dim * x_order
    H = torch.tensor(rng.standard_normal((streams * n, width)))
    GA = torch.tensor(rng.standard_normal((streams * n, width)))
    gamma = torch.tensor(1.0 + 0.2 * rng.standard_normal(width)) if layer_norm else None
    beta = torch.tensor(0.2 * rng.standard_normal(width)) if layer_norm else None
    A = fused_step._transport_fwd_plain(H, gamma, beta, n, dim, act).split(n)
    GH, Gg, Gb = fused_step._transport_bwd_plain(H, gamma, beta, GA, n, dim, act)
    GH = GH.split(n)
    hs, gs = H.split(n), GA.split(n)
    value_rows, sums = torch.zeros_like(hs[0]), [0.0, 0.0]
    for g in range(dim):
        own = list(range(1 + g * x_order, 1 + (g + 1) * x_order))
        rows = [0, *own, streams - 1]
        Hg = torch.cat([hs[i] for i in rows])
        Gog = torch.cat([gs[i] if g == 0 or i in own else torch.zeros_like(gs[i]) for i in rows])
        Ag = fused_step._transport_fwd_plain(Hg, gamma, beta, n, 1, act).split(n)
        GHg, Ggg, Gbg = fused_step._transport_bwd_plain(Hg, gamma, beta, Gog, n, 1, act)
        GHg = GHg.split(n)
        for k, i in enumerate(own, start=1):
            assert rel_to_max(Ag[k], A[i]) < 1e-12 and rel_to_max(GHg[k], GH[i]) < 1e-12
        if g == 0:
            assert rel_to_max(Ag[0], A[0]) < 1e-12 and rel_to_max(Ag[-1], A[-1]) < 1e-12
            assert rel_to_max(GHg[-1], GH[-1]) < 1e-12
        value_rows = value_rows + GHg[0]
        if layer_norm:
            sums = [sums[0] + Ggg, sums[1] + Gbg]
    assert rel_to_max(value_rows, GH[0]) < 1e-12
    if layer_norm:
        assert rel_to_max(sums[0], Gg) < 1e-12 and rel_to_max(sums[1], Gb) < 1e-12
