"""Kernel 1's products on the CPU: which go to the GEMM core (``ops.gemm``,
``csrc/sgemm_sm90.cuh`` on the card) and which to the output layer's row
passes (``rowdot``, ``outer``, ``wcolsum``), the plain twins of those passes
against ``@`` in float64, the split over K for the core's 128x128 tile at
the recipes' shapes, the launcher with its plain twins against
torch.autograd at the Burgers and KdV recipes' widths, and the ctypes
bindings of kernel 3's entry points.

Tolerances: the twins in float64 against ``@``, 1e-12 relative to max (only
the order of the additions may differ); the launcher against autograd as in
tests/test_torch_fused_causal.py: Burgers loss 1e-5 and gradients 1e-4
relative, KdV 2e-4 and 1e-3 (the JAX suite's bounds for its kernel).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_parity_helpers import KDV_DOMAIN, burgers_pair, kdv_pair, points, rel_to_max, torch_params

from pinnrl_tpu_torch.ops.jet_mlp import make_bundle_fn
from pinnrl_tpu_torch.ops.kernels import fused_step, mlp, siren

BOUNDS = {"burgers": (1e-5, 1e-4), "kdv": (2e-4, 1e-3)}  # (loss, gradients)
# The recipes' Dense widths (input features, hidden..., output) and stacked
# rows at N = 8192: Burgers 4 streams, mapping 128; KdV 5 streams, mapping 256.
RECIPES = {"burgers": ((256, 256, 256, 256, 1), 4 * 8192),
           "kdv": ((512, 256, 256, 256, 1), 5 * 8192)}


class _Recorder(fused_step._TorchOps):
    """The plain twins, recording which entry point each call takes."""

    def __init__(self):
        self.calls = []

    def __getattribute__(self, name):
        if name in ("gemm", "rowdot", "outer", "wcolsum", "colsum"):
            object.__getattribute__(self, "calls").append(name)
        return object.__getattribute__(self, name)


def _rng_tensor(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape))


@pytest.mark.parametrize("route,out,rows,want", [
    ("linear", 24, 64, ["gemm"]),
    ("linear", 1, 64, ["rowdot"]),
    ("dx", 24, 64, ["gemm"]),
    ("dx", 1, 64, ["outer"]),
    ("dw", 24, 64, ["gemm"]),
    ("dw", 24, 2048, ["gemm", "colsum"]),  # long K: split, partials summed by colsum
    ("dw", 1, 2048, ["wcolsum"]),
])
def test_products_route_by_shape(route, out, rows, want):
    """The output layer (out = 1: the forward's N, dX's K and dW's M are 1)
    takes the row passes; every other product takes the GEMM core."""
    rng = np.random.default_rng(out + rows)
    inp = 40
    X, W, b, G = (_rng_tensor(rng, rows, inp), _rng_tensor(rng, out, inp), _rng_tensor(rng, out),
                  _rng_tensor(rng, rows, out))
    ops = _Recorder()
    if route == "linear":
        got, ref = fused_step._linear(ops, X, W, b, rows // 2), X @ W.t()
        ref[: rows // 2] += b
    elif route == "dx":
        got, ref = fused_step._linear_dx(ops, G, W), G @ W
    else:
        got, ref = fused_step._linear_dw(ops, G, X), G.t() @ X
    assert ops.calls == want
    assert got.shape == ref.shape and rel_to_max(got, ref) < 1e-12


def test_mlp_scorer_stays_on_one_gemm():
    """Kernel 4's launcher takes ``_gemm_linear``: one ``gemm`` call (its old
    64x64 tile on the card), whatever the widths."""
    calls = []

    class Ops(mlp._TorchOps):
        def gemm(self, *args):
            calls.append("gemm")
            return super().gemm(*args)

    rng = np.random.default_rng(0)
    h = 16
    P = {"Dense_0.weight": _rng_tensor(rng, h, 2), "Dense_0.bias": _rng_tensor(rng, h),
         "LayerNorm_0.weight": 1.0 + 0.1 * _rng_tensor(rng, h), "LayerNorm_0.bias": _rng_tensor(rng, h),
         "Dense_1.weight": _rng_tensor(rng, h, h), "Dense_1.bias": _rng_tensor(rng, h),
         "LayerNorm_1.weight": 1.0 + 0.1 * _rng_tensor(rng, h), "LayerNorm_1.bias": _rng_tensor(rng, h),
         "Dense_2.weight": _rng_tensor(rng, 1, h), "Dense_2.bias": _rng_tensor(rng, 1)}
    x = _rng_tensor(rng, 50, 2)
    got = mlp._score(Ops(), x, P, 1e-6)
    assert calls == ["gemm"]
    assert rel_to_max(got, mlp.fused_mlp_score_plain(x, P)) < 1e-12


@pytest.mark.parametrize("R,K", [(300, 256), (1, 7), (64, 1), (2049, 37)])
def test_row_pass_twins_match_matmul_in_float64(R, K):
    rng = np.random.default_rng(R * K)
    X, w, b, g = _rng_tensor(rng, R, K), _rng_tensor(rng, 1, K), _rng_tensor(rng, 1), _rng_tensor(rng, R, 1)
    ops = fused_step._TorchOps()
    ref = X @ w.t()
    ref[: R // 2] += b
    assert rel_to_max(ops.rowdot(X, w, b, R // 2), ref) < 1e-12
    assert rel_to_max(ops.rowdot(X, w, None, R), X @ w.t()) < 1e-12
    assert rel_to_max(ops.outer(g, w), g @ w) < 1e-12
    assert ops.wcolsum(g, X).shape == (1, K)
    assert rel_to_max(ops.wcolsum(g, X), g.t() @ X) < 1e-12


def _recipe_products(pde):
    """(M, K, N) of every product of one kernel-1 call at the recipe's
    widths: per layer the forward, dW and (past the first) dX."""
    widths, rows = RECIPES[pde]
    shapes = []
    for i, (inp, out) in enumerate(zip(widths[:-1], widths[1:])):
        shapes += [(rows, inp, out), (out, rows, inp)] + ([(rows, out, inp)] if i else [])
    return shapes


@pytest.mark.parametrize("pde,index", [(p, i) for p in RECIPES for i in range(11)])
def test_split_k_for_the_128_tile_at_recipe_shapes(pde, index):
    """Each of the 11 products of a Burgers and a KdV call: the splits cover
    K exactly, chunks are whole BK slices, and the split stops at about
    ``_TARGET_BLOCKS`` blocks of the 128x128 tile."""
    shapes = _recipe_products(pde)
    assert len(shapes) == 11
    M, K, N = shapes[index]
    splits, chunk = fused_step._split_k(M, N, K)
    tiles = -(-M // fused_step._GEMM_TILE) * -(-N // fused_step._GEMM_TILE)
    assert fused_step._GEMM_TILE == 128 and fused_step._GEMM_BK == 8
    assert splits >= 1 and chunk % fused_step._GEMM_BK == 0
    assert (splits - 1) * chunk < K <= splits * chunk
    assert splits <= max(1, -(-fused_step._TARGET_BLOCKS // tiles))
    if K >= 32768 and min(M, N) > 1:  # the hidden layers' dW fill the card
        assert tiles * splits >= fused_step._TARGET_BLOCKS // 2


@pytest.mark.parametrize("pde", ["burgers", "kdv"])
def test_launcher_twins_match_autograd_at_recipe_widths(pde):
    """The launcher at the recipe's widths (Fourier 256x3, mapping 128 for
    Burgers, mapping 256 and causal eps 1.0 for KdV) with the plain twins:
    8 products through ``gemm`` and one through each row pass, against
    autograd on the plain version."""
    if pde == "burgers":
        pair = burgers_pair(hidden=(256, 256, 256), mapping=128)
        x, t = points(5, 48)
    else:
        pair = kdv_pair(hidden=(256, 256, 256), mapping=256, causal_eps=1.0)
        x, t = points(5, 48, **KDV_DOMAIN)
    z = np.concatenate([x, t], axis=1)
    z = z[np.argsort(z[:, 1], kind="stable")]
    params = torch_params(pair.tmodel)
    tpde = pair.tpde
    bundle_fn = make_bundle_fn(pair.tmodel, 1, max(tpde.spatial_orders), max(tpde.temporal_orders))
    l_ref = fused_step.fused_residual_loss_plain(bundle_fn, tpde, params, torch.from_numpy(z))
    g_ref = dict(zip(params, torch.autograd.grad(l_ref, list(params.values()))))
    l_ref = l_ref.detach()
    spec = fused_step._spec(pair.tmodel, tpde)
    ops = _Recorder()
    with torch.no_grad():
        loss, grads = fused_step._loss_and_grads(ops, spec, torch.from_numpy(z),
                                                 {k: v.detach() for k, v in params.items()})
    routes = {name: ops.calls.count(name) for name in ("gemm", "rowdot", "outer", "wcolsum")}
    assert routes == {"gemm": 8, "rowdot": 1, "outer": 1, "wcolsum": 1}
    loss_tol, grad_tol = BOUNDS[pde]
    assert abs(float(loss) - float(l_ref)) / abs(float(l_ref)) < loss_tol
    assert sorted(grads) == sorted(g_ref)
    for name, ref in g_ref.items():
        assert grads[name].shape == ref.shape, name
        assert rel_to_max(grads[name], ref) < grad_tol, name


def test_siren_bindings_match_the_c_entry_points():
    """Every extern "C" function of siren.cu has a ctypes binding with as
    many arguments."""
    src = (Path(siren.__file__).resolve().parents[2] / "csrc" / "siren.cu").read_text()
    entries = {m.group(1): m.group(2) for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src)}
    assert set(entries) == set(siren._ARGTYPES)
    for name, args in entries.items():
        assert len(args.split(",")) == len(siren._ARGTYPES[name]), name
