"""Kernel 1's products on the CPU: which go to the GEMM core (``ops.gemm``,
``csrc/sgemm_sm90.cuh`` on the card) and which to the output layer's row
passes (``rowdot``, ``outer``, ``wcolsum``), the plain twins of those passes
against ``@`` in float64, the split over K for the core's 128x128 tile at
the recipes' shapes, the launcher with its plain twins against
torch.autograd at the Burgers and KdV recipes' widths; kernel 4's launch
sequence and the split of its product; the ctypes bindings of kernels 3 and
4's entry points.

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
from pinnrl_tpu_torch.ops.kernels import _gemm_core, fused_step, mlp, siren

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


def _scorer_params(rng, h, a_dim):
    """A DQN scorer's parameters at width h, LayerNorm away from (1, 0)."""
    return {"Dense_0.weight": _rng_tensor(rng, h, 2), "Dense_0.bias": _rng_tensor(rng, h),
            "LayerNorm_0.weight": 1.0 + 0.1 * _rng_tensor(rng, h),
            "LayerNorm_0.bias": _rng_tensor(rng, h),
            "Dense_1.weight": _rng_tensor(rng, h, h) / h ** 0.5, "Dense_1.bias": _rng_tensor(rng, h),
            "LayerNorm_1.weight": 1.0 + 0.1 * _rng_tensor(rng, h),
            "LayerNorm_1.bias": _rng_tensor(rng, h),
            "Dense_2.weight": _rng_tensor(rng, a_dim, h), "Dense_2.bias": _rng_tensor(rng, a_dim)}


@pytest.mark.parametrize("n,h,a_dim", [(50, 16, 1), (10000, 512, 1)])
def test_mlp_scorer_stays_on_one_gemm(n, h, a_dim):
    """Kernel 4's launcher: first pass, W2's transpose, one ``gemm`` on the
    core with B = W2^T n-contiguous (split over K in two at the shipped
    (10000, 512, 1), b2 then added by the head), the head; in float64
    against the plain version."""
    calls = []

    class Ops(mlp._TorchOps):
        def __getattribute__(self, name):
            if name in ("dense_ln_relu_in", "transpose", "gemm", "ln_relu_head"):
                calls.append(name)
            return object.__getattribute__(self, name)

        def gemm(self, M, N, K, A, sam, sak, B, sbk, sbn, C, ldc, bias, bias_rows, splits,
                 k_chunk):
            calls.append(((M, N, K), (sam, sak), (sbk, sbn), bias is None, bias_rows, splits,
                          k_chunk))
            return super().gemm(M, N, K, A, sam, sak, B, sbk, sbn, C, ldc, bias, bias_rows, splits,
                                k_chunk)

        def ln_relu_head(self, P, b2, *args):
            calls.append((tuple(P.shape), b2 is None))
            return super().ln_relu_head(P, b2, *args)

    rng = np.random.default_rng(n + h)
    P = _scorer_params(rng, h, a_dim)
    x = torch.from_numpy(rng.uniform(-1.0, 1.0, (n, 2)))
    got = mlp._score(Ops(), x, P, 1e-6)
    splits, k_chunk = (2, h // 2) if (n, h) == (10000, 512) else (1, h)
    assert calls == ["dense_ln_relu_in", "transpose", "gemm",
                     ((n, h, h), (h, 1), (h, 1), splits > 1, n, splits, k_chunk),
                     "ln_relu_head", ((splits, n, h), splits == 1)]
    assert got.shape == (n, a_dim)
    assert rel_to_max(got, mlp.fused_mlp_score_plain(x, P)) < 1e-12


@pytest.mark.parametrize("n,h", [(10000, 512), (10001, 512), (1000, 128), (37, 40), (1, 30)])
def test_scorer_product_split(n, h):
    """The split of kernel 4's product over K: chunks of whole BK = 8 slices
    that cover K exactly; in two only where the unsplit tiles fill between
    one and two waves of ``TARGET_BLOCKS``, as at the shipped (10000, 512):
    316 tiles would fill 1.2 waves and 632 fill 2.4 of half the length."""
    splits, chunk = mlp._product_split(n, h, h)
    tiles = -(-n // 128) * -(-h // 128)
    assert chunk % _gemm_core.BK == 0
    assert (splits - 1) * chunk < h <= splits * chunk
    assert splits == (2 if _gemm_core.TARGET_BLOCKS < tiles < 2 * _gemm_core.TARGET_BLOCKS else 1)
    if h == 512 and n >= 10000:
        assert (splits, chunk) == (2, 256)
        assert tiles * splits == 632 == mlp._TorchOps().gemm_blocks(n, h, splits)
    for want in (1, 2, 3):  # forced splits: the same rules
        s, c = _gemm_core.split_chunks(h, want)
        assert c % _gemm_core.BK == 0 and (s - 1) * c < h <= s * c and s <= want


@pytest.mark.parametrize("bias_rows,splits", [(4, 2), (2, 1)])
def test_scorer_twins_refuse_a_bias_on_split_partials(bias_rows, splits):
    """Every split's epilogue would add the bias, and kernel 4's GEMM has no
    row test: the C entry refuses a bias on split partials or on fewer than
    M rows, and so does its twin."""
    A, B = torch.ones(4, 8, dtype=torch.float64), torch.ones(8, 4, dtype=torch.float64)
    C = torch.empty(2, 4, 4, dtype=torch.float64)
    with pytest.raises(ValueError, match="unsplit"):
        mlp._TorchOps().gemm(4, 4, 8, A, 8, 1, B, 4, 1, C, 4, torch.ones(4, dtype=torch.float64),
                             bias_rows, splits, 8 // splits)


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
    ``TARGET_BLOCKS`` blocks of the 128x128 tile."""
    shapes = _recipe_products(pde)
    assert len(shapes) == 11
    M, K, N = shapes[index]
    splits, chunk = fused_step._split_k(M, N, K)
    tiles = -(-M // _gemm_core.TILE) * -(-N // _gemm_core.TILE)
    assert _gemm_core.TILE == 128 and _gemm_core.BK == 8
    assert splits >= 1 and chunk % _gemm_core.BK == 0
    assert (splits - 1) * chunk < K <= splits * chunk
    assert splits <= max(1, -(-_gemm_core.TARGET_BLOCKS // tiles))
    if K >= 32768 and min(M, N) > 1:  # the hidden layers' dW fill the card
        assert tiles * splits >= _gemm_core.TARGET_BLOCKS // 2


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


def _c_entries(source: str):
    src = (Path(siren.__file__).resolve().parents[2] / "csrc" / source).read_text()
    return {m.group(1): m.group(2) for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src)}


def test_siren_bindings_match_the_c_entry_points():
    """Every extern "C" function of siren.cu has a ctypes binding with as
    many arguments."""
    entries = _c_entries("siren.cu")
    assert set(entries) == set(siren._ARGTYPES)
    for name, args in entries.items():
        assert len(args.split(",")) == len(siren._ARGTYPES[name]), name


def test_mlp_score_bindings_match_the_c_entry_points():
    """Every extern "C" function of mlp_score.cu has a ctypes binding with
    as many arguments, and a plain twin of the same name in ``_TorchOps``."""
    entries = _c_entries("mlp_score.cu")
    assert set(entries) == set(mlp._CudaOps._ARGTYPES)
    for name, args in entries.items():
        assert len(args.split(",")) == len(mlp._CudaOps._ARGTYPES[name]), name
        assert callable(getattr(mlp._TorchOps, name[len("ms_"):])), name


def test_one_gemm_core_in_csrc():
    """The port has one FP32 GEMM: every .cu that runs a product includes
    the Hopper core and runs its tile, kernels 1 and 4 through the header's
    one linear-layer GEMM (``sm90_gemm``), and no other GEMM header is left
    (the one other header, the generated residual's skeleton, runs no
    product)."""
    csrc = Path(siren.__file__).resolve().parents[2] / "csrc"
    assert sorted(p.name for p in csrc.glob("*.cuh")) == ["residual_generated.cuh",
                                                          "sgemm_sm90.cuh"]
    assert "gemm" not in (csrc / "residual_generated.cuh").read_text().lower()
    assert "gemm_sm90_tile<" in (csrc / "sgemm_sm90.cuh").read_text()
    for name, call in (("fused_residual.cu", "sm90_gemm<true>("),
                       ("mlp_score.cu", "sm90_gemm<false>("), ("siren.cu", "gemm_sm90_tile<")):
        src = (csrc / name).read_text()
        assert '#include "sgemm_sm90.cuh"' in src and call in src, name
        assert "__launch_bounds__(TileLarge" not in src, name  # no second copy of the kernel
