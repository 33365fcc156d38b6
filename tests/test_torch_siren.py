"""Kernel 3 (the SIREN layer) and the SIREN model: the port against
pinnrl_tpu, and ``_SirenFn`` rehearsed on the CPU with its launch swapped
for the plain version.

Tolerances:
- the plain layer against JAX's ``siren_layer``: 1e-5 relative to max (f32;
  at omega 30 the phases reach tens of radians, where one ulp of the phase
  is ~4e-6);
- nested jvp against JAX's nested ``jax.jvp`` of its kernel's rule: 1e-3
  relative to max, the bound tests/test_kernels.py holds that rule to
  (each order multiplies f32 rounding by omega);
- ``_SirenFn`` against the plain function in float64: 1e-10 relative to
  max (the same arithmetic, arranged by hand in the rules);
- the model forward against flax: 1e-5 relative to max.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_helpers import KDV_DOMAIN, points, rel_to_max, siren_kdv_pair

from pinnrl_tpu.ops.kernels.siren import siren_layer as jax_siren
from pinnrl_tpu_torch.models.bridge import params_from_flax, params_to_flax
from pinnrl_tpu_torch.ops.kernels import siren

TOL = 1e-5
JVP_TOL = 1e-3
F64_TOL = 1e-10
OMEGA = 30.0


def _layer_inputs(n, k, m, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = (2.0 * rng.random((n, k)) - 1.0).astype(dtype)
    bound = np.sqrt(6.0 / k) / OMEGA
    W = rng.uniform(-bound, bound, (k, m)).astype(dtype)
    b = (0.1 * rng.standard_normal(m)).astype(dtype)
    return x, W, b


@pytest.mark.parametrize("n,k,m", [(64, 2, 16), (37, 16, 16), (50, 124, 124)])
def test_plain_layer_matches_jax(n, k, m):
    x, W, b = _layer_inputs(n, k, m, seed=k)
    ref = np.asarray(jax_siren(jnp.asarray(x), jnp.asarray(W), jnp.asarray(b), OMEGA))
    got = siren.siren_layer(*map(torch.from_numpy, (x, W, b)), OMEGA)
    assert got.shape == ref.shape == (n, m)
    assert rel_to_max(got, ref) < TOL


def _two_layer(layer):
    """x (N, 2) -> sum over features of two SIREN layers: a scalar per row."""
    def f(x, W1, b1, W2, b2):
        return layer(layer(x, W1, b1, OMEGA), W2, b2, OMEGA).sum(-1)

    return f


def _nested(f, x, v, order):
    fn = f
    for _ in range(order):
        fn = (lambda prev: (lambda xx: jax.jvp(prev, (xx,), (v,))[1]))(fn)
    return fn(x)


def _nested_torch(f, x, v, order):
    fn = f
    for _ in range(order):
        fn = (lambda prev: (lambda xx: torch.func.jvp(prev, (xx,), (v,))[1]))(fn)
    return fn(x)


def _net_inputs(seed, dtype=np.float32):
    x, W1, b1 = _layer_inputs(48, 2, 12, seed, dtype)
    _, W2, b2 = _layer_inputs(1, 12, 12, seed + 1, dtype)
    v = np.zeros_like(x)
    v[:, 0] = 1.0
    return x, (W1, b1, W2, b2), v


@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_nested_jvp_matches_jax(order):
    x, w, v = _net_inputs(order)
    jw = [jnp.asarray(a) for a in w]
    ref = _nested(lambda xx: _two_layer(jax_siren)(xx, *jw), jnp.asarray(x), jnp.asarray(v), order)
    tw = [torch.from_numpy(a) for a in w]
    got = _nested_torch(lambda xx: _two_layer(siren.siren_layer)(xx, *tw), torch.from_numpy(x),
                        torch.from_numpy(v), order)
    assert rel_to_max(got, np.asarray(ref)) < JVP_TOL


def _fn_layer(x, W, b, omega):
    """The Function with the plain version in place of the CUDA launch."""
    return siren._SirenFn.apply(x, W, b, omega, siren.siren_layer_plain)


@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_function_nested_jvp_rehearsal(order):
    """torch.func.jvp nested to ``order`` through the Function's jvp rule,
    against the plain function: the rule's ops must stay visible to every
    enclosing level."""
    x, w, v = _net_inputs(10 + order, np.float64)
    tw = [torch.from_numpy(a) for a in w]
    x, v = torch.from_numpy(x), torch.from_numpy(v)
    got = _nested_torch(lambda xx: _two_layer(_fn_layer)(xx, *tw), x, v, order)
    ref = _nested_torch(lambda xx: _two_layer(siren.siren_layer_plain)(xx, *tw), x, v, order)
    assert float(ref.abs().max()) > 0.0
    assert rel_to_max(got, ref) < F64_TOL


def test_function_jvp_in_the_weights():
    """Tangents in W and b as well as x, nested twice."""
    x, (W1, b1, W2, b2), _ = _net_inputs(20, np.float64)
    rng = np.random.default_rng(21)
    prim = [torch.from_numpy(a) for a in (x, W1, b1)]
    tang = [torch.from_numpy(rng.standard_normal(a.shape)) for a in (x, W1, b1)]
    W2t, b2t = torch.from_numpy(W2), torch.from_numpy(b2)

    def second(layer):
        f = lambda xx, W, b: layer(layer(xx, W, b, OMEGA), W2t, b2t, OMEGA).sum(-1)  # noqa: E731
        g = lambda *p: torch.func.jvp(f, tuple(p), tuple(tang))[1]  # noqa: E731
        return torch.func.jvp(g, tuple(prim), tuple(tang))[1]

    assert rel_to_max(second(_fn_layer), second(siren.siren_layer_plain)) < F64_TOL


def test_function_reverse_over_forward():
    """torch.autograd.grad of a loss built from order-1..3 jvp outputs (the
    residual's shape) through the Function: its backward at the base level
    and the jvp rule's ops at every level."""
    x, w, v = _net_inputs(30, np.float64)
    x, v = torch.from_numpy(x), torch.from_numpy(v)

    def grads(layer):
        ws = [torch.from_numpy(a).requires_grad_(True) for a in w]
        f = lambda xx: _two_layer(layer)(xx, *ws)  # noqa: E731
        d1, d2, d3 = (_nested_torch(f, x, v, k) for k in (1, 2, 3))
        loss = (f(x) ** 2).mean() + (d1 * d3).mean() + (d2 ** 2).mean()
        return torch.autograd.grad(loss, ws)

    for got, ref in zip(grads(_fn_layer), grads(siren.siren_layer_plain)):
        assert rel_to_max(got, ref) < F64_TOL


def test_function_backward_matches_autograd():
    x, W, b = (torch.from_numpy(a).requires_grad_(True)
               for a in _layer_inputs(40, 12, 9, 5, np.float64))
    g = torch.from_numpy(np.random.default_rng(6).standard_normal((40, 9)))
    got = torch.autograd.grad(_fn_layer(x, W, b, OMEGA), (x, W, b), g)
    ref = torch.autograd.grad(siren.siren_layer_plain(x, W, b, OMEGA), (x, W, b), g)
    for a, r in zip(got, ref):
        assert rel_to_max(a, r) < F64_TOL


def test_function_vmap():
    """torch.func.vmap over the Function's rows (folded into one call), over
    per-row 1-D inputs, and over batched weights (one call per entry)."""
    x, W, b = (torch.from_numpy(a) for a in _layer_inputs(24, 6, 5, 7, np.float64))
    xb = x.reshape(4, 6, 6)
    assert rel_to_max(torch.func.vmap(lambda xx: _fn_layer(xx, W, b, OMEGA))(xb),
                      siren.siren_layer_plain(xb, W, b, OMEGA)) < F64_TOL
    assert rel_to_max(torch.func.vmap(lambda xx: _fn_layer(xx, W, b, OMEGA))(x),
                      siren.siren_layer_plain(x, W, b, OMEGA)) < F64_TOL
    Wb = torch.stack([W, 0.5 * W, -W])
    got = torch.func.vmap(lambda WW: _fn_layer(x, WW, b, OMEGA))(Wb)
    ref = torch.stack([siren.siren_layer_plain(x, WW, b, OMEGA) for WW in Wb])
    assert rel_to_max(got, ref) < F64_TOL


def test_cuda_bindings_match_the_c_entry_points():
    """Every extern "C" function of siren.cu has a ctypes binding with as
    many arguments."""
    src = (Path(siren.__file__).resolve().parents[2] / "csrc" / "siren.cu").read_text()
    entries = {m.group(1): m.group(2) for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src)}
    assert set(entries) == set(siren._ARGTYPES)
    for name, args in entries.items():
        assert len(args.split(",")) == len(siren._ARGTYPES[name]), name
    code = "\n".join(line.split("//")[0] for line in src.splitlines())
    assert "sinf(" in code and "__sinf" not in code  # full-range sin


def test_cpu_tensors_take_the_plain_version_and_other_devices_raise():
    before = siren.siren_layer.launches
    x, W, b = (torch.from_numpy(a) for a in _layer_inputs(8, 2, 4, 0))
    assert torch.equal(siren.siren_layer(x, W, b), siren.siren_layer_plain(x, W, b))
    assert siren.siren_layer.launches == before == 0
    with pytest.raises(ValueError, match="unsupported devices"):
        siren.siren_layer(x.to("meta"), W.to("meta"), b.to("meta"))


# --------------------------------------------------------------------- model


@pytest.mark.parametrize("hidden", [(16,) * 3, (124,) * 7])
def test_forward_matches_flax(hidden):
    pair = siren_kdv_pair(hidden=hidden)
    x, t = points(3, 200, **KDV_DOMAIN)
    z = np.concatenate([x, t], axis=1)
    ref = np.asarray(pair.jmodel.apply(pair.jmodel.params, jnp.asarray(z)))
    got = pair.tmodel.apply(pair.tmodel.params, torch.from_numpy(z))
    assert got.shape == ref.shape == (200, 1)
    assert rel_to_max(got, ref) < TOL


def test_init_bounds_and_zero_biases():
    from pinnrl_tpu_torch.config import load_config
    from pinnrl_tpu_torch.models import PINNModel

    cfg = load_config(pde_type="kdv", device="cpu")
    a, b = PINNModel(cfg, seed=3), PINNModel(cfg, seed=3)
    params = a.params
    assert sorted(params) == sorted([f"SIRENLayer_{i}.{n}" for i in range(7) for n in ("kernel", "bias")]
                                    + ["Dense_0.weight", "Dense_0.bias"])
    for k in params:
        assert torch.equal(params[k], b.params[k])
    first = params["SIRENLayer_0.kernel"].detach()
    assert first.shape == (2, 124) and float(first.abs().max()) <= 0.5
    assert float(first.abs().max()) > 0.45  # U[-1/2, 1/2] over 248 draws
    hidden_bound = np.sqrt(6.0 / 124) / 30.0
    for i in range(1, 7):
        w = params[f"SIRENLayer_{i}.kernel"].detach()
        assert w.shape == (124, 124) and float(w.abs().max()) <= hidden_bound
        assert abs(float(w.std()) - hidden_bound / np.sqrt(3.0)) < 0.05 * hidden_bound
    head = params["Dense_0.weight"].detach()
    assert head.shape == (1, 124) and float(head.abs().max()) <= hidden_bound
    for k, v in params.items():
        if k.endswith("bias"):
            assert float(v.detach().abs().max()) == 0.0, k


def test_bridge_round_trip_is_exact():
    pair = siren_kdv_pair(hidden=(16,) * 3)
    params_np = jax.tree_util.tree_map(np.asarray, pair.jmodel.params)
    state = params_from_flax(params_np)
    back, consts = params_to_flax(state)
    assert consts == {}
    flat_a = jax.tree_util.tree_leaves_with_path(params_np)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.shape == b.shape and np.array_equal(a, b)
    assert tuple(state["SIRENLayer_0.kernel"].shape) == params_np["SIRENLayer_0"]["kernel"].shape
    assert tuple(state["Dense_0.weight"].shape) == params_np["Dense_0"]["kernel"].shape[::-1]
