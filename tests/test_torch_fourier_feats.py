"""Fourier-feature op: the port's plain version (what the wrapper runs on
CPU tensors) against pinnrl_tpu's fourier_features, primal and gradient.

Tolerance 1e-5 relative to max: f32, phases up to tens of radians, where
one ulp of the phase is ~4e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_helpers import rel_to_max

from pinnrl_tpu.ops.kernels.fourier_feats import fourier_features as jax_ff
from pinnrl_tpu_torch.ops.kernels.fourier_feats import fourier_features

TOL = 1e-5


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("d", [1, 2, 3])
def test_primal_and_gradient_match_jax(periodic, d):
    rng = np.random.default_rng(d)
    x = (2.0 * rng.random((64, d)) - 1.0).astype(np.float32)
    B = (2.0 * rng.standard_normal((d, 16))).astype(np.float32)
    g = rng.standard_normal((64, 32)).astype(np.float32)

    out_j, vjp = jax.vjp(lambda a, b: jax_ff(a, b, periodic), jnp.asarray(x), jnp.asarray(B))
    gx_j, gB_j = vjp(jnp.asarray(g))

    xt = torch.from_numpy(x).requires_grad_(True)
    Bt = torch.from_numpy(B).requires_grad_(True)
    out_t = fourier_features(xt, Bt, periodic)
    gx_t, gB_t = torch.autograd.grad(out_t, (xt, Bt), torch.from_numpy(g))

    assert rel_to_max(out_t, out_j) < TOL
    assert rel_to_max(gx_t, gx_j) < TOL
    assert rel_to_max(gB_t, gB_j) < TOL


def test_cuda_function_backward_formula_on_cpu():
    """The autograd.Function's backward (written on the kernel's output) is
    the exact VJP: run it on CPU with the plain forward standing in."""
    from pinnrl_tpu_torch.ops.kernels import fourier_feats as ff

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((32, 2), np.float32)).requires_grad_(True)
    B = torch.from_numpy(rng.standard_normal((2, 8)).astype(np.float32)).requires_grad_(True)
    g = torch.from_numpy(rng.standard_normal((32, 16)).astype(np.float32))

    class Ctx:
        needs_input_grad = (True, True, False)
        two_pi = True
        saved_tensors = (x.detach(), B.detach(), ff.fourier_features_plain(x.detach(), B.detach()))

    gx, gB, _ = ff._FourierFeaturesFn.backward(Ctx, g)
    rx, rB = torch.autograd.grad(ff.fourier_features_plain(x, B), (x, B), g)
    assert rel_to_max(gx, rx) < TOL and rel_to_max(gB, rB) < TOL
