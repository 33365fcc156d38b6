"""The loss's optional penalties in the port against pinnrl_tpu's
``pdes/base.py``:

- the finite-difference smoothness penalty and its gradients: in float64
  (JAX under x64), 1e-9 and 1e-8; in float32, 5e-5 and 5e-4 (the finite
  difference's cancellation, see the test);
- gPINN on heat (order 2) and KdV (order 4): the penalty and its
  gradients, 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_helpers import (burgers_pair, heat_pair, jax_grad_rels, kdv_pair, points,
                                  torch_params)


def _smoothness_pair(pair, x, t, f64: bool):
    jparams = pair.jmodel.params
    if f64:
        jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float64)), jparams)
        pair.tmodel.module.double()
    ref, g_ref = jax.value_and_grad(lambda p: pair.jpde._fd_smoothness(
        pair.jmodel.apply, p, jnp.asarray(x), jnp.asarray(t)))(jparams)
    params = torch_params(pair.tmodel)
    got = pair.tpde._fd_smoothness(pair.tmodel.apply, params, torch.from_numpy(x),
                                   torch.from_numpy(t))
    grads = dict(zip(params, torch.autograd.grad(got, list(params.values()))))
    return abs(float(got.detach()) - float(ref)) / abs(float(ref)), jax_grad_rels(grads, g_ref)


def test_smoothness_penalty_and_gradients_match_jax():
    """In float64 (JAX under x64) at 1e-9 and 1e-8. In float32 the value at
    5e-5 and the gradients at 5e-4, not 1e-5 and 1e-4: a difference of two
    network outputs divided by the step 1e-4 turns one ulp of u (6e-8 at
    |u| ~ 0.5), by which the packages' forwards differ, into 6e-4 of a
    point's |du| (and the difference of two parameter gradients likewise);
    the mean keeps ~1e-5 of it (the gradients 2.6e-4 of max)."""
    pair = burgers_pair()
    x, t = points(3, 96)
    x[:4, 0] = [-1.0, 1.0, -1.0 + 5e-5, 1.0 - 5e-5]  # the clip at the domain's faces
    err, grad_errs = _smoothness_pair(pair, x, t, f64=False)
    assert err < 5e-5 and max(grad_errs.values()) < 5e-4
    with jax.enable_x64(True):
        err, grad_errs = _smoothness_pair(pair, x.astype(np.float64), t.astype(np.float64),
                                          f64=True)
    assert err < 1e-9 and max(grad_errs.values()) < 1e-8


@pytest.mark.parametrize("kind", ["heat", "kdv"])
def test_gpinn_penalty_and_gradients_match_jax(kind):
    """Heat's residual is order 2 (gPINN order 3), KdV's order 3 (4)."""
    pair = heat_pair() if kind == "heat" else kdv_pair(hidden=(16, 16), mapping=8)
    dom = dict(domain=pair.tpde.domain, time_domain=pair.tpde.time_domain)
    x, t = points(11, 48, **dom)
    ref, g_ref = jax.value_and_grad(lambda p: pair.jpde._gpinn_loss(
        pair.jmodel.apply, p, jnp.asarray(x), jnp.asarray(t)))(pair.jmodel.params)
    params = torch_params(pair.tmodel)
    got = pair.tpde._gpinn_loss(pair.tmodel.apply, params, torch.from_numpy(x),
                                torch.from_numpy(t))
    grads = dict(zip(params, torch.autograd.grad(got, list(params.values()), allow_unused=True,
                                                 materialize_grads=True)))
    assert abs(float(got.detach()) - float(ref)) / abs(float(ref)) < 1e-4
    assert max(jax_grad_rels(grads, g_ref).values()) < 1e-4
