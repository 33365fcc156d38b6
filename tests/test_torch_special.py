"""Jacobi elliptic functions and the exact pendulum (``ops/special.py``)
against pinnrl_tpu.ops.special on the same inputs, in float32 and float64.

Tolerances (absolute): ``ellipk``, ``ellipj`` and ``pendulum_theta`` 1e-6 in
float32 and 1e-12 in float64 (the same operations in the same order; the
two libraries' sin/arcsin may round an ulp apart); d/dt of
``pendulum_theta`` (``torch.func.jvp`` against ``jax.jvp``) 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity_helpers  # noqa: F401  (pins torch's CPU threads per worker)

from pinnrl_tpu.ops import special as jax_special
from pinnrl_tpu_torch.ops import special

MS = [0.0, 0.1, 0.5, 0.9, 0.95]
TOLS = {np.float32: 1e-6, np.float64: 1e-12}
DTYPES = {np.float32: torch.float32, np.float64: torch.float64}
OMEGA = float(np.float32(np.sqrt(9.81)))  # the pendulum's omega as JAX rounds it


def _u(dtype, seed=0):
    """|u| up to 12: a grid through both signs and uniform draws."""
    rng = np.random.default_rng(seed)
    return np.concatenate([np.linspace(-12.0, 12.0, 241), rng.uniform(-12.0, 12.0, 200)]).astype(dtype)


def _theta0(m):
    """The release angle whose elliptic parameter sin^2(theta0 / 2) is m."""
    return float(2.0 * np.arcsin(np.sqrt(m)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m", MS)
def test_ellipk_and_ellipj_match_jax(dtype, m):
    u = _u(dtype)
    with jax.enable_x64(dtype == np.float64):
        k_ref = np.asarray(jax_special.ellipk(jnp.asarray(m, dtype)))
        ref = [np.asarray(a) for a in jax_special.ellipj(jnp.asarray(u), m)]
    k_got = special.ellipk(torch.tensor(m, dtype=DTYPES[dtype]))
    got = special.ellipj(torch.from_numpy(u), m)
    assert k_got.dtype == DTYPES[dtype] and abs(float(k_got) - float(k_ref)) < TOLS[dtype]
    for name, a, b in zip(("sn", "cn", "dn"), got, ref):
        assert a.dtype == DTYPES[dtype] and a.shape == u.shape, name
        assert np.abs(a.numpy() - b).max() < TOLS[dtype], name


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m", MS)
def test_pendulum_theta_and_its_time_derivative_match_jax(dtype, m):
    t = (np.abs(_u(dtype, seed=1)) * (10.0 / 12.0)).astype(dtype)  # t in [0, 10]
    theta0 = _theta0(m)
    with jax.enable_x64(dtype == np.float64):
        jt = jnp.asarray(t)
        ref, dref = jax.jvp(lambda tt: jax_special.pendulum_theta(tt, theta0, OMEGA), (jt,),
                            (jnp.ones_like(jt),))
    tt = torch.from_numpy(t)
    got = special.pendulum_theta(tt, theta0, OMEGA)
    _, dgot = torch.func.jvp(lambda s: special.pendulum_theta(s, theta0, OMEGA), (tt,),
                             (torch.ones_like(tt),))
    assert got.dtype == DTYPES[dtype]
    assert np.abs(got.numpy() - np.asarray(ref)).max() < TOLS[dtype]
    assert np.abs(dgot.numpy() - np.asarray(dref)).max() < 1e-5


def test_ellipj_takes_a_tensor_m_per_point():
    """m as a tensor beside u (one value per point) takes the device branch
    of the m = 0 case and agrees with the scalar calls."""
    u = _u(np.float32)
    m = np.resize(np.array(MS, np.float32), u.shape)
    got = special.ellipj(torch.from_numpy(u), torch.from_numpy(m))
    for value in MS:
        sel = m == value
        one = special.ellipj(torch.from_numpy(u[sel]), value)
        for a, b in zip(got, one):
            assert torch.equal(a[torch.from_numpy(sel)], b)
    assert torch.equal(got[2][torch.from_numpy(m == 0.0)], torch.ones(int((m == 0.0).sum())))
