"""The threefry replica (``pinnrl_tpu_torch/utils/prng.py``) against
``jax.random`` on the CPU (jax 0.9's defaults: threefry-2x32, partitionable
bits): keys, splits and fold-ins bit for bit, ``uniform`` bit for bit,
``normal`` within 2 ulp (XLA's erfinv as its CPU code rounds it; it comes
out bit for bit here too), and the two constants the port draws with it,
the Fourier basis of a ``feature_seed`` and the ``random`` IC's series,
against the JAX package's own draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity_helpers  # noqa: F401  (pins torch's CPU threads per worker)

from pinnrl_tpu_torch.models.fourier import FourierFeatures, feature_basis
from pinnrl_tpu_torch.pdes.base import random_ic_basis
from pinnrl_tpu_torch.utils import prng

SEEDS = [0, 1, 2, 7, 42, 1234, 99991, 2**31 - 1]
SHAPES = [(1,), (5,), (2, 128), (3, 17), (4, 3, 5), (20001,)]


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.max(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_splits_and_fold_ins_are_bit_equal(seed):
    key = jax.random.PRNGKey(seed)
    mine = prng.PRNGKey(seed)
    assert np.array_equal(np.asarray(key), mine)
    for num in (1, 2, 3, 7):
        assert np.array_equal(np.asarray(jax.random.split(key, num)), prng.split(mine, num))
    for data in (0, 1, 5, 1000, 2**31 - 1):
        assert np.array_equal(np.asarray(jax.random.fold_in(key, data)), prng.fold_in(mine, data))
    # Chains: a fold-in of a split, a split of a fold-in.
    k1 = jax.random.split(jax.random.fold_in(key, 3), 3)[2]
    m1 = prng.split(prng.fold_in(mine, 3), 3)[2]
    assert np.array_equal(np.asarray(k1), m1)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_uniform_is_bit_equal(seed, shape):
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(jax.random.uniform(key, shape))
    assert prng.uniform(prng.PRNGKey(seed), shape).tobytes() == ref.tobytes()
    ref = np.asarray(jax.random.uniform(key, shape, minval=-1.5, maxval=2 * jnp.pi))
    assert prng.uniform(prng.PRNGKey(seed), shape, -1.5, 2 * np.pi).tobytes() == ref.tobytes()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_normal_within_two_ulp(seed, shape):
    ref = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    got = prng.normal(prng.PRNGKey(seed), shape)
    assert got.shape == ref.shape and got.dtype == np.float32
    assert _ulps(got, ref) <= 2


def test_erfinv_matches_xla_over_its_range():
    """XLA's float32 erfinv on 400k points across (-1, 1), both of its
    polynomial branches and both of log1p's."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
    u = prng.uniform(prng.PRNGKey(5), (400_000,), lo, 1.0)
    u = np.concatenate([u, np.float32([0.0, 0.5, -0.5, 0.999999, -0.9999999, 1e-8])])
    ref = np.asarray(jax.lax.erf_inv(jnp.asarray(u)))
    assert _ulps(prng.erfinv(u), ref) <= 2


@pytest.mark.parametrize("seed,in_dim,m", [(0, 2, 128), (0, 2, 256), (1, 2, 256), (3, 3, 64),
                                           (17, 4, 32), (123, 1, 8)])
def test_feature_basis_equals_jax(seed, in_dim, m):
    ref = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (in_dim, m)))
    assert _ulps(feature_basis(seed, in_dim, m).numpy(), ref) <= 2


def test_feature_seed_scales_as_flax():
    """``FourierFeatures(feature_seed=s)`` against flax's module with the
    same seed: an isotropic and an anisotropic scale."""
    from pinnrl_tpu.models.fourier import FourierFeatures as JaxFF

    x = jnp.zeros((1, 3), jnp.float32)
    for scale in (2.5, (0.0, 1.5, 3.0)):
        jB = JaxFF(16, scale, feature_seed=11).init(jax.random.PRNGKey(0), x)["constants"]["B"]
        tB = FourierFeatures(3, 16, scale, feature_seed=11).B
        assert _ulps(tB.numpy(), np.asarray(jB)) <= 2


@pytest.mark.parametrize("seed,modes,dim", [(0, 16, 1), (0, 16, 2), (0, 16, 3), (1, 16, 1),
                                            (0, 8, 2), (5, 32, 3), (9, 4, 4)])
def test_random_ic_basis_equals_jax(seed, modes, dim):
    k_w, k_p, k_a = jax.random.split(jax.random.PRNGKey(seed), 3)
    ref = (jax.random.normal(k_w, (dim, modes)) * 4.0,
           jax.random.uniform(k_p, (modes,), maxval=2 * jnp.pi),
           jax.random.normal(k_a, (modes,)) / jnp.sqrt(modes))
    got = random_ic_basis(seed, modes, dim)
    for g, r in zip(got, ref):
        assert isinstance(g, torch.Tensor) and g.dtype == torch.float32
        assert _ulps(g.numpy(), np.asarray(r, np.float32)) <= 2


@pytest.mark.parametrize("dim,seed,modes", [(1, 3, 16), (2, 0, 8), (4, 2, 16)])
def test_random_ic_matches_the_jax_pde_outside_the_former_table(dim, seed, modes):
    """The ``random`` IC target of both packages' PDE on the same points,
    at seeds, mode counts and dimensions the former table did not hold."""
    from pinnrl_tpu.config import load_config as jax_load_config
    from pinnrl_tpu.pdes import create_pde as jax_create_pde
    from pinnrl_tpu_torch.config import load_config
    from pinnrl_tpu_torch.pdes import create_pde

    ic = {"type": "random", "amplitude": 0.3, "seed": seed, "n_modes": modes}
    cfgs = [jax_load_config(pde_type="heat"), load_config(pde_type="heat", device="cpu")]
    for cfg in cfgs:
        cfg.pde.dimension = dim
        cfg.pde.domain = [[0.0, 1.0]] * dim
        cfg.model.input_dim = dim + 1
        cfg.pde.initial_condition = dict(ic)
    x = np.random.default_rng(seed).random((64, dim)).astype(np.float32)
    t = np.zeros((64, 1), np.float32)
    ref = np.asarray(jax_create_pde(cfgs[0]).boundary_conditions["initial"](jnp.asarray(x),
                                                                            jnp.asarray(t)))
    got = create_pde(cfgs[1]).boundary_conditions["initial"](torch.from_numpy(x),
                                                             torch.from_numpy(t))
    # The series are bit-equal; the phases x W + phase (up to ~10 rad) are
    # summed in another order, an ulp of which is ~1e-6 of the target.
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
