"""The port's collocation samplers against pinnrl_tpu.sampling.

jax.random and torch.Generator give different streams, so each sampler's
deterministic helper is fed JAX's own draws, computed from the key splits
the JAX sampler makes (``k_pool, k_pick`` for RAR, ``k_pick, k_jit`` for the
adaptive sampler). The helpers must then pick the same indices, and the
points must agree within 1e-6 (f32 coordinates of the same draws).
``residual_score`` agrees at 1e-5 relative to max on bridged parameters
(the compute_loss bound: the same f32 stacked-jet bundle).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_helpers import burgers_pair, points, rel_to_max

from pinnrl_tpu.sampling import strategies as jstrat
from pinnrl_tpu_torch.sampling import strategies as tstrat

POINT_TOL = 1e-6
DOMAIN, TIME = [(-1.0, 1.0)], (0.0, 1.0)
_TINY = np.finfo(np.float32).tiny


def draw(arr) -> torch.Tensor:
    return torch.from_numpy(np.array(arr))


def _close(got, ref, tol=POINT_TOL):
    return float(np.max(np.abs(got.numpy() - np.asarray(ref)))) <= tol


def _score_j(g):
    return jnp.sin(3.0 * g[:, 0]) * jnp.cos(2.0 * g[:, -1]) + 0.1 * g[:, 0]


def _score_t(g):
    return torch.sin(3.0 * g[:, 0]) * torch.cos(2.0 * g[:, -1]) + 0.1 * g[:, 0]


@pytest.mark.parametrize("domain,ppa", [(DOMAIN, 10), ([(-1.0, 1.0), (0.0, 2.0)], 7), (DOMAIN, 100)])
def test_make_grid_matches_jax(domain, ppa):
    ref = np.asarray(jstrat.make_grid(domain, TIME, ppa))
    got = tstrat.make_grid(domain, TIME, ppa, device="cpu")
    assert got.shape == ref.shape == (ppa ** (len(domain) + 1), len(domain) + 1)
    assert _close(got, ref)


def test_gumbel_top_k_and_categorical_pick_jax_indices():
    rng = np.random.default_rng(0)
    logp = np.log(rng.random(200).astype(np.float32) * 3 + 0.5)
    key = jax.random.PRNGKey(1)
    u = jax.random.uniform(key, (200,))
    g = -jnp.log(-jnp.log(u + 1e-12) + 1e-12)
    _, ref = jax.lax.top_k(jnp.asarray(logp) + g, 60)
    got = tstrat._gumbel_top_k(draw(logp), draw(u), 60)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    ref = jax.random.categorical(key, jnp.asarray(logp), shape=(300,))
    u = jax.random.uniform(key, (300, 200), minval=_TINY, maxval=1.0)  # what categorical draws
    got = tstrat._categorical(draw(logp), draw(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("n", [40, 100, 150])  # top-k, top-k of the whole grid, categorical
def test_sample_adaptive_matches_jax(n):
    ppa = 10
    key = jax.random.PRNGKey(2)
    xr, tr = jstrat.sample_adaptive(key, n, DOMAIN, TIME, score_fn=_score_j, points_per_axis=ppa)
    k_pick, k_jit = jax.random.split(key)
    G = ppa * ppa
    if n <= G:
        u = jax.random.uniform(k_pick, (G,))
    else:
        u = jax.random.uniform(k_pick, (n, G), minval=_TINY, maxval=1.0)
    jit = jax.random.uniform(k_jit, (n, 2), minval=-0.5, maxval=0.5)
    grid = tstrat.make_grid(DOMAIN, TIME, ppa, device="cpu")
    lo, hi = tstrat._bounds(DOMAIN, TIME, "cpu")
    x, t = tstrat._adaptive_pick(grid, _score_t(grid), n, draw(u), draw(jit), lo, hi, ppa)
    assert x.shape == (n, 1) and t.shape == (n, 1)
    assert _close(x, xr) and _close(t, tr)
    # The same cells: each point is its cell's grid point moved by under half a cell.
    cell = 2.0 / (ppa - 1)
    assert np.array_equal(np.round((x.numpy() + 1.0) / cell), np.round((np.asarray(xr) + 1.0) / cell))


def test_sample_adaptive_public_path():
    gen = torch.Generator().manual_seed(0)
    x, t = tstrat.sample_adaptive(gen, 64, DOMAIN, TIME, score_fn=_score_t, points_per_axis=10)
    assert x.shape == (64, 1) and t.shape == (64, 1)
    assert float(x.min()) >= -1.0 and float(x.max()) <= 1.0
    assert float(t.min()) >= 0.0 and float(t.max()) <= 1.0
    # Without replacement, 64 of 100 cells: no cell twice.
    cells = torch.round((x + 1.0) / (2.0 / 9)) * 10 + torch.round(t / (1.0 / 9))
    assert len(set(cells.reshape(-1).tolist())) == 64
    x, t = tstrat.sample_adaptive(gen, 64, DOMAIN, TIME)  # no agent: uniform
    assert x.shape == (64, 1) and float(x.abs().max()) <= 1.0


def _rar_jax_draws(key, n, pool_factor, chunk_size, replace):
    k_pool, k_pick = jax.random.split(key)
    pool = tstrat._pool_size(n, pool_factor, chunk_size)
    xp, tp = jstrat.sample_uniform(k_pool, pool, DOMAIN, TIME)
    if replace:
        u = jax.random.uniform(k_pick, (n, pool), minval=_TINY, maxval=1.0)
    else:
        u = jax.random.uniform(k_pick, (pool,))
    return draw(xp), draw(tp), draw(u)


@pytest.mark.parametrize("replace,chunk_size,floor,power,zero", [
    (False, 8192, 4.0, 1.0, False),   # the shipped RAD defaults
    (True, 8192, 4.0, 1.0, False),    # with replacement
    (False, 64, 4.0, 1.0, False),     # pool 160 > chunk 64: rounded to 192, scored in 3 chunks
    (True, 64, 1.0, 2.0, False),      # chunked, k = 2, c = 1
    (False, 8192, 0.0, 1.0, True),    # the all-zero guard
])
def test_sample_residual_based_matches_jax(replace, chunk_size, floor, power, zero):
    n, key = 40, jax.random.PRNGKey(3)
    calls = []

    def res_j(x, t):
        return 0.0 * x if zero else jnp.sin(3.0 * x) * (t + 0.2)

    def res_t(x, t):
        calls.append(x.shape[0])
        return 0.0 * x if zero else torch.sin(3.0 * x) * (t + 0.2)

    kw = dict(pool_factor=4, uniform_floor=floor, power=power, replace=replace, chunk_size=chunk_size)
    xr, tr = jstrat.sample_residual_based(key, n, DOMAIN, TIME, residual_fn=res_j, **kw)
    xp, tp, u = _rar_jax_draws(key, n, 4, chunk_size, replace)
    x, t = tstrat._residual_based(xp, tp, res_t, n, u, eps=1e-8, uniform_floor=floor, power=power,
                                  replace=replace, chunk_size=chunk_size)
    assert calls == ([chunk_size] * 3 if chunk_size == 64 else [160])
    assert x.shape == (n, 1) and t.shape == (n, 1)
    assert _close(x, xr) and _close(t, tr)
    picked = [int(np.flatnonzero(xp.numpy()[:, 0] == v)[0]) for v in x.numpy()[:, 0]]
    ref = [int(np.flatnonzero(np.asarray(xp)[:, 0] == v)[0]) for v in np.asarray(xr)[:, 0]]
    assert picked == ref
    if not replace:
        assert len(set(picked)) == n


def test_sample_residual_based_public_path():
    gen = torch.Generator().manual_seed(1)
    x, t = tstrat.sample_residual_based(gen, 30, DOMAIN, TIME, residual_fn=lambda x, t: x * t,
                                        chunk_size=50)
    assert x.shape == (30, 1) and t.shape == (30, 1)
    assert float(x.abs().max()) <= 1.0 and 0.0 <= float(t.min()) and float(t.max()) <= 1.0
    x, t = tstrat.sample_residual_based(gen, 30, DOMAIN, TIME)  # no residual: uniform
    assert x.shape == (30, 1)


@pytest.mark.parametrize("domain", [DOMAIN, [(-1.0, 1.0), (0.0, 3.0)]])
def test_sample_stratified_one_point_per_bin(domain):
    n = 50
    x, t = tstrat.sample_stratified(torch.Generator().manual_seed(2), n, domain, TIME)
    assert x.shape == (n, len(domain)) and t.shape == (n, 1)
    z = torch.cat([x, t], dim=-1).numpy()
    bounds = list(domain) + [TIME]
    for i, (lo, hi) in enumerate(bounds):
        bins = np.floor((z[:, i] - lo) / (hi - lo) * n).astype(int)
        assert sorted(bins.tolist()) == list(range(n)), i


def test_stratified_helper_matches_jax():
    n, key = 30, jax.random.PRNGKey(4)
    xr, tr = jstrat.sample_stratified(key, n, DOMAIN, TIME)
    keys = jax.random.split(key, 4)
    jitter = draw(np.stack([np.asarray(jax.random.uniform(keys[2 * i], (n,))) for i in range(2)]))
    perm = draw(np.stack([np.asarray(jax.random.permutation(keys[2 * i + 1], n)) for i in range(2)]))
    lo, hi = tstrat._bounds(DOMAIN, TIME, "cpu")
    x, t = tstrat._stratified(jitter, perm.long(), lo, hi)
    assert _close(x, xr) and _close(t, tr)


def test_residual_score_matches_jax():
    pair = burgers_pair()
    pair.jpde.attach_fast_bundle(pair.jmodel)
    pair.tpde.attach_fast_bundle(pair.tmodel)
    x, t = points(12, 200)
    ref = pair.jpde.residual_score(pair.jmodel.apply, pair.jmodel.params, jnp.asarray(x), jnp.asarray(t), {})
    with torch.no_grad():
        got = pair.tpde.residual_score(pair.tmodel.apply, pair.tmodel.params,
                                       torch.from_numpy(x), torch.from_numpy(t))
    assert got.shape == (200,) and bool((got >= 0).all())
    assert rel_to_max(got, ref) < 1e-5


def test_generate_collocation_points_passes_the_hooks_through():
    pair = burgers_pair()
    gen = torch.Generator().manual_seed(5)
    seen = []

    def score_fn(grid):
        seen.append(("score", tuple(grid.shape)))
        return _score_t(grid)

    def residual_fn(x, t):
        seen.append(("residual", tuple(x.shape)))
        return x * t

    x, _ = pair.tpde.generate_collocation_points(gen, 16, "adaptive", score_fn=score_fn)
    assert x.shape == (16, 1)
    x, _ = pair.tpde.generate_collocation_points(gen, 16, "residual_based", residual_fn=residual_fn,
                                                 pool_factor=2)
    assert x.shape == (16, 1)
    assert seen == [("score", (10000, 2)), ("residual", (32, 1))]
    with pytest.raises(ValueError, match="Unknown sampling strategy"):
        pair.tpde.generate_collocation_points(gen, 16, "sobol")
