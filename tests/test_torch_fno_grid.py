"""The gridded 2D FNO of the port (``models/fno_grid.py``) against
``pinnrl_tpu.models.fno_grid`` on bridged parameters and numpy-seeded
fields.

The port's spectral convolution is ``torch.fft.rfft2`` / ``irfft2`` on the
two corner blocks (JAX's ``use_fft=True`` branch); JAX's default is the
truncated DFT as matmuls. Both JAX branches are oracles.

Tolerances (each with its reason):
- forward 1e-5 relative to max: float32, the FFT and the DFT matmuls sum in
  other orders;
- parameter gradients 1e-4 relative to max (the JAX suite's kernel bound);
- resolution transfer (weights made at 48^2, evaluated at 64^2) 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_helpers import rel_to_max

import pinnrl_tpu.models.fno_grid as jax_fno_grid
from pinnrl_tpu_torch.models.bridge import params_from_flax, params_to_flax
from pinnrl_tpu_torch.models.fno_grid import GridFNO2D, SpectralConv2d

FWD_TOL = 1e-5
GRAD_TOL = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _field(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _load(module, flax_params):
    module.load_state_dict(params_from_flax(_np(flax_params)), strict=True)


@pytest.mark.parametrize("h,w,m", [(24, 20, 6), (16, 17, 5), (16, 16, 9), (15, 12, 7)])
def test_spectral_conv2d_matches_both_jax_branches(h, w, m):
    """Odd W, modes reaching the Nyquist column, odd H, and modes clipped to
    H // 2 and W // 2 + 1; weights (2, mx, my, C, O) as flax makes them."""
    c, o = 3, 5
    x = _field((2, h, w, c), 0)
    jmod = jax_fno_grid.SpectralConv2d(out_channels=o, modes_x=m, modes_y=m)
    p = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    refs = [np.asarray(jax_fno_grid.SpectralConv2d(o, m, m, use_fft=flag).apply(p, x))
            for flag in (False, True)]
    conv = SpectralConv2d(c, o, m, m, grid=(h, w))
    assert tuple(conv.w_real.shape) == p["params"]["w_real"].shape
    conv.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in p["params"].items()})
    got = conv(torch.from_numpy(x)).detach()
    assert got.shape == (2, h, w, o)
    for ref in refs:
        assert rel_to_max(got, ref) < FWD_TOL


def _pair(width=8, modes=6, blocks=2, grid=(24, 24), in_channels=1, out_channels=1, seed=0):
    jfno = jax_fno_grid.GridFNO2D(in_channels=in_channels, out_channels=out_channels,
                                  width=width, modes=modes, num_blocks=blocks)
    a = _field((1, *grid, in_channels), seed)
    jp = jfno.init(jax.random.PRNGKey(seed), jnp.asarray(a))
    tfno = GridFNO2D(in_channels, out_channels, width, modes, blocks, grid=grid)
    _load(tfno, jp["params"])
    return jfno, jp, tfno


@pytest.mark.parametrize("use_fft", [False, True])
def test_forward_and_gradients_match_jax(monkeypatch, use_fft):
    """Coordinate features, the lift, the blocks and the project, against
    JAX's default and its FFT branch; every parameter gradient of a
    weighted sum of the output."""
    if use_fft:
        monkeypatch.setattr(jax_fno_grid, "SpectralConv2d",
                            functools.partial(jax_fno_grid.SpectralConv2d, use_fft=True))
    jfno, jp, tfno = _pair(in_channels=2, out_channels=3)
    a = _field((3, 24, 24, 2), 5)
    ref = np.asarray(jfno.apply(jp, jnp.asarray(a)))
    out = tfno(torch.from_numpy(a))
    assert out.shape == (3, 24, 24, 3) and rel_to_max(out, ref) < FWD_TOL
    wts = _field(ref.shape, 6)
    jgrads = params_from_flax(_np(jax.grad(
        lambda p: jnp.sum(jfno.apply(p, jnp.asarray(a)) * wts))(jp)["params"]))
    names = [k for k, _ in tfno.named_parameters()]
    grads = torch.autograd.grad((out * torch.from_numpy(wts)).sum(), list(tfno.parameters()))
    for name, g in zip(names, grads):
        assert rel_to_max(g, jgrads[name]) < GRAD_TOL, name


def test_bridge_round_trips_the_grid_tree():
    jfno, jp, tfno = _pair()
    back, constants = params_to_flax(tfno.state_dict())
    assert constants == {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(_np(jp["params"])):
        node = back
        for k in path:
            node = node[k.key]
        assert np.array_equal(node, leaf), path


def test_resolution_transfer_matches_jax():
    """Weights made at 48^2 (12 modes) evaluate unchanged at 64^2, as the
    operator harness's transfer rows do; a grid that keeps other mode
    counts is refused."""
    jfno, jp, tfno = _pair(width=8, modes=12, grid=(48, 48))
    a = _field((2, 64, 64, 1), 7)
    ref = np.asarray(jfno.apply(jp, jnp.asarray(a)))
    with torch.no_grad():
        got = tfno(torch.from_numpy(a))
    assert rel_to_max(got, ref) < FWD_TOL
    with pytest.raises(ValueError, match="keeps 8x9 modes"):
        tfno(torch.zeros((1, 16, 16, 1)))


def test_spectral_conv2d_truncates_high_modes():
    """A pure high-frequency input (mode 10 >> 3) maps to (numerically) zero."""
    h = w = 32
    xs = torch.arange(h, dtype=torch.float32)
    x = torch.cos(2 * torch.pi * 10 * xs / h)[None, :, None, None].expand(1, h, w, 1)
    conv = SpectralConv2d(1, 1, 3, 3, grid=(h, w), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert float(conv(x.contiguous()).abs().max()) < 1e-4
