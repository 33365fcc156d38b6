"""The point-wise FNO of the port (``models/fno.py``) against
``pinnrl_tpu.models.fno`` on bridged parameters and numpy-seeded inputs.

The port's spectral convolution is ``torch.fft.rfft`` / ``irfft`` (JAX's
``use_dft_matmul=False`` branch); JAX's default computes the same transform
as four matmuls against DFT bases. Both JAX branches are oracles.

Tolerances (each with its reason):
- forward 1e-5 relative to max: float32, the FFT and the matmul bases sum
  in other orders;
- parameter gradients 1e-4 relative to max (the JAX suite's kernel bound);
- the heat_2d residual, an order-2 nested jvp through the FNO (the laplacian
  over both axes and u_t), 1e-4 relative to max.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_helpers import rel_to_max

import pinnrl_tpu.models.fno as jax_fno
from pinnrl_tpu.config import load_config as jax_load_config
from pinnrl_tpu.models import PINNModel as JaxPINNModel
from pinnrl_tpu.pdes import create_pde as jax_create_pde
from pinnrl_tpu_torch.config import load_config
from pinnrl_tpu_torch.models import PINNModel
from pinnrl_tpu_torch.models.bridge import params_from_flax, params_to_flax
from pinnrl_tpu_torch.models.fno import FNONetwork, SpectralConv
from pinnrl_tpu_torch.pdes import create_pde

FWD_TOL = 1e-5
GRAD_TOL = 1e-4
JVP_TOL = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jitter(params, seed, scale=0.1):
    """Move every leaf off flax's init (LayerNorm (1, 0), zero biases)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: a + scale * rng.standard_normal(a.shape).astype(np.float32), params)


@pytest.mark.parametrize("hidden,modes", [(32, 6), (16, 9), (15, 4), (8, 20)])
def test_spectral_conv_matches_both_jax_branches(hidden, modes):
    """Even and odd channel counts, modes reaching the Nyquist bin, and modes
    clipped to hidden // 2 + 1."""
    x = np.random.default_rng(0).standard_normal((64, hidden)).astype(np.float32)
    jmod = jax_fno.SpectralConv(hidden, modes)
    p = _jitter(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)), 1, scale=0.05)
    refs = [np.asarray(jax_fno.SpectralConv(hidden, modes, use_dft_matmul=flag).apply(p, x))
            for flag in (True, False)]
    conv = SpectralConv(hidden, modes)
    assert tuple(conv.w_re.shape) == p["params"]["w_re"].shape
    conv.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in p["params"].items()})
    got = conv(torch.from_numpy(x)).detach()
    for ref in refs:
        assert rel_to_max(got, ref) < FWD_TOL


def _pair(hidden=32, blocks=2, modes=6, seed=0, pde_type="heat_2d"):
    cfgs = [jax_load_config(pde_type=pde_type, architecture="fno"),
            load_config(pde_type=pde_type, architecture="fno", device="cpu")]
    for cfg in cfgs:
        cfg.model.arch_params.update({"hidden_dim": hidden, "num_blocks": blocks, "modes": modes})
    jcfg, tcfg = cfgs
    jmodel, tmodel = JaxPINNModel(jcfg, seed=seed), PINNModel(tcfg, seed=seed)
    jmodel.params = _jitter(jmodel.params, seed + 1, scale=0.05)
    tmodel.module.load_state_dict(params_from_flax(_np(jmodel.params)), strict=True)
    return jcfg, jmodel, tcfg, tmodel


def _z(n=48, seed=3):
    rng = np.random.default_rng(seed)
    lo, hi = np.array([0.0, 0.0, 0.0]), np.array([3.14159, 3.14159, 5.0])
    return (lo + (hi - lo) * rng.random((n, 3))).astype(np.float32)


def test_factory_builds_the_registry_fno_and_bridges_both_ways():
    """The "fno" branch builds hidden 256, 4 blocks, 16 modes, gelu (the
    shipped block), with flax's names; the bridge round-trips exactly."""
    tcfg = load_config(pde_type="heat_2d", architecture="fno", device="cpu")
    model = PINNModel(tcfg)
    jmodel = JaxPINNModel(jax_load_config(pde_type="heat_2d", architecture="fno"))
    jtree = _np(jmodel.params)
    assert isinstance(model.module, FNONetwork) and model.module.num_blocks == 4
    state = params_from_flax(jtree)
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: tuple(v.shape) for k, v in model.module.state_dict().items()}
    model.module.load_state_dict(state, strict=True)
    back, constants = params_to_flax(model.module.state_dict())
    assert constants == {}
    flat = jax.tree_util.tree_leaves_with_path(jtree)
    for path, leaf in flat:
        node = back
        for k in path:
            node = node[k.key]
        assert np.array_equal(node, leaf), path
    assert model.count_parameters() == sum(np.size(v) for _, v in flat)


@pytest.mark.parametrize("dft", [True, False])
def test_forward_and_gradients_match_jax(monkeypatch, dft):
    """PINNModel.apply (the input map, the lift, the blocks, the project)
    against JAX's default (DFT matmuls) and its FFT branch."""
    jcfg, jmodel, tcfg, tmodel = _pair()
    if not dft:
        monkeypatch.setattr(jax_fno, "SpectralConv",
                            functools.partial(jax_fno.SpectralConv, use_dft_matmul=False))
    z = _z()
    ref = np.asarray(jmodel.apply(jmodel.params, jnp.asarray(z)))
    params = {k: v.detach().clone().requires_grad_(True) for k, v in tmodel.params.items()}
    out = tmodel.apply(params, torch.from_numpy(z))
    assert out.shape == (48, 1) and rel_to_max(out, ref) < FWD_TOL
    w = np.random.default_rng(4).standard_normal(ref.shape).astype(np.float32)
    jgrads = jax.grad(lambda p: jnp.sum(jmodel.apply(p, jnp.asarray(z)) * w))(jmodel.params)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), list(params.values()))
    ref_grads = params_from_flax(_np(jgrads))
    for name, g in zip(params, grads):
        assert rel_to_max(g, ref_grads[name]) < GRAD_TOL, name


def test_order2_nested_jvp_through_the_fft_matches_jax():
    """heat_2d's residual u_t - alpha lap(u) through the FNO: the generic
    engine nests torch.func.jvp through rfft/irfft to order 2 (the
    laplacian vmapped over both axes), against JAX's residual; and its
    loss's parameter gradients (reverse over forward)."""
    jcfg, jmodel, tcfg, tmodel = _pair()
    jpde, tpde = jax_create_pde(jcfg), create_pde(tcfg)
    z = _z(64, seed=5)
    x, t = z[:, :2], z[:, 2:]
    ref = np.asarray(jpde.compute_residual(jmodel.apply, jmodel.params, jnp.asarray(x),
                                           jnp.asarray(t)))
    params = {k: v.detach().clone().requires_grad_(True) for k, v in tmodel.params.items()}
    r = tpde.compute_residual(tmodel.apply, params, torch.from_numpy(x), torch.from_numpy(t))
    assert rel_to_max(r, ref.reshape(-1, 1)) < JVP_TOL

    def jloss(p):
        return jnp.mean(jpde.compute_residual(jmodel.apply, p, jnp.asarray(x), jnp.asarray(t)) ** 2)

    jgrads = params_from_flax(_np(jax.grad(jloss)(jmodel.params)))
    # The residual does not depend on the head's bias: its gradient is 0.
    grads = torch.autograd.grad(torch.mean(r**2), list(params.values()), allow_unused=True,
                                materialize_grads=True)
    for name, g in zip(params, grads):
        assert float(g.abs().max()) == 0.0 if name == "Dense_3.bias" else \
            rel_to_max(g, jgrads[name]) < JVP_TOL, name


def test_gelu_nests_under_jvp_at_large_inputs():
    """The FNO's gelu inside nested jvps: torch's fused tanh-gelu gives NaN
    gradients of its second derivative for |x| >~ 50 (it differentiates
    through cosh); the port's gelu runs JAX's plain formula there. Its
    order-2 derivative and that derivative's gradient equal jax.nn.gelu's
    at the file's nested-jvp bound, 1e-4 relative to max (JAX rounds x**3
    as two products, torch's pow once; derivatives of the cube amplify
    that), finite everywhere, over [-300, 300]."""
    from pinnrl_tpu_torch.models.base import gelu

    xs = np.linspace(-300.0, 300.0, 2001).astype(np.float32)

    def jd2(z):
        f = lambda u: jax.nn.gelu(u, approximate=True)  # noqa: E731
        return jax.jvp(lambda u: jax.jvp(f, (u,), (jnp.ones_like(u),))[1], (z,),
                       (jnp.ones_like(z),))[1]

    ref = np.asarray(jd2(jnp.asarray(xs)))
    ref_g = np.asarray(jax.grad(lambda z: jnp.sum(jd2(z)))(jnp.asarray(xs)))
    x = torch.from_numpy(xs).requires_grad_(True)
    v = torch.ones_like(x)
    d2 = torch.func.jvp(lambda z: torch.func.jvp(gelu, (z,), (v,))[1], (x,), (v,))[1]
    g = torch.autograd.grad(d2.sum(), x)[0]
    assert torch.isfinite(d2).all() and torch.isfinite(g).all()
    assert rel_to_max(d2, ref) < JVP_TOL and rel_to_max(g, ref_g) < JVP_TOL
    small = torch.from_numpy(xs[900:1100])
    assert torch.equal(gelu(small), torch.nn.functional.gelu(small, approximate="tanh"))
