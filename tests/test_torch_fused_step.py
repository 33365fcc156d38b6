"""Fused residual loss: the port's plain version against the JAX Pallas
kernel (interpret mode), and the CUDA kernels' host launcher run with their
plain PyTorch twins against torch.autograd.

Tolerances: loss 1e-5 relative, each gradient 1e-4 relative to its max (the
bounds the JAX suite holds its fused kernel to; the sums run in another
order). The hand-derived transport backward is checked at 1e-5 relative to
max in f32 (and at 1e-12 in f64, where only rounding separates it from
autograd). Causal weighting: loss 1e-5, gradients 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_helpers import burgers_pair, points, rel_to_max, torch_params

from pinnrl_tpu.ops.kernels import fused_step as jax_fused
from pinnrl_tpu_torch.ops.jet_mlp import make_bundle_fn
from pinnrl_tpu_torch.ops.kernels import _gemm_core, fused_step

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4


def _z(seed=7, n=128):
    x, t = points(seed, n)
    return np.concatenate([x, t], axis=1)


def _plain_loss_and_grads(pair, params, z):
    bundle_fn = make_bundle_fn(pair.tmodel, 1, 2, 1)
    loss = fused_step.fused_residual_loss_plain(bundle_fn, pair.tpde, params, torch.from_numpy(z))
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


@pytest.mark.parametrize("layer_norm", [True, False])
def test_plain_version_matches_jax_interpret_kernel(layer_norm):
    pair = burgers_pair(layer_norm=layer_norm)
    z = _z()
    fused_j = jax_fused.make_fused_residual_loss(pair.jmodel, pair.jpde, tile=32, interpret=True)
    l_j, g_j = jax.value_and_grad(lambda p: fused_j(p, jnp.asarray(z)))(pair.jmodel.params)
    params = torch_params(pair.tmodel)
    l_t, g_t = _plain_loss_and_grads(pair, params, z)
    assert abs(float(l_t) - float(l_j)) / abs(float(l_j)) < LOSS_TOL
    for name, g in g_t.items():
        module, leaf = name.split(".")
        jleaf = {"weight": "kernel" if module.startswith("Dense") else "scale", "bias": "bias"}[leaf]
        ref = np.asarray(g_j[module][jleaf])
        got = g.detach().numpy()
        got = got.T if got.ndim == 2 else got
        assert rel_to_max(got, ref) < GRAD_TOL, name


@pytest.mark.parametrize("layer_norm", [True, False])
def test_kernel_launcher_with_plain_twins_matches_autograd(layer_norm):
    """The host launcher of the CUDA kernels (layouts, strides, split-K,
    colsums, the hand-derived backward) run with the plain twins."""
    pair = burgers_pair(layer_norm=layer_norm, hidden=(32, 24, 16))
    z = _z(n=160)
    params = torch_params(pair.tmodel)
    l_ref, g_ref = _plain_loss_and_grads(pair, params, z)
    spec = fused_step._spec(pair.tmodel, pair.tpde)
    with torch.no_grad():
        loss, grads = fused_step._loss_and_grads(
            fused_step._TorchOps(), spec, torch.from_numpy(z), {k: v.detach() for k, v in params.items()})
    assert sorted(grads) == sorted(g_ref)
    assert abs(float(loss) - float(l_ref)) / abs(float(l_ref)) < LOSS_TOL
    for name in g_ref:
        assert grads[name].shape == g_ref[name].shape
        assert rel_to_max(grads[name], g_ref[name]) < GRAD_TOL, name
    # Validation's loss-only run: the same forward, no reverse pass.
    with torch.no_grad():
        loss_only, none = fused_step._loss_and_grads(
            fused_step._TorchOps(), spec, torch.from_numpy(z), {k: v.detach() for k, v in params.items()},
            need_grads=False)
    assert none == {} and torch.equal(loss_only, loss)


@pytest.mark.parametrize("dim", [1, 2, 3, 4, 5, 8])
@pytest.mark.parametrize("x_order", [1, 2, 3])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("layer_norm", [True, False])
def test_transport_backward_matches_autograd(dtype, tol, layer_norm, x_order, dim):
    """The hand-derived reverse pass of the [value; dim x-groups of x1..xK;
    t1] transport, K = 1 (convection), K = 2 (Burgers) and K = 3 (KdV), in
    1-5 and 8 space dimensions."""
    rng = np.random.default_rng(11)
    n, width, streams = 24, 40, 2 + dim * x_order
    H = torch.tensor(rng.standard_normal((streams * n, width)), dtype=dtype, requires_grad=True)
    gamma = torch.tensor(1.0 + 0.2 * rng.standard_normal(width), dtype=dtype, requires_grad=True)
    beta = torch.tensor(0.2 * rng.standard_normal(width), dtype=dtype, requires_grad=True)
    GA = torch.tensor(rng.standard_normal((streams * n, width)), dtype=dtype)
    g, b = (gamma, beta) if layer_norm else (None, None)
    out = fused_step._transport_fwd_plain(H, g, b, n, dim, "tanh")
    inputs = [H, gamma, beta] if layer_norm else [H]
    ref = torch.autograd.grad(out, inputs, GA)
    GH, Gg, Gb = fused_step._transport_bwd_plain(
        H.detach(), None if g is None else gamma.detach(), None if b is None else beta.detach(), GA, n,
        dim, "tanh")
    assert rel_to_max(GH, ref[0]) < tol
    if layer_norm:
        assert rel_to_max(Gg.sum(0), ref[1]) < tol
        assert rel_to_max(Gb.sum(0), ref[2]) < tol
    else:
        assert Gg is None and Gb is None


def _bundle_streams(monkeypatch, arch, x_order, dim=1, frame=None, n=40):
    """(model, z, the plain bundle's stacked first-layer input) for a
    Fourier (mapping 8) or feedforward trunk at x-order ``x_order`` in
    ``dim`` space dimensions, in a co-moving frame of speed ``frame``: what
    the bundle hands the first Dense layer's ``F.linear``."""
    import torch.nn.functional as F

    from pinnrl_tpu_torch.config import load_config
    from pinnrl_tpu_torch.models import PINNModel

    cfg = load_config(pde_type="burgers", architecture=arch, device="cpu")
    cfg.pde.dimension, cfg.model.input_dim = dim, dim + 1
    cfg.pde.domain = [[-1.0, 1.0], [0.0, 2.0], [-3.0, 0.5], [0.5, 1.5]][:dim]
    cfg.model.hidden_dims = [8]
    cfg.model.arch_params.update({"mapping_size": 8, "scale": 2.0})
    if frame is not None:
        cfg.model.arch_params["moving_frame_speed"] = frame
    model = PINNModel(cfg, seed=0)
    params = dict(model.params)
    captured, linear = [], F.linear

    def spy(x, w, b=None):
        if w is params["Dense_0.weight"]:
            captured.append(x)
        return linear(x, w, b)

    monkeypatch.setattr(F, "linear", spy)
    x, t = points(4, n, domain=tuple(map(tuple, cfg.pde.domain)))
    z = torch.from_numpy(np.concatenate([x, t], axis=1))
    make_bundle_fn(model, dim, x_order, 1)(params, z)
    (stacked,) = captured
    return model, z, stacked


@pytest.mark.parametrize("dim,frame", [(1, None), (2, None), (3, None), (4, None), (1, 0.7),
                                       (2, -1.3), (4, 0.7)])
@pytest.mark.parametrize("x_order", [1, 2, 3])
@pytest.mark.parametrize("arch", ["fourier", "feedforward"])
def test_stacked_input_twins_match_the_bundle(monkeypatch, arch, x_order, dim, frame):
    """``_embed_plain`` (Fourier) and ``_affine_input_plain`` (feedforward):
    the stacked input [value; per axis x1..xK; t1] that the plain bundle
    feeds the first Dense layer, at x-orders 1-3 in 1-4 space dimensions,
    with and without a co-moving frame. Fourier: 1e-6 relative to max (the
    phase rotations in another order); feedforward: equal."""
    model, z, ref = _bundle_streams(monkeypatch, arch, x_order, dim, frame)
    lo, sc = model._in_lo, model._in_scale
    if arch == "fourier":
        got = fused_step._embed_plain(z, lo, sc, model.constants["FourierFeatures_0.B"], True,
                                      x_order, frame)
        assert got.shape == ref.shape and rel_to_max(got, ref) < 1e-6
    else:
        got = fused_step._affine_input_plain(z, lo, sc, x_order, frame)
        assert got.shape == ref.shape == ((2 + dim * x_order) * z.shape[0], dim + 1)
        assert torch.equal(got, ref)


def test_causal_residual_loss_matches_jax():
    pair = burgers_pair(causal_eps=1.0)
    x, t = points(9, 128)
    pair.jpde.attach_fast_bundle(pair.jmodel)
    pair.tpde.attach_fast_bundle(pair.tmodel)

    def jloss(p):
        r = pair.jpde.compute_residual(pair.jmodel.apply, p, jnp.asarray(x), jnp.asarray(t), None)
        return pair.jpde._residual_loss(r, jnp.asarray(t))

    l_j, g_j = jax.value_and_grad(jloss)(pair.jmodel.params)
    params = torch_params(pair.tmodel)
    r = pair.tpde.compute_residual(pair.tmodel.apply, params, torch.from_numpy(x), torch.from_numpy(t))
    l_t = pair.tpde._residual_loss(r, torch.from_numpy(t))
    g_t = dict(zip(params, torch.autograd.grad(l_t, list(params.values()))))
    assert abs(float(l_t.detach()) - float(l_j)) / abs(float(l_j)) < LOSS_TOL
    ref = np.asarray(g_j["Dense_1"]["kernel"])
    assert rel_to_max(g_t["Dense_1.weight"].detach().numpy().T, ref) < GRAD_TOL
    ref = np.asarray(g_j["LayerNorm_0"]["scale"])
    assert rel_to_max(g_t["LayerNorm_0.weight"], ref) < GRAD_TOL


_SCOPE_PDES = ("burgers", "heat", "kdv", "convection", "allen_cahn", "black_scholes")


@pytest.mark.parametrize("pde_type", _SCOPE_PDES)
@pytest.mark.parametrize("arch", ["fourier", "feedforward", "siren"])
def test_supports_matches_the_reference_in_one_dimension(pde_type, arch):
    """The PDE x architecture matrix: the port's ``supports`` agrees with the
    JAX reference's, except for the reference's width gate (every width here
    is below its 128: the port has no width gate)."""
    from pinnrl_tpu.ops.kernels import fused_step as jax_fused
    from torch_parity_helpers import pde_pair

    pair = pde_pair(pde_type, arch=arch, hidden=(16, 16), mapping=8)
    ref = jax_fused.supports(pair.jmodel, pair.jpde, pair.jcfg.training)
    assert not ref  # the reference's width gate (16 < 128)
    pair.jcfg.model.hidden_dims = [128, 128]
    pair.jcfg.model.arch_params["mapping_size"] = 128
    from pinnrl_tpu.models import PINNModel as JaxModel

    wide = JaxModel(pair.jcfg, seed=0)
    ref = jax_fused.supports(wide, pair.jpde, pair.jcfg.training)
    assert ref == (arch != "siren")
    assert fused_step.supports(pair.tmodel, pair.tpde, pair.tcfg.training) == ref


def test_supports_scope():
    pair = burgers_pair()
    assert fused_step.supports(pair.tmodel, pair.tpde, pair.tcfg.training)
    assert pair.tpde.attach_fused_residual_kernel(pair.tmodel)
    causal = burgers_pair(causal_eps=0.5)
    assert fused_step.supports(causal.tmodel, causal.tpde, causal.tcfg.training)
    assert causal.tpde.attach_fused_residual_kernel(causal.tmodel, enable="on")
    # A feedforward trunk is in scope (its affine input, then the same GEMMs).
    ff = burgers_pair(arch="feedforward")
    assert fused_step.supports(ff.tmodel, ff.tpde)
    assert fused_step._spec(ff.tmodel, ff.tpde).B is None
    # In: a moving frame and any number of space dimensions (the reference's
    # gate has no limit on d). Out: order 4, temporal order 2.
    frame = burgers_pair()
    frame.tmodel._frame_speed = 0.5
    assert fused_step.supports(frame.tmodel, frame.tpde)
    assert fused_step._spec(frame.tmodel, frame.tpde).frame_speed == 0.5
    for dim in (2, 3, 4, 5, 8):
        wide = burgers_pair()
        wide.tpde.dimension = dim
        assert fused_step.supports(wide.tmodel, wide.tpde), dim
    for orders in (dict(spatial_orders=(4,)), dict(temporal_orders=(2,))):
        odd = burgers_pair()
        for k, v in orders.items():
            setattr(odd.tpde, k, v)
        assert not fused_step.supports(odd.tmodel, odd.tpde), orders
    pair.tcfg.training.loss_function = "mae"
    assert not fused_step.supports(pair.tmodel, pair.tpde, pair.tcfg.training)
    with pytest.raises(ValueError, match="unsupported"):
        pair.tpde.attach_fused_residual_kernel(pair.tmodel, enable="on")
    # No width gate: narrow trunks stay on the kernel.
    narrow = burgers_pair(hidden=(8,), mapping=4)
    assert fused_step.supports(narrow.tmodel, narrow.tpde)


@pytest.mark.parametrize("M,N,K", [(256, 256, 32768), (1, 256, 32768), (256, 256, 100), (64, 64, 8192)])
def test_split_k_covers_k(M, N, K):
    splits, chunk = fused_step._split_k(M, N, K)
    assert chunk % _gemm_core.BK == 0 and splits >= 1
    assert (splits - 1) * chunk < K <= splits * chunk


@pytest.mark.parametrize("pde_type", _SCOPE_PDES)
@pytest.mark.parametrize("arch", ["fourier", "feedforward"])
def test_launcher_matches_jax_kernel_in_two_dimensions(pde_type, arch):
    """Every residual of kernel 1 in two space dimensions (convection with
    one velocity per axis; Black-Scholes reading S along each axis), through
    the launcher with the plain twins, against the JAX kernel (tile 32) in
    interpret mode."""
    from torch_parity_helpers import FUSED_TOLS, launcher_vs_jax_kernel, pde_pair, sorted_z

    over = {"parameters": {"velocity": [0.5, -1.5]}} if pde_type == "convection" else None
    pair = pde_pair(pde_type, arch=arch, pde=over, dim=2)
    spec = fused_step._spec(pair.tmodel, pair.tpde)
    assert spec.dimension == 2
    if pde_type == "convection":
        assert spec.velocity == (0.5, -1.5)
    domain = dict(domain=tuple(map(tuple, pair.tcfg.pde.domain)),
                  time_domain=tuple(pair.tcfg.pde.time_domain))
    loss_rel, grad_rels = launcher_vs_jax_kernel(pair, sorted_z(5, 96, domain))
    loss_tol, grad_tol = FUSED_TOLS[0.0]
    assert loss_rel < loss_tol
    for name, rel in grad_rels.items():
        assert rel < grad_tol, name


@pytest.mark.parametrize("arch", ["fourier", "feedforward"])
def test_float64_parameters_take_the_plain_path(arch):
    """As the JAX package gates its kernel: any parameter that is not
    float32 sends the residual to the plain path (the kernel's launcher
    refuses such leaves). The fused callable must not be called, and the
    residual term equals ``compute_residual`` + ``_residual_loss`` on the
    same inputs, promoted to float64 as flax's Dense promotes."""
    pair = burgers_pair(arch=arch)
    pde, model = pair.tpde, pair.tmodel
    pde.attach_fast_bundle(model)
    assert pde.attach_fused_residual_kernel(model)

    def refuse(params, z):
        raise AssertionError("kernel 1 called with float64 parameters")

    pde._fused_residual_loss = refuse
    params = {k: v.detach().double() for k, v in model.params.items()}
    x, t = (torch.from_numpy(a) for a in points(11, 128))
    losses = pde.compute_loss(model.apply, params, x, t, generator=torch.Generator().manual_seed(0))
    ref = pde._residual_loss(pde.compute_residual(model.apply, params, x, t), t)
    assert losses["residual"].dtype == torch.float64
    assert torch.equal(losses["residual"], ref)
    assert all(torch.isfinite(v) for v in losses.values())
