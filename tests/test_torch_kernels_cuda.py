"""Card-only checks: each hand-written CUDA kernel against its plain PyTorch
version on the same CUDA tensors. Marked ``cuda``; each test skips (from the
``cuda_device`` fixture) where torch sees no card. On a CUDA machine:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q

Tolerances: Fourier features 1e-5 relative to max (sincosf vs torch's
sin/cos on the same f32 phases); fused loss 1e-5 relative and gradients
1e-4 relative to each gradient's max (sums in another order), 2e-4 and
1e-3 for the KdV causal variant (order-3 jets, causal weights); the MLP
scorer 1e-4 relative to max (the JAX suite's bound for its kernel: sums in
another order through two LayerNorms); the SIREN layer 1e-5 relative to
max, and the kernels' jvp rules at order k 1e-4 x 10^(k-1) relative to max
(the JAX suite's bounds for its SIREN and Fourier kernels,
tests/test_pallas_parity_tpu.py). The GEMM core and the output layer's row
passes against float64 ``torch.mm``: 1e-5 relative to max for K <= 512,
1e-4 above (FP32 sums of K terms in another order drift by about
sqrt(K) eps); split-K, kernel 1 and the MLP scorer bit-identical across
two calls. Kernel 1's convection (x-order 1), Allen-Cahn and Black-Scholes
variants and its feedforward trunk: loss 1e-5 relative and gradients 1e-4
relative to max (1e-4 and 1e-3 causal), bit-identical across two calls;
its feedforward input kernel 1e-6 relative to max (an fmaf where the plain
version rounds twice). Kernel 1 in two and three space dimensions and in a
co-moving frame: the same bounds; its Fourier input kernel 1e-4 relative
to max (an fmaf in the affine map where the plain version rounds twice
moves a phase of tens of radians by an ulp of w times 2 pi B, and the
order-K streams scale that by p1^K, up to ~800 here), its feedforward input
kernel 1e-6 (the direction rows equal without a frame), its transport
kernels 1e-5 relative to max per stacked tensor and its residual kernels
1e-6. Cahn-Hilliard: kernel 2's jvp rule nested to order 4 on the
biharmonic recipe's network (its basis's t-row zero) at 1e-4 x 10^(k-1)
relative to max at order k, and the direct (order-4) residual, its loss and
each parameter gradient through kernel 2 at 1e-3 relative to max (the
bound of the order-3 residual loss's gradients through kernel 3). The heat
inverse recipe: its loss (data term included) 1e-5 relative and its
gradients (alpha's and every leaf's) 1e-4 relative to max through kernel 2
against the plain version, as kernel 1's loss and gradients. The sampling
harness's shapes: the scorer at hidden 64 on (10000, 2) and (10000, 3) at
its 1e-4, kernel 2 at mapping 32 at its 1e-5 and its jvp rule at its
orders' bounds. Kernel 1 with gelu, sigmoid, silu and sin: the transport
kernels with each activation code against their twins at 1e-5 relative to
max per stacked tensor, and the whole loss against the plain version run
in float64 at the kernel's bounds (loss 1e-5, gradients 1e-4; causal KdV
2e-4 and 1e-3). Kernel 1 in d >= 4 dimensions (the ``*_nd`` kernels): its
input, transport and residual kernels at the d = 2-3 bounds above, dL/dB
(one and two tiles of axis rows) at 1e-4 relative to max against the
float64 twin, and the whole loss against the plain version run in float64
at the kernel's bounds (causal 1e-4 and 1e-3). The generated residual
kernel (any PDE's residual, traced): 1e-5 relative to max against its
program's float64 twin (sinf, tanhf and expf against torch's), and 1e-6
against burgers_kernel on Burgers' own residual; a first-order ODE's input,
dL/dB and transport kernels (no x-group) at the bounds of their K >= 1
tests. Its selects (clamp, where, maximum, minimum, relu, fmax, softplus and
atan2, asinh, log10, erfc): 1e-5 relative to max against the float64 twin
on finite entries, with NaNs and infinities where the float32 twin has
them. The trainer's step program: a run of the small Burgers slice (RAR,
and uniform with the DQN agent) replayed from its captured step equals the
eager program's run bit for bit (the same kernels on the same draws), with
the same launch counts: a launch captured into a step program's tally is
counted on the device at every replay.
"""

import numpy as np
import pytest
import torch
import torch_parity_helpers  # noqa: F401  (pins torch's CPU threads per worker)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels are built with nvcc for sm_90a)")
    return torch.device("cuda")


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@pytest.mark.parametrize("periodic", [True, False])
def test_fourier_features_kernel_matches_plain(cuda_device, periodic):
    from pinnrl_tpu_torch.ops.kernels import fourier_feats

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = 2.0 * torch.rand((4096, 2), generator=gen, device=cuda_device) - 1.0
    B = 2.0 * torch.randn((2, 128), generator=gen, device=cuda_device)
    before = fourier_feats.fourier_features.launches
    got = fourier_feats.fourier_features(x, B, periodic)
    ref = fourier_feats.fourier_features_plain(x, B, periodic)
    torch.cuda.synchronize()
    assert fourier_feats.fourier_features.launches == before + 1
    assert _rel(got, ref) < 1e-5


def _ff_inputs(n, d, m, gen, device, x_offset=0, b_offset=0):
    """x in [-1, 1]^d, B ~ 2 N(0, 1) (the Burgers recipe's scale) times 2 / d
    for d > 2, so the phases stay at the recipes' scale (up to ~100 rad);
    each optionally ``offset`` floats past a 16-byte boundary."""
    x = _offset_matrix(n, d, x_offset, gen, device).uniform_(-1.0, 1.0, generator=gen)
    B = _offset_matrix(d, m, b_offset, gen, device).mul_(2.0 * min(1.0, 2.0 / d))
    return x, B


@pytest.mark.parametrize("m", [1, 5, 127, 128, 256])
@pytest.mark.parametrize("d", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [1, 7, 4096, 5000, 20000])
def test_fourier_features_shapes(cuda_device, n, d, m):
    """Both s settings at every shape class: the vector path (d <= 3, m %
    4 == 0) and the edge path (d = 4, or m in {1, 5, 127}), rows below one
    block, ragged, and above one step of the grid."""
    from pinnrl_tpu_torch.ops.kernels import fourier_feats

    x, B = _ff_inputs(n, d, m, torch.Generator(device=cuda_device).manual_seed(n + 10 * d + m),
                      cuda_device)
    for two_pi in (True, False):
        before = fourier_feats.fourier_features.launches
        got = fourier_feats.fourier_features(x, B, two_pi)
        ref = fourier_feats.fourier_features_plain(x, B, two_pi)
        torch.cuda.synchronize()
        assert fourier_feats.fourier_features.launches == before + 1
        assert got.shape == (n, 2 * m) and torch.isfinite(got).all()
        assert _rel(got, ref) < 1e-5, two_pi


@pytest.mark.parametrize("n,d,m", [(4096, 2, 128), (5000, 3, 256), (7, 1, 4)])
@pytest.mark.parametrize("x_offset,b_offset", [(1, 0), (0, 1), (1, 1), (2, 2)])
def test_fourier_features_unaligned_views(cuda_device, n, d, m, x_offset, b_offset):
    """x one or two floats past a 16-byte boundary keeps the vector path
    (x is read by scalar loads); an unaligned B takes the edge path."""
    from pinnrl_tpu_torch.ops.kernels import fourier_feats

    x, B = _ff_inputs(n, d, m, torch.Generator(device=cuda_device).manual_seed(n + m), cuda_device,
                      x_offset, b_offset)
    assert x.data_ptr() % 16 == 4 * x_offset % 16 and B.data_ptr() % 16 == 4 * b_offset % 16
    path = fourier_feats.launch_plan(n, d, m, B.data_ptr() % 16 == 0, 132)[0]
    assert path == (0 if b_offset else d)
    got = fourier_feats.fourier_features(x, B, True)
    ref = fourier_feats.fourier_features_plain(x, B, True)
    torch.cuda.synchronize()
    assert _rel(got, ref) < 1e-5


def test_fourier_features_bit_identical_and_paths_agree(cuda_device):
    """Two calls give the same bits, and the edge path forced on an aligned
    (4096, 2) x (2, 128) gives the vector path's bits (the same fmaf chain
    and sincosf per feature)."""
    from pinnrl_tpu_torch.ops.kernels import _build, fourier_feats

    x, B = _ff_inputs(4096, 2, 128, torch.Generator(device=cuda_device).manual_seed(8), cuda_device)
    first = fourier_feats.fourier_features(x, B, True)
    second = fourier_feats.fourier_features(x, B, True)
    edge = torch.empty_like(first)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    _, _, rows = fourier_feats.launch_plan(4096, 2, 128, False, sms)
    _build.check(fourier_feats._lib().ff_forward(
        x.data_ptr(), B.data_ptr(), edge.data_ptr(), 4096, 2, 128, 0, rows, 1, 1, 0, 0,
        _build.stream_handle(x.device)), "fourier_features_kernel")
    torch.cuda.synchronize()
    assert torch.equal(first, second) and torch.equal(first, edge)


@pytest.mark.parametrize("path,d,m,b_offset,rows", [
    (2, 3, 128, 0, 4), (2, 2, 126, 0, 4), (2, 2, 128, 1, 4), (4, 4, 128, 0, 4), (0, 2, 128, 0, 0),
    (0, 2, 128, 0, 65536),
])
def test_fourier_features_launcher_refuses_a_wrong_plan(cuda_device, path, d, m, b_offset, rows):
    """``ff_forward`` returns an error without launching for a vector path
    the inputs do not admit (d != path, m % 4, unaligned B, d > 3) or a grid
    out of range, rather than reading the wrong layout."""
    from pinnrl_tpu_torch.ops.kernels import _build, fourier_feats

    gen = torch.Generator(device=cuda_device).manual_seed(1)
    x, B = _ff_inputs(16, d, m, gen, cuda_device, 0, b_offset)
    out = torch.empty((16, 2 * m), device=cuda_device)
    status = fourier_feats._lib().ff_forward(x.data_ptr(), B.data_ptr(), out.data_ptr(), 16, d, m,
                                             path, rows, 1, 1, 0, 0, _build.stream_handle(x.device))
    assert status != 0


def test_fourier_features_launch_floor_kernel(cuda_device):
    """The empty kernel (the launch-floor yardstick) launches on the plan's
    grid."""
    from pinnrl_tpu_torch.ops.kernels import _build, fourier_feats

    path, _, rows = fourier_feats.launch_plan(4096, 2, 128, True, 132)
    _build.check(fourier_feats._lib().ff_empty(128, path, rows, _build.stream_handle(cuda_device)),
                 "empty_kernel")
    torch.cuda.synchronize()


def test_fourier_features_rejects_bad_inputs(cuda_device):
    from pinnrl_tpu_torch.ops.kernels import fourier_feats

    # float64 is not refused since the dtype gate: it takes the plain version.
    x = torch.zeros((8, 2), device=cuda_device, dtype=torch.float64)
    launches = fourier_feats.fourier_features.launches
    got = fourier_feats.fourier_features(x, torch.zeros((2, 4), device=cuda_device,
                                                        dtype=torch.float64))
    assert got.dtype == torch.float64 and fourier_feats.fourier_features.launches == launches
    with pytest.raises(ValueError):
        fourier_feats.fourier_features(torch.zeros((8, 3), device=cuda_device),
                                       torch.zeros((2, 4), device=cuda_device))
    with pytest.raises(ValueError):  # B on the host
        fourier_feats.fourier_features(torch.zeros((8, 2), device=cuda_device), torch.zeros((2, 4)))
    with pytest.raises(ValueError):  # a transposed (non-contiguous) B
        fourier_feats.fourier_features(torch.zeros((8, 2), device=cuda_device),
                                       torch.zeros((4, 2), device=cuda_device).t())


@pytest.mark.parametrize("hidden,mapping,n", [((256, 256, 256), 128, 8192), ((32, 24), 16, 300)])
def test_fused_residual_loss_matches_plain(cuda_device, hidden, mapping, n):
    from pinnrl_tpu_torch.config import load_config
    from pinnrl_tpu_torch.models import PINNModel
    from pinnrl_tpu_torch.ops.jet_mlp import make_bundle_fn
    from pinnrl_tpu_torch.ops.kernels import fused_step
    from pinnrl_tpu_torch.pdes import create_pde

    cfg = load_config(pde_type="burgers", architecture="fourier", device="cuda")
    cfg.model.hidden_dims = list(hidden)
    cfg.model.arch_params.update({"mapping_size": mapping, "scale": 2.0})
    pde, model = create_pde(cfg), PINNModel(cfg, seed=0)
    fn = fused_step.make_fused_residual_loss(model, pde)
    bundle_fn = make_bundle_fn(model, 1, 2, 1)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    x, t = pde.generate_collocation_points(gen, n, "uniform")
    z = torch.cat([x, t], dim=-1)
    params = model.params
    lk = fn(params, z)
    gk = torch.autograd.grad(lk, list(params.values()))
    lp = fused_step.fused_residual_loss_plain(bundle_fn, pde, params, z)
    gp = torch.autograd.grad(lp, list(params.values()))
    torch.cuda.synchronize()
    assert abs(float(lk.detach()) - float(lp.detach())) / abs(float(lp.detach())) < 1e-5
    for name, a, b in zip(params, gk, gp):
        assert _rel(a, b) < 1e-4, name
    assert np.isfinite(float(lk.detach()))
    # Without autograd (validation) the kernels run loss-only: one launch,
    # the same loss bit for bit (same kernels, same order).
    before = fused_step.fused_residual_loss.launches
    with torch.no_grad():
        l_val = fn(params, z)
    torch.cuda.synchronize()
    assert fused_step.fused_residual_loss.launches == before + 1
    assert float(l_val) == float(lk.detach())


@pytest.mark.parametrize("hidden,mapping,n", [((256, 256, 256), 256, 8192), ((32, 24), 16, 300)])
def test_fused_residual_loss_kdv_causal_matches_plain(cuda_device, hidden, mapping, n):
    """Kernel 1's order-3, causal variant on the KdV recipe (eps 1.0) on
    time-sorted points: loss 2e-4 relative, gradients 1e-3 relative to max
    (the JAX suite's order-3 and causal bounds)."""
    from pinnrl_tpu_torch.benchmarks.convergence import build_recipe_config
    from pinnrl_tpu_torch.models import PINNModel
    from pinnrl_tpu_torch.ops.jet_mlp import make_bundle_fn
    from pinnrl_tpu_torch.ops.kernels import fused_step
    from pinnrl_tpu_torch.pdes import create_pde

    cfg = build_recipe_config("kdv", device="cuda")
    cfg.model.hidden_dims = list(hidden)
    cfg.model.arch_params["mapping_size"] = mapping
    cfg.model.arch_params.pop("feature_seed")
    pde, model = create_pde(cfg), PINNModel(cfg, seed=0)
    fn = fused_step.make_fused_residual_loss(model, pde)
    bundle_fn = make_bundle_fn(model, 1, 3, 1)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    x, t = pde.generate_collocation_points(gen, n, "uniform")
    z = torch.cat([x, t], dim=-1)[torch.argsort(t.reshape(-1), stable=True)]
    params = model.params
    lk = fn(params, z)
    gk = torch.autograd.grad(lk, list(params.values()))
    lp = fused_step.fused_residual_loss_plain(bundle_fn, pde, params, z)
    gp = torch.autograd.grad(lp, list(params.values()))
    torch.cuda.synchronize()
    assert abs(float(lk.detach()) - float(lp.detach())) / abs(float(lp.detach())) < 2e-4
    for name, a, b in zip(params, gk, gp):
        assert _rel(a, b) < 1e-3, name


@pytest.mark.parametrize("case,hidden,mapping,n", [
    ("burgers", (256, 256, 256), 128, 8192), ("burgers", (32, 24), 16, 300),
    ("kdv", (32, 24), 16, 300), ("heat_2d", (32, 24), 16, 300), ("frame", (32, 24), 16, 300)])
def test_fused_residual_loss_with_a_trainable_basis_matches_plain(cuda_device, case, hidden,
                                                                   mapping, n):
    """Kernel 1 with ``trainable_features``: B a leaf read per call and its
    gradient from ``fr_embed_bwd``, against autograd through the plain
    bundle; loss 1e-5 relative and every gradient (B's included) 1e-4
    relative to its max (causal KdV 2e-4 and 1e-3), bit-identical in two
    calls."""
    from pinnrl_tpu_torch.benchmarks.convergence import build_recipe_config
    from pinnrl_tpu_torch.config import load_config
    from pinnrl_tpu_torch.models import PINNModel
    from pinnrl_tpu_torch.ops.jet_mlp import make_bundle_fn
    from pinnrl_tpu_torch.ops.kernels import fused_step
    from pinnrl_tpu_torch.pdes import create_pde

    if case in ("kdv", "heat_2d"):
        cfg = build_recipe_config(case, device="cuda")
        cfg.model.arch_params.pop("feature_seed", None)
    else:
        cfg = load_config(pde_type="burgers", architecture="fourier", device="cuda")
        cfg.model.arch_params["scale"] = 2.0
        if case == "frame":
            cfg.model.arch_params["moving_frame_speed"] = 0.7
    cfg.model.hidden_dims = list(hidden)
    cfg.model.arch_params.update({"mapping_size": mapping, "trainable_features": True})
    pde, model = create_pde(cfg), PINNModel(cfg, seed=0)
    fn = fused_step.make_fused_residual_loss(model, pde)
    bundle_fn = make_bundle_fn(model, pde.dimension, max(pde.spatial_orders), 1)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x, t = pde.generate_collocation_points(gen, n, "uniform")
    z = torch.cat([x, t], dim=-1)[torch.argsort(t.reshape(-1), stable=True)]
    params = model.params
    assert "FourierFeatures_0.B" in params
    runs = [(fn(params, z),) for _ in range(2)]
    lk, lk2 = runs[0][0], runs[1][0]
    gk = torch.autograd.grad(lk, list(params.values()))
    gk2 = torch.autograd.grad(lk2, list(params.values()))
    lp = fused_step.fused_residual_loss_plain(bundle_fn, pde, params, z)
    gp = torch.autograd.grad(lp, list(params.values()), allow_unused=True, materialize_grads=True)
    torch.cuda.synchronize()
    loss_tol, grad_tol = (2e-4, 1e-3) if case == "kdv" else (1e-5, 1e-4)
    assert abs(float(lk.detach()) - float(lp.detach())) / abs(float(lp.detach())) < loss_tol
    for name, a, b in zip(params, gk, gp):
        assert _rel(a, b) < grad_tol, name
    assert torch.equal(lk, lk2) and all(torch.equal(a, b) for a, b in zip(gk, gk2))


@pytest.mark.parametrize("n", [1, 1000, 5000, 8192])
def test_causal_scan_matches_plain(cuda_device, n):
    """The three-pass scan kernels against the plain twin: [w, w r^2] to
    1e-5 relative to max (f32 sums in another order inside exp)."""
    from pinnrl_tpu_torch.ops.kernels import fused_step

    gen = torch.Generator(device=cuda_device).manual_seed(n)
    r = 2.0 * torch.randn((n, 1), generator=gen, device=cuda_device)
    got = fused_step._cuda_ops(cuda_device).causal_weights(r, n, 1.0)
    ref = fused_step._TorchOps().causal_weights(r, n, 1.0)
    torch.cuda.synchronize()
    assert got.shape == (n, 2) and float(got[0, 0]) == 1.0
    assert _rel(got[:, 0], ref[:, 0]) < 1e-5 and _rel(got[:, 1], ref[:, 1]) < 1e-5


def _scorer_params(hidden, action_dim, device, state_dim=2):
    """The agent's seeded init, LayerNorm moved away from (1, 0) so its
    terms count."""
    from pinnrl_tpu_torch.rl import RLAgent

    agent = RLAgent(state_dim=state_dim, hidden_dim=hidden, action_dim=action_dim, device=device)
    params = agent.init(torch.Generator().manual_seed(2)).policy_params
    gen = torch.Generator(device=device).manual_seed(hidden)
    with torch.no_grad():
        for k in ("LayerNorm_0.weight", "LayerNorm_1.weight", "LayerNorm_0.bias", "LayerNorm_1.bias"):
            params[k].add_(0.1 * torch.randn(params[k].shape, generator=gen, device=device))
    return {k: v.detach() for k, v in params.items()}


# (10000, 512, 1): the shipped agent on the 100x100 grid; 10001: a ragged
# last tile; h = 30 and 16 below 4 float4 per lane, h = 30 no multiple of 4
# (the scalar paths); N = 1: one row.
@pytest.mark.parametrize("n,hidden,action_dim", [
    (10000, 512, 1), (1000, 128, 4), (37, 40, 3), (1, 512, 1), (10001, 512, 1), (300, 30, 2),
    (37, 16, 1),
])
def test_fused_mlp_score_matches_plain(cuda_device, n, hidden, action_dim):
    from pinnrl_tpu_torch.ops.kernels import mlp

    params = _scorer_params(hidden, action_dim, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = 2.0 * torch.rand((n, 2), generator=gen, device=cuda_device) - 1.0
    before = mlp.fused_mlp_score.launches
    with torch.no_grad():
        got = mlp.fused_mlp_score(x, params)
        again = mlp.fused_mlp_score(x, params)
        ref = mlp.fused_mlp_score_plain(x, params)
    torch.cuda.synchronize()
    assert mlp.fused_mlp_score.launches == before + 2
    assert got.shape == (n, action_dim) and torch.isfinite(got).all()
    assert _rel(got, ref) < 1e-4
    assert torch.equal(got, again)  # fixed-order sums, no atomics


@pytest.mark.parametrize("splits", [1, 2])
@pytest.mark.parametrize("n,hidden", [(10000, 512), (10001, 512), (300, 30), (1000, 128)])
def test_fused_mlp_score_split_settings(cuda_device, splits, n, hidden):
    """The launcher on the card with the product's split forced to each
    setting: 1e-4 of the plain version, and the same bits in two calls."""
    from pinnrl_tpu_torch.ops.kernels import mlp

    params = _scorer_params(hidden, 1, cuda_device)
    x = 2.0 * torch.rand((n, 2), generator=torch.Generator(device=cuda_device).manual_seed(n),
                         device=cuda_device) - 1.0
    ops = mlp._cuda_ops(cuda_device)
    with torch.no_grad():
        first = mlp._score(ops, x, params, 1e-6, splits=splits)
        second = mlp._score(ops, x, params, 1e-6, splits=splits)
        ref = mlp.fused_mlp_score_plain(x, params)
    torch.cuda.synchronize()
    assert _rel(first, ref) < 1e-4
    assert torch.equal(first, second)


@pytest.mark.parametrize("d", [1, 3, 4, 5])
def test_fused_mlp_score_input_widths(cuda_device, d):
    """The first pass's register path for each d in 1..4, and its guarded
    scalar path for d = 5."""
    from pinnrl_tpu_torch.ops.kernels import mlp

    params = _scorer_params(512, 1, cuda_device, state_dim=d)
    gen = torch.Generator(device=cuda_device).manual_seed(d)
    x = 2.0 * torch.rand((1000, d), generator=gen, device=cuda_device) - 1.0
    with torch.no_grad():
        got = mlp.fused_mlp_score(x, params)
        ref = mlp.fused_mlp_score_plain(x, params)
    torch.cuda.synchronize()
    assert _rel(got, ref) < 1e-4


def test_fused_mlp_score_unaligned_views(cuda_device):
    """x, b1 and the head's operands one float past a 16-byte boundary: the
    first pass reads x by scalars and, with b1 unaligned, takes its guarded
    scalar path, as the head does."""
    from pinnrl_tpu_torch.ops.kernels import mlp

    params = _scorer_params(512, 2, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    x = _offset_matrix(10000, 2, 1, gen, cuda_device).uniform_(-1.0, 1.0, generator=gen)
    shifted = dict(params)
    for k in ("Dense_0.bias", "LayerNorm_1.weight", "Dense_2.weight"):
        v = params[k]
        shifted[k] = _offset_matrix(1, v.numel(), 1, gen, cuda_device).copy_(v.reshape(1, -1)).view(v.shape)
    assert x.data_ptr() % 16 and shifted["Dense_2.weight"].data_ptr() % 16
    with torch.no_grad():
        got = mlp.fused_mlp_score(x, shifted)
        ref = mlp.fused_mlp_score_plain(x, params)
    torch.cuda.synchronize()
    assert _rel(got, ref) < 1e-4


@pytest.mark.parametrize("rows,cols", [(512, 512), (30, 77), (1, 5)])
def test_scorer_transpose_kernel(cuda_device, rows, cols):
    from pinnrl_tpu_torch.ops.kernels import mlp

    W = torch.randn((rows, cols), generator=torch.Generator(device=cuda_device).manual_seed(rows),
                    device=cuda_device)
    got = mlp._cuda_ops(cuda_device).transpose(W)
    torch.cuda.synchronize()
    assert torch.equal(got, mlp._TorchOps().transpose(W))


@pytest.mark.parametrize("n,h,splits", [(10000, 512, 2), (10001, 512, 1), (1, 30, 2)])
def test_scorer_gemm_blocks_match_the_twin(cuda_device, n, h, splits):
    """``ms_gemm_blocks`` reads the grid ``ms_gemm`` launches; its twin
    counts 128x128 tiles times splits."""
    from pinnrl_tpu_torch.ops.kernels import mlp

    got = mlp._cuda_ops(cuda_device).gemm_blocks(n, h, splits)
    assert got == mlp._TorchOps().gemm_blocks(n, h, splits)


@pytest.mark.parametrize("bias_rows,splits", [(4, 2), (2, 1)])
def test_scorer_gemm_refuses_a_bias_on_split_partials(cuda_device, bias_rows, splits):
    """A bias on split partials or on fewer than M rows: ``ms_gemm`` returns
    an error without launching, as its twin raises."""
    from pinnrl_tpu_torch.ops.kernels import mlp

    A, B = torch.ones((4, 8), device=cuda_device), torch.ones((8, 4), device=cuda_device)
    C, bias = torch.empty((2, 4, 4), device=cuda_device), torch.ones(4, device=cuda_device)
    with pytest.raises(RuntimeError, match="cudaError_t"):
        mlp._cuda_ops(cuda_device).gemm(4, 4, 8, A, 8, 1, B, 4, 1, C, 4, bias, bias_rows, splits,
                                        8 // splits)


def test_fused_mlp_score_rejects_bad_inputs(cuda_device):
    from pinnrl_tpu_torch.ops.kernels import mlp
    from pinnrl_tpu_torch.rl import RLAgent

    params = RLAgent(hidden_dim=32, device=cuda_device).init(torch.Generator()).policy_params
    with pytest.raises(ValueError):
        mlp.fused_mlp_score(torch.zeros((8, 3), device=cuda_device), params)
    with pytest.raises(ValueError):
        mlp.fused_mlp_score(torch.zeros((0, 2), device=cuda_device), params)
    with pytest.raises(TypeError):
        mlp.fused_mlp_score(torch.zeros((8, 2), device=cuda_device, dtype=torch.float64), params)


def _siren_inputs(n, k, m, device, seed):
    """x like a SIREN layer's input (the mapped coordinates, or the previous
    layer's sin), W and b from the SIREN init at omega 30."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = 2.0 * torch.rand((n, k), generator=gen, device=device) - 1.0
    bound = 1.0 / k if k <= 2 else (6.0 / k) ** 0.5 / 30.0
    W = bound * (2.0 * torch.rand((k, m), generator=gen, device=device) - 1.0)
    b = 0.1 * torch.randn((m,), generator=gen, device=device)
    return x, W, b


@pytest.mark.parametrize("n,k,m", [(2048, 2, 124), (2048, 124, 124), (5000, 124, 124), (37, 5, 13)])
def test_siren_kernel_matches_plain(cuda_device, n, k, m):
    from pinnrl_tpu_torch.ops.kernels import siren

    x, W, b = _siren_inputs(n, k, m, cuda_device, n + k)
    before = siren.siren_layer.launches
    with torch.no_grad():
        got = siren.siren_layer(x, W, b, 30.0)
        ref = siren.siren_layer_plain(x, W, b, 30.0)
    torch.cuda.synchronize()
    assert siren.siren_layer.launches == before + 1
    assert got.shape == (n, m) and torch.isfinite(got).all()
    assert _rel(got, ref) < 1e-5


def _nested(f, x, v, order):
    for _ in range(order):
        f = (lambda prev: (lambda xx: torch.func.jvp(prev, (xx,), (v,))[1]))(f)
    return f(x)


@pytest.mark.parametrize("order", [1, 2, 3])
def test_kernel_jvp_rules_on_card(cuda_device, order):
    """Nested jvp through _SirenFn (two 124-wide layers) and through
    _FourierFeaturesFn against the plain functions on the card."""
    from pinnrl_tpu_torch.ops.kernels import fourier_feats, siren

    x, W1, b1 = _siren_inputs(2048, 2, 124, cuda_device, 1)
    _, W2, b2 = _siren_inputs(1, 124, 124, cuda_device, 2)
    v = torch.zeros_like(x)
    v[:, 0] = 1.0

    def net(layer):
        return lambda xx: layer(layer(xx, W1, b1, 30.0), W2, b2, 30.0).sum(-1)

    got = _nested(net(siren.siren_layer), x, v, order)
    ref = _nested(net(siren.siren_layer_plain), x, v, order)
    torch.cuda.synchronize()
    assert _rel(got, ref) < 1e-4 * 10 ** (order - 1)

    B = 0.75 * torch.randn((2, 128), generator=torch.Generator(device=cuda_device).manual_seed(3),
                           device=cuda_device)
    Wf = 0.1 * torch.randn((256, 8), generator=torch.Generator(device=cuda_device).manual_seed(4),
                           device=cuda_device)

    def ff_net(ff):
        return lambda xx: torch.tanh(ff(xx, B) @ Wf).sum(-1)

    before = fourier_feats.fourier_features.jvps
    got = _nested(ff_net(fourier_feats.fourier_features), x, v, order)
    ref = _nested(ff_net(fourier_feats.fourier_features_plain), x, v, order)
    torch.cuda.synchronize()
    assert fourier_feats.fourier_features.jvps > before
    assert _rel(got, ref) < 1e-4 * 10 ** (order - 1)


def test_siren_rejects_bad_inputs(cuda_device):
    from pinnrl_tpu_torch.ops.kernels import siren

    x, W, b = _siren_inputs(8, 4, 6, cuda_device, 0)
    # float64 is not refused since the dtype gate: it takes the plain version.
    launches = siren.siren_layer.launches
    got = siren.siren_layer(x.double(), W.double(), b.double())
    assert got.dtype == torch.float64 and siren.siren_layer.launches == launches
    with pytest.raises(ValueError):
        siren.siren_layer(x, W[:3], b)
    with pytest.raises(ValueError):
        siren.siren_layer(x, W, b[:5])


@pytest.mark.parametrize("causal", [False, True])
def test_fused_residual_loss_heat_matches_plain(cuda_device, causal):
    """Kernel 1's heat variant on the heat recipe (256x3, mapping 128) at
    N = 8192: loss 1e-5 relative, gradients 1e-4 relative to max (1e-4 and
    1e-3 causal)."""
    from pinnrl_tpu_torch.benchmarks.convergence import build_recipe_config
    from pinnrl_tpu_torch.models import PINNModel
    from pinnrl_tpu_torch.ops.jet_mlp import make_bundle_fn
    from pinnrl_tpu_torch.ops.kernels import fused_step
    from pinnrl_tpu_torch.pdes import create_pde

    cfg = build_recipe_config("heat", device="cuda")
    cfg.training.optimizer = "adam"
    cfg.training.causal_eps = 1.0 if causal else 0.0
    pde, model = create_pde(cfg), PINNModel(cfg, seed=0)
    fn = fused_step.make_fused_residual_loss(model, pde)
    bundle_fn = make_bundle_fn(model, 1, 2, 1)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    x, t = pde.generate_collocation_points(gen, 8192, "uniform")
    z = torch.cat([x, t], dim=-1)[torch.argsort(t.reshape(-1), stable=True)]
    params = model.params
    lk = fn(params, z)
    gk = torch.autograd.grad(lk, list(params.values()))
    lp = fused_step.fused_residual_loss_plain(bundle_fn, pde, params, z)
    gp = torch.autograd.grad(lp, list(params.values()), allow_unused=True, materialize_grads=True)
    torch.cuda.synchronize()
    loss_tol, grad_tol = (1e-4, 1e-3) if causal else (1e-5, 1e-4)
    assert abs(float(lk.detach()) - float(lp.detach())) / abs(float(lp.detach())) < loss_tol
    for name, a, b in zip(params, gk, gp):
        assert _rel(a, b) < grad_tol, name  # the output bias: 0 in both


# --------------------------------------------------------------------------- #
# The GEMM core (csrc/sgemm_sm90.cuh) and the output layer's row passes
# --------------------------------------------------------------------------- #
# Tolerance: rel to max |float64 torch.mm| of the same operands, 1e-5 for
# K <= 512 and 1e-4 above (an FP32 sum of K terms in another order drifts by
# about sqrt(K) eps).


def _gemm_tol(K):
    return 1e-5 if K <= 512 else 1e-4


def _offset_matrix(rows, cols, offset, gen, device):
    """A contiguous (rows, cols) float32 matrix starting ``offset`` floats
    into its buffer (offset 1: not 16-byte aligned)."""
    buf = torch.randn(rows * cols + offset, generator=gen, device=device)
    return buf[offset:].view(rows, cols)


@pytest.mark.parametrize("pde,rows,widths", [
    ("burgers", 4 * 8192, (256, 256, 256, 256, 1)),  # mapping 128 -> 256 features
    ("kdv", 5 * 8192, (512, 256, 256, 256, 1)),  # mapping 256 -> 512 features
    ("convection", 3 * 8192, (256, 256, 256, 256, 1)),
    ("black_scholes_ff", 4 * 8192, (2,) + (128,) * 7 + (1,)),  # the shipped feedforward 128x7
])
def test_gemm_core_matches_float64_at_kernel1_products(cuda_device, pde, rows, widths):
    """Each product of one kernel-1 call, through the launcher's routing
    (the core for the hidden layers, row passes for the output layer). The
    feedforward trunk's first layer has two input columns (the core's
    guarded path): its forward, dW and, though the launcher never needs it,
    dX."""
    from pinnrl_tpu_torch.ops.kernels import fused_step

    ops = fused_step._cuda_ops(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(rows)
    for i, (inp, out) in enumerate(zip(widths[:-1], widths[1:])):
        X = torch.randn((rows, inp), generator=gen, device=cuda_device)
        W = torch.randn((out, inp), generator=gen, device=cuda_device)
        b = torch.randn((out,), generator=gen, device=cuda_device)
        G = torch.randn((rows, out), generator=gen, device=cuda_device)
        X64, W64, G64 = X.double(), W.double(), G.double()
        ref = X64 @ W64.t()
        ref[: rows // 4] += b.double()
        checks = [(fused_step._linear(ops, X, W, b, rows // 4), ref, inp),
                  (fused_step._linear_dw(ops, G, X), G64.t() @ X64, rows)]
        if i or inp == 2:
            checks.append((fused_step._linear_dx(ops, G, W), G64 @ W64, out))
        for got, want, K in checks:
            assert got.shape == want.shape
            assert _rel(got.double(), want) < _gemm_tol(K), (pde, i, K)


@pytest.mark.parametrize("layout", ["xwt", "gw", "gtx", "gtwt"])
@pytest.mark.parametrize("M,N,K,offset", [
    (130, 70, 37, 0), (1, 129, 200, 0), (257, 1, 64, 0), (96, 124, 1, 0), (2048, 124, 2, 0),
    (200, 124, 124, 1), (384, 256, 1000, 0), (200, 132, 96, 0), (129, 131, 133, 1),
])
def test_gemm_core_ragged_and_unaligned(cuda_device, layout, M, N, K, offset):
    """``fr_gemm`` on every layout kernel 1 uses (A, B k-contiguous; B
    n-contiguous; A m-contiguous, split over K) and on one it does not (A
    m-contiguous, B k-contiguous: the guarded scalar path), at M, N, K that
    are no multiple of 128, 8 or 4, K in {1, 2}, one row or column, and
    operands one float past a 16-byte boundary, with a bias on the first
    rows."""
    from pinnrl_tpu_torch.ops.kernels import fused_step

    gen = torch.Generator(device=cuda_device).manual_seed(M * 7 + N * 3 + K)
    if layout == "xwt":
        A = _offset_matrix(M, K, offset, gen, cuda_device)
        B = _offset_matrix(N, K, offset, gen, cuda_device)
        args, ref = (A, K, 1, B, 1, K), A.double() @ B.double().t()
    elif layout == "gw":
        A = _offset_matrix(M, K, offset, gen, cuda_device)
        B = _offset_matrix(K, N, offset, gen, cuda_device)
        args, ref = (A, K, 1, B, N, 1), A.double() @ B.double()
    elif layout == "gtx":
        A = _offset_matrix(K, M, offset, gen, cuda_device)
        B = _offset_matrix(K, N, offset, gen, cuda_device)
        args, ref = (A, 1, M, B, N, 1), A.double().t() @ B.double()
    else:
        A = _offset_matrix(K, M, offset, gen, cuda_device)
        B = _offset_matrix(N, K, offset, gen, cuda_device)
        args, ref = (A, 1, M, B, 1, K), A.double().t() @ B.double().t()
    # dW (gtx) is split over K and takes no bias, as in the launcher.
    splits, k_chunk = fused_step._split_k(M, N, K) if layout == "gtx" else (1, K)
    bias = None if layout == "gtx" else torch.randn((N,), generator=gen, device=cuda_device)
    bias_rows = M // 2
    if bias is not None:
        ref[:bias_rows] += bias.double()
    C = torch.full((splits, M, N), float("nan"), device=cuda_device)
    fused_step._cuda_ops(cuda_device).gemm(M, N, K, *args, C, N, bias, bias_rows, splits, k_chunk)
    torch.cuda.synchronize()
    assert torch.isfinite(C).all()
    assert _rel(C.double().sum(0), ref) < _gemm_tol(K)


def test_gemm_split_k_is_bit_identical(cuda_device):
    """dW over 32768 rows in 64 splits, twice: fixed-order partials and
    colsum, no float atomics, so the two results are equal bit for bit."""
    from pinnrl_tpu_torch.ops.kernels import fused_step

    ops = fused_step._cuda_ops(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    G = torch.randn((32768, 256), generator=gen, device=cuda_device)
    X = torch.randn((32768, 256), generator=gen, device=cuda_device)
    assert fused_step._split_k(256, 256, 32768)[0] > 1
    first = fused_step._linear_dw(ops, G, X)
    second = fused_step._linear_dw(ops, G, X)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert _rel(first.double(), G.double().t() @ X.double()) < _gemm_tol(32768)


@pytest.mark.parametrize("R,K,offset", [(32768, 256, 0), (40960, 256, 0), (300, 37, 0), (77, 256, 1)])
def test_output_layer_row_passes_match_float64(cuda_device, R, K, offset):
    """rowdot (U = X w + b on the first rows), outer (dX = dU w) and
    wcolsum (dW = dU^T X) against float64, float4 and scalar paths."""
    from pinnrl_tpu_torch.ops.kernels import fused_step

    ops = fused_step._cuda_ops(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(R + K)
    X = _offset_matrix(R, K, offset, gen, cuda_device)
    w = _offset_matrix(1, K, offset, gen, cuda_device)
    b = torch.randn((1,), generator=gen, device=cuda_device)
    g = torch.randn((R, 1), generator=gen, device=cuda_device)
    X64, w64, g64 = X.double(), w.double(), g.double()
    ref = X64 @ w64.t()
    ref[: R // 4] += b.double()
    assert _rel(ops.rowdot(X, w, b, R // 4).double(), ref) < _gemm_tol(K)
    assert _rel(ops.outer(g, w).double(), g64 @ w64) < 1e-7
    assert _rel(ops.wcolsum(g, X).double(), g64.t() @ X64) < _gemm_tol(R)


def test_fused_residual_loss_is_bit_identical_across_calls(cuda_device):
    """Kernel 1 at the Burgers recipe's width: two calls on the same inputs
    give the same loss and gradients bit for bit."""
    from pinnrl_tpu_torch.config import load_config
    from pinnrl_tpu_torch.models import PINNModel
    from pinnrl_tpu_torch.ops.kernels import fused_step
    from pinnrl_tpu_torch.pdes import create_pde

    cfg = load_config(pde_type="burgers", architecture="fourier", device="cuda")
    cfg.model.hidden_dims = [256, 256, 256]
    cfg.model.arch_params.update({"mapping_size": 128, "scale": 2.0})
    pde, model = create_pde(cfg), PINNModel(cfg, seed=0)
    fn = fused_step.make_fused_residual_loss(model, pde)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    z = torch.cat(pde.generate_collocation_points(gen, 8192, "uniform"), dim=-1)
    runs = []
    for _ in range(2):
        loss = fn(model.params, z)
        runs.append((loss.detach(), torch.autograd.grad(loss, list(model.params.values()))))
    torch.cuda.synchronize()
    (l1, g1), (l2, g2) = runs
    assert torch.equal(l1, l2) and all(torch.equal(a, b) for a, b in zip(g1, g2))


@pytest.mark.parametrize("n,k,m,offset", [(2048, 124, 124, 1), (2048, 2, 124, 0), (37, 5, 13, 1)])
def test_siren_kernel_unaligned_and_fill(cuda_device, n, k, m, offset):
    """Kernel 3's 32x32 tile on an x one float past a 16-byte boundary (the
    guarded scalar path), and its grid: at least one block per SM at the
    shipped SIREN's (2048, 124) -> 124."""
    from pinnrl_tpu_torch.ops.kernels import siren

    _, W, b = _siren_inputs(n, k, m, cuda_device, n + k + 1)
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    x = _offset_matrix(n, k, offset, gen, cuda_device).uniform_(-1.0, 1.0, generator=gen)
    with torch.no_grad():
        got = siren.siren_layer(x, W, b, 30.0)
        ref = siren.siren_layer_plain(x, W, b, 30.0)
    torch.cuda.synchronize()
    assert _rel(got, ref) < 1e-5
    assert siren.launch_blocks(2048, 124) >= torch.cuda.get_device_properties(0).multi_processor_count


def _variant_config(key, arch, causal):
    """A kernel-1 configuration at recipe width: the convergence recipe
    ``key`` (Fourier 256x3, mapping 128), or the PDE's shipped block on its
    feedforward trunk (Black-Scholes: 128x7 with LayerNorm, as shipped)."""
    from pinnrl_tpu_torch.benchmarks.convergence import build_recipe_config
    from pinnrl_tpu_torch.config import load_config

    if arch == "fourier":
        cfg = build_recipe_config(key, device="cuda")
    else:
        cfg = load_config(pde_type=key, architecture="feedforward", device="cuda")
    cfg.training.causal_eps = 1.0 if causal else 0.0
    return cfg


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("key,arch", [("convection", "fourier"), ("allen_cahn", "fourier"),
                                      ("black_scholes", "fourier"), ("convection", "feedforward"),
                                      ("black_scholes", "feedforward")])
def test_fused_residual_loss_new_variants_match_plain(cuda_device, key, arch, causal):
    """Kernel 1's convection (3 streams), Allen-Cahn and Black-Scholes
    variants, on a Fourier and on a feedforward trunk, plain and causal, at
    N = 8192 on time-sorted points; two calls bit-identical."""
    from pinnrl_tpu_torch.models import PINNModel
    from pinnrl_tpu_torch.ops.jet_mlp import make_bundle_fn
    from pinnrl_tpu_torch.ops.kernels import fused_step
    from pinnrl_tpu_torch.pdes import create_pde

    cfg = _variant_config(key, arch, causal)
    pde, model = create_pde(cfg), PINNModel(cfg, seed=0)
    assert fused_step.supports(model, pde, cfg.training)
    fn = fused_step.make_fused_residual_loss(model, pde)
    bundle_fn = make_bundle_fn(model, 1, max(pde.spatial_orders), 1)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    x, t = pde.generate_collocation_points(gen, 8192, "uniform")
    z = torch.cat([x, t], dim=-1)[torch.argsort(t.reshape(-1), stable=True)]
    params = model.params
    runs = []
    for _ in range(2):
        lk = fn(params, z)
        runs.append((lk.detach(), torch.autograd.grad(lk, list(params.values()))))
    lp = fused_step.fused_residual_loss_plain(bundle_fn, pde, params, z)
    gp = torch.autograd.grad(lp, list(params.values()), allow_unused=True, materialize_grads=True)
    torch.cuda.synchronize()
    (l1, g1), (l2, g2) = runs
    assert torch.equal(l1, l2) and all(torch.equal(a, b) for a, b in zip(g1, g2))
    loss_tol, grad_tol = (1e-4, 1e-3) if causal else (1e-5, 1e-4)
    assert abs(float(l1) - float(lp.detach())) / abs(float(lp.detach())) < loss_tol
    for name, a, b in zip(params, g1, gp):
        assert torch.isfinite(a).all() and _rel(a, b) < grad_tol, name


@pytest.mark.parametrize("x_order", [1, 2, 3])
@pytest.mark.parametrize("n", [1, 300, 8192])
def test_affine_input_kernel_matches_twin(cuda_device, x_order, n):
    """The feedforward trunk's stacked input: the value rows to 1e-6
    relative to max, the direction rows exactly."""
    from pinnrl_tpu_torch.ops.kernels import fused_step

    gen = torch.Generator(device=cuda_device).manual_seed(n)
    z = torch.rand((n, 2), generator=gen, device=cuda_device) * 200.0
    lo = torch.tensor([0.0, 0.0], device=cuda_device)
    sc = torch.tensor([0.01, 2.0], device=cuda_device)
    got = fused_step._cuda_ops(cuda_device).affine_input(z, lo, sc, x_order, None)
    ref = fused_step._affine_input_plain(z, lo, sc, x_order, None)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == ((2 + x_order) * n, 2)
    assert _rel(got[:n], ref[:n]) < 1e-6 and torch.equal(got[n:], ref[n:])


@pytest.mark.parametrize("kx", [0, 4])
def test_kernel1_entry_points_refuse_an_x_order_out_of_scope(cuda_device, kx):
    from pinnrl_tpu_torch.ops.kernels import _build, fused_step

    ops = fused_step._cuda_ops(cuda_device)
    z = torch.zeros((8, 2), device=cuda_device)
    X = torch.empty((6 * 8, 2), device=cuda_device)
    one = torch.ones(2, device=cuda_device)
    stream = _build.stream_handle(cuda_device)
    # The input kernels take x-order 0 (an ODE: no x-group); the transport does not.
    status = ops.lib.fr_affine_input(z.data_ptr(), one.data_ptr(), one.data_ptr(), X.data_ptr(), 8,
                                     kx, 1, 0, 0.0, 1, stream)
    assert (status == 0) == (kx == 0)
    H = torch.zeros((6 * 8, 4), device=cuda_device)
    assert ops.lib.fr_transport_fwd(H.data_ptr(), None, None, H.data_ptr(), 8, 4, 0, kx, 1, 0, 1,
                                    stream) != 0



@pytest.mark.parametrize("dim", [0, -1])
def test_kernel1_entry_points_refuse_a_dimension_out_of_scope(cuda_device, dim):
    from pinnrl_tpu_torch.ops.kernels import _build, fused_step

    ops = fused_step._cuda_ops(cuda_device)
    stream = _build.stream_handle(cuda_device)
    buf = torch.zeros(4096, device=cuda_device)
    p = buf.data_ptr()
    assert ops.lib.fr_embed(p, p, p, p, p, 8, 4, 1, 2, dim, 0, 0.0, 1, 0, stream) != 0
    assert ops.lib.fr_affine_input(p, p, p, p, 8, 2, dim, 0, 0.0, 1, stream) != 0
    # The transport takes dim 0 (an ODE: no x-group); the other entry points do not.
    fwd = ops.lib.fr_transport_fwd(p, None, None, p, 8, 4, 0, 2, dim, 0, 1, stream)
    bwd = ops.lib.fr_transport_bwd(p, None, None, p, p, None, None, 8, 4, 0, 2, dim, 0, 1, stream)
    assert (fwd == 0) == (bwd == 0) == (dim == 0)
    assert ops.lib.fr_heat(p, p, p, 8, dim, 1.0, 0, 1, stream) != 0
    assert ops.lib.fr_convection(p, p, p, 8, dim, p, 0, 1, stream) != 0


@pytest.mark.parametrize("frame", [None, 0.7])
@pytest.mark.parametrize("x_order", [1, 2, 3])
@pytest.mark.parametrize("dim", [1, 2, 3, 4, 5])
def test_stacked_input_kernels_match_twins(cuda_device, dim, x_order, frame):
    """embed_kernel<D, KX> and affine_input_kernel<D> (d >= 4:
    embed_nd_kernel<KX> and affine_input_nd_kernel) against their twins at
    (4999, dim+1) points, mapping 64, with and without a frame."""
    from pinnrl_tpu_torch.ops.kernels import fused_step

    gen = torch.Generator(device=cuda_device).manual_seed(dim * 10 + x_order)
    n = 4999
    z = torch.rand((n, dim + 1), generator=gen, device=cuda_device) * 3.0 - 1.0
    lo = -torch.ones(dim + 1, device=cuda_device)
    sc = torch.rand(dim + 1, generator=gen, device=cuda_device) + 0.5
    B = torch.randn((dim + 1, 64), generator=gen, device=cuda_device)
    ops = fused_step._cuda_ops(cuda_device)
    got = ops.embed(z, lo, sc, B, True, x_order, frame)
    ref = fused_step._embed_plain(z, lo, sc, B, True, x_order, frame)
    got_ff = ops.affine_input(z, lo, sc, x_order, frame)
    ref_ff = fused_step._affine_input_plain(z, lo, sc, x_order, frame)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == ((2 + dim * x_order) * n, 128)
    assert _rel(got, ref) < 1e-4
    assert got_ff.shape == ref_ff.shape == ((2 + dim * x_order) * n, dim + 1)
    assert _rel(got_ff[:n], ref_ff[:n]) < 1e-6
    if frame is None:
        assert torch.equal(got_ff[n:], ref_ff[n:])
    else:
        assert _rel(got_ff[n:], ref_ff[n:]) < 1e-6


@pytest.mark.parametrize("layer_norm", [True, False])
@pytest.mark.parametrize("x_order", [1, 2, 3])
@pytest.mark.parametrize("dim", [1, 2, 3, 4, 5, 8])
def test_transport_kernels_match_twins(cuda_device, dim, x_order, layer_norm):
    """transport_fwd_kernel<D, KX> and transport_bwd_kernel<D, KX> (d >= 4:
    the *_nd_kernel<KX> group walk) against the twins on seeded (S n, 256)
    tensors."""
    from pinnrl_tpu_torch.ops.kernels import fused_step

    gen = torch.Generator(device=cuda_device).manual_seed(dim * 10 + x_order)
    n, width, streams = 300, 256, 2 + dim * x_order
    H = torch.randn((streams * n, width), generator=gen, device=cuda_device)
    GA = torch.randn((streams * n, width), generator=gen, device=cuda_device)
    gamma = 1.0 + 0.2 * torch.randn(width, generator=gen, device=cuda_device)
    beta = 0.2 * torch.randn(width, generator=gen, device=cuda_device)
    g, b = (gamma, beta) if layer_norm else (None, None)
    ops = fused_step._cuda_ops(cuda_device)
    A = ops.transport_fwd(H, g, b, n, dim, "tanh")
    GH, Gg, Gb = ops.transport_bwd(H, g, b, GA, n, dim, "tanh")
    A_ref = fused_step._transport_fwd_plain(H, g, b, n, dim, "tanh")
    GH_ref, Gg_ref, Gb_ref = fused_step._transport_bwd_plain(H, g, b, GA, n, dim, "tanh")
    torch.cuda.synchronize()
    assert _rel(A, A_ref) < 1e-5 and _rel(GH, GH_ref) < 1e-5
    if layer_norm:
        assert _rel(Gg, Gg_ref) < 1e-5 and _rel(Gb, Gb_ref) < 1e-5


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dim", [1, 2, 3, 4, 8])
def test_residual_kernels_match_twins(cuda_device, dim, causal):
    """The six residual kernels at D = 1-3 (and their *_nd kernels at d = 4
    and 8) against their twins on seeded stacked outputs."""
    from pinnrl_tpu_torch.ops.kernels import fused_step

    gen = torch.Generator(device=cuda_device).manual_seed(dim)
    n = 5000
    z = torch.rand((n, dim + 1), generator=gen, device=cuda_device) * 2.0
    cuda_ops, plain = fused_step._cuda_ops(cuda_device), fused_step._TorchOps()
    velocity = (0.5, -1.5, 2.0, 0.25, -0.75, 1.25, 3.0, -2.0)[:dim]
    velocity_dev = torch.tensor(velocity, device=cuda_device)
    for name, K, args in (("burgers", 2, (dim, 0.01)), ("heat", 2, (dim, 0.3)), ("kdv", 3, (dim,)),
                          ("convection", 1, (velocity, velocity_dev)),
                          ("allen_cahn", 2, (dim, 0.09))):
        U = torch.randn(((2 + dim * K) * n, 1), generator=gen, device=cuda_device)
        got = getattr(cuda_ops, name)(U, n, *args, causal)
        ref = getattr(plain, name)(U, n, *args, causal)
        torch.cuda.synchronize()
        for a, r in zip(got, ref):
            assert a.shape == r.shape and _rel(a, r) < 1e-6, name
    U = torch.randn(((2 + dim * 2) * n, 1), generator=gen, device=cuda_device)
    got = cuda_ops.black_scholes(U, z, n, -1.0, 0.02, 0.05, causal)
    ref = plain.black_scholes(U, z, n, -1.0, 0.02, 0.05, causal)
    torch.cuda.synchronize()
    for a, r in zip(got, ref):
        assert a.shape == r.shape and _rel(a, r) < 1e-6, "black_scholes"


@pytest.mark.parametrize("case", ["heat_2d", "heat_2d_causal", "heat_2d_feedforward",
                                  "heat_2d_frame", "burgers_frame", "heat_3d"])
def test_fused_residual_loss_beyond_one_dimension_matches_plain(cuda_device, case):
    """Kernel 1 in two and three space dimensions and in a co-moving frame
    through ``make_fused_residual_loss`` at N = 8192, narrow trunks; two
    calls bit-identical."""
    from pinnrl_tpu_torch.benchmarks.convergence import build_recipe_config
    from pinnrl_tpu_torch.config import load_config
    from pinnrl_tpu_torch.models import PINNModel
    from pinnrl_tpu_torch.ops.jet_mlp import make_bundle_fn
    from pinnrl_tpu_torch.ops.kernels import fused_step
    from pinnrl_tpu_torch.pdes import create_pde

    if case == "burgers_frame":
        cfg = load_config(pde_type="burgers", architecture="fourier", device="cuda")
    elif case == "heat_3d":
        cfg = load_config(pde_type="heat", architecture="fourier", device="cuda")
        cfg.pde.dimension, cfg.model.input_dim = 3, 4
        cfg.pde.domain = [list(cfg.pde.domain[0])] * 3
    else:
        cfg = build_recipe_config("heat_2d", device="cuda")
        if case.endswith("feedforward"):
            cfg.model.architecture = "feedforward"
    cfg.model.hidden_dims = [64, 48]
    cfg.model.arch_params["mapping_size"] = 32
    cfg.training.causal_eps = 1.0 if case.endswith("causal") else 0.0
    if case.endswith("frame"):
        cfg.model.arch_params["moving_frame_speed"] = 0.7
    pde, model = create_pde(cfg), PINNModel(cfg, seed=0)
    assert fused_step.supports(model, pde, cfg.training)
    fn = fused_step.make_fused_residual_loss(model, pde)
    bundle_fn = make_bundle_fn(model, pde.dimension, max(pde.spatial_orders), 1)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    x, t = pde.generate_collocation_points(gen, 8192, "uniform")
    z = torch.cat([x, t], dim=-1)[torch.argsort(t.reshape(-1), stable=True)]
    params = model.params
    runs = []
    for _ in range(2):
        lk = fn(params, z)
        runs.append((lk.detach(), torch.autograd.grad(lk, list(params.values()))))
    lp = fused_step.fused_residual_loss_plain(bundle_fn, pde, params, z)
    gp = torch.autograd.grad(lp, list(params.values()), allow_unused=True, materialize_grads=True)
    torch.cuda.synchronize()
    (l1, g1), (l2, g2) = runs
    assert torch.equal(l1, l2) and all(torch.equal(a, b) for a, b in zip(g1, g2))
    loss_tol, grad_tol = (1e-4, 1e-3) if case.endswith("causal") else (1e-5, 1e-4)
    assert abs(float(l1) - float(lp.detach())) / abs(float(lp.detach())) < loss_tol
    for name, a, b in zip(params, g1, gp):
        assert torch.isfinite(a).all() and _rel(a, b) < grad_tol, name


def test_float64_parameters_take_the_plain_path_on_card(cuda_device):
    """Kernel 1 refuses float64 leaves, so compute_loss gates them to the
    plain path, as the JAX package does: no launch, float64 losses equal to
    compute_residual + _residual_loss."""
    from pinnrl_tpu_torch.config import load_config
    from pinnrl_tpu_torch.models import PINNModel
    from pinnrl_tpu_torch.ops.kernels import fused_step
    from pinnrl_tpu_torch.pdes import create_pde

    cfg = load_config(pde_type="burgers", architecture="fourier", device="cuda")
    cfg.model.hidden_dims = [64, 64]
    cfg.model.arch_params["mapping_size"] = 32
    pde, model = create_pde(cfg), PINNModel(cfg, seed=0)
    pde.attach_fast_bundle(model)
    assert pde.attach_fused_residual_kernel(model)
    params = {k: v.detach().double() for k, v in model.params.items()}
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x, t = pde.generate_collocation_points(gen, 1024, "uniform")
    fused_step.fused_residual_loss.launches = 0
    losses = pde.compute_loss(model.apply, params, x, t, generator=gen)
    ref = pde._residual_loss(pde.compute_residual(model.apply, params, x, t), t)
    assert fused_step.fused_residual_loss.launches == 0
    assert losses["residual"].dtype == torch.float64
    assert _rel(losses["residual"], ref) < 1e-12
    assert all(bool(torch.isfinite(v)) for v in losses.values())


def test_pendulum_velocity_target_on_card(cuda_device):
    """The elliptic solution and its jvp in t on CUDA points (the ladder
    runs on the host as 0-d tensors) against the same on the CPU."""
    from pinnrl_tpu_torch.ops.special import pendulum_theta

    t = torch.linspace(0.0, 10.0, 4096).reshape(-1, 1)
    omega = float(torch.sqrt(torch.tensor(9.81)))

    def f(s):
        return pendulum_theta(s, 0.5, omega)

    v_c, d_c = torch.func.jvp(f, (t,), (torch.ones_like(t),))
    tg = t.to(cuda_device)
    v_g, d_g = torch.func.jvp(f, (tg,), (torch.ones_like(tg),))
    assert v_g.is_cuda and d_g.is_cuda
    assert float((v_g.cpu() - v_c).abs().max()) < 1e-5
    assert float((d_g.cpu() - d_c).abs().max()) < 1e-5


def _biharmonic(device, n):
    """The biharmonic recipe's PDE and network (Fourier 128x3, mapping 64,
    scale (1, 0)) on ``device``, and n uniform points."""
    from pinnrl_tpu_torch.benchmarks.convergence import build_recipe_config
    from pinnrl_tpu_torch.models import PINNModel
    from pinnrl_tpu_torch.pdes import create_pde

    cfg = build_recipe_config("cahn_hilliard_biharmonic", device="cuda")
    pde, model = create_pde(cfg), PINNModel(cfg, seed=0)
    x, t = pde.generate_collocation_points(torch.Generator(device=device).manual_seed(1), n,
                                           "uniform")
    return pde, model, x, t


def test_fourier_features_jvp_rule_at_order_4_on_card(cuda_device):
    """Four nested jvps along x of the biharmonic recipe's network: every
    order through kernel 2's rule against the plain version."""
    from pinnrl_tpu_torch.ops.derivatives import directional_derivative, make_scalar_fn
    from pinnrl_tpu_torch.ops.kernels import fourier_feats

    pde, model, x, t = _biharmonic(cuda_device, 2048)
    assert not model.constants["FourierFeatures_0.B"][1].any()
    z = torch.cat([x, t], dim=-1)
    u = make_scalar_fn(model.apply, model.params)
    before = fourier_feats.fourier_features.jvps
    with torch.no_grad():
        got = directional_derivative(u, z, 0, 4)
        assert fourier_feats.fourier_features.jvps - before >= 4
        plain = fourier_feats.fourier_features
        fourier_feats.fourier_features = fourier_feats.fourier_features_plain
        try:
            ref = directional_derivative(u, z, 0, 4)
        finally:
            fourier_feats.fourier_features = plain
    for k, (a, b) in enumerate(zip(got, ref), start=1):
        assert _rel(a, b) < 1e-4 * 10 ** (k - 1), k


def test_cahn_hilliard_direct_residual_gradients_through_kernel2(cuda_device):
    from pinnrl_tpu_torch.ops.kernels import fourier_feats

    pde, model, x, t = _biharmonic(cuda_device, 1024)
    params = {k: v.detach().requires_grad_(True) for k, v in model.params.items()}

    def loss_and_grads():
        r = pde.compute_residual(model.apply, params, x, t)
        loss = pde._residual_loss(r, t)
        return r, loss, torch.autograd.grad(loss, list(params.values()), allow_unused=True,
                                            materialize_grads=True)

    before = fourier_feats.fourier_features.launches
    r_k, l_k, g_k = loss_and_grads()
    assert fourier_feats.fourier_features.launches > before
    plain = fourier_feats.fourier_features
    fourier_feats.fourier_features = fourier_feats.fourier_features_plain
    try:
        r_p, l_p, g_p = loss_and_grads()
    finally:
        fourier_feats.fourier_features = plain
    assert _rel(r_k.detach(), r_p.detach()) < 1e-3
    assert abs(float(l_k) - float(l_p)) / abs(float(l_p)) < 1e-3
    for a, b in zip(g_k, g_p):
        assert _rel(a, b) < 1e-3


def test_heat_inverse_loss_and_coefficient_gradient_through_kernel2(cuda_device):
    """The heat inverse recipe's loss on 2000 noisy observations and its
    gradients with respect to alpha and the network, with kernel 2 and with
    its plain version on the same points; kernel 2 launches three times per
    loss (IC, periodic faces, data) and runs its jvp rule once."""
    from pinnrl_tpu_torch.benchmarks.inverse import build_inverse_config
    from pinnrl_tpu_torch.models import PINNModel
    from pinnrl_tpu_torch.ops.kernels import fourier_feats
    from pinnrl_tpu_torch.pdes import create_pde
    from pinnrl_tpu_torch.training import PDETrainer

    cfg = build_inverse_config("heat", epochs=1, device="cuda")
    pde = create_pde(cfg)
    pde.generate_synthetic_observations(torch.Generator(device=cuda_device).manual_seed(1000),
                                        2000, 0.01)
    tr = PDETrainer(PINNModel(cfg, seed=0), pde, cfg)
    assert not tr.fused_kernel_active and sorted(tr.coeffs) == ["alpha"]
    params = tr.model.params
    x, t = pde.generate_collocation_points(torch.Generator(device=cuda_device).manual_seed(2),
                                           4096, "uniform")

    def loss_and_grads():
        losses = tr._loss_components(params, x, t, torch.Generator(device=cuda_device).manual_seed(3))
        return losses, torch.autograd.grad(losses["total"], tr._leaves(params))

    ff = fourier_feats.fourier_features
    launches, jvps = ff.launches, ff.jvps
    l_k, g_k = loss_and_grads()
    torch.cuda.synchronize()
    assert (ff.launches - launches, ff.jvps - jvps) == (3, 1)
    fourier_feats.fourier_features = fourier_feats.fourier_features_plain
    try:
        l_p, g_p = loss_and_grads()
    finally:
        fourier_feats.fourier_features = ff
    for k in ("total", "data", "boundary", "initial", "residual"):
        assert abs(float(l_k[k]) - float(l_p[k])) <= 1e-5 * abs(float(l_p[k])), k
    assert float(l_k["data"]) > 0
    for a, b in zip(g_k, g_p):
        assert _rel(a, b) < 1e-4


# The sampling harness's shapes: its agent (hidden 64) on the 100 x 100 grid
# with (x, t) and with the residual feature, and its Fourier trunk (mapping
# 32) on the BC / IC batches (5000 rows) and the 64^2 evaluation grid.
@pytest.mark.parametrize("d", [2, 3])
def test_fused_mlp_score_at_the_sampling_harness_width(cuda_device, d):
    from pinnrl_tpu_torch.ops.kernels import mlp

    params = _scorer_params(64, 1, cuda_device, state_dim=d)
    gen = torch.Generator(device=cuda_device).manual_seed(d)
    x = 2.0 * torch.rand((10000, d), generator=gen, device=cuda_device) - 1.0
    before = mlp.fused_mlp_score.launches
    with torch.no_grad():
        got = mlp.fused_mlp_score(x, params)
        again = mlp.fused_mlp_score(x, params)
        ref = mlp.fused_mlp_score_plain(x, params)
    torch.cuda.synchronize()
    assert mlp.fused_mlp_score.launches == before + 2
    assert got.shape == (10000, 1) and _rel(got, ref) < 1e-4 and torch.equal(got, again)


@pytest.mark.parametrize("n", [5000, 4096])
def test_fourier_features_at_mapping_32(cuda_device, n):
    """The harness's basis (2, 32): eight feature quads; forward, gradient
    and the jvp rule (wave's velocity IC) at orders 1-2 along t."""
    from pinnrl_tpu_torch.ops.kernels import fourier_feats

    gen = torch.Generator(device=cuda_device).manual_seed(n)
    x = 2.0 * torch.rand((n, 2), generator=gen, device=cuda_device) - 1.0
    B = 2.0 * torch.randn((2, 32), generator=gen, device=cuda_device)
    got = fourier_feats.fourier_features(x, B, True)
    assert _rel(got, fourier_feats.fourier_features_plain(x, B, True)) < 1e-5
    assert torch.equal(got, fourier_feats.fourier_features(x, B, True))
    xg = x.clone().requires_grad_(True)
    g_out = torch.randn((n, 64), generator=gen, device=cuda_device)
    gk = torch.autograd.grad(fourier_feats.fourier_features(xg, B, True), xg, g_out)[0]
    gp = torch.autograd.grad(fourier_feats.fourier_features_plain(xg, B, True), xg, g_out)[0]
    assert _rel(gk, gp) < 1e-5
    v = torch.zeros_like(x)
    v[:, 1] = 1.0
    for order in (1, 2):
        k = _nested(lambda xx: fourier_feats.fourier_features(xx, B, True), x, v, order)
        p = _nested(lambda xx: fourier_feats.fourier_features_plain(xx, B, True), x, v, order)
        assert _rel(k, p) < 1e-4 * 10 ** (order - 1), order


def test_kernel1_under_lrw_component_gradients(cuda_device):
    """LRW's three per-component ``torch.autograd.grad`` calls and the
    weighted backward through kernel 1's Function: one launch for all four,
    and the residual, boundary and initial gradients against the plain
    path's (kernel 1 off) on the same points: 1e-4 relative to each
    gradient's max, as kernel 1's gradients."""
    from pinnrl_tpu_torch.config import load_config
    from pinnrl_tpu_torch.models import PINNModel
    from pinnrl_tpu_torch.ops.kernels import fused_step
    from pinnrl_tpu_torch.pdes import create_pde
    from pinnrl_tpu_torch.training import PDETrainer

    cfg = load_config(pde_type="burgers", architecture="fourier", device="cuda")
    cfg.model.hidden_dims = [256, 256, 256]
    cfg.model.arch_params.update({"mapping_size": 128, "scale": 2.0})
    cfg.training.adaptive_weights.enabled = True
    cfg.training.adaptive_weights.strategy = "lrw"
    cfg.training.optimizer = "adam"
    model, pde = PINNModel(cfg, seed=0), create_pde(cfg)
    tr = PDETrainer(model, pde, cfg)
    assert tr.fused_kernel_active
    params = model.params
    leaves = tr._leaves(params)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    x, t = pde.generate_collocation_points(gen, 8192, "uniform")

    def component_grads():
        losses = tr._loss_components(params, x, t, torch.Generator(device=cuda_device).manual_seed(2))
        grads = [torch.autograd.grad(losses[k], leaves, retain_graph=True)
                 for k in ("residual", "boundary", "initial")]
        total, _ = tr._adaptive_total(losses, leaves)
        total.backward()
        return grads

    before = fused_step.fused_residual_loss.launches
    gk = component_grads()
    torch.cuda.synchronize()
    assert fused_step.fused_residual_loss.launches == before + 1
    pde.attach_fused_residual_kernel(model, enable="off")
    gp = component_grads()
    for comp, a, b in zip(("residual", "boundary", "initial"), gk, gp):
        for name, ga, gb in zip(params, a, b):
            assert _rel(ga, gb) < 1e-4, (comp, name)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_float64_takes_the_plain_versions_by_the_jax_gate(cuda_device, dtype):
    """Kernels 2 and 3 on CUDA tensors: float64 (the float64 residual phase)
    runs the plain version and launches nothing, float32 launches the
    kernel."""
    from pinnrl_tpu_torch.ops.kernels import fourier_feats, siren

    g = torch.Generator(device=cuda_device).manual_seed(17)
    x = torch.rand((2048, 2), generator=g, device=cuda_device, dtype=dtype)
    B = torch.randn((2, 128), generator=g, device=cuda_device, dtype=dtype)
    W = torch.randn((2, 124), generator=g, device=cuda_device, dtype=dtype)
    b = torch.zeros(124, device=cuda_device, dtype=dtype)
    for fn, plain, args in ((fourier_feats.fourier_features, fourier_feats.fourier_features_plain,
                             (x, B, True)),
                            (siren.siren_layer, siren.siren_layer_plain, (x, W, b, 30.0))):
        launches, plain_calls = fn.launches, fn.plain_f64
        got = fn(*args)
        ref = plain(*args)
        assert got.dtype == dtype
        if dtype == torch.float64:
            assert (fn.launches, fn.plain_f64) == (launches, plain_calls + 1)
            assert torch.equal(got, ref)
        else:
            assert (fn.launches, fn.plain_f64) == (launches + 1, plain_calls)
            assert _rel(got, ref) < 1e-5


_ACTS = ["tanh", "gelu", "sigmoid", "silu", "sin"]


@pytest.mark.parametrize("layer_norm", [True, False])
@pytest.mark.parametrize("x_order", [1, 2, 3])
@pytest.mark.parametrize("dim", [1, 3])
@pytest.mark.parametrize("act", _ACTS)
def test_transport_kernels_match_twins_for_every_activation(cuda_device, act, dim, x_order,
                                                            layer_norm):
    """transport_fwd_kernel<D, KX> and transport_bwd_kernel<D, KX> with each
    activation code against the twins on seeded (S n, 256) tensors, 1e-5
    relative to max per stacked tensor."""
    from pinnrl_tpu_torch.ops.kernels import fused_step

    gen = torch.Generator(device=cuda_device).manual_seed(dim * 10 + x_order)
    n, width, streams = 300, 256, 2 + dim * x_order
    H = torch.randn((streams * n, width), generator=gen, device=cuda_device)
    GA = torch.randn((streams * n, width), generator=gen, device=cuda_device)
    gamma = 1.0 + 0.2 * torch.randn(width, generator=gen, device=cuda_device)
    beta = 0.2 * torch.randn(width, generator=gen, device=cuda_device)
    g, b = (gamma, beta) if layer_norm else (None, None)
    ops = fused_step._cuda_ops(cuda_device)
    A = ops.transport_fwd(H, g, b, n, dim, act)
    GH, Gg, Gb = ops.transport_bwd(H, g, b, GA, n, dim, act)
    A_ref = fused_step._transport_fwd_plain(H, g, b, n, dim, act)
    GH_ref, Gg_ref, Gb_ref = fused_step._transport_bwd_plain(H, g, b, GA, n, dim, act)
    torch.cuda.synchronize()
    assert _rel(A, A_ref) < 1e-5 and _rel(GH, GH_ref) < 1e-5
    if layer_norm:
        assert _rel(Gg, Gg_ref) < 1e-5 and _rel(Gb, Gb_ref) < 1e-5


def test_transport_entry_points_refuse_an_unknown_activation(cuda_device):
    from pinnrl_tpu_torch.ops.kernels import _build, fused_step

    ops = fused_step._cuda_ops(cuda_device)
    stream = _build.stream_handle(cuda_device)
    p = torch.zeros(4096, device=cuda_device).data_ptr()
    for act in (-1, 5):
        assert ops.lib.fr_transport_fwd(p, None, None, p, 8, 4, 0, 2, 1, act, 1, stream) != 0
        assert ops.lib.fr_transport_bwd(p, None, None, p, p, None, None, 8, 4, 0, 2, 1, act, 1,
                                        stream) != 0


@pytest.mark.parametrize("case", ["burgers", "kdv_causal", "heat_2d", "feedforward", "no_ln",
                                  "trainable_basis"])
@pytest.mark.parametrize("act", ["gelu", "sigmoid", "silu", "sin"])
def test_fused_residual_loss_matches_plain_for_every_activation(cuda_device, act, case):
    """Kernel 1 with each non-tanh activation through
    ``make_fused_residual_loss`` at N = 8192 on narrow trunks (64x48, mapping
    32; Black-Scholes's shipped feedforward 128x7) against the plain version
    run in float64 on the same inputs: loss 1e-5 and gradients 1e-4
    relative (causal KdV 2e-4 and 1e-3); two calls bit-identical. The
    float64 run is the reference because the float32 plain version is the
    less accurate of the two where the residual cancels (the feedforward
    Black-Scholes trunk with sin; ``chip_smoke.py`` phase 43 prints both
    gaps to float64)."""
    from pinnrl_tpu_torch.benchmarks.convergence import build_recipe_config
    from pinnrl_tpu_torch.config import load_config
    from pinnrl_tpu_torch.models import PINNModel
    from pinnrl_tpu_torch.ops.jet_mlp import make_bundle_fn
    from pinnrl_tpu_torch.ops.kernels import fused_step
    from pinnrl_tpu_torch.pdes import create_pde

    if case == "feedforward":
        cfg = load_config(pde_type="black_scholes", device="cuda")
    else:
        cfg = build_recipe_config({"kdv_causal": "kdv", "heat_2d": "heat_2d"}.get(case, "burgers"),
                                  device="cuda")
        cfg.model.hidden_dims = [64, 48]
        cfg.model.arch_params["mapping_size"] = 32
        cfg.model.arch_params.pop("feature_seed", None)
    cfg.model.activation = act
    cfg.model.layer_norm = case != "no_ln"
    cfg.model.arch_params["trainable_features"] = case == "trainable_basis"
    cfg.training.causal_eps = 1.0 if case == "kdv_causal" else 0.0
    pde, model = create_pde(cfg), PINNModel(cfg, seed=0)
    assert fused_step.supports(model, pde, cfg.training)
    fn = fused_step.make_fused_residual_loss(model, pde)
    bundle_fn = make_bundle_fn(model, pde.dimension, max(pde.spatial_orders), 1)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    x, t = pde.generate_collocation_points(gen, 8192, "uniform")
    z = torch.cat([x, t], dim=-1)[torch.argsort(t.reshape(-1), stable=True)]
    params = model.params
    runs = []
    for _ in range(2):
        lk = fn(params, z)
        runs.append((lk.detach(), torch.autograd.grad(lk, list(params.values()))))
    p64 = {k: v.detach().double().requires_grad_(True) for k, v in params.items()}
    lp = fused_step.fused_residual_loss_plain(bundle_fn, pde, p64, z.double())
    gp = torch.autograd.grad(lp, list(p64.values()), allow_unused=True, materialize_grads=True)
    torch.cuda.synchronize()
    (l1, g1), (l2, g2) = runs
    assert torch.equal(l1, l2) and all(torch.equal(a, b) for a, b in zip(g1, g2))
    loss_tol, grad_tol = (2e-4, 1e-3) if case == "kdv_causal" else (1e-5, 1e-4)
    assert abs(float(l1) - float(lp.detach())) / abs(float(lp.detach())) < loss_tol
    for name, a, b in zip(params, g1, gp):
        assert torch.isfinite(a).all() and _rel(a, b) < grad_tol, name


@pytest.mark.parametrize("frame", [None, 0.7])
@pytest.mark.parametrize("x_order", [1, 2, 3])
@pytest.mark.parametrize("dim", [4, 40])
def test_embed_bwd_nd_kernel_matches_twin(cuda_device, dim, x_order, frame):
    """dL/dB of a trainable basis in d >= 4 dimensions
    (embed_bwd_nd_partial_kernel<KX>: d = 40 takes two tiles of axis rows
    along z) against ``_embed_bwd_plain`` on a seeded cotangent, 1e-4
    relative to max (the gradients' bound)."""
    from pinnrl_tpu_torch.ops.kernels import fused_step

    gen = torch.Generator(device=cuda_device).manual_seed(dim + x_order)
    n, m = 999, 40
    z = torch.rand((n, dim + 1), generator=gen, device=cuda_device) * 2.0 - 1.0
    lo = -torch.ones(dim + 1, device=cuda_device)
    sc = torch.rand(dim + 1, generator=gen, device=cuda_device) + 0.5
    B = torch.randn((dim + 1, m), generator=gen, device=cuda_device)
    G = torch.randn(((2 + dim * x_order) * n, 2 * m), generator=gen, device=cuda_device)
    got = fused_step._cuda_ops(cuda_device).embed_bwd(z, lo, sc, B, G, True, x_order, frame)
    ref = fused_step._embed_bwd_plain(z.double(), lo.double(), sc.double(), B.double(),
                                      G.double(), True, x_order, frame)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (dim + 1, m)
    assert _rel(got.double(), ref) < 1e-4


ND_CASES = {f"{p}_4d": (p, 4) for p in ("burgers", "heat", "kdv", "convection", "allen_cahn",
                                        "black_scholes")}
ND_CASES.update({"heat_8d": ("heat", 8), "heat_4d_feedforward": ("heat", 4),
                 "heat_4d_causal_frame_basis_gelu": ("heat", 4),
                 "black_scholes_4d_shipped_feedforward": ("black_scholes", 4)})


@pytest.mark.parametrize("case", sorted(ND_CASES))
def test_fused_residual_loss_in_four_and_more_dimensions_matches_plain(cuda_device, case):
    """Kernel 1 in d >= 4 dimensions through ``make_fused_residual_loss``
    at N = 4096 on narrow trunks (64x48, mapping 32; every residual at d =
    4, heat at d = 8, the feedforward trunk, and causal weights with a
    frame, a trainable basis and gelu together), and on Black-Scholes's
    shipped feedforward 128x7 over a basket of four assets on [0, 200]^4
    (the ill-conditioned float32 case), against the plain version
    run in float64 on the same inputs: loss 1e-5 and gradients 1e-4
    relative (causal 1e-4 and 1e-3); two calls bit-identical."""
    from pinnrl_tpu_torch.config import load_config
    from pinnrl_tpu_torch.models import PINNModel
    from pinnrl_tpu_torch.ops.jet_mlp import make_bundle_fn
    from pinnrl_tpu_torch.ops.kernels import fused_step
    from pinnrl_tpu_torch.pdes import create_pde

    pde_type, dim = ND_CASES[case]
    arch = "feedforward" if case.endswith("feedforward") else "fourier"
    cfg = load_config(pde_type=pde_type, architecture=arch, device="cuda")
    cfg.pde.dimension, cfg.model.input_dim = dim, dim + 1
    cfg.pde.domain = [list(cfg.pde.domain[0])] * dim
    if pde_type == "convection":
        cfg.pde.parameters["velocity"] = [0.5, -1.5, 1.0, 0.25]
    if "shipped" not in case:
        cfg.model.hidden_dims = [64, 48]
        cfg.model.arch_params["mapping_size"] = 32
    causal = case.endswith("gelu")
    if causal:
        cfg.model.activation = "gelu"
        cfg.model.arch_params.update({"trainable_features": True, "moving_frame_speed": 0.7})
    cfg.training.causal_eps = 1.0 if causal else 0.0
    pde, model = create_pde(cfg), PINNModel(cfg, seed=0)
    assert fused_step.supports(model, pde, cfg.training)
    fn = fused_step.make_fused_residual_loss(model, pde)
    bundle_fn = make_bundle_fn(model, pde.dimension, max(pde.spatial_orders), 1)
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    x, t = pde.generate_collocation_points(gen, 4096, "uniform")
    z = torch.cat([x, t], dim=-1)[torch.argsort(t.reshape(-1), stable=True)]
    params = model.params
    launches = fused_step.fused_residual_loss.launches
    runs = []
    for _ in range(2):
        lk = fn(params, z)
        runs.append((lk.detach(), torch.autograd.grad(lk, list(params.values()))))
    assert fused_step.fused_residual_loss.launches == launches + 2
    p64 = {k: v.detach().double().requires_grad_(True) for k, v in params.items()}
    lp = fused_step.fused_residual_loss_plain(bundle_fn, pde, p64, z.double())
    gp = torch.autograd.grad(lp, list(p64.values()), allow_unused=True, materialize_grads=True)
    torch.cuda.synchronize()
    (l1, g1), (l2, g2) = runs
    assert torch.equal(l1, l2) and all(torch.equal(a, b) for a, b in zip(g1, g2))
    loss_tol, grad_tol = (1e-4, 1e-3) if causal else (1e-5, 1e-4)
    assert abs(float(l1) - float(lp.detach())) / abs(float(lp.detach())) < loss_tol
    for name, a, b in zip(params, g1, gp):
        assert torch.isfinite(a).all() and _rel(a.double(), b) < grad_tol, name


def _sin_tanh_program(dim):
    """A residual through sin, tanh, sigmoid and exp, reading z: traced from
    a Burgers subclass (the generated residual's op table and its reverse)."""
    from pinnrl_tpu_torch.config import load_config
    from pinnrl_tpu_torch.ops.derivatives import directional_derivative as dd
    from pinnrl_tpu_torch.ops.kernels import residual_codegen
    from pinnrl_tpu_torch.pdes.burgers import BurgersEquation

    class Forced(BurgersEquation):
        def residual_pointwise(self, u, z, coeffs):
            val = u(z)
            r = dd(u, z, self.dimension, 1)[0] + 0.5 * torch.tanh(val) + torch.sigmoid(val)
            for ax in range(self.dimension):
                r = r + torch.sin(z[:, ax]) * dd(u, z, ax, 2)[1] * torch.exp(-val * val)
            return r

    cfg = load_config(pde_type="burgers", device="cpu")
    cfg.pde.dimension = dim
    cfg.pde.domain = [[-1.0, 1.0]] * dim
    return residual_codegen.trace(Forced(cfg.pde, cfg.training, device="cpu"), 2)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dim", [1, 2, 4])
def test_generated_residual_kernel_matches_twin(cuda_device, dim, causal):
    """The generated residual kernel (csrc/residual_generated.cuh around the
    emitted body) against its float64 twin (``_TorchOps.generated``) on seeded stacked
    outputs, 1e-5 relative to max (sinf, tanhf, expf against torch's), with
    exactly one launch counted per call and two calls bit-identical; and for
    Burgers' own residual against burgers_kernel at 1e-6."""
    from pinnrl_tpu_torch.config import load_config
    from pinnrl_tpu_torch.ops.kernels import fused_step, residual_codegen
    from pinnrl_tpu_torch.pdes import create_pde

    gen = torch.Generator(device=cuda_device).manual_seed(dim)
    n = 5000
    program = _sin_tanh_program(dim)
    U = torch.randn((program.n_streams * n, 1), generator=gen, device=cuda_device)
    z = torch.rand((n, dim + 1), generator=gen, device=cuda_device) * 2.0
    before = residual_codegen.launch.launches
    got = residual_codegen.launch(program, U, z, n, causal)
    again = residual_codegen.launch(program, U, z, n, causal)
    ref = fused_step._TorchOps().generated(program, U.double(), z.double(), n, causal)
    torch.cuda.synchronize()
    assert residual_codegen.launch.launches == before + 2
    for a, b, r in zip(got, again, ref):
        assert a.shape == r.shape and torch.equal(a, b) and _rel(a.double(), r) < 1e-5
    cfg = load_config(pde_type="burgers", device="cpu")
    cfg.pde.dimension, cfg.pde.domain = dim, [[-1.0, 1.0]] * dim
    burgers = residual_codegen.trace(create_pde(cfg), 2)
    U = torch.randn((burgers.n_streams * n, 1), generator=gen, device=cuda_device)
    got = residual_codegen.launch(burgers, U, z, n, causal)
    ref = fused_step._cuda_ops(cuda_device).burgers(U, n, dim, 0.01, causal)
    torch.cuda.synchronize()
    for a, r in zip(got, ref):
        assert _rel(a, r) < 1e-6


@pytest.mark.parametrize("causal", [True, False])
def test_select_residual_kernel_keeps_twins_nans(cuda_device, causal):
    """A residual through every select of the op table, traced from a
    Burgers subclass: on points with u at its clamp bounds and at 0, NaN and
    +-inf, the
    kernel's NaNs and infinities are the float32 twin's and its finite
    entries within 1e-5 of the float64 twin's."""
    from pinnrl_tpu_torch.config import load_config
    from pinnrl_tpu_torch.ops.derivatives import directional_derivative as dd
    from pinnrl_tpu_torch.ops.kernels import fused_step, residual_codegen
    from pinnrl_tpu_torch.pdes.burgers import BurgersEquation

    class Selects(BurgersEquation):
        def residual_pointwise(self, u, z, coeffs):
            val = u(z)
            sel = (torch.clamp(val, -0.5, 0.5) + torch.where(val > 0, val, 0.0)
                   + torch.maximum(val, torch.full_like(val, 0.2))
                   + torch.minimum(val, z[:, 0]) + torch.relu(val - 0.3)
                   + torch.fmax(val, z[:, 1] - 1.0) + torch.nn.functional.softplus(val))
            smooth = (torch.atan2(val, 1.0 + val * val) + torch.asinh(val)
                      + torch.log10(1.0 + val * val) + torch.erfc(val))
            return (dd(u, z, self.dimension, 1)[0] + val * dd(u, z, 0, 1)[0] + 0.1 * sel
                    + 0.01 * smooth)

    cfg = load_config(pde_type="burgers", device="cpu")
    program = residual_codegen.trace(Selects(cfg.pde, cfg.training, device="cpu"), 2)
    assert "fmaxf" not in program.source and "fminf" not in program.source
    gen = torch.Generator(device=cuda_device).manual_seed(21)
    n = 5000
    U = torch.randn((program.n_streams, n), generator=gen, device=cuda_device)
    # Kinks exact in float32 and float64 alike (0.2 is not: the two twins
    # would take the two sides of maximum's tie), then NaN and +-inf.
    special = torch.tensor([-0.5, 0.5, 0.0, float("nan"), float("inf"), -float("inf")],
                           device=cuda_device)
    U[0, :special.numel()] = special
    U[:, -1] = float("nan")
    U[:, -2] = float("inf")
    U = U.reshape(-1, 1)
    z = torch.rand((n, 2), generator=gen, device=cuda_device) * 2.0 - 1.0
    got = residual_codegen.launch(program, U, z, n, causal)
    twin = fused_step._TorchOps().generated(program, U, z, n, causal)
    ref = fused_step._TorchOps().generated(program, U.double(), z.double(), n, causal)
    torch.cuda.synchronize()
    for a, t, r in zip(got, twin, ref):
        assert torch.equal(a.isnan(), t.isnan()) and torch.equal(a.isinf(), t.isinf())
        fin = torch.isfinite(r) & torch.isfinite(a)
        assert _rel(a.double()[fin], r[fin]) < 1e-5


@pytest.mark.parametrize("dim", [1, 2, 4])
def test_no_x_group_kernels_match_twins(cuda_device, dim):
    """A first-order ODE's kernels (no x-group): the Fourier and feedforward
    input kernels at K = 0 (embed_kernel<D, 0>, embed_nd_kernel<0>), dL/dB
    at K = 0, and the transport at D = 0 (transport_fwd_kernel<0, 1>,
    transport_bwd_kernel<0, 1>, with and without LayerNorm) against their
    twins, at the bounds of the K >= 1 tests above."""
    from pinnrl_tpu_torch.ops.kernels import fused_step

    gen = torch.Generator(device=cuda_device).manual_seed(dim)
    n, m, width = 2999, 64, 256
    z = torch.rand((n, dim + 1), generator=gen, device=cuda_device) * 3.0 - 1.0
    lo = -torch.ones(dim + 1, device=cuda_device)
    sc = torch.rand(dim + 1, generator=gen, device=cuda_device) + 0.5
    B = torch.randn((dim + 1, m), generator=gen, device=cuda_device)
    ops = fused_step._cuda_ops(cuda_device)
    X = ops.embed(z, lo, sc, B, True, 0, None)
    X_ff = ops.affine_input(z, lo, sc, 0, None)
    G = torch.randn((2 * n, 2 * m), generator=gen, device=cuda_device)
    dB = ops.embed_bwd(z, lo, sc, B, G, True, 0, None)
    torch.cuda.synchronize()
    assert X.shape == (2 * n, 2 * m) and X_ff.shape == (2 * n, dim + 1)
    assert _rel(X, fused_step._embed_plain(z, lo, sc, B, True, 0, None)) < 1e-4
    assert _rel(X_ff, fused_step._affine_input_plain(z, lo, sc, 0, None)) < 1e-6
    dB_ref = fused_step._embed_bwd_plain(z.double(), lo.double(), sc.double(), B.double(),
                                         G.double(), True, 0, None)
    assert _rel(dB.double(), dB_ref) < 1e-4
    H = torch.randn((2 * n, width), generator=gen, device=cuda_device)
    GA = torch.randn((2 * n, width), generator=gen, device=cuda_device)
    gamma = 1.0 + 0.2 * torch.randn(width, generator=gen, device=cuda_device)
    beta = 0.2 * torch.randn(width, generator=gen, device=cuda_device)
    for g, b in ((gamma, beta), (None, None)):
        A = ops.transport_fwd(H, g, b, n, 0, "tanh")
        GH, Gg, Gb = ops.transport_bwd(H, g, b, GA, n, 0, "tanh")
        A_ref = fused_step._transport_fwd_plain(H, g, b, n, 0, "tanh")
        GH_ref, Gg_ref, Gb_ref = fused_step._transport_bwd_plain(H, g, b, GA, n, 0, "tanh")
        torch.cuda.synchronize()
        assert _rel(A, A_ref) < 1e-5 and _rel(GH, GH_ref) < 1e-5
        if g is not None:
            assert _rel(Gg, Gg_ref) < 1e-5 and _rel(Gb, Gb_ref) < 1e-5


@pytest.mark.parametrize("case", ["layer_norm", "causal_basis", "feedforward", "four_dims"])
def test_member_batched_kernel1_equals_single_member_calls(cuda_device, case):
    """Kernel 1 on 3 stacked members (z (3, N, d+1), leaves (3, ...)) in one
    launch of each kernel, bit-identical to 3 single-member calls on copies
    of each member's tensors (the member axis changes which block computes,
    not the order of any sum), and bit-identical in two calls."""
    from pinnrl_tpu_torch.config import load_config
    from pinnrl_tpu_torch.models import PINNModel
    from pinnrl_tpu_torch.ops.kernels import fused_step
    from pinnrl_tpu_torch.pdes import create_pde

    arch = "feedforward" if case == "feedforward" else "fourier"
    cfg = load_config(pde_type="heat" if case == "four_dims" else "burgers", architecture=arch,
                      device="cuda")
    if case == "four_dims":
        cfg.pde.dimension, cfg.model.input_dim = 4, 5
        cfg.pde.domain = [list(cfg.pde.domain[0])] * 4
    cfg.model.hidden_dims = [64, 48]
    cfg.model.arch_params["mapping_size"] = 32
    cfg.model.arch_params["trainable_features"] = case == "causal_basis"
    cfg.training.causal_eps = 1.0 if case == "causal_basis" else 0.0
    models = [PINNModel(cfg, seed=e) for e in range(3)]
    pde = create_pde(cfg)
    P = {k: torch.stack([m.params[k].detach() for m in models]) for k in models[0].params}
    spec = fused_step._spec(models[0], pde)
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    z = torch.stack([torch.cat(pde.generate_collocation_points(gen, 1000, "uniform"), dim=-1)
                     for _ in range(3)])
    z = torch.gather(z, 1, torch.argsort(z[..., -1], dim=1, stable=True)[..., None].expand_as(z))
    ops = fused_step._cuda_ops(cuda_device)
    loss, grads = fused_step._loss_and_grads(ops, spec, z, P)
    loss2, grads2 = fused_step._loss_and_grads(ops, spec, z, P)
    torch.cuda.synchronize()
    assert loss.shape == (3,) and all(grads[k].shape == P[k].shape for k in P)
    assert torch.equal(loss, loss2) and all(torch.equal(grads[k], grads2[k]) for k in grads)
    for e in range(3):
        l1, g1 = fused_step._loss_and_grads(ops, spec, z[e].clone(),
                                            {k: v[e].clone() for k, v in P.items()})
        torch.cuda.synchronize()
        assert torch.equal(loss[e], l1) and all(torch.equal(grads[k][e], g1[k]) for k in g1), e


def test_member_batched_kernels_2_and_3_equal_single_launches(cuda_device):
    """Kernels 2 and 3 on 4 members (B (4, d, m); W (4, k, m), b (4, m)) in
    one launch, equal to per-member launches and within the plain versions'
    bounds; through their vmap rules the same one launch."""
    from pinnrl_tpu_torch.ops.kernels import fourier_feats, siren

    gen = torch.Generator(device=cuda_device).manual_seed(12)
    x = torch.rand((4, 3000, 2), generator=gen, device=cuda_device) * 2.0 - 1.0
    B = torch.randn((4, 2, 64), generator=gen, device=cuda_device)
    before = fourier_feats.fourier_features.launches
    out = torch.func.vmap(fourier_feats.fourier_features)(x, B)
    assert fourier_feats.fourier_features.launches == before + 1
    each = [fourier_feats.fourier_features_cuda(x[e].clone(), B[e].clone()) for e in range(4)]
    torch.cuda.synchronize()
    assert all(torch.equal(out[e], each[e]) for e in range(4))
    assert _rel(out, fourier_feats.fourier_features_plain(x, B)) < 1e-5
    xs = torch.rand((4, 3000, 40), generator=gen, device=cuda_device) * 2.0 - 1.0
    W = torch.randn((4, 40, 36), generator=gen, device=cuda_device) * 0.05
    b = torch.randn((4, 36), generator=gen, device=cuda_device) * 0.05
    before = siren.siren_layer.launches
    out = torch.func.vmap(siren.siren_layer)(xs, W, b)
    assert siren.siren_layer.launches == before + 1
    each = [siren.siren_layer_cuda(xs[e].clone(), W[e].clone(), b[e].clone()) for e in range(4)]
    torch.cuda.synchronize()
    assert all(torch.equal(out[e], each[e]) for e in range(4))
    assert _rel(out, siren.siren_layer_plain(xs, W, b)) < 1e-5


def _graph_slice(device, rl: bool = False, **training):
    """The Burgers slice at a small width (Fourier 64x2, mapping 32; 2048
    points in batches of 512; RAR, or uniform with the DQN agent), to train
    2 chunks of 2 epochs (``training``: settings of ``cfg.training`` to
    change first)."""
    from pinnrl_tpu_torch.config import load_config
    from pinnrl_tpu_torch.models import PINNModel
    from pinnrl_tpu_torch.pdes import create_pde
    from pinnrl_tpu_torch.rl import RLAgent
    from pinnrl_tpu_torch.training import PDETrainer

    cfg = load_config(pde_type="burgers", architecture="fourier", device=str(device))
    cfg.pde.exact_solution = {"type": "traveling_wave", "amplitude": 0.5, "speed": 0.5,
                              "center": -0.25}
    cfg.pde.initial_condition = {"type": "traveling_wave"}
    cfg.model.hidden_dims = [64, 64]
    cfg.model.arch_params.update({"mapping_size": 32, "scale": 2.0})
    t = cfg.training
    t.optimizer, t.num_epochs, t.validation_frequency = "adam", 4, 2
    t.num_collocation_points, t.batch_size = 2048, 512
    t.num_boundary_points = t.num_initial_points = 256
    t.collocation_distribution = "uniform" if rl else "residual_based"
    t.early_stopping.enabled = False
    for key, value in training.items():
        setattr(t, key, value)
    agent = RLAgent(hidden_dim=64, batch_size=124, device=device) if rl else None
    return PDETrainer(PINNModel(cfg, seed=0), create_pde(cfg), cfg, rl_agent=agent)


@pytest.mark.parametrize("rl", [False, True])
def test_graph_run_equals_eager_step_program(cuda_device, rl, monkeypatch):
    import sys

    from pinnrl_tpu_torch.ops.kernels import fourier_feats, fused_step, mlp
    from pinnrl_tpu_torch.training import step_program

    runs = []
    for graphs in (True, False):
        if not graphs:  # the program never leaves its warm-up: every step eager
            monkeypatch.setattr(step_program, "WARMUP_STEPS", sys.maxsize)
        tr = _graph_slice(cuda_device, rl)
        counters = (fused_step.fused_residual_loss, fourier_feats.fourier_features,
                    mlp.fused_mlp_score)
        before = [c.launches for c in counters]
        res = tr.train(seed=0)
        torch.cuda.synchronize()
        launches = [c.launches - b for c, b in zip(counters, before)]
        runs.append((tr, res["history"], launches))
    (g, gh, gl), (e, eh, el) = runs
    (program,) = g.programs
    assert program.path == "graph" and program.graph is None  # released at the end
    assert program.eager_steps >= 1 and program.eager_steps + program.replays == 16
    assert e.programs[0].replays == 0 and e.programs[0].eager_steps == 16
    assert gh["train_loss"] == eh["train_loss"] and gh["val_loss"] == eh["val_loss"]
    for k, v in g.model.params.items():
        assert torch.equal(v, e.model.params[k]), k
    # Kernel 1 once per step and per validation, counted per replay; the
    # same counts as the eager run's.
    assert gl == el and gl[0] == 16 + 2
    if rl:
        assert gl[2] == 16
        st, se = g._rl_state, e._rl_state
        assert (int(st.size), int(st.steps)) == (int(se.size), int(se.steps)) == (2048, 16)
        assert st.opt_state.count == se.opt_state.count == 16


def test_a_failed_capture_raises(cuda_device):
    """A step that reads a value back cannot be captured: the run raises and
    takes no eager step in its place."""
    tr = _graph_slice(cuda_device)
    step = tr._step

    def reading(*args):
        row = step(*args)
        float(row[0])  # a host read inside the step
        return row

    tr._step = reading
    with pytest.raises(RuntimeError):
        tr.train(seed=0)
    (program,) = tr.programs
    assert program.eager_steps == 1 and program.replays == 0


def test_a_replayed_launch_counts_on_the_device(cuda_device):
    """A kernel launch captured into a tally adds one to its counter at each
    replay (read and settled by the host), none at the capture."""
    from pinnrl_tpu_torch.ops.kernels import counts, fourier_feats

    ff = fourier_feats.fourier_features
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.rand((512, 2), generator=gen, device=cuda_device)
    B = torch.randn((2, 32), generator=gen, device=cuda_device)
    ff(x, B)  # built before the capture
    torch.cuda.synchronize()
    tally, graph = counts.tally(cuda_device), torch.cuda.CUDAGraph()
    before = ff.launches
    with counts.tallying(tally), torch.cuda.graph(graph):
        out = ff(x, B)
    assert ff.launches == before
    for _ in range(3):
        graph.replay()
    counts.settle(tally, tally.tolist())
    assert ff.launches == before + 3 and int(tally.sum()) == 0
    assert torch.equal(out, fourier_feats.fourier_features_cuda(x, B))


def _lbfgs_slice(device, rl: bool = False, dtype: str = "float32"):
    """``_graph_slice`` through Adam then L-BFGS: 6 epochs, the switch at 3,
    validation every 2 epochs (the L-BFGS phase's chunks: 1 and 2
    iterations)."""
    return _graph_slice(device, rl, optimizer="adam_lbfgs", num_epochs=6,
                        adam_lbfgs_switch_ratio=0.5, residual_dtype=dtype)


@pytest.mark.parametrize("rl,dtype", [(False, "float32"), (True, "float32"), (False, "float64")])
def test_graph_lbfgs_run_equals_eager(cuda_device, rl, dtype, monkeypatch):
    """The L-BFGS phase replayed (start, 25 trials under the IF node,
    finish) against the eager program's (every trial guarded by a host
    read), bit for bit: history, parameters, evaluations, kernel-1
    launches; the graph run's phase makes no host read inside a chunk."""
    import sys

    from pinnrl_tpu_torch.ops.kernels import fused_step
    from pinnrl_tpu_torch.training import step_program
    from pinnrl_tpu_torch.training.lbfgs import LBFGS

    runs = []
    for graphs in (True, False):
        if not graphs:
            monkeypatch.setattr(step_program, "WARMUP_STEPS", sys.maxsize)
        tr = _lbfgs_slice(cuda_device, rl, dtype)
        k1 = fused_step.fused_residual_loss
        e0, l0, r0 = LBFGS.evaluations, k1.launches, LBFGS.host_reads
        res = tr.train(seed=0)
        torch.cuda.synchronize()
        runs.append((tr, res["history"], LBFGS.evaluations - e0, k1.launches - l0,
                     LBFGS.host_reads - r0))
    (g, gh, ge, gl, gr), (e, eh, ee, el, er) = runs
    assert [p.path for p in g.programs] == ["graph", "graph"]
    adam, lbfgs = g.programs
    assert lbfgs.replays == 3 and lbfgs.eager_steps == 0 and e.programs[1].eager_steps == 3
    assert gh["train_loss"] == eh["train_loss"] and gh["val_loss"] == eh["val_loss"]
    for k, v in g.model.params.items():
        assert torch.equal(v, e.model.params[k]), k
    assert ge == ee >= 6 and gl == el
    assert gr == 0 and er > 0  # the graph run's search reads nothing on the host


def test_a_failed_lbfgs_capture_raises(cuda_device):
    """A trial that reads a value back cannot be captured: the run raises
    and takes no eager trial in its place."""
    from pinnrl_tpu_torch.training.lbfgs import LBFGS

    tr = _graph_slice(cuda_device, optimizer="lbfgs", num_epochs=2)
    trial = LBFGS.trial

    def reading(self, closure):
        trial(self, closure)
        float(self._state["value"])  # a host read inside the trial

    LBFGS.trial = reading
    try:
        with pytest.raises(RuntimeError):
            tr.train(seed=0)
    finally:
        LBFGS.trial = trial
    (program,) = tr.programs
    assert program.path == "graph" and program.replays == 0 and "trial" not in program.graphs
