"""Card-only checks: each hand-written CUDA kernel against its plain PyTorch
version on the same CUDA tensors. Marked ``cuda``; each test skips (from the
``cuda_device`` fixture) where torch sees no card. On a CUDA machine:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q

Tolerances: Fourier features 1e-5 relative to max (sincosf vs torch's
sin/cos on the same f32 phases); fused loss 1e-5 relative and gradients
1e-4 relative to each gradient's max (sums in another order), 2e-4 and
1e-3 for the KdV causal variant (order-3 jets, causal weights); the MLP
scorer 1e-4 relative to max (the JAX suite's bound for its kernel: sums in
another order through two LayerNorms).
"""

import numpy as np
import pytest
import torch

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


def test_fourier_features_rejects_bad_inputs(cuda_device):
    from pinnrl_tpu_torch.ops.kernels import fourier_feats

    x = torch.zeros((8, 2), device=cuda_device, dtype=torch.float64)
    with pytest.raises(TypeError):
        fourier_feats.fourier_features(x, torch.zeros((2, 4), device=cuda_device, dtype=torch.float64))
    with pytest.raises(ValueError):
        fourier_feats.fourier_features(torch.zeros((8, 3), device=cuda_device),
                                       torch.zeros((2, 4), device=cuda_device))


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


@pytest.mark.parametrize("n,hidden,action_dim", [(10000, 512, 1), (1000, 128, 4), (37, 40, 3)])
def test_fused_mlp_score_matches_plain(cuda_device, n, hidden, action_dim):
    from pinnrl_tpu_torch.ops.kernels import mlp
    from pinnrl_tpu_torch.rl import RLAgent

    agent = RLAgent(hidden_dim=hidden, action_dim=action_dim, device=cuda_device)
    params = agent.init(torch.Generator().manual_seed(2)).policy_params
    with torch.no_grad():  # LayerNorm away from (1, 0), so its terms count
        for k in ("LayerNorm_0.weight", "LayerNorm_1.weight", "LayerNorm_0.bias", "LayerNorm_1.bias"):
            params[k].add_(0.1 * torch.randn(params[k].shape, device=cuda_device))
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = 2.0 * torch.rand((n, 2), generator=gen, device=cuda_device) - 1.0
    before = mlp.fused_mlp_score.launches
    with torch.no_grad():
        got = mlp.fused_mlp_score(x, params)
        ref = mlp.fused_mlp_score_plain(x, params)
    torch.cuda.synchronize()
    assert mlp.fused_mlp_score.launches == before + 1
    assert got.shape == (n, action_dim) and torch.isfinite(got).all()
    assert _rel(got, ref) < 1e-4


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
