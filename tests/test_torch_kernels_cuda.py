"""Card-only checks: each hand-written CUDA kernel against its plain PyTorch
version on the same CUDA tensors. Marked ``cuda``; each test skips (from the
``cuda_device`` fixture) where torch sees no card. On a CUDA machine:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q

Tolerances: Fourier features 1e-5 relative to max (sincosf vs torch's
sin/cos on the same f32 phases); fused loss 1e-5 relative and gradients
1e-4 relative to each gradient's max (sums in another order).
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
