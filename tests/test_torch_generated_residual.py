"""Kernel 1's generated residual: a PDE whose ``residual_pointwise`` has no
hand kernel (a user's ``@register_pde`` class, or a subclass that overrides
a shipped class's residual) traced by ``residual_codegen`` into a program
that the launcher runs through its plain twin, against the JAX Pallas
kernel in interpret mode (tile 32), which traces the same residual into its
body.

The user PDEs below are defined twice, once per package, with the same
arithmetic, and registered in both packages' ``PDE_CLASSES`` only while a
test runs (``monkeypatch.setitem``); their configs are shipped blocks with
the PDE type replaced.

Tolerances: ``FUSED_TOLS`` (loss 1e-5 relative and gradients 1e-4 relative
to max; causal 1e-4 and 1e-3: the JAX suite's bounds for its fused kernel).
The program against the hand residuals' twins in float64: 1e-12 relative to
max (the two evaluate the same expressions, up to the order of a sum).
"""

import math
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import jax.scipy.special
import numpy as np
import pytest
import torch
from torch_parity_helpers import FUSED_TOLS, launcher_vs_jax_kernel, pde_pair, sorted_z

from pinnrl_tpu.ops.derivatives import directional_derivative as j_dd
from pinnrl_tpu.ops.derivatives import laplacian as j_laplacian
from pinnrl_tpu.pdes import allen_cahn as j_allen_cahn
from pinnrl_tpu.pdes import base as j_base
from pinnrl_tpu.pdes import burgers as j_burgers
from pinnrl_tpu.pdes import convection as j_convection
from pinnrl_tpu.pdes import heat as j_heat
from pinnrl_tpu.pdes import kdv as j_kdv
from pinnrl_tpu.pdes import pendulum as j_pendulum
from pinnrl_tpu_torch.config import load_config
from pinnrl_tpu_torch.ops.derivatives import directional_derivative as t_dd
from pinnrl_tpu_torch.ops.derivatives import laplacian as t_laplacian
from pinnrl_tpu_torch.ops.kernels import fused_step, residual_codegen
from pinnrl_tpu_torch.pdes import allen_cahn as t_allen_cahn
from pinnrl_tpu_torch.pdes import base as t_base
from pinnrl_tpu_torch.pdes import burgers as t_burgers
from pinnrl_tpu_torch.pdes import convection as t_convection
from pinnrl_tpu_torch.pdes import create_pde
from pinnrl_tpu_torch.pdes import heat as t_heat
from pinnrl_tpu_torch.pdes import kdv as t_kdv
from pinnrl_tpu_torch.pdes import pendulum as t_pendulum

# --------------------------------------------------------------------------- #
# User PDEs, one class per package (JAX: per point; port: batched)
# --------------------------------------------------------------------------- #


class JForcedBurgers(j_burgers.BurgersEquation):
    """Burgers with a forcing: its residual minus sin(x_0); ``pde_type``
    stays "burgers"."""

    def residual_pointwise(self, u, z, coeffs):
        return super().residual_pointwise(u, z, coeffs) - jnp.sin(z[0])


class TForcedBurgers(t_burgers.BurgersEquation):
    def residual_pointwise(self, u, z, coeffs):
        return super().residual_pointwise(u, z, coeffs) - torch.sin(z[:, 0])


class JFisherKPP(j_heat.HeatEquation):
    """u_t - D lap u - rho u (1 - u)."""

    pde_type = "fisher_kpp"
    default_parameters = {"diffusion": 0.1, "rho": 1.0}

    def residual_pointwise(self, u, z, coeffs):
        val = u(z)
        lap = 0.0
        for ax in range(self.dimension):
            lap = lap + j_dd(u, z, ax, 2)[1]
        u_t = j_dd(u, z, self.dimension, 1)[0]
        return u_t - self.parameters["diffusion"] * lap - self.parameters["rho"] * val * (1.0 - val)


class TFisherKPP(t_heat.HeatEquation):
    pde_type = "fisher_kpp"
    default_parameters = {"diffusion": 0.1, "rho": 1.0}

    def residual_pointwise(self, u, z, coeffs):
        val = u(z)
        lap = 0.0
        for ax in range(self.dimension):
            lap = lap + t_dd(u, z, ax, 2)[1]
        u_t = t_dd(u, z, self.dimension, 1)[0]
        return u_t - self.parameters["diffusion"] * lap - self.parameters["rho"] * val * (1.0 - val)


class JVarAdvection(j_convection.ConvectionEquation):
    """u_t + sum_ax sin(x_ax) u_ax: a velocity read from z."""

    pde_type = "var_advection"

    def residual_pointwise(self, u, z, coeffs):
        r = j_dd(u, z, self.dimension, 1)[0]
        for ax in range(self.dimension):
            r = r + jnp.sin(z[ax]) * j_dd(u, z, ax, 1)[0]
        return r


class TVarAdvection(t_convection.ConvectionEquation):
    pde_type = "var_advection"

    def residual_pointwise(self, u, z, coeffs):
        r = t_dd(u, z, self.dimension, 1)[0]
        for ax in range(self.dimension):
            r = r + torch.sin(z[:, ax]) * t_dd(u, z, ax, 1)[0]
        return r


class JKdVBurgers(j_kdv.KdVEquation):
    """u_t + u u_x - nu u_xx + delta u_xxx + 0.1 sin(u), order 3."""

    pde_type = "kdv_burgers"
    spatial_orders = (1, 2, 3)

    def residual_pointwise(self, u, z, coeffs):
        val = u(z)
        r = j_dd(u, z, self.dimension, 1)[0] + 0.1 * jnp.sin(val)
        for ax in range(self.dimension):
            d1, d2, d3 = j_dd(u, z, ax, 3)
            r = r + val * d1 - 0.05 * d2 + 0.02 * d3
        return r


class TKdVBurgers(t_kdv.KdVEquation):
    pde_type = "kdv_burgers"
    spatial_orders = (1, 2, 3)

    def residual_pointwise(self, u, z, coeffs):
        val = u(z)
        r = t_dd(u, z, self.dimension, 1)[0] + 0.1 * torch.sin(val)
        for ax in range(self.dimension):
            d1, d2, d3 = t_dd(u, z, ax, 3)
            r = r + val * d1 - 0.05 * d2 + 0.02 * d3
        return r


class JRelaxation(j_pendulum.PendulumEquation):
    """A first-order ODE: u_t + 0.5 tanh(u) + 0.2 sigmoid(u) - 0.1 (no x-group)."""

    pde_type = "relaxation"
    temporal_orders = (1,)

    def residual_pointwise(self, u, z, coeffs):
        val = u(z)
        return (j_dd(u, z, self.dimension, 1)[0] + 0.5 * jnp.tanh(val)
                + 0.2 * (1.0 / (1.0 + jnp.exp(-val))) - 0.1)


class TRelaxation(t_pendulum.PendulumEquation):
    pde_type = "relaxation"
    temporal_orders = (1,)

    def residual_pointwise(self, u, z, coeffs):
        val = u(z)
        return t_dd(u, z, self.dimension, 1)[0] + 0.5 * torch.tanh(val) + 0.2 * torch.sigmoid(val) - 0.1


class JPoisson(j_heat.HeatEquation):
    """A steady problem (temporal order 0): lap u + sin(x_0) exp(-u^2)."""

    pde_type = "poisson"
    temporal_orders = ()

    def residual_pointwise(self, u, z, coeffs):
        val = u(z)
        lap = 0.0
        for ax in range(self.dimension):
            lap = lap + j_dd(u, z, ax, 2)[1]
        return lap + jnp.sin(z[0]) * jnp.exp(-val * val)


class TPoisson(t_heat.HeatEquation):
    pde_type = "poisson"
    temporal_orders = ()

    def residual_pointwise(self, u, z, coeffs):
        val = u(z)
        lap = 0.0
        for ax in range(self.dimension):
            lap = lap + t_dd(u, z, ax, 2)[1]
        return lap + torch.sin(z[:, 0]) * torch.exp(-val * val)


class JClippedAllenCahn(j_allen_cahn.AllenCahnEquation):
    """Allen-Cahn with u clamped at +-10 before the cubic term, as the
    reference's Cahn-Hilliard clips it (``pinnrl_tpu/pdes/cahn_hilliard.py``)."""

    pde_type = "clipped_allen_cahn"

    def residual_pointwise(self, u, z, coeffs):
        val = u(z)
        u_t = j_dd(u, z, self.dimension, 1)[0]
        lap = j_laplacian(u, z, range(self.dimension))
        return u_t - self._eps(coeffs) ** 2 * lap - val + jnp.clip(val, -10.0, 10.0) ** 3


class TClippedAllenCahn(t_allen_cahn.AllenCahnEquation):
    pde_type = "clipped_allen_cahn"

    def residual_pointwise(self, u, z, coeffs):
        val = u(z)
        u_t = t_dd(u, z, self.dimension, 1)[0]
        lap = t_laplacian(u, z, range(self.dimension))
        return u_t - self._eps(coeffs) ** 2 * lap - val + torch.clamp(val, -10.0, 10.0) ** 3


# The kinks of the select Burgers residual in u: where its selects switch.
SELECT_KINKS = (-0.5, -0.2, 0.0, 0.2, 0.3, 0.5)


class JSelectBurgers(j_burgers.BurgersEquation):
    """Burgers' residual plus selects that switch inside the network's range
    (clamp, where on u, maximum, minimum, relu), a piecewise viscosity
    switched on x_0 and the elementwise functions atan2, asinh, log10, erfc
    and softplus."""

    pde_type = "select_burgers"

    def residual_pointwise(self, u, z, coeffs):
        val = u(z)
        selects = (jnp.clip(val, -0.5, 0.5) + jnp.where(val > 0, val, 0.0)
                   + jnp.maximum(val, 0.2) + jnp.minimum(val, -0.2) + jax.nn.relu(val - 0.3))
        nu_x = jnp.where(z[0] > 0, 0.01 / math.pi, 0.02 / math.pi)
        smooth = (jnp.arctan2(val, 1.0 + val * val) + jnp.arcsinh(val) + jnp.log10(1.0 + val * val)
                  + jax.scipy.special.erfc(val) + jax.nn.softplus(val))
        return (super().residual_pointwise(u, z, coeffs) + 0.1 * selects
                - nu_x * j_dd(u, z, 0, 2)[1] + 0.01 * smooth)


class TSelectBurgers(t_burgers.BurgersEquation):
    pde_type = "select_burgers"

    def residual_pointwise(self, u, z, coeffs):
        val = u(z)
        selects = (torch.clamp(val, -0.5, 0.5) + torch.where(val > 0, val, 0.0)
                   + torch.maximum(val, torch.full_like(val, 0.2))
                   + torch.minimum(val, torch.full_like(val, -0.2)) + torch.relu(val - 0.3))
        nu_x = torch.where(z[:, 0] > 0, 0.01 / math.pi, 0.02 / math.pi)
        smooth = (torch.atan2(val, 1.0 + val * val) + torch.asinh(val) + torch.log10(1.0 + val * val)
                  + torch.erfc(val) + torch.nn.functional.softplus(val))
        return (super().residual_pointwise(u, z, coeffs) + 0.1 * selects
                - nu_x * t_dd(u, z, 0, 2)[1] + 0.01 * smooth)


# (JAX class, port class, shipped block it is built from)
USER_PDES = {
    "forced_burgers": (JForcedBurgers, TForcedBurgers, "burgers"),
    "fisher_kpp": (JFisherKPP, TFisherKPP, "heat"),
    "var_advection": (JVarAdvection, TVarAdvection, "convection"),
    "kdv_burgers": (JKdVBurgers, TKdVBurgers, "kdv"),
    "relaxation": (JRelaxation, TRelaxation, "pendulum"),
    "poisson": (JPoisson, TPoisson, "heat"),
    "clipped_allen_cahn": (JClippedAllenCahn, TClippedAllenCahn, "allen_cahn"),
    "select_burgers": (JSelectBurgers, TSelectBurgers, "burgers"),
}


@pytest.fixture
def registered(monkeypatch):
    """The user PDEs in both registries, for this test only."""
    for name, (jcls, tcls, _block) in USER_PDES.items():
        monkeypatch.setitem(j_base.PDE_CLASSES, name, jcls)
        monkeypatch.setitem(t_base.PDE_CLASSES, name, tcls)
    return USER_PDES


def _user_pair(name, **kw):
    return pde_pair(USER_PDES[name][2], as_type=name, **kw)


def _check(pair, causal_eps=0.0, seed=3, n=96):
    domain = dict(domain=tuple(map(tuple, pair.tcfg.pde.domain)),
                  time_domain=tuple(pair.tcfg.pde.time_domain))
    loss_rel, grad_rels = launcher_vs_jax_kernel(pair, sorted_z(seed, n, domain))
    loss_tol, grad_tol = FUSED_TOLS[causal_eps]
    assert loss_rel < loss_tol
    for name, rel in grad_rels.items():
        assert rel < grad_tol, name


# --------------------------------------------------------------------------- #
# The overridden-residual fault
# --------------------------------------------------------------------------- #


def test_overridden_residual_is_computed_not_the_parents(registered):
    """A subclass of Burgers that overrides ``residual_pointwise`` and keeps
    ``pde_type = "burgers"``: kernel 1 computes the override (generated), not
    Burgers' hand residual, and matches JAX's kernel."""
    pair = _user_pair("forced_burgers", hidden=(32, 32), mapping=16)
    assert type(pair.tpde) is TForcedBurgers and pair.tpde.pde_type == "burgers"
    assert fused_step.supports(pair.tmodel, pair.tpde)
    assert fused_step._spec(pair.tmodel, pair.tpde).residual == "generated"
    x = sorted_z(0, 96, dict(domain=((-1.0, 1.0),), time_domain=(0.0, 1.0)))
    loss_rel, grad_rels = launcher_vs_jax_kernel(pair, x)
    assert loss_rel < FUSED_TOLS[0.0][0]
    assert max(grad_rels.values()) < FUSED_TOLS[0.0][1]


def test_shipped_residuals_keep_their_hand_kernels():
    """The six shipped PDEs, as shipped, take their hand residual kernels."""
    for key in ("burgers", "heat", "kdv", "convection", "allen_cahn", "black_scholes"):
        pde = create_pde(load_config(pde_type=key, device="cpu"))
        assert fused_step._hand_residual(pde) == key


# --------------------------------------------------------------------------- #
# User PDEs against the JAX kernel
# --------------------------------------------------------------------------- #

CASES = {
    "fisher_1d_fourier": ("fisher_kpp", {}),
    "fisher_1d_feedforward": ("fisher_kpp", dict(arch="feedforward")),
    "fisher_2d_fourier": ("fisher_kpp", dict(dim=2)),
    "fisher_2d_feedforward": ("fisher_kpp", dict(arch="feedforward", dim=2)),
    "fisher_causal": ("fisher_kpp", dict(causal_eps=1.0)),
    "fisher_framed": ("fisher_kpp", dict(frame=0.5)),
    "fisher_gelu": ("fisher_kpp", dict(activation="gelu")),
    "var_advection_fourier": ("var_advection", {}),
    "var_advection_feedforward": ("var_advection", dict(arch="feedforward")),
    "var_advection_4d": ("var_advection", dict(dim=4)),
    "kdv_burgers_fourier": ("kdv_burgers", {}),
    "kdv_burgers_feedforward": ("kdv_burgers", dict(arch="feedforward")),
    "fisher_4d": ("fisher_kpp", dict(dim=4, arch="feedforward")),
    "relaxation_fourier": ("relaxation", {}),
    "relaxation_feedforward": ("relaxation", dict(arch="feedforward")),
    "relaxation_causal": ("relaxation", dict(causal_eps=1.0)),
    "poisson_fourier": ("poisson", {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_generated_residual_matches_jax_kernel(registered, case):
    name, kw = CASES[case]
    pair = _user_pair(name, **kw)
    assert fused_step.supports(pair.tmodel, pair.tpde, pair.tcfg.training)
    spec = fused_step._spec(pair.tmodel, pair.tpde)
    assert spec.residual == "generated"
    _check(pair, causal_eps=kw.get("causal_eps", 0.0))


def test_ode_and_steady_layouts(registered):
    """An ODE has no x-group (streams [u; u_t]); a steady problem's program
    reads no t-stream (its dr/du_t is 0)."""
    ode = _user_pair("relaxation")
    spec = fused_step._spec(ode.tmodel, ode.tpde)
    assert (spec.x_order, spec.program.n_streams) == (0, 2)
    steady = _user_pair("poisson")
    prog = fused_step._spec(steady.tmodel, steady.tpde).program
    assert prog.n_streams == 4
    assert prog.instrs[prog.g[-1]] == ("const", 0.0)


# --------------------------------------------------------------------------- #
# The program against the hand residuals
# --------------------------------------------------------------------------- #


def _hand(ops, key, pde, U, z, n, dim, causal):
    if key == "burgers":
        return ops.burgers(U, n, dim, float(pde._nu(None)), causal)
    if key == "heat":
        return ops.heat(U, n, dim, float(pde._alpha(None)), causal)
    if key == "kdv":
        return ops.kdv(U, n, dim, causal)
    if key == "convection":
        return ops.convection(U, n, tuple(float(v) for v in pde._velocity(None)), None, causal)
    if key == "allen_cahn":
        return ops.allen_cahn(U, n, dim, float(pde._eps(None)) ** 2, causal)
    return ops.black_scholes(U, z, n, pde.time_sign(), 0.5 * float(pde._sigma(None)) ** 2,
                             float(pde._r(None)), causal)


@pytest.mark.parametrize("key", ["burgers", "heat", "kdv", "convection", "allen_cahn",
                                 "black_scholes"])
@pytest.mark.parametrize("dim", [1, 2])
def test_program_equals_hand_residual_in_float64(key, dim):
    cfg = load_config(pde_type=key, device="cpu")
    if dim > 1:
        cfg.pde.dimension = dim
        cfg.pde.domain = [list(cfg.pde.domain[0])] * dim
        if key == "convection":
            cfg.pde.parameters["velocity"] = [1.0, -0.5]
    pde = create_pde(cfg)
    program = residual_codegen.trace(pde, max(pde.spatial_orders))
    n = 64
    rng = np.random.default_rng(dim)
    U = torch.from_numpy(rng.standard_normal((program.n_streams * n, 1)))
    z = torch.from_numpy(rng.uniform(0.5, 3.0, (n, dim + 1)))
    for causal in (False, True):
        got = fused_step._TorchOps().generated(program, U, z, n, causal)
        ref = _hand(fused_step._TorchOps(), key, pde, U, z, n, dim, causal)
        for a, b in zip(got, ref):
            assert float((a - b).abs().max() / b.abs().max()) < 1e-12, (key, dim, causal)


# --------------------------------------------------------------------------- #
# Refusals and the emitted source
# --------------------------------------------------------------------------- #


class TLgamma(t_burgers.BurgersEquation):
    """A residual through an op outside the table (log-gamma)."""

    def residual_pointwise(self, u, z, coeffs):
        return torch.lgamma(u(z)) + t_dd(u, z, self.dimension, 1)[0]


class TCoupled(t_burgers.BurgersEquation):
    """A residual that couples the points (minus the batch mean of u)."""

    def residual_pointwise(self, u, z, coeffs):
        return super().residual_pointwise(u, z, coeffs) - u(z).mean()


@pytest.mark.parametrize("cls,needle", [(TLgamma, "lgamma.default"),
                                        (TCoupled, "couples points")])
def test_refused_residuals(cls, needle):
    pair = pde_pair("burgers", hidden=(16, 16), mapping=8)
    pde = cls(pair.tcfg.pde, pair.tcfg.training, device="cpu")
    reason = fused_step.refusal(pair.tmodel, pde)
    assert reason is not None and needle in reason
    assert not fused_step.supports(pair.tmodel, pde)
    assert not pde.attach_fused_residual_kernel(pair.tmodel)
    with pytest.raises(ValueError, match=needle):
        pde.attach_fused_residual_kernel(pair.tmodel, enable="on")


def test_emitted_source_is_deterministic(registered):
    pair = _user_pair("kdv_burgers", hidden=(16, 16), mapping=8)
    a = residual_codegen.trace(pair.tpde, 3)
    b = residual_codegen.trace(pair.tpde, 3)
    assert a.source == b.source and a.digest == b.digest
    src = a.source
    assert '#include "residual_generated.cuh"' in src and "sinf(" in src and "cosf(" in src
    assert "powf" not in src  # integer powers are products


def test_cuda_tensor_without_card_raises(registered):
    """The generated kernel's wrapper takes CUDA float32 tensors only."""
    pair = _user_pair("fisher_kpp", hidden=(16, 16), mapping=8)
    program = fused_step._spec(pair.tmodel, pair.tpde).program
    with pytest.raises(ValueError, match="CUDA"):
        residual_codegen.launch(program, torch.zeros(program.n_streams * 8, 1),
                                torch.zeros(8, 2), 8, False)


def test_trainer_steps_through_the_generated_residual(registered):
    """Three Adam steps of ``PDETrainer`` on Fisher-KPP with kernel 1
    attached (its plain version on the CPU): finite, falling losses."""
    from pinnrl_tpu_torch.models import PINNModel
    from pinnrl_tpu_torch.training import PDETrainer

    cfg = load_config(pde_type="heat", architecture="fourier", device="cpu")
    cfg.pde_type = "fisher_kpp"
    cfg.model.hidden_dims = [16, 16]
    cfg.model.arch_params["mapping_size"] = 8
    t = cfg.training
    t.num_collocation_points, t.batch_size = 128, 64
    t.num_boundary_points = t.num_initial_points = 16
    t.num_epochs = 3
    t.fused_residual_kernel = "on"
    pde = create_pde(cfg)
    trainer = PDETrainer(PINNModel(cfg, seed=0), pde, cfg)
    assert pde._fused_residual_loss is not None
    trainer.train(num_epochs=3)
    losses = [float(v) for v in trainer.history["train_loss"]]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_a_fault_while_lowering_is_a_refusal(registered, monkeypatch):
    """An unexpected error while lowering the traced graph refuses kernel 1
    (the plain bundle runs) and names its kind; it does not escape attach."""

    def broken(gm, n_streams, n_cols):
        raise KeyError("no such node")

    monkeypatch.setattr(residual_codegen, "_lower", broken)
    pair = _user_pair("fisher_kpp", hidden=(16, 16), mapping=8)
    reason = fused_step.refusal(pair.tmodel, pair.tpde)
    assert reason is not None and "KeyError" in reason
    assert not pair.tpde.attach_fused_residual_kernel(pair.tmodel)
    with pytest.raises(ValueError, match="KeyError"):
        pair.tpde.attach_fused_residual_kernel(pair.tmodel, enable="on")


def test_attach_traces_the_residual_once(registered, monkeypatch):
    """Attaching kernel 1 to a user PDE traces its residual once: the gate's
    trace is the one the spec keeps."""
    calls = []
    real = residual_codegen.trace

    def counted(*args, **kw):
        calls.append(args[0])
        return real(*args, **kw)

    monkeypatch.setattr(residual_codegen, "trace", counted)
    pair = _user_pair("fisher_kpp", hidden=(16, 16), mapping=8)
    assert pair.tpde.attach_fused_residual_kernel(pair.tmodel, enable="on")
    assert len(calls) == 1


def test_emitted_source_is_replaced_whole(tmp_path, monkeypatch):
    """``load_generated`` puts the emitted text in place by a rename, so a
    concurrent build never reads a half-written file; no temporary is left
    beside it."""
    from pinnrl_tpu_torch.ops.kernels import _build

    renames, built = [], []
    real_replace = os.replace
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_compile",
                        lambda name, source, target: built.append(source.read_text()))
    monkeypatch.setattr(os, "replace", lambda src, dst: (renames.append(Path(dst)),
                                                         real_replace(src, dst)))
    _build.load_generated("generated_test_whole", "// one\n")
    assert built == ["// one\n"]
    assert [p.name for p in tmp_path.iterdir()] == [p.name for p in renames]
    assert renames[0].suffix == ".cu"
