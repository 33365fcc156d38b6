"""Selects, comparisons, clamps and the elementwise functions atan2, asinh,
log10, erfc and softplus in kernel 1's generated residual
(``residual_codegen``): a comparison is a 0/1 value, one select
``where(c, a, b)`` carries every branch, and the clamp family, maximum,
minimum, relu and softplus are lowered to selects with torch's NaN rules.

Against JAX's Pallas kernel in interpret mode (tile 32) at ``FUSED_TOLS``
(loss 1e-5 and gradients 1e-4 relative; causal 1e-4 and 1e-3): the user
PDEs ``clipped_allen_cahn`` and ``select_burgers`` of
``test_torch_generated_residual.USER_PDES``. In float64 the program equals
torch's autograd of the residual exactly (its twin runs the same torch ops
in the same order), on kinks, NaNs and infinities too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_generated_residual import SELECT_KINKS, _user_pair, registered  # noqa: F401
from torch_parity_helpers import FUSED_TOLS, launcher_vs_jax_kernel, sorted_z

from pinnrl_tpu_torch.config import load_config
from pinnrl_tpu_torch.models import PINNModel
from pinnrl_tpu_torch.ops.derivatives import directional_derivative as t_dd
from pinnrl_tpu_torch.ops.jet_mlp import BundleView
from pinnrl_tpu_torch.ops.kernels import fused_step, residual_codegen
from pinnrl_tpu_torch.pdes import burgers as t_burgers
from pinnrl_tpu_torch.pdes import create_pde

# --------------------------------------------------------------------------- #
# Against the JAX kernel
# --------------------------------------------------------------------------- #

# The kinks of each user PDE's residual in u (the clamp bounds, the max/min
# ties, relu's and where's switch points).
KINKS = {"select_burgers": SELECT_KINKS, "clipped_allen_cahn": (-10.0, 10.0)}

CASES = {
    "select_burgers_1d": ("select_burgers", {}),
    "select_burgers_2d": ("select_burgers", dict(dim=2)),
    "select_burgers_feedforward": ("select_burgers", dict(arch="feedforward")),
    "select_burgers_causal": ("select_burgers", dict(causal_eps=1.0)),
    "clipped_allen_cahn_1d": ("clipped_allen_cahn", {}),
    "clipped_allen_cahn_2d_feedforward": ("clipped_allen_cahn", dict(dim=2, arch="feedforward")),
    "clipped_allen_cahn_causal": ("clipped_allen_cahn", dict(causal_eps=1.0)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_selects_match_jax_kernel(registered, case):
    """Kernel 1 through the generated residual against JAX's kernel.

    At a kink the two packages may take different subgradients (torch's
    clamp has slope 1 at its bounds, ``jnp.clip`` 0.5: see
    ``test_clamp_bound_subgradient_differs_from_jax``), so no point's u may
    lie within 1e-6 of one; the points are ``sorted_z``'s, as drawn."""
    name, kw = CASES[case]
    pair = _user_pair(name, **kw)
    assert fused_step.supports(pair.tmodel, pair.tpde, pair.tcfg.training)
    assert fused_step._spec(pair.tmodel, pair.tpde).residual == "generated"
    domain = dict(domain=tuple(map(tuple, pair.tcfg.pde.domain)),
                  time_domain=tuple(pair.tcfg.pde.time_domain))
    z = sorted_z(3, 96, domain)
    with torch.no_grad():
        u = pair.tmodel.apply(pair.tmodel.params, torch.from_numpy(z)).reshape(-1).double()
    gap = min(float((u - k).abs().min()) for k in KINKS[name])
    assert gap > 1e-6, f"a point's u lies {gap:.2e} from a kink"
    loss_rel, grad_rels = launcher_vs_jax_kernel(pair, z)
    loss_tol, grad_tol = FUSED_TOLS[kw.get("causal_eps", 0.0)]
    assert loss_rel < loss_tol
    for pname, rel in grad_rels.items():
        assert rel < grad_tol, pname


def test_select_burgers_takes_both_sides_of_every_select(registered):
    """At the JAX comparison's points the network's u crosses every kink of
    the select Burgers residual, so each select's two branches are read."""
    pair = _user_pair("select_burgers")
    z = sorted_z(3, 96, dict(domain=((-1.0, 1.0),), time_domain=(0.0, 1.0)))
    with torch.no_grad():
        u = pair.tmodel.apply(pair.tmodel.params, torch.from_numpy(z)).reshape(-1)
    for k in SELECT_KINKS:
        assert bool((u < k).any()) and bool((u > k).any()), k
    assert (z[:, 0] < 0).any() and (z[:, 0] > 0).any()


# --------------------------------------------------------------------------- #
# The program against torch's autograd, in float64
# --------------------------------------------------------------------------- #


def _torch_pde(name):
    block = {"select_burgers": "burgers", "clipped_allen_cahn": "allen_cahn"}[name]
    cfg = load_config(pde_type=block, device="cpu")
    cfg.pde_type = name
    return create_pde(cfg)


def _autograd(pde, x_order, U, z):
    """(r, dr/dU) of ``pde.residual_pointwise`` by torch's autograd on the
    streams U (S, n), as the trace lays them out."""
    n_streams, layout = residual_codegen._stream_layout(pde, x_order)
    U = U.detach().requires_grad_(True)
    rows = U.unbind(0)
    view = BundleView(rows[0], {ax: [rows[s] for s in idx] for ax, idx in layout.items()})
    r = pde.residual_pointwise(view, z, None).reshape(-1)
    (g,) = torch.autograd.grad(r, U, grad_outputs=torch.ones_like(r))
    return r.detach(), g


def _kink_streams(n_streams, kinks, seed=0):
    """U (S, n) in float64: u on every kink, on NaN and on +-inf, then
    random; one point with a NaN and one with an inf in a derivative stream."""
    rng = np.random.default_rng(seed)
    special = [*kinks, float("nan"), float("inf"), -float("inf")]
    n = len(special) + 64
    U = rng.standard_normal((n_streams, n))
    U[0, :len(special)] = special
    U[0, len(special):] *= 2.0
    U[1, -1], U[-1, -2] = float("nan"), float("inf")
    return torch.from_numpy(U)


@pytest.mark.parametrize("name", ["select_burgers", "clipped_allen_cahn"])
def test_program_equals_autograd_on_kinks_and_nans(registered, name):
    """The program of each user PDE in float64 equals the residual and its
    gradient by torch's autograd bit for bit, NaNs in the same places, on
    u exactly at every kink (the clamp bounds, the max/min ties, relu's and
    where's switch at 0), NaN and +-inf. This covers the in-place
    ``logical_and_`` (clamp's reverse) and ``masked_fill_`` (maximum's)."""
    pde = _torch_pde(name)
    x_order = max(pde.spatial_orders)
    program = residual_codegen.trace(pde, x_order)
    U = _kink_streams(program.n_streams, [*KINKS[name], -11.0, 11.0])
    n = U.shape[1]
    z = torch.from_numpy(np.random.default_rng(1).uniform(-1.0, 1.0, (n, 2)))
    z[:3, 0] = 0.0  # on the piecewise viscosity's switch
    r, g = program.evaluate(U, z, n)
    r_ref, g_ref = _autograd(pde, x_order, U, z)
    torch.testing.assert_close(r, r_ref, rtol=0, atol=0, equal_nan=True)
    for s in range(program.n_streams):
        torch.testing.assert_close(g[s], g_ref[s], rtol=0, atol=0, equal_nan=True)
    assert bool(torch.isnan(r).any()) and bool(torch.isinf(r).any())


@pytest.mark.parametrize("name", ["select_burgers", "clipped_allen_cahn"])
def test_emitted_selects_keep_nans(registered, name):
    """maximum, minimum and clamp propagate a NaN; CUDA's fmaxf/fminf drop
    it, so the emitted source never calls them."""
    program = residual_codegen.trace(_torch_pde(name), 2)
    src = program.source
    assert "fmaxf" not in src and "fminf" not in src
    assert "? " in src and "where" in program.ops


def _inplace_residual(u, z):
    """A residual that mutates a mask in place, then reads it twice."""
    m = u > 0.0
    m.logical_and_(u < 0.5)
    return torch.where(m, u * u, -u) + m.to(u.dtype) * z[:, 0]


class TInPlace(t_burgers.BurgersEquation):
    def residual_pointwise(self, u, z, coeffs):
        return _inplace_residual(u(z), z) + t_dd(u, z, self.dimension, 1)[0]


def test_inplace_result_is_read_through_the_mutated_node():
    """An in-place op's result is bound to its own node and to the mutated
    operand's: the graph is rewritten so that every reader after
    ``logical_and_`` reads the mutated ``gt`` node instead, and the program
    still equals the graph run eagerly (where ``gt``'s tensor was mutated)."""
    pde = TInPlace(load_config(pde_type="burgers", device="cpu").pde, device="cpu")
    gm, n_streams, n_cols = residual_codegen._graph(pde, 2)
    inplace = [nd for nd in gm.graph.nodes if nd.op == "call_function"
               and residual_codegen._op_name(nd) == "logical_and_.default"]
    assert len(inplace) == 1
    node = inplace[0]
    mutated = node.args[0]
    readers = [u for u in node.users]
    assert readers
    for user in readers:
        user.replace_input_with(node, mutated)
    gm.recompile()
    assert not node.users and len(mutated.users) == 1 + len(readers)
    program = residual_codegen._program(gm, n_streams, n_cols, "rewritten")
    n = residual_codegen._TRACE_POINTS  # the graph's own size
    rng = np.random.default_rng(4)
    U = torch.from_numpy(rng.uniform(-1.0, 1.0, (n_streams, n)))
    z = torch.from_numpy(rng.uniform(-1.0, 1.0, (n, n_cols)))
    r, g = program.evaluate(U, z, n)
    r_ref, g_ref = gm(U, z)
    torch.testing.assert_close(r, r_ref, rtol=0, atol=0)
    for s in range(n_streams):
        torch.testing.assert_close(g[s], g_ref[s], rtol=0, atol=0)
    r_pde, _ = _autograd(pde, 2, U, z)
    torch.testing.assert_close(r, r_pde, rtol=0, atol=0)


def test_inplace_on_a_view_is_refused():
    """An in-place op on a tensor that shares its storage with a view is
    refused: the lowering binds the new value to the mutated node only."""

    class TViewed(t_burgers.BurgersEquation):
        def residual_pointwise(self, u, z, coeffs):
            m = (u(z) > 0.0).unsqueeze(1)
            flat = m.view(-1)
            m.logical_and_((u(z) < 0.5).unsqueeze(1))
            return torch.where(flat, u(z), 0.0) + t_dd(u, z, self.dimension, 1)[0]

    pde = TViewed(load_config(pde_type="burgers", device="cpu").pde, device="cpu")
    with pytest.raises(residual_codegen.Unsupported, match="shares its storage"):
        residual_codegen.trace(pde, 2)


# --------------------------------------------------------------------------- #
# Which residuals kernel 1 takes
# --------------------------------------------------------------------------- #

ADMITTED = {
    "clamp": lambda u, z: torch.clamp(u, -0.5, 0.5),
    "clip": lambda u, z: torch.clip(u, max=0.4),
    "clamp_min": lambda u, z: torch.clamp_min(u, 0.2),
    "clamp_max": lambda u, z: torch.clamp_max(u, 0.2),
    "clamp_tensor": lambda u, z: torch.clamp(u, z[:, 0] - 1.0, z[:, 0]),
    "where_u": lambda u, z: torch.where(u > 0, u, 0.0),
    "where_z": lambda u, z: torch.where(z[:, 0] >= 0.25, u, 2.0 * u),
    "maximum": lambda u, z: torch.maximum(u, torch.full_like(u, 0.2)),
    "minimum": lambda u, z: torch.minimum(u, z[:, -1]),
    "fmax_fmin": lambda u, z: torch.fmax(u, z[:, 0]) + torch.fmin(u, -z[:, 0]),
    "relu": lambda u, z: torch.relu(u - 0.3),
    "logical": lambda u, z: ((u > 0) & ~(u > 0.5) | (u < -1.0) ^ (z[:, 0] > 0)).to(u.dtype),
    "masked_fill": lambda u, z: u.masked_fill(u > 0.2, 0.7),
    "atan2": lambda u, z: torch.atan2(u, 1.0 + u * u),
    "asinh": lambda u, z: torch.asinh(u),
    "log10": lambda u, z: torch.log10(1.0 + u * u),
    "erfc": lambda u, z: torch.erfc(u),
    "softplus": lambda u, z: torch.nn.functional.softplus(u),
    "softplus_beta": lambda u, z: torch.nn.functional.softplus(u, beta=2.0, threshold=1.0),
}


def _burgers_plus(term):
    class T(t_burgers.BurgersEquation):
        def residual_pointwise(self, u, z, coeffs):
            return super().residual_pointwise(u, z, coeffs) + term(u(z), z)

    return T


@pytest.fixture(scope="module")
def small_burgers():
    cfg = load_config(pde_type="burgers", architecture="fourier", device="cpu")
    cfg.model.hidden_dims = [16, 16]
    cfg.model.arch_params["mapping_size"] = 8
    return cfg, PINNModel(cfg, seed=0)


# torch's CPU kernels of softplus and of its reverse round exp and log1p
# otherwise than torch.exp and torch.log1p, which the program's select runs:
# at 13 of 200 random points they differ in the last place (float64).
ULPS = {"softplus": 4, "softplus_beta": 4}


@pytest.mark.parametrize("case", sorted(ADMITTED))
def test_kernel1_takes_the_residual(small_burgers, case):
    """Each residual attaches kernel 1 through the generated residual, and
    its program equals torch's autograd in float64 at random points (to
    ``ULPS`` places for softplus, bit for bit otherwise)."""
    cfg, model = small_burgers
    pde = _burgers_plus(ADMITTED[case])(cfg.pde, cfg.training, device="cpu")
    assert fused_step.refusal(model, pde) is None
    assert fused_step.supports(model, pde)
    spec = fused_step._spec(model, pde)
    assert spec.residual == "generated"
    n = 200
    rng = np.random.default_rng(7)
    U = torch.from_numpy(rng.standard_normal((spec.program.n_streams, n)))
    z = torch.from_numpy(rng.uniform(-1.0, 1.0, (n, 2)))
    r, g = spec.program.evaluate(U, z, n)
    r_ref, g_ref = _autograd(pde, 2, U, z)
    rtol = ULPS.get(case, 0) * torch.finfo(torch.float64).eps
    torch.testing.assert_close(r, r_ref, rtol=rtol, atol=0)
    for s in range(spec.program.n_streams):
        torch.testing.assert_close(g[s], g_ref[s], rtol=rtol, atol=0)


def test_fold_and_select_identities():
    """Constant folding covers every new op, a select on a constant
    condition is its branch, and a comparison's 0/1 value is not compared
    with 0 again."""
    b = residual_codegen._SSA()
    u, one, two = b.value("u", 0), b.const(1.0), b.const(2.0)
    for name in ("gt", "ge", "lt", "le", "eq", "ne", "atan2"):
        assert b.instrs[b.op(name, one, two)][0] == "const"
    for name in ("asinh", "log10", "erfc"):
        assert b.instrs[b.op(name, two)][0] == "const"
    assert b.instrs[b.op("where", one, u, two)] == ("u", 0)
    assert b.instrs[b.op("where", b.const(0.0), u, two)] == ("const", 2.0)
    assert b.op("where", b.op("gt", u, one), u, u) == u
    c = b.op("gt", u, one)
    assert b.truth(c) == c and b.op("where", c, one, b.const(0.0)) == c
    assert b.instrs[b.truth(u)][0] == "ne"


# --------------------------------------------------------------------------- #
# The kink difference from JAX
# --------------------------------------------------------------------------- #


def test_clamp_bound_subgradient_differs_from_jax(registered):
    """At a clamp bound torch's subgradient is 1 and ``jnp.clip``'s 0.5;
    at a max/min tie both give 0.5, and relu and ``where(x > 0, x, 0)`` at
    0 both give 0. Kernel 1's program follows torch (the port's plain
    bundle does too): a deliberate difference, on a set of measure zero."""
    with jax.enable_x64(True):
        j = {"clip": float(jax.grad(lambda x: jnp.clip(x, -0.5, 0.5))(0.5)),
             "clip_lo": float(jax.grad(lambda x: jnp.clip(x, -0.5, 0.5))(-0.5)),
             "max_tie": float(jax.grad(lambda x: jnp.maximum(x, 0.2))(0.2)),
             "min_tie": float(jax.grad(lambda x: jnp.minimum(x, -0.2))(-0.2)),
             "relu": float(jax.grad(jax.nn.relu)(0.0)),
             "where": float(jax.grad(lambda x: jnp.where(x > 0, x, 0.0))(0.0))}

    def tgrad(f, x0):
        x = torch.tensor(x0, dtype=torch.float64, requires_grad=True)
        return float(torch.autograd.grad(f(x), x)[0])

    t = {"clip": tgrad(lambda x: torch.clamp(x, -0.5, 0.5), 0.5),
         "clip_lo": tgrad(lambda x: torch.clamp(x, -0.5, 0.5), -0.5),
         "max_tie": tgrad(lambda x: torch.maximum(x, torch.full_like(x, 0.2)), 0.2),
         "min_tie": tgrad(lambda x: torch.minimum(x, torch.full_like(x, -0.2)), -0.2),
         "relu": tgrad(torch.relu, 0.0),
         "where": tgrad(lambda x: torch.where(x > 0, x, 0.0), 0.0)}
    assert j == {"clip": 0.5, "clip_lo": 0.5, "max_tie": 0.5, "min_tie": 0.5, "relu": 0.0,
                 "where": 0.0}
    assert t == {"clip": 1.0, "clip_lo": 1.0, "max_tie": 0.5, "min_tie": 0.5, "relu": 0.0,
                 "where": 0.0}
    # The program of select_burgers at u = 0.5: torch's slope of the clamp term.
    pde = _torch_pde("select_burgers")
    program = residual_codegen.trace(pde, 2)
    U = torch.zeros(program.n_streams, 2, dtype=torch.float64)
    U[0] = torch.tensor([0.5, 0.5 - 1e-9], dtype=torch.float64)
    _, g = program.evaluate(U, torch.zeros(2, 2, dtype=torch.float64), 2)
    _, g_ref = _autograd(pde, 2, U, torch.zeros(2, 2, dtype=torch.float64))
    assert float(g[0][0]) == float(g_ref[0][0])
    # Below the bound the clamp's slope is 1 in both packages: the kink adds 0.
    assert abs(float(g[0][0] - g[0][1])) < 1e-6
