"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

Each helper makes the same small problem (Burgers, KdV, heat, convection,
Allen-Cahn, Black-Scholes, wave, the pendulum or Cahn-Hilliard) in the JAX
package and in the port, and bridges the JAX model's parameters into the
port's model, so both sides evaluate the same function. Inputs are made
with numpy from a seed and handed to both as arrays.
"""

from __future__ import annotations

import itertools
import os
from types import SimpleNamespace

import numpy as np
import torch

# Tier-1 runs the test files in pytest-xdist workers on one host: each
# worker takes its share of the cores for torch's intra-op threads, where
# torch's default (every core in every worker) oversubscribes them.
torch.set_num_threads(max(1, os.cpu_count() // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

try:
    import jax
except ImportError:  # the card's machine: its CUDA tests use no JAX helper
    jax = None

TRAVELING_WAVE = {"type": "traveling_wave", "amplitude": 0.5, "speed": 0.5, "center": -0.25}
KDV_DOMAIN = dict(domain=((-15.0, 15.0),), time_domain=(0.0, 5.0))  # for points(...)
HEAT_DOMAIN = dict(domain=((0.0, 2.0),), time_domain=(0.0, 10.0))
# The shipped config blocks' domains (for points(...)).
DOMAINS = {"convection": dict(domain=((0.0, 2.0),), time_domain=(0.0, 1.0)),
           "allen_cahn": dict(domain=((-1.0, 1.0),), time_domain=(0.0, 1.0)),
           "black_scholes": dict(domain=((0.0, 200.0),), time_domain=(0.0, 1.0))}


def rel_to_max(got, ref) -> float:
    """max |got - ref| / max |ref| over numpy-convertible arrays."""
    got = np.asarray(got.detach().cpu() if isinstance(got, torch.Tensor) else got, np.float64)
    ref = np.asarray(ref.detach().cpu() if isinstance(ref, torch.Tensor) else ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30))


def _configure(cfg, **kw):
    cfg.pde.parameters.update({"nu": 0.01})
    cfg.pde.exact_solution = dict(TRAVELING_WAVE)
    cfg.pde.initial_condition = {"type": "traveling_wave"}
    return _configure_model_training(cfg, **kw)


def _configure_model_training(cfg, *, hidden, mapping, periodic, layer_norm, scale, causal_eps):
    cfg.model.hidden_dims = list(hidden)
    cfg.model.layer_norm = layer_norm
    cfg.model.arch_params.update({"mapping_size": mapping, "scale": scale, "periodic": periodic})
    t = cfg.training
    t.num_boundary_points = 32
    t.num_initial_points = 32
    t.optimizer_config.learning_rate = 2e-3
    t.optimizer_config.weight_decay = 0.0
    t.loss_weights["smoothness"] = 0.0
    t.early_stopping.enabled = False
    t.causal_eps = causal_eps
    return cfg


def bridge(jax_model, torch_model) -> None:
    """Copy the JAX model's params and constants into the port's module."""
    from pinnrl_tpu_torch.models.bridge import params_from_flax

    state = params_from_flax(
        jax.tree_util.tree_map(np.asarray, jax_model.params),
        jax.tree_util.tree_map(np.asarray, jax_model.constants),
    )
    torch_model.module.load_state_dict(state, strict=True)


def burgers_pair(*, arch="fourier", hidden=(32, 32), mapping=16, periodic=True,
                 layer_norm=True, scale=2.0, causal_eps=0.0, seed=0, ln_jitter=True):
    """(JAX cfg/pde/model, port cfg/pde/model) with bridged parameters.

    ``ln_jitter`` perturbs the LayerNorm scale/bias away from flax's (1, 0)
    init so their gradients and the gamma/beta terms are exercised."""
    from pinnrl_tpu.config import load_config as jax_load_config
    from pinnrl_tpu_torch.config import load_config

    kw = dict(hidden=hidden, mapping=mapping, periodic=periodic, layer_norm=layer_norm,
              scale=scale, causal_eps=causal_eps)
    jcfg = _configure(jax_load_config(pde_type="burgers", architecture=arch), **kw)
    tcfg = _configure(load_config(pde_type="burgers", architecture=arch, device="cpu"), **kw)
    return _pair(jcfg, tcfg, seed=seed, jitter_ln=ln_jitter and layer_norm)


def kdv_pair(*, hidden=(32, 32), mapping=16, periodic=True, layer_norm=True, scale=0.75,
             causal_eps=0.0, seed=0, ln_jitter=True):
    """The KdV problem (soliton IC and exact solution on [-15, 15] x [0, 5],
    Dirichlet u = 0) on a Fourier trunk in both packages, bridged as
    ``burgers_pair`` bridges Burgers."""
    from pinnrl_tpu.config import load_config as jax_load_config
    from pinnrl_tpu_torch.config import load_config

    kw = dict(hidden=hidden, mapping=mapping, periodic=periodic, layer_norm=layer_norm,
              scale=scale, causal_eps=causal_eps)
    jcfg = _configure_model_training(jax_load_config(pde_type="kdv", architecture="fourier"), **kw)
    tcfg = _configure_model_training(
        load_config(pde_type="kdv", architecture="fourier", device="cpu"), **kw)
    return _pair(jcfg, tcfg, seed=seed, jitter_ln=ln_jitter and layer_norm)


def siren_kdv_pair(*, hidden=(124,) * 7, omega=30.0, seed=0):
    """The shipped KdV configuration (``load_config(pde_type="kdv")``: a
    SIREN, omega_0 30) in both packages, at ``hidden`` widths, bridged;
    BC/IC counts cut to 32 each."""
    from pinnrl_tpu.config import load_config as jax_load_config
    from pinnrl_tpu_torch.config import load_config

    cfgs = [jax_load_config(pde_type="kdv"), load_config(pde_type="kdv", device="cpu")]
    for cfg in cfgs:
        assert cfg.model.architecture == "siren"
        cfg.model.hidden_dims = list(hidden)
        cfg.model.arch_params["omega_0"] = omega
        cfg.training.num_boundary_points = cfg.training.num_initial_points = 32
    return _pair(*cfgs, seed=seed, jitter_ln=False)


def heat_pair(*, hidden=(16, 16), mapping=8, scale=0.75, layer_norm=True, causal_eps=0.0, seed=0):
    """The shipped heat configuration (Fourier trunk, periodic BC,
    sin_exp_decay IC and exact solution on [0, 2] x [0, 10]) in both
    packages at small width, bridged."""
    from pinnrl_tpu.config import load_config as jax_load_config
    from pinnrl_tpu_torch.config import load_config

    kw = dict(hidden=hidden, mapping=mapping, periodic=True, layer_norm=layer_norm, scale=scale,
              causal_eps=causal_eps)
    jcfg = _configure_model_training(jax_load_config(pde_type="heat"), **kw)
    tcfg = _configure_model_training(load_config(pde_type="heat", device="cpu"), **kw)
    return _pair(jcfg, tcfg, seed=seed, jitter_ln=layer_norm)


# Kernel 1 against its references, by causal eps: (loss relative, each
# gradient relative to its max): the JAX suite's bounds for its fused kernel
# (tests/test_pallas_parity_tpu.py), plain and causal.
FUSED_TOLS = {0.0: (1e-5, 1e-4), 1.0: (1e-4, 1e-3)}


def small_recipe_trainer(key: str, epochs: int = 6):
    """A ``PDETrainer`` on the convergence recipe ``key`` cut to CPU size:
    trunk 16x2, mapping 8 (a random basis: the shipped ``feature_seed``
    bases are at the recipes' mapping), 256 points in batches of 128, 32 BC
    and IC points, ``epochs`` epochs."""
    from pinnrl_tpu_torch.benchmarks import convergence
    from pinnrl_tpu_torch.models import PINNModel
    from pinnrl_tpu_torch.pdes import create_pde
    from pinnrl_tpu_torch.training import PDETrainer

    cfg = convergence.build_recipe_config(key, epochs=epochs, device="cpu")
    cfg.model.hidden_dims = [16, 16]
    cfg.model.arch_params["mapping_size"] = 8
    cfg.model.arch_params.pop("feature_seed", None)
    t = cfg.training
    t.num_collocation_points, t.batch_size = 256, 128
    t.num_boundary_points = t.num_initial_points = 32
    return PDETrainer(PINNModel(cfg, seed=0), create_pde(cfg), cfg)


def shrink_recipe(cfg):
    """Cut a recipe's config to CPU size in place (a ``mutate`` hook): trunk
    8x8, mapping 4 (a random basis), 64 points in batches of 32, 16 BC and
    IC points."""
    cfg.model.hidden_dims = [8, 8]
    cfg.model.arch_params["mapping_size"] = 4
    cfg.model.arch_params.pop("feature_seed", None)
    t = cfg.training
    t.num_collocation_points, t.batch_size = 64, 32
    t.num_boundary_points = t.num_initial_points = 16


def pde_pair(pde_type, *, arch="fourier", hidden=(32, 24), mapping=16, periodic=True,
             layer_norm=True, scale=1.0, causal_eps=0.0, seed=0, ln_jitter=True, pde=None,
             dim=None, frame=None, arch_params=None, activation=None, as_type=None):
    """The shipped config block of ``pde_type`` on an ``arch`` trunk at small
    width in both packages, bridged; ``pde`` overrides entries of the PDE
    block (``parameters`` merged) in both. ``dim`` poses the problem in that
    many space dimensions (the block's first axis repeated); ``frame`` gives
    the model a co-moving frame of that speed; ``arch_params`` updates the
    model's (``trainable_features``, ``modified``); ``activation`` replaces
    the trunk's; ``as_type`` builds the PDE registered under that name (a
    user's ``@register_pde`` class) from the block."""
    from pinnrl_tpu.config import load_config as jax_load_config
    from pinnrl_tpu_torch.config import load_config

    kw = dict(hidden=hidden, mapping=mapping, periodic=periodic, layer_norm=layer_norm,
              scale=scale, causal_eps=causal_eps)
    cfgs = [jax_load_config(pde_type=pde_type, architecture=arch),
            load_config(pde_type=pde_type, architecture=arch, device="cpu")]
    for cfg in cfgs:
        for k, v in (pde or {}).items():
            if k == "parameters":
                cfg.pde.parameters.update(v)
            else:
                setattr(cfg.pde, k, v)
        if dim is not None:
            cfg.pde.dimension = dim
            cfg.pde.domain = [list(cfg.pde.domain[0])] * dim
            cfg.model.input_dim = dim + 1
        if frame is not None:
            cfg.model.arch_params["moving_frame_speed"] = frame
        cfg.model.arch_params.update(arch_params or {})
        if activation is not None:
            cfg.model.activation = activation
        if as_type is not None:
            cfg.pde_type = as_type
        _configure_model_training(cfg, **kw)
    return _pair(*cfgs, seed=seed, jitter_ln=ln_jitter and layer_norm)


def _pair(jcfg, tcfg, *, seed, jitter_ln):
    from pinnrl_tpu.models import PINNModel as JaxModel
    from pinnrl_tpu.pdes import create_pde as jax_create_pde
    from pinnrl_tpu_torch.models import PINNModel
    from pinnrl_tpu_torch.pdes import create_pde

    jpde, jmodel = jax_create_pde(jcfg), JaxModel(jcfg, seed=seed)
    if jitter_ln:
        rng = np.random.default_rng(seed + 100)

        def jitter(path, leaf):
            name = jax.tree_util.keystr(path)
            if "LayerNorm" in name or "norms" in name:  # the autoencoder's encoder_norms_i
                return leaf + 0.1 * rng.standard_normal(leaf.shape).astype(np.float32)
            return leaf

        jmodel.params = jax.tree_util.tree_map_with_path(jitter, jmodel.params)
    tpde, tmodel = create_pde(tcfg), PINNModel(tcfg, seed=seed)
    bridge(jmodel, tmodel)
    return SimpleNamespace(jcfg=jcfg, jpde=jpde, jmodel=jmodel, tcfg=tcfg, tpde=tpde, tmodel=tmodel)


def points(seed: int, n: int, domain=((-1.0, 1.0),), time_domain=(0.0, 1.0)):
    """Uniform (x, t) as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    lo = np.array([d[0] for d in domain] + [time_domain[0]], np.float32)
    hi = np.array([d[1] for d in domain] + [time_domain[1]], np.float32)
    z = (lo + (hi - lo) * rng.random((n, lo.shape[0]))).astype(np.float32)
    return z[:, :-1], z[:, -1:]


def torch_params(model):
    """Fresh leaf copies of the port model's parameters that require grad."""
    return {k: v.detach().clone().requires_grad_(True) for k, v in model.params.items()}


def jax_bc_ic_points(jpde, key, n_colloc):
    """The BC and IC points that pinnrl_tpu's compute_loss draws from ``key``."""
    k_b, k_i = jax.random.split(jax.random.fold_in(key, 0xB0), 2)
    n_b, n_i = jpde._bc_counts(n_colloc)
    _, k_bc = jax.random.split(k_b)  # one Dirichlet entry in boundary_conditions
    xb, tb = jpde._sample_boundary_points(k_bc, n_b)
    xi, ti = jpde._sample_initial_points(k_i, n_i)
    return [np.array(a) for a in (xb, tb, xi, ti)]


def jax_periodic_draws(jpde, key, n):
    """The per-axis (free, t) draws of pinnrl_tpu's _periodic_loss(key, n),
    as tensors."""
    per_axis = max(n // (2 * jpde.dimension), 1)
    los, his = jpde._space_bounds()
    draws = []
    for _axis in range(jpde.dimension):
        key, k_free, k_t = jax.random.split(key, 3)
        free = jax.random.uniform(k_free, (per_axis, jpde.dimension), minval=los, maxval=his)
        draws.append((torch.from_numpy(np.array(free)),
                      torch.from_numpy(np.array(jpde._sample_boundary_time(k_t, per_axis)))))
    return draws


def inject_periodic_draws(monkeypatch, pair, key, n_colloc):
    """Make the port's compute_loss use the periodic and IC draws that
    pinnrl_tpu's compute_loss takes from ``key`` (one periodic BC)."""
    jpde, tpde = pair.jpde, pair.tpde
    k_b, k_i = jax.random.split(jax.random.fold_in(key, 0xB0), 2)
    n_b, n_i = jpde._bc_counts(n_colloc)
    _, k_bc = jax.random.split(k_b)
    draws = jax_periodic_draws(jpde, k_bc, n_b)
    xi, ti = (torch.from_numpy(np.array(a)) for a in jpde._sample_initial_points(k_i, n_i))
    monkeypatch.setattr(tpde, "_periodic_loss", lambda u, gen, n: tpde._periodic_terms(u, draws))
    monkeypatch.setattr(tpde, "_sample_initial_points", lambda gen, n: (xi, ti))


def sorted_z(seed: int, n: int, domain):
    """(n, d+1) float32 points from ``points(seed, n, **domain)``, sorted by
    time (the order the causal kernel takes)."""
    x, t = points(seed, n, **domain)
    z = np.concatenate([x, t], axis=1)
    return z[np.argsort(z[:, -1], kind="stable")]


def jax_grad_rels(grads, g_j):
    """{flax path: rel to max} of port gradients (a name -> tensor dict in
    torch layout, nested names included) against a flax gradient tree,
    through the parameter bridge."""
    from pinnrl_tpu_torch.models.bridge import params_to_flax

    def flat(tree):
        return {jax.tree_util.keystr(p): np.asarray(v)
                for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

    got, ref = flat(params_to_flax(grads, grads)[0]), flat(g_j)
    assert sorted(got) == sorted(ref)
    return {k: rel_to_max(got[k], ref[k]) for k in ref}


def launcher_vs_jax_kernel(pair, z):
    """Kernel 1's host launcher run with its plain twins (``_TorchOps``) on
    the port's model against the JAX Pallas kernel in interpret mode (tile
    32) on the bridged model, on the time-sorted points ``z``: (loss
    relative error, {name: gradient error relative to its max}). Causal
    when the port's PDE is."""
    from pinnrl_tpu.ops.kernels import fused_step as jax_fused
    from pinnrl_tpu_torch.ops.kernels import fused_step

    fused_j = jax_fused.make_fused_residual_loss(pair.jmodel, pair.jpde, tile=32, interpret=True,
                                                 causal_eps=pair.tpde.causal_eps())
    l_j, g_j = jax.value_and_grad(lambda p: fused_j(p, jax.numpy.asarray(z)))(pair.jmodel.params)
    spec = fused_step._spec(pair.tmodel, pair.tpde)
    params = {k: v.detach() for k, v in pair.tmodel.params.items()}
    with torch.no_grad():
        loss, grads = fused_step._loss_and_grads(fused_step._TorchOps(), spec, torch.from_numpy(z),
                                                 params)
    assert sorted(grads) == sorted(params)
    return abs(float(loss) - float(l_j)) / abs(float(l_j)), jax_grad_rels(grads, g_j)


def plain_vs_launcher(pair, z):
    """The launcher with the plain twins against autograd through the plain
    version (bundle -> residual -> loss) on the same port model: (loss
    relative error, {name: gradient error relative to its max})."""
    from pinnrl_tpu_torch.ops.jet_mlp import make_bundle_fn
    from pinnrl_tpu_torch.ops.kernels import fused_step

    tpde = pair.tpde
    params = torch_params(pair.tmodel)
    bundle_fn = make_bundle_fn(pair.tmodel, tpde.dimension, max(tpde.spatial_orders), 1)
    ref = fused_step.fused_residual_loss_plain(bundle_fn, tpde, params, torch.from_numpy(z))
    g_ref = torch.autograd.grad(ref, list(params.values()), allow_unused=True,
                                materialize_grads=True)
    spec = fused_step._spec(pair.tmodel, tpde)
    with torch.no_grad():
        loss, grads = fused_step._loss_and_grads(fused_step._TorchOps(), spec, torch.from_numpy(z),
                                                 {k: v.detach() for k, v in params.items()})
    rels = {name: rel_to_max(grads[name], g) for name, g in zip(params, g_ref)}
    ref = float(ref.detach())
    return abs(float(loss) - ref) / abs(ref), rels


def inject_points(monkeypatch, tpde, xb, tb, xi, ti, velocity=None):
    """Make the port's PDE return these BC and IC points; with ``velocity``
    ((x, t) arrays), its IC draws alternate between (xi, ti) and those, as
    a loss with a velocity IC draws them (wave, pendulum)."""
    monkeypatch.setattr(tpde, "_sample_boundary_points",
                        lambda gen, n: (torch.from_numpy(xb), torch.from_numpy(tb)))
    draws = itertools.cycle([(xi, ti)] + ([tuple(velocity)] if velocity is not None else []))
    monkeypatch.setattr(tpde, "_sample_initial_points",
                        lambda gen, n: tuple(torch.from_numpy(a) for a in next(draws)))


def jax_velocity_points(jpde, key, n_colloc):
    """The velocity-IC points that pinnrl_tpu's wave and pendulum
    compute_loss draw from ``key``."""
    _, n_i = jpde._bc_counts(n_colloc)
    xv, tv = jpde._sample_initial_points(jax.random.fold_in(key, 0x1C), n_i)
    return np.array(xv), np.array(tv)


def ch_pair(formulation="direct", dim=1, *, arch="fourier", hidden=(32, 24), mapping=16,
            scale=1.0, eps=0.1, domain=(-0.5, 0.5), time_domain=(0.0, 1.0), pde=None,
            training=None, arch_params=None, seed=0):
    """The shipped Cahn-Hilliard block (its Dirichlet and zero-Neumann BCs)
    in ``formulation`` over ``dim`` copies of ``domain``, against the
    standing interface (exact, IC and Dirichlet trace) unless ``pde``
    overrides entries (``parameters`` merged); an ``arch`` trunk at small
    width (``arch_params`` merged), a 2-channel head for the mixed form;
    ``training`` entries set on the training config (``loss_weights``
    merged). Both packages, bridged; BC/IC counts 32."""
    from pinnrl_tpu.config import load_config as jax_load_config
    from pinnrl_tpu_torch.config import load_config

    cfgs = [jax_load_config(pde_type="cahn_hilliard", architecture=arch),
            load_config(pde_type="cahn_hilliard", architecture=arch, device="cpu")]
    for cfg in cfgs:
        cfg.pde.parameters.update({"formulation": formulation, "epsilon": eps})
        cfg.pde.dimension = dim
        cfg.pde.domain = [list(domain)] * dim
        cfg.pde.time_domain = list(time_domain)
        cfg.pde.exact_solution = {"type": "stationary_interface"}
        cfg.pde.initial_condition = {"type": "stationary_interface"}
        for k, v in (pde or {}).items():
            if k == "parameters":
                cfg.pde.parameters.update(v)
            else:
                setattr(cfg.pde, k, v)
        cfg.model.input_dim = dim + 1
        cfg.model.output_dim = cfg.pde.output_dim = 2 if formulation == "mixed" else 1
        _configure_model_training(cfg, hidden=hidden, mapping=mapping, periodic=True,
                                  layer_norm=True, scale=scale, causal_eps=0.0)
        cfg.model.arch_params.update(arch_params or {})
        for k, v in (training or {}).items():
            if k == "loss_weights":
                cfg.training.loss_weights.update(v)
            else:
                setattr(cfg.training, k, v)
    return _pair(*cfgs, seed=seed, jitter_ln=True)


def jax_loss_draws(jpde, key, n_colloc):
    """Every draw pinnrl_tpu's compute_loss (Cahn-Hilliard's included)
    takes from ``key``, as numpy arrays: per registered BC in dict order
    (``dirichlet``: (x, t); ``neumann``: [(x_f, t_f)] per face;
    ``periodic``: the per-axis (free, t) tensors), the IC points, and the
    mass and mu-H2 penalties' times."""
    dim = jpde.dimension
    k_b, k_i = jax.random.split(jax.random.fold_in(key, 0xB0), 2)
    n_b, n_i = jpde._bc_counts(n_colloc)
    out = {}
    for bc_type in jpde.boundary_conditions:
        if bc_type == "initial":
            continue
        k_b, k_bc = jax.random.split(k_b)
        if bc_type == "neumann":
            per_face, faces = max(n_b // (2 * dim), 1), []
            for axis in range(dim):
                for face_val in jpde.domain[axis]:
                    k_bc, k_x, k_t = jax.random.split(k_bc, 3)
                    faces.append((np.array(jpde._sample_face(k_x, per_face, axis, face_val)),
                                  np.array(jpde._sample_boundary_time(k_t, per_face))))
            out["neumann"] = faces
        elif bc_type == "periodic":
            out["periodic"] = jax_periodic_draws(jpde, k_bc, n_b)
        else:
            out["dirichlet"] = [np.array(a) for a in jpde._sample_boundary_points(k_bc, n_b)]
    out["initial"] = [np.array(a) for a in jpde._sample_initial_points(k_i, n_i)]
    lo, hi = jpde.time_domain
    for name, tag, k in (("mass", 0x3A55, 16), ("mu_h2", 0x4D55, 8)):
        out[name] = np.array(jax.random.uniform(jax.random.fold_in(key, tag), (k, 1),
                                                minval=lo, maxval=hi))
    return out


def inject_loss_draws(monkeypatch, tpde, draws):
    """Make the port's compute_loss use ``jax_loss_draws``'s draws."""
    def t(a):
        return torch.from_numpy(a)

    if "dirichlet" in draws:
        xb, tb = draws["dirichlet"]
        monkeypatch.setattr(tpde, "_sample_boundary_points", lambda gen, n: (t(xb), t(tb)))
    if "neumann" in draws:
        faces = [(t(x), t(tt)) for x, tt in draws["neumann"]]
        monkeypatch.setattr(tpde, "_neumann_loss",
                            lambda u, f, gen, n: tpde._neumann_terms(u, f, faces))
    if "periodic" in draws:
        monkeypatch.setattr(tpde, "_periodic_loss",
                            lambda u, gen, n: tpde._periodic_terms(u, draws["periodic"]))
    xi, ti = draws["initial"]
    monkeypatch.setattr(tpde, "_sample_initial_points", lambda gen, n: (t(xi), t(ti)))
    times = {16: t(draws["mass"]), 8: t(draws["mu_h2"])}
    monkeypatch.setattr(tpde, "_draw_times", lambda gen, k: times[k])
