"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

Each helper makes the same small Burgers or KdV problem in the JAX package
and in the port, and bridges the JAX model's parameters into the port's model, so
both sides evaluate the same function. Inputs are made with numpy from a
seed and handed to both as arrays.
"""

from __future__ import annotations

from types import SimpleNamespace

import jax
import numpy as np
import torch

TRAVELING_WAVE = {"type": "traveling_wave", "amplitude": 0.5, "speed": 0.5, "center": -0.25}
KDV_DOMAIN = dict(domain=((-15.0, 15.0),), time_domain=(0.0, 5.0))  # for points(...)


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
            if "LayerNorm" in name:
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


def inject_points(monkeypatch, tpde, xb, tb, xi, ti):
    """Make the port's PDE return these BC and IC points."""
    monkeypatch.setattr(tpde, "_sample_boundary_points",
                        lambda gen, n: (torch.from_numpy(xb), torch.from_numpy(tb)))
    monkeypatch.setattr(tpde, "_sample_initial_points",
                        lambda gen, n: (torch.from_numpy(xi), torch.from_numpy(ti)))
