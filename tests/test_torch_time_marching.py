"""Time-marching in the port (``benchmarks/convergence.run_time_marching``
and ``cli convergence --time-marching``) against pinnrl_tpu's tests of it
(``tests/test_time_marching_and_inverse_bench.py``), at CPU size through
the ``mutate`` hook: the row's naming, the windows' partition of the
horizon, the inherited IC, the hook itself and the CLI. Besides: window
w-1's weights are unchanged by window w's training, and the stitched rel-L2
equals JAX's arithmetic on the same points and weights (1e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_helpers import shrink_recipe

from pinnrl_tpu.models import PINNModel as JaxModel
from pinnrl_tpu.pdes import create_pde as jax_create_pde
from pinnrl_tpu_torch.benchmarks import cli
from pinnrl_tpu_torch.benchmarks import convergence as conv
from pinnrl_tpu_torch.models.bridge import params_to_flax


def _tm(key="heat", n_windows=2, epochs_per_window=2, mutate=shrink_recipe):
    return conv.run_time_marching(key, seed=0, n_windows=n_windows,
                                  epochs_per_window=epochs_per_window, mutate=mutate, device="cpu")


def _spy(monkeypatch, what):
    """Record ``what(cfg, pde)`` for every window's PDE."""
    seen = []
    orig = conv.create_pde

    def spy(cfg):
        pde = orig(cfg)
        seen.append(what(cfg, pde))
        return pde

    monkeypatch.setattr(conv, "create_pde", spy)
    return seen


def test_time_marching_smoke_and_naming():
    r = _tm()
    assert r.pde == "heat_tm2" and r.epochs == 4 and r.architecture == "fourier"
    assert np.isfinite(r.rel_l2) and r.rel_l2 >= 0 and np.isfinite(r.final_train_loss)
    assert r.points_per_sec > 0


def test_time_marching_inherits_ic_between_windows(monkeypatch):
    captured = _spy(monkeypatch, lambda cfg, pde: pde)
    _tm(epochs_per_window=1)
    first, second = captured
    x, t = torch.linspace(0.0, 1.0, 8).reshape(-1, 1), torch.zeros((8, 1))
    with torch.no_grad():
        ic0 = first.boundary_conditions["initial"](x, t)
        ic1 = second.boundary_conditions["initial"](x, t)
    assert ic0.shape == ic1.shape == (8, 1)
    assert not np.allclose(ic0.numpy(), ic1.numpy(), atol=1e-6)


def test_time_marching_windows_partition_time_domain(monkeypatch):
    domains = _spy(monkeypatch, lambda cfg, pde: tuple(cfg.pde.time_domain))
    _tm(n_windows=3, epochs_per_window=1)
    assert len(domains) == 3
    full = conv.build_recipe_config("heat", device="cpu").pde.time_domain
    assert domains[0][0] == pytest.approx(full[0]) and domains[-1][1] == pytest.approx(full[1])
    for (_, hi), (lo, _) in zip(domains[:-1], domains[1:]):
        assert hi == pytest.approx(lo)


def test_time_marching_mutate_hook_applies_per_window():
    seen = []

    def mutate(wcfg):
        shrink_recipe(wcfg)
        seen.append((tuple(wcfg.pde.time_domain), wcfg.training.num_epochs))

    r = _tm(mutate=mutate)
    (td0, ep0), (td1, ep1) = seen
    assert td0[1] == td1[0] and ep0 == ep1 == 2 and np.isfinite(r.rel_l2)


def test_time_marching_cli_smoke(monkeypatch, capsys):
    """``--time-marching N`` routes to run_time_marching; ``--epochs`` is the
    total, split across the windows."""
    calls = []
    orig = conv.run_time_marching

    def tiny(pde_key, seed=0, n_windows=4, epochs_per_window=None, device="cuda"):
        calls.append((n_windows, epochs_per_window, device))
        return orig(pde_key, seed=seed, n_windows=n_windows, epochs_per_window=1,
                    mutate=shrink_recipe, device=device)

    monkeypatch.setattr(conv, "run_time_marching", tiny)
    argv = ["convergence", "--pde", "heat", "--time-marching", "2", "--epochs", "8"]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    assert calls == [(2, 4, "cpu")] and "heat_tm2" in capsys.readouterr().out


def test_earlier_windows_are_unchanged_by_later_training(monkeypatch):
    """Window w's inherited IC reads window w-1's parameters: they must be
    the ones window w-1 ended with, whatever window w's optimizer did."""
    from pinnrl_tpu_torch.training import trainer as trainer_mod

    ends = []
    train = trainer_mod.PDETrainer.train

    def recording(self, *args, **kwargs):
        res = train(self, *args, **kwargs)
        ends.append({k: v.detach().clone() for k, v in self._final_state["params"]["net"].items()})
        ends[-1]["_live"] = self._final_state["params"]["net"]
        return res

    monkeypatch.setattr(trainer_mod.PDETrainer, "train", recording)
    _tm(n_windows=3, epochs_per_window=2)
    assert len(ends) == 3
    for w in range(3):
        live = ends[w].pop("_live")
        for k, v in live.items():
            assert torch.equal(v, ends[w][k]), (w, k)
    # Each window starts from the previous window's weights and moves them.
    assert any(not torch.equal(ends[1][k], ends[0][k]) for k in ends[0])


def test_stitched_rel_l2_matches_jax_arithmetic(monkeypatch):
    """The port's stitched errors against JAX's code on the same points,
    with each window's weights bridged into a JAX model of its window."""
    windows = _spy(monkeypatch, lambda cfg, pde: (cfg, pde))
    from pinnrl_tpu_torch.training import trainer as trainer_mod

    models = []
    train = trainer_mod.PDETrainer.train

    def recording(self, *args, **kwargs):
        models.append(self.model)
        return train(self, *args, **kwargs)

    monkeypatch.setattr(trainer_mod.PDETrainer, "train", recording)
    r = _tm(n_windows=2, epochs_per_window=2)
    n_val = 20000 // 2
    window_models = [(m.apply, m.params, pde) for m, (_, pde) in zip(models, windows)]
    x_t = [conv._stitch_points(pde, n_val) for _, pde in windows]
    rel, max_err = conv._stitched_errors(window_models, x_t)
    assert rel == r.rel_l2 and max_err == r.max_error

    from pinnrl_tpu.benchmarks.convergence import build_recipe_config as jax_build

    err_sq, exact_sq, jmax = 0.0, 0.0, 0.0
    for w, (model, (tcfg, tpde)) in enumerate(zip(models, windows)):
        jcfg = jax_build("heat", epochs=2)
        jcfg.pde.time_domain = list(tcfg.pde.time_domain)
        shrink_recipe(jcfg)
        jmodel, jpde = JaxModel(jcfg, seed=0), jax_create_pde(jcfg)
        jparams, jconst = params_to_flax(model.module.state_dict())
        jmodel.params = jax.tree_util.tree_map(jnp.asarray, jparams)
        jmodel.constants = jax.tree_util.tree_map(jnp.asarray, jconst)
        x, tt = (jnp.asarray(a.numpy()) for a in x_t[w])
        # JAX's stitched validation, line for line.
        ex = jpde.exact_solution(x, tt)
        pred = jmodel.apply(jmodel.params, jnp.concatenate([x, tt], -1))
        pred = pred.reshape(x.shape[0], -1)[:, 0:1]
        diff = np.asarray(pred - ex.reshape(pred.shape))
        err_sq += float((diff**2).sum())
        exact_sq += float((np.asarray(ex) ** 2).sum())
        jmax = max(jmax, float(np.abs(diff).max()))
    jrel = (err_sq ** 0.5) / ((exact_sq ** 0.5) + 1e-12)
    assert abs(rel - jrel) / jrel < 1e-6 and abs(max_err - jmax) / jmax < 1e-5
