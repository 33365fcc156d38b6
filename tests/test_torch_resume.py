"""Checkpoints and resume in the port's trainer.

- A run checkpointed at epoch k and resumed in a fresh trainer reproduces
  the uninterrupted run exactly on the CPU: parameters, ``train_loss`` and
  the rest of the history, with Adam and L-BFGS, EMA, LRW, the plateau
  scale, RAR and an RL agent.
- An L-BFGS-phase checkpoint loaded into a run's first (Adam) optimizer
  keeps the fresh optimizer, logged, as the JAX package's fallback does.
- ``run_convergence(resume_from=...)`` continues a recipe's run.
"""

import logging
import shutil

import numpy as np
import pytest
import torch

from pinnrl_tpu_torch.benchmarks import convergence
from pinnrl_tpu_torch.models import PINNModel
from pinnrl_tpu_torch.pdes import create_pde
from pinnrl_tpu_torch.rl import RLAgent
from pinnrl_tpu_torch.training import PDETrainer

CASES = {
    # Burgers recipe (RAR): 3 Adam epochs of 2 steps with EMA, then L-BFGS.
    "adam_lbfgs_ema": dict(optimizer="adam_lbfgs", epochs=6, param_ema=0.9),
    # Adam with LRW weights, the plateau scale and RL-driven sampling.
    "adam_lrw_plateau_rl": dict(optimizer="adam", epochs=4, lrw=True, rl=True),
    # Pure L-BFGS: the memory is restored.
    "lbfgs": dict(optimizer="lbfgs", epochs=4),
}


def _trainer(case):
    spec = CASES[case]
    cfg = convergence.build_recipe_config("burgers", epochs=spec["epochs"], device="cpu")
    cfg.model.hidden_dims = [16, 16]
    cfg.model.arch_params["mapping_size"] = 8
    t = cfg.training
    t.num_collocation_points, t.batch_size = 256, 128
    t.num_boundary_points = t.num_initial_points = 32
    t.optimizer, t.validation_frequency = spec["optimizer"], 2
    t.param_ema = spec.get("param_ema", 0.0)
    if spec.get("lrw"):
        t.adaptive_weights.enabled, t.adaptive_weights.strategy = True, "lrw"
        t.scheduler_type, t.lr_scheduler.patience = "reduce_lr", 1
    agent = (RLAgent(hidden_dim=16, memory_size=64, batch_size=8, device="cpu")
             if spec.get("rl") else None)
    return PDETrainer(PINNModel(cfg, seed=0), create_pde(cfg), cfg, rl_agent=agent)


def _run_keeping(monkeypatch, case, exp, keep_at, keep_dir):
    """An uninterrupted run that copies its checkpoint at epoch ``keep_at``."""
    tr = _trainer(case)
    save = tr._save_checkpoint

    def saving(path, epoch, *args):
        save(path, epoch, *args)
        if epoch == keep_at:
            keep_dir.mkdir()
            for f in ("checkpoint.npz", "checkpoint.json"):
                shutil.copy(path.parent / f, keep_dir / f)

    monkeypatch.setattr(tr, "_save_checkpoint", saving)
    return tr, tr.train(seed=0, experiment_dir=str(exp))


@pytest.mark.parametrize("case", list(CASES))
def test_resume_reproduces_the_uninterrupted_run(monkeypatch, tmp_path, case):
    full, res = _run_keeping(monkeypatch, case, tmp_path / "a", 2, tmp_path / "ck")
    resumed = _trainer(case)
    res2 = resumed.train(seed=0, experiment_dir=str(tmp_path / "b"),
                         resume_from=str(tmp_path / "ck" / "checkpoint.npz"))
    assert res2["history"]["train_loss"] == res["history"]["train_loss"]
    for key in ("val_loss", "learning_rate", "adaptive_weights", "loss_components"):
        assert res2["history"][key] == res["history"][key], key
    for k, v in full.model.params.items():
        assert torch.equal(resumed.model.params[k], v), k
    if CASES[case].get("rl"):
        for k, v in full._rl_state.policy_params.items():
            assert torch.equal(resumed._rl_state.policy_params[k], v), k
        assert float(resumed._rl_state.epsilon) == float(full._rl_state.epsilon)


def test_lbfgs_checkpoint_into_an_adam_template_keeps_the_fresh_optimizer(monkeypatch, tmp_path,
                                                                         caplog):
    _run_keeping(monkeypatch, "adam_lbfgs_ema", tmp_path / "a", 5, tmp_path / "ck")
    with np.load(tmp_path / "ck" / "checkpoint.npz") as ck:
        assert str(ck["opt/kind"]) == "lbfgs" and "opt/lbfgs/s_memory" in ck.files
    resumed = _trainer("adam_lbfgs_ema")
    with caplog.at_level(logging.WARNING, logger="pinnrl_tpu_torch.training.trainer"):
        res = resumed.train(seed=0, resume_from=str(tmp_path / "ck" / "checkpoint.npz"))
    assert "could not restore 'opt_state'" in caplog.text
    assert res["status"] == "completed" and len(res["history"]["train_loss"]) == 6
    assert np.isfinite(res["history"]["train_loss"][-1])


def test_run_convergence_resumes(monkeypatch, tmp_path):
    """A recipe's run resumed from its last checkpoint ends on the same model."""
    build = convergence.build_recipe_config

    def small(key, epochs=None, device="cuda"):
        cfg = build(key, epochs, device=device)
        cfg.model.hidden_dims = [16, 16]
        cfg.model.arch_params["mapping_size"] = 8
        t = cfg.training
        t.num_collocation_points, t.batch_size = 256, 128
        t.num_boundary_points = t.num_initial_points = 32
        return cfg

    monkeypatch.setattr(convergence, "build_recipe_config", small)
    first = convergence.run_convergence("burgers", epochs=4, experiment_dir=str(tmp_path / "a"),
                                        device="cpu")
    again = convergence.run_convergence("burgers", epochs=4, experiment_dir=str(tmp_path / "b"),
                                        resume_from=str(tmp_path / "a" / "checkpoint.npz"),
                                        device="cpu")
    assert again.rel_l2 == first.rel_l2 and again.final_train_loss == first.final_train_loss
