#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (each raises on failure, and the script then exits non-zero):
  1. device  — require a CUDA card; print its name and power limit.
  2. build   — compile the hand-written kernels from ``pinnrl_tpu_torch/csrc``
               (one nvcc per source, all started together).
  3. parity  — each kernel against its plain PyTorch version on the card, at
               the shapes of the Burgers recipe slice and of the DQN scorer.
  4. slice   — the Burgers recipe (Fourier 256x3, mapping 128, batch 8192)
               through ``load_config`` -> ``create_pde`` -> ``PINNModel`` ->
               ``PDETrainer.train`` for 52 Adam steps and 5 validations, then
               ``validate``; the kernels' launch counters must show the main
               path used them on every step and every validation.
  5. timing  — median ms per training step with the kernels and on the plain
               path, and each kernel against its plain version.
  6. rl      — the same recipe with RL-driven sampling: an ``RLAgent`` with
               the shipped defaults (hidden 512) scores the 100x100 grid
               through ``fused_mlp_score`` on every step and takes its DQN
               update; 52 steps and 5 validations, with launch, buffer,
               epsilon and parameter checks.
  7. rar     — 4 steps of the recipe with residual-based (RAR) sampling.
  8. syncs   — host round trips of one RL step against one uniform step,
               counted under ``torch.cuda.set_sync_debug_mode("warn")``.
  9. timing  — ``fused_mlp_score`` against its plain version, and median ms
               per RL step with the kernels and on the plain path.

The second-to-last line is a JSON object describing each kernel (its
``launches`` are those of the RL slice, the path that runs all three); the
last line is ``{"ok": true, "device": {...}}``. Imports no JAX.
"""

from __future__ import annotations

import contextlib
import json
import linecache
import statistics
import subprocess
import sys
import time
import traceback
import warnings
from concurrent.futures import ThreadPoolExecutor

# The Burgers recipe: 13 epochs x 4 steps of batch 8192 on 40000 points = 52 steps.
EPOCHS = 13
FF_TOL = 1e-5       # rel to max |ref|: sincosf vs torch's sin/cos, same f32 inputs
LOSS_TOL = 1e-5     # rel: sums run in another order than the plain version's
GRAD_TOL = 1e-4     # rel to each gradient's max |ref| (the JAX suite's fused-kernel bound)
MLP_TOL = 1e-4      # rel to max |ref| (the JAX suite's bound for the MLP scorer kernel)
RAR_STEPS = 4       # one epoch of 4 steps


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def burgers_recipe_config(device: str):
    """The shipped Burgers recipe, with Adam only (L-BFGS is not ported
    yet) and uniform sampling."""
    from pinnrl_tpu_torch.config import load_config

    cfg = load_config(pde_type="burgers", architecture="fourier", device=device)
    cfg.pde.parameters.update({"nu": 0.01})
    cfg.pde.exact_solution = {"type": "traveling_wave", "amplitude": 0.5,
                              "speed": 0.5, "center": -0.25}
    cfg.pde.initial_condition = {"type": "traveling_wave"}
    cfg.model.input_dim = cfg.pde.dimension + 1
    cfg.model.hidden_dims = [256, 256, 256]
    cfg.model.arch_params.update({"mapping_size": 128, "scale": 2.0})
    t = cfg.training
    t.optimizer_config.learning_rate = 2e-3
    t.optimizer_config.weight_decay = 0.0
    t.num_epochs = EPOCHS
    t.num_collocation_points = 40000
    t.batch_size = 8192
    t.num_boundary_points = 4096
    t.num_initial_points = 4096
    t.optimizer = "adam"
    t.collocation_distribution = "uniform"
    t.early_stopping.enabled = False
    t.loss_weights["smoothness"] = 0.0
    t.validation_frequency = max(t.num_epochs // 4, 1)
    return cfg


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@contextlib.contextmanager
def plain_fourier_features():
    """Route the model's Fourier features to the plain version (timing only)."""
    from pinnrl_tpu_torch.ops.kernels import fourier_feats

    kernel = fourier_feats.fourier_features
    fourier_feats.fourier_features = fourier_feats.fourier_features_plain
    try:
        yield
    finally:
        fourier_feats.fourier_features = kernel


@contextlib.contextmanager
def plain_mlp_score():
    """Route the agent's grid scoring to the plain version (timing only)."""
    from pinnrl_tpu_torch.ops.kernels import mlp

    kernel = mlp.fused_mlp_score
    mlp.fused_mlp_score = mlp.fused_mlp_score_plain
    try:
        yield
    finally:
        mlp.fused_mlp_score = kernel


def make_agent(cfg):
    """The agent ``training/train.py`` builds from ``cfg.rl``."""
    from pinnrl_tpu_torch.rl import RLAgent

    rl = cfg.rl
    return RLAgent(
        state_dim=cfg.model.input_dim, action_dim=rl.action_dim, hidden_dim=rl.hidden_dim,
        learning_rate=rl.learning_rate, gamma=rl.gamma, epsilon_start=rl.epsilon_start,
        epsilon_end=rl.epsilon_end, epsilon_decay=rl.epsilon_decay, memory_size=rl.memory_size,
        batch_size=rl.batch_size, target_update=rl.target_update,
        reward_weights=dict(rl.reward_weights), device=cfg.device,
    )


def step_times(tr, n: int, epochs: int, batch: int, seed: int = 7):
    """Host-clock ms of ``n`` training steps after 3 warm-up steps, each
    ending in ``torch.cuda.synchronize()``."""
    import torch

    params = tr.model.params
    steps_per_epoch = tr.tcfg.num_collocation_points // batch
    opt = tr._make_adam(epochs, steps_per_epoch, list(params.values()))
    g = torch.Generator(device=tr.device).manual_seed(seed)
    if tr.rl_agent is not None and tr._rl_state is None:
        tr._rl_state = tr._init_rl_state(0)
    times = []
    for i in range(n + 3):
        torch.cuda.synchronize()
        s = time.perf_counter()
        tr._step(params, opt, g, batch)
        torch.cuda.synchronize()
        if i >= 3:  # warm-up
            times.append((time.perf_counter() - s) * 1e3)
    return times


def record_syncs(fn):
    """Run ``fn`` under ``torch.cuda.set_sync_debug_mode("warn")`` and return
    the host round trips it made, each named by the innermost frame in
    ``pinnrl_tpu_torch`` that led to it (and the frame that raised it)."""
    import torch

    torch.cuda.synchronize()
    sites = []

    def record(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" not in str(message):
            return  # e.g. the one-time notice that the debug mode is a prototype
        stack = traceback.extract_stack()[:-1]
        ours = [f for f in stack if "pinnrl_tpu_torch" in f.filename]
        if not ours:  # not under a frame of the port: show where it came from
            print(f"[syncs]   outside the port: "
                  f"{filename}:{lineno} {linecache.getline(filename, lineno).strip()!r} <- "
                  + " <- ".join(f"{f.filename.rsplit('/', 1)[-1]}:{f.lineno}:{f.name}"
                                for f in reversed(stack)), flush=True)
            ours = stack
        sites.append(f"{ours[-1].filename.rsplit('/', 1)[-1]}:{ours[-1].lineno} "
                     f"({filename.rsplit('/', 1)[-1]}:{lineno})")

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sites


def count_syncs(tr, batch: int):
    """Host round trips of one warm training step (see ``record_syncs``)."""
    import torch

    params = tr.model.params
    opt = tr._make_adam(1, 1, list(params.values()))
    g = torch.Generator(device=tr.device).manual_seed(11)
    if tr.rl_agent is not None and tr._rl_state is None:
        tr._rl_state = tr._init_rl_state(0)
    tr._step(params, opt, g, batch)  # warm-up
    sites = record_syncs(lambda: tr._step(params, opt, g, batch))
    return len(sites), sorted(set(sites))


def main() -> int:
    import torch

    # ---- 1. device ----------------------------------------------------- #
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to run", file=sys.stderr)
        return 2
    import pinnrl_tpu_torch  # noqa: F401 — fails outside a checkout of the repo
    from pinnrl_tpu_torch.models import PINNModel
    from pinnrl_tpu_torch.ops.jet_mlp import make_bundle_fn
    from pinnrl_tpu_torch.ops.kernels import _build, fourier_feats, fused_step, mlp
    from pinnrl_tpu_torch.sampling import make_grid
    from pinnrl_tpu_torch.pdes import create_pde
    from pinnrl_tpu_torch.training import PDETrainer

    dev = torch.device("cuda")
    card = nvidia_smi_line()
    print(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # ---- 2. build ------------------------------------------------------ #
    t0 = time.perf_counter()
    names = ("fourier_feats", "fused_residual", "mlp_score")
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        list(pool.map(_build.load_library, names))  # one nvcc per source, all at once
    for name in names:
        print(f"[build] {name}: {_build.BUILD_SECONDS[name]:.2f} s", flush=True)
        for line in _build.BUILD_LOG.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"[build]   {line.strip()}")
    print(f"[build] total {time.perf_counter() - t0:.2f} s ({card})", flush=True)

    # ---- 3. parity ----------------------------------------------------- #
    cfg = burgers_recipe_config("cuda")
    pde = create_pde(cfg)
    model = PINNModel(cfg, seed=0)
    gen = torch.Generator(device=dev).manual_seed(123)

    x_ff = 2.0 * torch.rand((4096, 2), generator=gen, device=dev) - 1.0
    B = model.constants["FourierFeatures_0.B"]
    ff_k = fourier_feats.fourier_features(x_ff, B, True)
    ff_p = fourier_feats.fourier_features_plain(x_ff, B, True)
    torch.cuda.synchronize()
    ff_err = float((ff_k - ff_p).abs().max())
    ff_rel = ff_err / float(ff_p.abs().max())
    xg = x_ff.clone().requires_grad_(True)
    g_out = torch.randn(ff_k.shape, generator=gen, device=dev)
    gk = torch.autograd.grad(fourier_feats.fourier_features(xg, B, True), xg, g_out)[0]
    gp = torch.autograd.grad(fourier_feats.fourier_features_plain(xg, B, True), xg, g_out)[0]
    torch.cuda.synchronize()
    ff_grad_rel = float((gk - gp).abs().max()) / float(gp.abs().max())
    print(f"[parity] fourier_features (4096,2)x(2,128): max_abs_err {ff_err:.3e} "
          f"rel {ff_rel:.3e} grad_rel {ff_grad_rel:.3e} (tol {FF_TOL:g})", flush=True)
    if not (ff_rel < FF_TOL and ff_grad_rel < FF_TOL):
        raise AssertionError("fourier_features kernel disagrees with its plain version")

    assert pde.attach_fast_bundle(model) and fused_step.supports(model, pde, cfg.training)
    fused = fused_step.make_fused_residual_loss(model, pde)
    bundle_fn = make_bundle_fn(model, 1, 2, 1)
    x, t = pde.generate_collocation_points(gen, 8192, "uniform")
    z = torch.cat([x, t], dim=-1)
    params = model.params

    def fused_grads(p, zz):
        loss = fused(p, zz)
        return loss, torch.autograd.grad(loss, list(p.values()))

    def plain_grads(p, zz):
        loss = fused_step.fused_residual_loss_plain(bundle_fn, pde, p, zz)
        return loss, torch.autograd.grad(loss, list(p.values()))

    def compare(tag, p, zz):
        lk, gk_ = fused_grads(p, zz)
        lk = lk.detach()
        lp, gp_ = plain_grads(p, zz)
        lp = lp.detach()
        torch.cuda.synchronize()
        loss_rel = abs(float(lk) - float(lp)) / max(abs(float(lp)), 1e-30)
        worst_abs, worst_rel, worst_name = abs(float(lk) - float(lp)), 0.0, ""
        for name, a, b in zip(p.keys(), gk_, gp_):
            if not torch.isfinite(a).all():
                raise AssertionError(f"{tag}: non-finite kernel gradient for {name}")
            d = float((a - b).abs().max())
            rel = d / max(float(b.abs().max()), 1e-30)
            worst_abs = max(worst_abs, d)
            if rel > worst_rel:
                worst_rel, worst_name = rel, name
        print(f"[parity] fused_residual_loss {tag}: loss {float(lk):.8e} vs plain {float(lp):.8e} "
              f"(rel {loss_rel:.3e}, tol {LOSS_TOL:g}); worst grad rel {worst_rel:.3e} "
              f"({worst_name}, tol {GRAD_TOL:g}); max_abs_err {worst_abs:.3e}", flush=True)
        if not (loss_rel < LOSS_TOL and worst_rel < GRAD_TOL):
            raise AssertionError(f"fused_residual_loss kernel disagrees with its plain version ({tag})")
        return worst_abs

    fused_err = compare("N=8192 seeded init", params, z)

    rl_cfg = burgers_recipe_config("cuda")
    rl_cfg.rl.enabled = True
    grid = make_grid(pde.domain, pde.time_domain, 100, dev)
    mlp_err = 0.0
    for hidden, a_dim, xs in ((rl_cfg.rl.hidden_dim, rl_cfg.rl.action_dim, grid),
                              (128, 4, 2.0 * torch.rand((1000, 2), generator=gen, device=dev) - 1.0)):
        rl_cfg.rl.hidden_dim, rl_cfg.rl.action_dim = hidden, a_dim
        q_params = make_agent(rl_cfg).init(torch.Generator().manual_seed(1)).policy_params
        with torch.no_grad():
            qk = mlp.fused_mlp_score(xs, q_params)
            qp = mlp.fused_mlp_score_plain(xs, q_params)
        torch.cuda.synchronize()
        err = float((qk - qp).abs().max())
        rel = err / float(qp.abs().max())
        mlp_err = max(mlp_err, err)
        print(f"[parity] fused_mlp_score ({xs.shape[0]},2)->{hidden}->{hidden}->{a_dim}: "
              f"max_abs_err {err:.3e} rel {rel:.3e} (tol {MLP_TOL:g})", flush=True)
        if not (tuple(qk.shape) == (xs.shape[0], a_dim) and rel < MLP_TOL):
            raise AssertionError("fused_mlp_score kernel disagrees with its plain version")
    rl_cfg = burgers_recipe_config("cuda")
    rl_cfg.rl.epsilon_start = 0.0
    greedy = make_agent(rl_cfg)
    g_state = greedy.init(torch.Generator().manual_seed(1))
    q_sel = greedy.select_action(g_state, grid, gen)
    with torch.no_grad():
        q_net = greedy.apply(g_state.policy_params, grid)[:, 0]
    torch.cuda.synchronize()
    sel_rel = float((q_sel - q_net).abs().max()) / float(q_net.abs().max())
    print(f"[parity] select_action at epsilon 0 vs the plain network's Q on the 100x100 grid: "
          f"rel {sel_rel:.3e} (tol {MLP_TOL:g})", flush=True)
    if not sel_rel < MLP_TOL:
        raise AssertionError("select_action at epsilon 0 is not the policy's Q")

    # ---- 4. slice ------------------------------------------------------ #
    cfg = burgers_recipe_config("cuda")
    pde = create_pde(cfg)
    model = PINNModel(cfg, seed=0)
    trainer = PDETrainer(model, pde, cfg)
    if not trainer.fused_kernel_active:
        raise AssertionError("fused residual kernel is not active on the recipe slice")
    steps_per_epoch = cfg.training.num_collocation_points // cfg.training.batch_size
    n_steps = EPOCHS * steps_per_epoch
    val_every = cfg.training.validation_frequency
    n_vals = sum(1 for e in range(1, EPOCHS + 1) if e % val_every == 0 or e == EPOCHS)
    fourier_feats.fourier_features.launches = 0
    fused_step.fused_residual_loss.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = trainer.train(seed=0)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    n_fused = fused_step.fused_residual_loss.launches
    n_ff = fourier_feats.fourier_features.launches
    hist = res["history"]["train_loss"]
    print(f"[slice] fused_kernel_active={trainer.fused_kernel_active} steps={n_steps} "
          f"validations={n_vals} train {train_s:.2f} s; launches: fused_residual_loss {n_fused}, "
          f"fourier_features {n_ff}", flush=True)
    print(f"[slice] epoch mean losses: {' '.join(f'{v:.4e}' for v in hist)}", flush=True)
    if len(hist) != EPOCHS or not all(map(lambda v: v == v and abs(v) != float("inf"), hist)):
        raise AssertionError(f"non-finite or missing losses: {hist}")
    if not hist[-1] < hist[0]:
        raise AssertionError(f"loss did not fall: first epoch {hist[0]}, last {hist[-1]}")
    if len(res["history"]["val_loss"]) != n_vals:
        raise AssertionError(f"{len(res['history']['val_loss'])} validations, expected {n_vals}")
    if n_fused != n_steps + n_vals:
        raise AssertionError(f"fused kernel launched {n_fused} times in {n_steps} steps "
                             f"and {n_vals} validations")
    if n_ff < 2 * (n_steps + n_vals):
        raise AssertionError(f"fourier_features launched {n_ff} times, "
                             f"expected >= {2 * (n_steps + n_vals)} (BC and IC of each loss)")
    net = trainer._final_state["params"]["net"]
    val = pde.validate(model.apply, net, num_points=20000)
    u = model.apply(net, torch.cat(pde.generate_collocation_points(gen, 20000), dim=-1))
    if tuple(u.shape) != (20000, 1) or not torch.isfinite(u).all():
        raise AssertionError(f"bad prediction: shape {tuple(u.shape)}")
    if not all(v == v for v in val.values()):
        raise AssertionError(f"non-finite validation metrics {val}")
    print(f"[slice] validate(20000): rel_l2 {val['rel_l2']:.4e} max_error {val['max_error']:.4e} "
          f"(no bar at {n_steps} steps)", flush=True)
    x, t = pde.generate_collocation_points(gen, 8192, "uniform")
    compare("N=8192 trained params", {k: v.detach().requires_grad_(True) for k, v in net.items()},
            torch.cat([x, t], dim=-1))

    # ---- 5. timing ----------------------------------------------------- #
    ff_ms = cuda_ms(lambda: fourier_feats.fourier_features(x_ff, B, True), iters=200)
    ff_plain_ms = cuda_ms(lambda: fourier_feats.fourier_features_plain(x_ff, B, True), iters=200)
    z = torch.cat([x, t], dim=-1)
    p = {k: v.detach().requires_grad_(True) for k, v in net.items()}
    fused_ms = cuda_ms(lambda: fused_grads(p, z), iters=20)
    fused_plain_ms = cuda_ms(lambda: plain_grads(p, z), iters=20)
    print(f"[timing] fourier_features (4096,2)x(2,128): kernel {ff_ms:.4f} ms, plain {ff_plain_ms:.4f} ms ({card})")
    print(f"[timing] fused_residual_loss N=8192 loss+grads: kernel {fused_ms:.3f} ms, "
          f"plain {fused_plain_ms:.3f} ms ({card})", flush=True)

    plain_cfg = burgers_recipe_config("cuda")
    plain_cfg.training.fused_residual_kernel = "off"
    plain_pde = create_pde(plain_cfg)
    plain_model = PINNModel(plain_cfg, seed=0)
    plain_trainer = PDETrainer(plain_model, plain_pde, plain_cfg)
    assert not plain_trainer.fused_kernel_active

    batch = cfg.training.batch_size
    kernel_times, plain_times = [], []
    for order in ("plain", "kernel", "kernel", "plain"):
        if order == "kernel":
            kernel_times += step_times(trainer, 15, EPOCHS, batch)
        else:
            with plain_fourier_features():
                plain_times += step_times(plain_trainer, 15, EPOCHS, batch)
    step_ms = statistics.median(kernel_times)
    step_plain_ms = statistics.median(plain_times)
    print(f"[timing] train step (batch 8192, BC 4096, IC 4096), median of {len(kernel_times)}: "
          f"kernels {step_ms:.3f} ms, plain path {step_plain_ms:.3f} ms ({card})", flush=True)

    # ---- 6. rl slice ---------------------------------------------------- #
    rl_cfg = burgers_recipe_config("cuda")
    rl_cfg.rl.enabled = True
    rl_pde = create_pde(rl_cfg)
    rl_model = PINNModel(rl_cfg, seed=0)
    agent = make_agent(rl_cfg)
    rl_trainer = PDETrainer(rl_model, rl_pde, rl_cfg, rl_agent=agent)
    if not (rl_trainer.fused_kernel_active and rl_trainer.strategy == "adaptive"):
        raise AssertionError("the RL slice is not on the fused kernel with adaptive sampling")
    init_policy = rl_trainer._init_rl_state(0).policy_params
    fourier_feats.fourier_features.launches = 0
    fused_step.fused_residual_loss.launches = 0
    mlp.fused_mlp_score.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rl_res = rl_trainer.train(seed=0)
    torch.cuda.synchronize()
    rl_s = time.perf_counter() - t0
    rl_launches = {"fused_residual_loss": fused_step.fused_residual_loss.launches,
                   "fourier_features": fourier_feats.fourier_features.launches,
                   "fused_mlp_score": mlp.fused_mlp_score.launches}
    st = rl_trainer._final_state["rl"]
    stats = agent.get_statistics(st)
    hist = rl_res["history"]["train_loss"]
    print(f"[rl] strategy={rl_trainer.strategy} fused_kernel_active={rl_trainer.fused_kernel_active} "
          f"steps={n_steps} validations={n_vals} train {rl_s:.2f} s; launches: {rl_launches}", flush=True)
    print(f"[rl] epoch mean losses: {' '.join(f'{v:.4e}' for v in hist)}", flush=True)
    print(f"[rl] agent: {stats}", flush=True)
    if len(hist) != EPOCHS or not all(map(lambda v: v == v and abs(v) != float("inf"), hist)):
        raise AssertionError(f"RL slice: non-finite or missing losses: {hist}")
    if not hist[-1] < hist[0]:
        raise AssertionError(f"RL slice: loss did not fall: first epoch {hist[0]}, last {hist[-1]}")
    if rl_launches["fused_mlp_score"] != n_steps:
        raise AssertionError(f"fused_mlp_score launched {rl_launches['fused_mlp_score']} times "
                             f"in {n_steps} steps")
    if rl_launches["fused_residual_loss"] != n_steps + n_vals:
        raise AssertionError(f"RL slice: fused kernel launched {rl_launches['fused_residual_loss']} "
                             f"times in {n_steps} steps and {n_vals} validations")
    if rl_launches["fourier_features"] < 2 * (n_steps + n_vals):
        raise AssertionError(f"RL slice: fourier_features launched {rl_launches['fourier_features']} "
                             f"times, expected >= {2 * (n_steps + n_vals)}")
    n_push = min(128, rl_cfg.training.batch_size)
    want_size = min(n_steps * n_push, agent.memory_size)
    if (st.size, st.steps) != (want_size, n_steps):
        raise AssertionError(f"agent size {st.size}, steps {st.steps}; expected {want_size}, {n_steps}")
    want_eps = max(rl_cfg.rl.epsilon_start * rl_cfg.rl.epsilon_decay ** EPOCHS, rl_cfg.rl.epsilon_end)
    if not abs(stats["epsilon"] - want_eps) < 1e-6:
        raise AssertionError(f"epsilon {stats['epsilon']}, expected {want_eps}")
    if all(torch.equal(init_policy[k], v.detach()) for k, v in st.policy_params.items()):
        raise AssertionError("the DQN policy did not move")
    target_is_init = all(torch.equal(init_policy[k], v) for k, v in st.target_params.items())
    if target_is_init != (n_steps < agent.target_update):
        raise AssertionError(f"target network: equals the initial policy {target_is_init} "
                             f"after {n_steps} steps (sync every {agent.target_update})")
    rl_net = rl_trainer._final_state["params"]["net"]
    rl_val = rl_pde.validate(rl_model.apply, rl_net, num_points=20000)
    if not all(v == v for v in rl_val.values()):
        raise AssertionError(f"RL slice: non-finite validation metrics {rl_val}")
    print(f"[rl] size {st.size} steps {st.steps} epsilon {stats['epsilon']:.7f} (0.995^{EPOCHS} = "
          f"{want_eps:.7f}); target synced: {not target_is_init}; validate(20000): rel_l2 "
          f"{rl_val['rel_l2']:.4e} max_error {rl_val['max_error']:.4e} (no bar at {n_steps} steps)",
          flush=True)

    # ---- 7. rar --------------------------------------------------------- #
    rar_cfg = burgers_recipe_config("cuda")
    rar_cfg.training.collocation_distribution = "residual_based"
    rar_cfg.training.num_collocation_points = RAR_STEPS * rar_cfg.training.batch_size
    rar_model = PINNModel(rar_cfg, seed=0)
    rar_trainer = PDETrainer(rar_model, create_pde(rar_cfg), rar_cfg)
    fused_step.fused_residual_loss.launches = 0
    rar_res = rar_trainer.train(num_epochs=1, seed=0)
    torch.cuda.synchronize()
    rar_fused = fused_step.fused_residual_loss.launches
    rar_hist = rar_res["history"]["train_loss"] + rar_res["history"]["val_loss"]
    if not all(v == v and abs(v) != float("inf") for v in rar_hist) or len(rar_hist) != 2:
        raise AssertionError(f"RAR: non-finite or missing losses {rar_hist}")
    if rar_fused != RAR_STEPS + 1:
        raise AssertionError(f"RAR: fused kernel launched {rar_fused} times in {RAR_STEPS} steps "
                             "and 1 validation")
    rar_ms = statistics.median(step_times(rar_trainer, 5, 1, batch))
    print(f"[rar] {RAR_STEPS} steps + 1 validation: losses {rar_hist}, fused kernel launched "
          f"{rar_fused} times; step (pool 32768 scored in 4 chunks) median of 5: {rar_ms:.3f} ms "
          f"({card})", flush=True)

    # ---- 8. host syncs --------------------------------------------------- #
    control = record_syncs(lambda: torch.ones((), device=dev).item())
    if len(control) != 1:  # the counter must see a known round trip
        raise AssertionError(f"the sync counter saw {control} for one .item()")
    n_sync_rl, rl_sites = count_syncs(rl_trainer, batch)
    n_sync_uni, uni_sites = count_syncs(trainer, batch)
    print(f"[syncs] one warm step under set_sync_debug_mode('warn'): RL {n_sync_rl} {rl_sites}, "
          f"uniform {n_sync_uni} {uni_sites}; control: one .item() counted {len(control)}",
          flush=True)
    if n_sync_rl > n_sync_uni:
        raise AssertionError(f"the RL step makes {n_sync_rl} host syncs, the uniform step {n_sync_uni}")

    # ---- 9. rl timing ---------------------------------------------------- #
    q_params = {k: v.detach() for k, v in st.policy_params.items()}
    with torch.no_grad():
        mlp_ms = cuda_ms(lambda: mlp.fused_mlp_score(grid, q_params), iters=100)
        mlp_plain_ms = cuda_ms(lambda: mlp.fused_mlp_score_plain(grid, q_params), iters=100)
    print(f"[timing] fused_mlp_score (10000,2)->512->512->1: kernel {mlp_ms:.4f} ms, "
          f"plain {mlp_plain_ms:.4f} ms ({card})", flush=True)
    plain_rl_cfg = burgers_recipe_config("cuda")
    plain_rl_cfg.rl.enabled = True
    plain_rl_cfg.training.fused_residual_kernel = "off"
    plain_rl_trainer = PDETrainer(PINNModel(plain_rl_cfg, seed=0), create_pde(plain_rl_cfg),
                                  plain_rl_cfg, rl_agent=make_agent(plain_rl_cfg))
    assert not plain_rl_trainer.fused_kernel_active
    rl_kernel_times, rl_plain_times = [], []
    for order in ("plain", "kernel", "kernel", "plain"):
        if order == "kernel":
            rl_kernel_times += step_times(rl_trainer, 15, EPOCHS, batch)
        else:
            with plain_fourier_features(), plain_mlp_score():
                rl_plain_times += step_times(plain_rl_trainer, 15, EPOCHS, batch)
    print(f"[timing] RL train step (batch 8192, grid 100x100, DQN 512, 128 pushed), median of "
          f"{len(rl_kernel_times)}: kernels {statistics.median(rl_kernel_times):.3f} ms, plain path "
          f"{statistics.median(rl_plain_times):.3f} ms ({card})", flush=True)

    if "jax" in sys.modules:
        raise AssertionError("chip_smoke imported jax")
    kernels = [
        {"name": "fused_residual_loss", "route": "cuda",
         "source": "pinnrl_tpu_torch/csrc/fused_residual.cu",
         "replaces": "pinnrl_tpu/ops/kernels/fused_step.py:277",
         "launches": rl_launches["fused_residual_loss"], "max_abs_err": fused_err,
         "ms": fused_ms, "plain_ms": fused_plain_ms},
        {"name": "fourier_features", "route": "cuda",
         "source": "pinnrl_tpu_torch/csrc/fourier_feats.cu",
         "replaces": "pinnrl_tpu/ops/kernels/fourier_feats.py:36",
         "launches": rl_launches["fourier_features"], "max_abs_err": ff_err,
         "ms": ff_ms, "plain_ms": ff_plain_ms},
        {"name": "fused_mlp_score", "route": "cuda",
         "source": "pinnrl_tpu_torch/csrc/mlp_score.cu",
         "replaces": "pinnrl_tpu/ops/kernels/mlp.py:75",
         "launches": rl_launches["fused_mlp_score"], "max_abs_err": mlp_err,
         "ms": mlp_ms, "plain_ms": mlp_plain_ms},
    ]
    print(f"[card] {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
