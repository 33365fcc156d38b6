#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (each raises on failure, and the script then exits non-zero):
  1. device  — require a CUDA card; print its name and power limit.
  2. build   — compile the hand-written kernels from ``pinnrl_tpu_torch/csrc``.
  3. parity  — each kernel against its plain PyTorch version on the card, at
               the shapes of the Burgers recipe slice.
  4. slice   — the Burgers recipe (Fourier 256x3, mapping 128, batch 8192)
               through ``load_config`` -> ``create_pde`` -> ``PINNModel`` ->
               ``PDETrainer.train`` for 52 Adam steps and 5 validations, then
               ``validate``; the kernels' launch counters must show the main
               path used them on every step and every validation.
  5. timing  — median ms per training step with the kernels and on the plain
               path, and each kernel against its plain version.

The second-to-last line is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``. Imports no JAX.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time

# The Burgers recipe: 13 epochs x 4 steps of batch 8192 on 40000 points = 52 steps.
EPOCHS = 13
FF_TOL = 1e-5       # rel to max |ref|: sincosf vs torch's sin/cos, same f32 inputs
LOSS_TOL = 1e-5     # rel: sums run in another order than the plain version's
GRAD_TOL = 1e-4     # rel to each gradient's max |ref| (the JAX suite's fused-kernel bound)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def burgers_recipe_config(device: str):
    """The shipped Burgers recipe, with Adam only and uniform sampling
    (L-BFGS and RAR are not ported yet)."""
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


def main() -> int:
    import torch

    # ---- 1. device ----------------------------------------------------- #
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to run", file=sys.stderr)
        return 2
    import pinnrl_tpu_torch  # noqa: F401 — fails outside a checkout of the repo
    from pinnrl_tpu_torch.models import PINNModel
    from pinnrl_tpu_torch.ops.jet_mlp import make_bundle_fn
    from pinnrl_tpu_torch.ops.kernels import _build, fourier_feats, fused_step
    from pinnrl_tpu_torch.pdes import create_pde
    from pinnrl_tpu_torch.training import PDETrainer

    dev = torch.device("cuda")
    card = nvidia_smi_line()
    print(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # ---- 2. build ------------------------------------------------------ #
    t0 = time.perf_counter()
    for name in ("fourier_feats", "fused_residual"):
        _build.load_library(name)
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

    def step_times(tr, n: int):
        params = tr.model.params
        opt = tr._make_adam(EPOCHS, steps_per_epoch, list(params.values()))
        g = torch.Generator(device=dev).manual_seed(7)
        times = []
        for i in range(n + 3):
            torch.cuda.synchronize()
            s = time.perf_counter()
            tr._step(params, opt, g, cfg.training.batch_size)
            torch.cuda.synchronize()
            if i >= 3:  # warm-up
                times.append((time.perf_counter() - s) * 1e3)
        return times

    kernel_times, plain_times = [], []
    for order in ("plain", "kernel", "kernel", "plain"):
        if order == "kernel":
            kernel_times += step_times(trainer, 15)
        else:
            with plain_fourier_features():
                plain_times += step_times(plain_trainer, 15)
    step_ms = statistics.median(kernel_times)
    step_plain_ms = statistics.median(plain_times)
    print(f"[timing] train step (batch 8192, BC 4096, IC 4096), median of {len(kernel_times)}: "
          f"kernels {step_ms:.3f} ms, plain path {step_plain_ms:.3f} ms ({card})", flush=True)

    if "jax" in sys.modules:
        raise AssertionError("chip_smoke imported jax")
    kernels = [
        {"name": "fused_residual_loss", "route": "cuda",
         "source": "pinnrl_tpu_torch/csrc/fused_residual.cu",
         "replaces": "pinnrl_tpu/ops/kernels/fused_step.py:277",
         "launches": n_fused, "max_abs_err": fused_err, "ms": fused_ms, "plain_ms": fused_plain_ms},
        {"name": "fourier_features", "route": "cuda",
         "source": "pinnrl_tpu_torch/csrc/fourier_feats.cu",
         "replaces": "pinnrl_tpu/ops/kernels/fourier_feats.py:36",
         "launches": n_ff, "max_abs_err": ff_err, "ms": ff_ms, "plain_ms": ff_plain_ms},
    ]
    print(f"[card] {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
