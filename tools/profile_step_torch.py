#!/usr/bin/env python3
"""Where the time of one training step of the PyTorch port goes, on one
CUDA card.

    python3 tools/profile_step_torch.py [--steps 20] [--profiled 10] [--out chiprun_out/profile]

For the Burgers recipe slice of ``chip_smoke.py`` (Fourier 256x3, mapping
128, batch 8192, BC/IC 4096), once with the hand-written kernels and once on
the plain path (fused residual off, plain Fourier features and MLP scorer),
it prints:

  * the host-clock step time (median, q1, q3) of ``--steps`` unprofiled steps,
    each ending in ``torch.cuda.synchronize()``, after 5 warm-up steps;
  * from a ``torch.profiler`` trace of ``--profiled`` further steps: the
    device's busy time per step (the union of the kernel, memcpy and memset
    intervals, so overlaps count once), the idle share of the unprofiled
    median step (1 - busy / median), and the device time and launch count of
    each kernel name per step.

With ``--rl`` the step is the RL-driven one: the DQN agent of the shipped
defaults scores the 100x100 grid and takes its update on every step. With
``--kdv`` it is a step of the KdV recipe (``build_recipe_config("kdv")``:
Fourier 256x3, mapping 256, batch 8192, causal eps 1.0, order-3 residual).

The chrome traces go to ``--out``. The script imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _device_intervals(trace_path: Path):
    events = json.loads(trace_path.read_text())["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["dur"])) for e in events
            if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS]


def _union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for _, ts, dur in sorted(intervals, key=lambda e: e[1]):
        lo, hi = max(ts, end), ts + dur
        if hi > lo:
            total += hi - lo
        end = max(end, hi)
    return total


def profile(trainer, cfg, label: str, steps: int, profiled: int, out: Path, card: str):
    import torch

    dev = trainer.device
    steps_per_epoch = cfg.training.num_collocation_points // cfg.training.batch_size
    params = trainer.model.params
    opt = trainer._make_adam(cfg.training.num_epochs, steps_per_epoch, list(params.values()))
    gen = torch.Generator(device=dev).manual_seed(7)

    def step():
        trainer._step(params, opt, gen, cfg.training.batch_size)

    times = []
    for i in range(5 + steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        if i >= 5:
            times.append((time.perf_counter() - t0) * 1e3)
    q1, med, q3 = statistics.quantiles(times, n=4)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(profiled):
            step()
        torch.cuda.synchronize()
    out.mkdir(parents=True, exist_ok=True)
    trace = out / f"trace_{label}.json"
    prof.export_chrome_trace(str(trace))
    ivs = _device_intervals(trace)
    if not ivs:
        raise RuntimeError(f"{label}: the profiler recorded no device activity")
    busy = _union_us(ivs) / 1e3 / profiled
    per_kernel = defaultdict(lambda: [0.0, 0])
    for name, _, dur in ivs:
        per_kernel[name][0] += dur / 1e3 / profiled
        per_kernel[name][1] += 1
    print(f"[{label}] step ms (host clock, {steps} steps): median {med:.3f} q1 {q1:.3f} "
          f"q3 {q3:.3f} ({card})")
    print(f"[{label}] device busy {busy:.3f} ms/step over {profiled} profiled steps; "
          f"idle share of the median step {1.0 - busy / med:.3f} ({card})")
    rows = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])
    for name, (ms, count) in rows[:15]:
        print(f"[{label}]   {ms:8.4f} ms/step  {count / profiled:6.1f} launches/step  {name[:90]}")
    return {"label": label, "median_ms": med, "q1_ms": q1, "q3_ms": q3, "busy_ms": busy,
            "idle_share": 1.0 - busy / med,
            "kernels": [{"name": n, "ms_per_step": v[0], "launches_per_step": v[1] / profiled}
                        for n, v in rows]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=20, help="unprofiled steps timed after warm-up")
    ap.add_argument("--profiled", type=int, default=10, help="steps under torch.profiler")
    ap.add_argument("--out", default=str(REPO / "chiprun_out" / "profile"),
                    help="directory for the chrome traces and summary.json")
    kind = ap.add_mutually_exclusive_group()
    kind.add_argument("--rl", action="store_true", help="profile the RL-driven step")
    kind.add_argument("--kdv", action="store_true", help="profile the KdV recipe's causal step")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_step_torch: no CUDA card", file=sys.stderr)
        return 2
    from chip_smoke import (burgers_recipe_config, kdv_recipe_config, make_agent, nvidia_smi_line,
                            plain_fourier_features, plain_mlp_score)
    from pinnrl_tpu_torch.models import PINNModel
    from pinnrl_tpu_torch.pdes import create_pde
    from pinnrl_tpu_torch.training import PDETrainer

    card = nvidia_smi_line()
    out = Path(args.out)
    results = []
    prefix = "rl_" if args.rl else "kdv_" if args.kdv else ""
    for label in ("kernels", "plain"):
        cfg = kdv_recipe_config("cuda") if args.kdv else burgers_recipe_config("cuda")
        cfg.rl.enabled = args.rl
        if label == "plain":
            cfg.training.fused_residual_kernel = "off"
        agent = make_agent(cfg) if args.rl else None
        trainer = PDETrainer(PINNModel(cfg, seed=0), create_pde(cfg), cfg, rl_agent=agent)
        if trainer.fused_kernel_active != (label == "kernels"):
            raise AssertionError(f"{label}: fused_kernel_active={trainer.fused_kernel_active}")
        if agent is not None:
            trainer._rl_state = trainer._init_rl_state(0)
        with contextlib.ExitStack() as plain:
            if label == "plain":
                plain.enter_context(plain_fourier_features())
                plain.enter_context(plain_mlp_score())
            results.append(profile(trainer, cfg, prefix + label, args.steps, args.profiled, out, card))
    (out / f"{prefix}summary.json").write_text(json.dumps({"card": card, "runs": results}, indent=1))
    if "jax" in sys.modules:
        raise AssertionError("profile_step_torch imported jax")
    return 0


if __name__ == "__main__":
    sys.exit(main())
