#!/usr/bin/env python3
"""Where the time of one training step of the PyTorch port goes, on one
CUDA card.

    python3 tools/profile_step_torch.py [--steps 20] [--profiled 10] [--out chiprun_out/profile]
        [--rl | --rar | --ensemble E | --kdv | --siren-kdv | --heat
         | --recipe KEY [--alternate ROUNDS] | --inverse KEY
         | --sampling STRATEGY [STRATEGY ...] [--batch N [N ...]]] [--lbfgs] [--graph]

For the Burgers recipe slice of ``chip_smoke.py`` (Fourier 256x3, mapping
128, batch 8192, BC/IC 4096), once with the hand-written kernels and once on
the plain path (fused residual off, plain Fourier features and MLP scorer),
it prints:

  * the host-clock step time (median, q1, q3) of ``--steps`` unprofiled steps,
    each ending in ``torch.cuda.synchronize()``, after 5 warm-up steps;
  * from a ``torch.profiler`` trace of ``--profiled`` further steps: the
    device's busy time per step (the union of the kernel, memcpy and memset
    intervals, so overlaps count once), the idle share of the unprofiled
    median step (1 - busy / median), the device launches per step (kernels,
    memcpys and memsets), and the device time and launch count of each
    kernel name per step.

With ``--rl`` the step is the RL-driven one: the DQN agent of the shipped
defaults scores the 100x100 grid and takes its update on every step. With
``--rar`` it is the Burgers recipe's own step: RAR sampling (a pool of
32768 scored in 4 chunks of 8192, 8192 drawn). With ``--ensemble E`` it is
a step of E members (one member-batched kernel-1 call). With
``--kdv`` it is a step of the KdV recipe (``build_recipe_config("kdv")``:
Fourier 256x3, mapping 256, batch 8192, causal eps 1.0, order-3 residual).
With ``--siren-kdv`` it is a step of KdV as shipped
(``load_config(pde_type="kdv")``: SIREN 124x7, omega_0 30, batch 2048, the
order-3 residual through nested jvp; plain = every SIREN layer on its plain
version). With ``--heat`` it is a step of the heat recipe (Fourier 256x3,
mapping 128, batch 8192, periodic BCs through one jvp, Adam). With
``--recipe wave``, ``pendulum`` or ``pendulum_nonlinear`` it is a step of
that recipe (Fourier 256x3, mapping 128, batch 8192: the residual on the
plain bundle at temporal order 2, kernel 2 on the BC, IC and velocity-IC
points and its jvp rule in the velocity IC; plain = kernel 2's plain
version). ``--recipe cahn_hilliard`` (attention 124x4, the mixed 2-D form,
batch 4096), ``cahn_hilliard_dynamics`` (Fourier 256x3, the mixed form with
its mass and mu-H2 penalties, causal) and ``cahn_hilliard_biharmonic``
(Fourier 128x3, mapping 64, the direct form: four nested jvps, batch 4096)
run the residual on the generic engine (nested jvp), kernel 2 inside the
Fourier recipes' jvps through its rule. ``--inverse heat`` or
``black_scholes`` is a step of that inverse recipe
(``benchmarks/inverse.py``: Fourier 128x3, mapping 64, batch 4096, BC/IC
2048, 2000 observations at 1% noise; alpha, or sigma and r, optimized with
the network; kernel 1 off, the residual on the plain bundle; plain = kernel
2's plain version). With
``--lbfgs`` it is one L-BFGS iteration of the recipe's second phase
(``training/lbfgs.py``: memory 50, zoom line search) on one fixed batch of
all the recipe's collocation points (40000; 4096 for the biharmonic) and fixed BC/IC points, from a fresh optimizer
at the seeded initial weights (the Burgers recipe, or the heat recipe with
``--heat``, or ``--recipe``'s); it also prints the objective's evaluations
per iteration.

With ``--alternate ROUNDS`` (with ``--recipe``) one trainer takes
``--steps`` host-clocked steps (or, with ``--lbfgs``, L-BFGS iterations,
reported per objective evaluation) with kernel 2 and then on its plain
version, in turns (kernel first in even rounds, plain first in odd ones),
for ``ROUNDS`` rounds; it prints each side's median and quartiles, the
caching allocator's new segments and retries on each side, and the
functions with the most host time in a ``cProfile`` of one step of each;
no trace is taken.

With ``--graph`` the step is the trainer's step program
(``training/step_program.py``) on the kernels' path, run eagerly and then
captured once and replayed per step (``chip_smoke.program_for`` with
``graph`` False and True: the same capturable Adam; plateau, EMA and agent
state as ``train`` sets them up): the same
numbers for each, the capture's seconds and the bytes it reserved, and
the ms per step of ``--steps`` steps issued back to back (one
``torch.cuda.synchronize()`` at the end), for both; before those, the two
sides' host-clock ms per step in turns (2 rounds of ``--steps`` steps
each, eager first, then graph first). With ``--lbfgs
--graph`` the step is one L-BFGS iteration of the program
(``chip_smoke.lbfgs_program_for``: a fresh optimizer on one fixed batch of
the recipe's points), eager (every trial guarded by a host read) and then
replayed (start, 25 trials under the IF node, finish); the evaluations are
counted on the device and settled outside the timed steps.

With ``--sampling`` the step is the sampling harness's
(``benchmarks/sampling.py``: Burgers, the 64x3 Fourier MLP at mapping 32,
the DQN at hidden 64 for ``adaptive[...]``) at each ``--batch`` (default
1024) under each strategy, as its step program (``_Run.program``) after
its warm-up; with ``--graph`` eager against captured and replayed (the
same capturable Adams), otherwise eager with the kernels against eager on
their plain versions; each side's points per second (batch / median ms)
too.

Every run also prints the back-to-back ms per step. The chrome traces go
to ``--out``, gzipped. The script imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import json
import shutil
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


def profile(trainer, cfg, label: str, steps: int, profiled: int, out: Path, card: str,
            lbfgs: bool = False, step=None, settle=lambda: None):
    import torch

    from pinnrl_tpu_torch.training.lbfgs import LBFGS

    dev = trainer.device
    steps_per_epoch = cfg.training.num_collocation_points // cfg.training.batch_size
    params = trainer.model.params
    gen = torch.Generator(device=dev).manual_seed(7)
    if step is not None:
        pass
    elif lbfgs:
        opt = trainer._make_lbfgs(trainer._leaves(params))
        batch = trainer._lbfgs_batch(7, 0, cfg.training.num_collocation_points)

        def step():
            trainer._lbfgs_step(params, opt, batch, gen)
    else:
        opt = trainer._make_adam(cfg.training.num_epochs, steps_per_epoch, trainer._leaves(params))

        def step():
            trainer._step(params, opt, gen, cfg.training.batch_size)

    times = []
    settle()
    evals = LBFGS.evaluations
    for i in range(5 + steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        if i >= 5:
            times.append((time.perf_counter() - t0) * 1e3)
    q1, med, q3 = statistics.quantiles(times, n=4)
    settle()  # a replayed program's evaluations are counted on the device
    evals_timed = (LBFGS.evaluations - evals) / (5 + steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    back_to_back = (time.perf_counter() - t0) * 1e3 / steps

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    settle()
    evals = LBFGS.evaluations
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(profiled):
            step()
        torch.cuda.synchronize()
    settle()
    evals_profiled = (LBFGS.evaluations - evals) / profiled
    out.mkdir(parents=True, exist_ok=True)
    trace = out / f"trace_{label}.json"
    prof.export_chrome_trace(str(trace))
    ivs = _device_intervals(trace)
    with open(trace, "rb") as src, gzip.open(f"{trace}.gz", "wb") as dst:
        shutil.copyfileobj(src, dst)  # a nested-jvp step's trace runs to hundreds of MB
    trace.unlink()
    if not ivs:
        raise RuntimeError(f"{label}: the profiler recorded no device activity")
    busy = _union_us(ivs) / 1e3 / profiled
    per_kernel = defaultdict(lambda: [0.0, 0])
    for name, _, dur in ivs:
        per_kernel[name][0] += dur / 1e3 / profiled
        per_kernel[name][1] += 1
    print(f"[{label}] step ms (host clock, {steps} steps): median {med:.3f} q1 {q1:.3f} "
          f"q3 {q3:.3f}; back to back {back_to_back:.3f} ms/step ({card})")
    print(f"[{label}] device busy {busy:.3f} ms/step over {profiled} profiled steps; "
          f"idle share of the median step {1.0 - busy / med:.3f}; "
          f"{len(ivs) / profiled:.1f} device launches/step ({card})")
    if lbfgs:
        print(f"[{label}] objective evaluations per iteration: {evals_timed:.2f} (timed), "
              f"{evals_profiled:.2f} (profiled)")
    rows = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])
    for name, (ms, count) in rows[:15]:
        print(f"[{label}]   {ms:8.4f} ms/step  {count / profiled:6.1f} launches/step  {name[:90]}")
    return {"label": label, "median_ms": med, "q1_ms": q1, "q3_ms": q3,
            "back_to_back_ms": back_to_back, "busy_ms": busy,
            "idle_share": 1.0 - busy / med, "launches_per_step": len(ivs) / profiled,
            **({"evaluations_per_step": evals_timed, "evaluations_per_profiled_step": evals_profiled}
               if lbfgs else {}),
            "kernels": [{"name": n, "ms_per_step": v[0], "launches_per_step": v[1] / profiled}
                        for n, v in rows]}


def in_turns(steps_by_side, steps: int, prefix: str, card: str, rounds: int = 2):
    """Host-clock ms per step of each side (eager and graph), ``steps``
    steps per side in each of ``rounds`` rounds, the sides in turns (eager
    first in even rounds) after 2 warm-up steps each."""
    import torch

    times = {side: [] for side in steps_by_side}
    for step in steps_by_side.values():
        for _ in range(2):
            step()
    for r in range(rounds):
        order = list(steps_by_side) if r % 2 == 0 else list(reversed(steps_by_side))
        for side in order:
            for _ in range(steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                steps_by_side[side]()
                torch.cuda.synchronize()
                times[side].append((time.perf_counter() - t0) * 1e3)
    medians = {side: statistics.median(v) for side, v in times.items()}
    print(f"[{prefix}turns] ms per step, {steps} per side in each of {rounds} rounds in turns: "
          + ", ".join(f"{side} median {ms:.3f}" for side, ms in medians.items()) + f" ({card})",
          flush=True)
    return {"label": f"{prefix}turns", "rounds": rounds, "median_ms": medians, "ms": times}


def alternate(trainer, cfg, label: str, rounds: int, steps: int, card: str, lbfgs: bool = False):
    """Kernel 2 against its plain version in turns on one trainer (see the
    module docstring); returns the summary it prints."""
    import cProfile
    import io
    import pstats

    import torch

    from chip_smoke import plain_fourier_features
    from pinnrl_tpu_torch.training.lbfgs import LBFGS

    params = trainer.model.params
    gen = torch.Generator(device=trainer.device).manual_seed(7)
    if lbfgs:
        opt = trainer._make_lbfgs(trainer._leaves(params))
        batch = trainer._lbfgs_batch(7, 0, cfg.training.num_collocation_points)

        def step():
            trainer._lbfgs_step(params, opt, batch, gen)
    else:
        opt = trainer._make_adam(cfg.training.num_epochs, 1, list(params.values()))

        def step():
            trainer._step(params, opt, gen, cfg.training.batch_size)

    def side(mode):
        return plain_fourier_features() if mode == "plain" else contextlib.nullcontext()

    def alloc():
        st = torch.cuda.memory_stats()
        return st.get("segment.all.allocated", 0), st.get("num_alloc_retries", 0)

    times = {"kernel": [], "plain": []}
    segments = {"kernel": [0, 0], "plain": [0, 0]}
    for r in range(rounds):
        for mode in (("kernel", "plain") if r % 2 == 0 else ("plain", "kernel")):
            with side(mode):
                step()  # warm
                before = alloc()
                for _ in range(steps):
                    evals = LBFGS.evaluations
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    step()
                    torch.cuda.synchronize()
                    ms = (time.perf_counter() - t0) * 1e3
                    times[mode].append(ms / (LBFGS.evaluations - evals) if lbfgs else ms)
                after = alloc()
                segments[mode] = [s + a - b for s, a, b in zip(segments[mode], after, before)]
    what = "ms per L-BFGS evaluation" if lbfgs else "ms per Adam step"
    summary = {"label": label, "unit": what, "rounds": rounds, "card": card}
    for mode, v in times.items():
        q1, med, q3 = statistics.quantiles(v, n=4)
        summary[mode] = {"median": med, "q1": q1, "q3": q3, "n": len(v),
                         "new_segments": segments[mode][0], "alloc_retries": segments[mode][1]}
        print(f"[{label}] {mode}: {what} median {med:.3f} q1 {q1:.3f} q3 {q3:.3f} over {len(v)} "
              f"in {rounds} rounds; allocator: {segments[mode][0]} new segments, "
              f"{segments[mode][1]} retries ({card})", flush=True)
    for mode in ("kernel", "plain"):
        with side(mode):
            step()
            torch.cuda.synchronize()
            prof = cProfile.Profile()
            prof.enable()
            step()
            torch.cuda.synchronize()
            prof.disable()
        text = io.StringIO()
        stats = pstats.Stats(prof, stream=text)
        stats.sort_stats("tottime").print_stats(18)
        summary[mode]["cprofile_s"] = stats.total_tt
        summary[mode]["cprofile_calls"] = stats.total_calls
        print(f"[{label}] {mode}: cProfile of one step, {stats.total_calls} calls, "
              f"{stats.total_tt:.3f} s\n" + text.getvalue().split("\n\n", 1)[-1].strip(), flush=True)
    return summary


def sampling_side(strategy: str, batch: int, label: str, capacity: int):
    """A sampling-harness run and the step of its program (Burgers, seed 0)
    past its warm-up (and capture, on the graph side)."""
    from pinnrl_tpu_torch.benchmarks import sampling

    ((base, variant),) = sampling.parse_strategies([strategy])
    run = sampling._Run("burgers", base, 10000, batch, 2e-3, 0, rl_variant=variant, device="cuda")
    program = run.program(run.pde, capacity)
    if label != "graph":
        program.path = "eager"
    program.warm_up()

    def step():
        if (program.eager_steps + program.replays) % capacity == 0:
            program.start_chunk()
        program.run()

    return run, step, program


def sampling_main(args, card: str, out: Path) -> list:
    """``--sampling``: each strategy at each batch, the two sides in turns
    (with ``--graph``) and profiled (see the module docstring)."""
    from chip_smoke import plain_fourier_features, plain_mlp_score

    results = []
    capacity = 64
    labels = ("eager", "graph") if args.graph else ("kernels", "plain")
    for batch in args.batch:
        for strategy in args.sampling:
            prefix = f"{'graph_' if args.graph else ''}sampling_{strategy}_b{batch}_"
            sides = {label: sampling_side(strategy, batch, label, capacity) for label in labels}
            if args.graph:
                results.append(in_turns({label: side[1] for label, side in sides.items()},
                                        args.steps, prefix, card))
            for label, (run, step, program) in sides.items():
                with contextlib.ExitStack() as plain:
                    if label == "plain":
                        plain.enter_context(plain_fourier_features())
                        plain.enter_context(plain_mlp_score())
                    res = profile(run, run.cfg, prefix + label, args.steps, args.profiled, out,
                                  card, step=step, settle=program.settle)
                res.update(strategy=strategy, batch=batch,
                           points_per_sec=batch / res["median_ms"] * 1e3, program=program.stats())
                print(f"[{prefix + label}] {res['points_per_sec']:.1f} points/s; step program: "
                      f"{program.stats()} ({card})", flush=True)
                run.release([program])
                results.append(res)
    return results


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=20, help="unprofiled steps timed after warm-up")
    ap.add_argument("--profiled", type=int, default=10, help="steps under torch.profiler")
    ap.add_argument("--out", default=str(REPO / "chiprun_out" / "profile"),
                    help="directory for the chrome traces and summary.json")
    kind = ap.add_mutually_exclusive_group()
    kind.add_argument("--rl", action="store_true", help="profile the RL-driven step")
    kind.add_argument("--rar", action="store_true", help="profile the Burgers recipe's RAR step")
    kind.add_argument("--ensemble", type=int, default=0, metavar="E",
                      help="profile a step of E members of the Burgers slice")
    kind.add_argument("--kdv", action="store_true", help="profile the KdV recipe's causal step")
    kind.add_argument("--siren-kdv", action="store_true",
                      help="profile a step of KdV as shipped (SIREN 124x7, nested jvp)")
    kind.add_argument("--heat", action="store_true", help="profile the heat recipe's step")
    kind.add_argument("--recipe", choices=("wave", "pendulum", "pendulum_nonlinear",
                                           "cahn_hilliard", "cahn_hilliard_dynamics",
                                           "cahn_hilliard_biharmonic"),
                      help="profile a step of this recipe (kernel 1 off its path)")
    kind.add_argument("--inverse", choices=("heat", "black_scholes"),
                      help="profile a step of this inverse recipe (kernel 1 off its path)")
    kind.add_argument("--sampling", nargs="+", metavar="STRATEGY",
                      help="profile the sampling harness's Burgers step under each strategy "
                           "(e.g. uniform 'adaptive[resfeat_improve]')")
    ap.add_argument("--batch", nargs="+", type=int, default=[1024],
                    help="with --sampling: the harness's batches")
    ap.add_argument("--alternate", type=int, default=0, metavar="ROUNDS",
                    help="with --recipe: kernel 2 and its plain version in turns on one trainer")
    ap.add_argument("--graph", action="store_true",
                    help="the step program, eager against captured and replayed")
    ap.add_argument("--lbfgs", action="store_true",
                    help="profile one L-BFGS iteration on all 40000 points (Burgers, or with --heat "
                         "the heat recipe)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_step_torch: no CUDA card", file=sys.stderr)
        return 2
    from chip_smoke import (burgers_recipe_config, heat_recipe_config, kdv_recipe_config,
                            lbfgs_program_for, nvidia_smi_line, plain_fourier_features,
                            plain_mlp_score, plain_siren, program_for, siren_kdv_config)
    from pinnrl_tpu_torch.benchmarks.convergence import build_recipe_config
    from pinnrl_tpu_torch.benchmarks.inverse import RECIPES as INVERSE_RECIPES
    from pinnrl_tpu_torch.benchmarks.inverse import build_inverse_config
    from pinnrl_tpu_torch.models import PINNModel
    from pinnrl_tpu_torch.pdes import create_pde
    from pinnrl_tpu_torch.training import PDETrainer
    from pinnrl_tpu_torch.training.train import make_agent

    card = nvidia_smi_line()
    out = Path(args.out)
    results = []
    if args.graph and args.alternate:
        ap.error("--graph takes no --alternate")
    if args.sampling:
        if args.lbfgs or args.alternate:
            ap.error("--sampling takes no --lbfgs or --alternate")
        results = sampling_main(args, card, out)
        name = f"{'graph_' if args.graph else ''}sampling_summary.json"
        (out / name).write_text(json.dumps({"card": card, "runs": results}, indent=1))
        if "jax" in sys.modules:
            raise AssertionError("profile_step_torch imported jax")
        return 0
    prefix = ("lbfgs_graph_" if args.lbfgs and args.graph else "lbfgs_" if args.lbfgs
              else "graph_" if args.graph else "") + (
        "rl_" if args.rl else "rar_" if args.rar else f"ensemble{args.ensemble}_" if args.ensemble
        else "kdv_" if args.kdv else "siren_kdv_" if args.siren_kdv
        else "heat_" if args.heat else f"{args.recipe}_" if args.recipe
        else f"inverse_{args.inverse}_" if args.inverse else "")
    configs = {"kdv_": kdv_recipe_config, "siren_kdv_": siren_kdv_config, "heat_": heat_recipe_config}
    if args.recipe:
        configs[f"{args.recipe}_"] = lambda device: build_recipe_config(args.recipe, device=device)
    if args.inverse:
        configs[f"inverse_{args.inverse}_"] = lambda device: build_inverse_config(args.inverse,
                                                                                  device=device)
    if args.alternate:
        if not args.recipe:
            ap.error("--alternate needs --recipe")
        cfg = configs[f"{args.recipe}_"]("cuda")
        trainer = PDETrainer(PINNModel(cfg, seed=0), create_pde(cfg), cfg)
        summary = alternate(trainer, cfg, prefix + "alternate", args.alternate, args.steps, card,
                            lbfgs=args.lbfgs)
        out.mkdir(parents=True, exist_ok=True)
        (out / f"{prefix}alternate.json").write_text(json.dumps(summary, indent=1))
        if "jax" in sys.modules:
            raise AssertionError("profile_step_torch imported jax")
        return 0
    # Kernel 1 takes neither the SIREN, nor a residual second order in time,
    # nor Cahn-Hilliard.
    kernel1 = not (args.siren_kdv or args.recipe or args.inverse)
    sides = []
    for label in (("eager", "graph") if args.graph else ("kernels", "plain")):
        cfg = configs.get(prefix.removeprefix("lbfgs_").removeprefix("graph_"),
                          burgers_recipe_config)("cuda")
        cfg.rl.enabled = args.rl
        if args.rar:
            cfg.training.collocation_distribution = "residual_based"
        if args.ensemble:
            cfg.training.ensemble_size = args.ensemble
            cfg.training.scheduler_type = "cosine"
        if label == "plain":
            cfg.training.fused_residual_kernel = "off"
        agent = make_agent(cfg) if args.rl else None
        pde = create_pde(cfg)
        if args.inverse:
            obs = INVERSE_RECIPES[args.inverse]["obs"]
            pde.generate_synthetic_observations(torch.Generator(device="cuda").manual_seed(1000),
                                                obs["num_points"], obs["noise"])
        trainer = PDETrainer(PINNModel(cfg, seed=0), pde, cfg, rl_agent=agent)
        if trainer.fused_kernel_active != (label != "plain" and kernel1):
            raise AssertionError(f"{label}: fused_kernel_active={trainer.fused_kernel_active}")
        if agent is not None:
            trainer._rl_state = trainer._init_rl_state(0)
        step = program = None
        if args.graph:
            make = lbfgs_program_for if args.lbfgs else program_for
            step, program = make(trainer, 5 + 2 * args.steps + args.profiled,
                                 graph=label == "graph")
        sides.append((label, cfg, trainer, step, program))
    if args.graph:
        results.append(in_turns({label: step for label, _, _, step, _ in sides}, args.steps,
                                prefix, card))
    for label, cfg, trainer, step, program in sides:
        with contextlib.ExitStack() as plain:
            if label == "plain":
                plain.enter_context(plain_fourier_features())
                plain.enter_context(plain_mlp_score())
                plain.enter_context(plain_siren())
            results.append(profile(trainer, cfg, prefix + label, args.steps, args.profiled, out, card,
                                   lbfgs=args.lbfgs, step=step,
                                   settle=program.settle if program is not None else lambda: None))
        if program is not None:
            results[-1]["program"] = program.stats()
            print(f"[{prefix + label}] step program: {program.stats()} ({card})", flush=True)
            program.release()
    (out / f"{prefix}summary.json").write_text(json.dumps({"card": card, "runs": results}, indent=1))
    if "jax" in sys.modules:
        raise AssertionError("profile_step_torch imported jax")
    return 0


if __name__ == "__main__":
    sys.exit(main())
