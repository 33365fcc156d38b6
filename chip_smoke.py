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
               path, and each kernel against its plain version; kernel 2 at
               the main path's three shapes by CUDA-graph replay and eager,
               beside an empty kernel on its grid (the launch floor) and the
               host cost of its eager call split by piece (``ff_host_split``).
  6. rl      — the same recipe with RL-driven sampling: an ``RLAgent`` with
               the shipped defaults (hidden 512) scores the 100x100 grid
               through ``fused_mlp_score`` on every step and takes its DQN
               update; 52 steps and 5 validations, with launch, buffer,
               epsilon and parameter checks.
  7. rar     — 4 steps of the recipe with residual-based (RAR) sampling.
  8. syncs   — host round trips of one RL step against one uniform step,
               counted under ``torch.cuda.set_sync_debug_mode("warn")``.
  9. timing  — ``fused_mlp_score`` against its plain version and cuBLAS by
               CUDA-graph replay (and its eager calls); each of its four
               launches apart, with the product's split and blocks; the
               product's layout A/B (W2^T n-contiguous against W2 as is)
               and split A/B (unsplit against two over K), in turns; median
               ms per RL step with the kernels and on the plain path.
 10. kdv     — the KdV convergence recipe (Fourier 256x3, mapping 256 with
               the shipped ``feature_seed`` 0 basis, batch 8192, causal
               eps 1.0, order-3 residual) through ``build_recipe_config`` ->
               ``create_pde`` -> ``PINNModel`` -> ``PDETrainer.train`` for 60
               Adam steps and 5 validations, then ``validate``; every
               residual loss goes through kernel 1's causal order-3 variant.
               Then kernel 1's KdV-causal parity on the trained parameters.
 11. kdv timing — host syncs of one warm KdV step (time sort included)
               against the uniform Burgers step; kernel 1 on KdV-causal loss
               + gradients against its plain version, and median ms per KdV
               step with the kernels and on the plain path.
 12. siren parity — kernel 3 against its plain version at the shipped
               SIREN's shapes ((2048, 2) -> 124, (2048, 124) -> 124 and
               (5000, 124) -> 124, omega 30); nested jvp at orders 1-3
               through kernel 3's and kernel 2's rules (the shipped SIREN and
               the heat recipe's Fourier network) against the plain
               functions; the parameter gradients of the order-3 KdV
               residual loss through kernel 3 against the plain path.
 13. siren-kdv — KdV exactly as shipped (``load_config(pde_type="kdv")``:
               SIREN 124x7, omega_0 30, batch 2048 of 5000, BC/IC 5000, Adam
               5e-3 cosine, weights 15/20/10) through ``create_pde`` ->
               ``PINNModel`` -> ``PDETrainer.train`` for 50 steps and 3
               validations, the residual through the generic engine (nested
               jvp); kernel 3 launches exactly 5 x 7 times per loss. The
               shipped learning rate makes this network's loss rise, as in
               the JAX package; a second run of 20 steps at lr 1e-4 must
               descend.
 14. heat      — the heat recipe (Fourier 256x3, mapping 128, scale 0.75,
               batch 8192 of 40000, BC/IC 4096) with Adam for 52 steps and 5
               validations: kernel 1's heat variant once per loss, kernel 2
               twice per loss (the periodic faces and the IC) and its jvp
               rule once (the periodic derivative matching).
 15. siren/heat timing — host syncs of one warm step of each; each new
               kernel against its plain version and cuBLAS; median ms per
               step with the kernels and on the plain path.
 16. gemm      — the products of one kernel-1 call (Burgers N=8192: 4
               streams, 256x3, mapping 128; KdV N=8192: 5 streams, mapping
               256) through two routes on the same operands, in turns
               (new, cuBLAS, cuBLAS, new): the GEMM core of
               ``csrc/sgemm_sm90.cuh`` and the output layer's row passes as
               kernel 1 runs them (``fr_gemm``, ``fr_rowdot``, ``fr_outer``,
               ``fr_wcolsum``), and ``torch.mm`` (TF32 off); each result
               against a float64 ``torch.mm``; device ms per product by
               CUDA-graph replay.
 17. lbfgs     — the Burgers and heat recipes as shipped, Adam then L-BFGS
               (``optimizer="adam_lbfgs"``), through ``run_convergence(key,
               seed=0, epochs=E, device="cuda")``: Burgers at 8 epochs (4 of
               RAR Adam, 16 steps; then 4 L-BFGS iterations on all 40000
               points), heat at 10 (4 Adam epochs, then 6 L-BFGS
               iterations). Kernel 1 must launch exactly once per Adam step,
               per L-BFGS evaluation and per validation; for heat, kernel 2's
               jvp rule too; the L-BFGS train loss must be finite and must not
               rise within the round (optax's approximate-decrease slack,
               1e-6 of the loss, aside); the phase replays its iterations,
               so its search makes no host read (``LBFGS.host_reads``).
 18. lbfgs timing — median ms per L-BFGS iteration of the Burgers recipe
               (N = 40000) with the kernels and on the plain path, in turns;
               the objective's evaluations per iteration; host syncs of one
               eager iteration under ``set_sync_debug_mode("warn")``, which
               must be its search's host reads (one per trial after the
               first, and one to stop: at most one per evaluation); kernel 1 at N = 40000
               against its plain version by CUDA-graph replay, with its bound
               and cuBLAS on its products.
 19. scope     — kernel 1's one-dimensional scope: its convection (x-order
               1, 3 streams), Allen-Cahn and Black-Scholes (to maturity)
               variants on their recipes' Fourier 256x3 trunks, plain and
               causal, at N = 8192 and N = 40000, and Black-Scholes as
               shipped (feedforward 128x7 with LayerNorm) at N = 8192, each
               against its plain version and bit-identical in two calls;
               each timed by CUDA-graph replay beside its plain version, its
               bound and cuBLAS on its products (N = 40000: the recipes as
               shipped, not causal).
 20. recipes   — the convection, Allen-Cahn, Black-Scholes and Allen-Cahn
               dynamics (spectral target, periodic BCs) recipes through
               ``run_convergence(key, seed=0, epochs=6, device="cuda")``: 3
               Adam epochs of 4 steps, then 3 L-BFGS iterations on all 40000
               points. Losses finite, falling over the run and not rising
               within the L-BFGS round; kernel 1 exactly once per loss,
               kernel 2 exactly twice per loss plus once for the final
               validate, its jvp rule once per loss for the periodic recipe;
               rel-L2 printed. Then 10 Adam steps of Black-Scholes as shipped
               (``load_config(pde_type="black_scholes")``): kernel 1 once per
               loss, kernel 2 never, finite losses.
 21. nd        — kernel 1 in two and three space dimensions and in a
               co-moving frame: heat_2d at its recipe's width (Fourier
               256x3, mapping 128, 6 stacked streams) at N = 8192 and 40000,
               causal, on a feedforward 256x3 trunk and in a frame of speed
               0.7; the Burgers recipe in that frame (one dimension); every
               residual in two dimensions and heat in three (64x48, mapping
               32, N = 4096). Each against its plain version and
               bit-identical in two calls; the full-width ones timed by
               CUDA-graph replay beside the plain version, the bound and
               cuBLAS on their products.
 22. heat_2d   — the heat_2d recipe through ``run_convergence("heat_2d",
               seed=0, epochs=6, device="cuda")``: 3 Adam epochs of 4 steps,
               then 3 L-BFGS iterations on all 40000 points. Losses finite,
               falling, not rising within the L-BFGS round; kernel 1 exactly
               once per loss; kernel 2 on the (N, 3) BC and IC points (basis
               (3, 128)) exactly twice per loss plus twice for heat's
               ``validate``, its jvp rule never.
 23. second order — float64 parameters with float32 points on the Burgers
               recipe take the plain path (kernel 1 never launches); kernel 2
               and its jvp rule (orders 1-2 along t) against their plain
               versions at (4096,2)x(2,128) with B's x-row zero (the pendulum
               recipes' basis); then the wave, pendulum and
               pendulum_nonlinear recipes through ``run_convergence(key,
               seed=0, epochs=6, device="cuda")``: 3 Adam epochs of 4 steps,
               then 3 L-BFGS iterations on all 40000 points, the residual on
               the plain bundle (temporal order 2). Losses finite, falling,
               not rising within the L-BFGS round; kernel 1 never; kernel 2
               exactly three times per loss (BC, IC, velocity IC) plus once
               for ``validate``, its jvp rule once per loss; the same counted
               alone for one Adam step, one L-BFGS iteration and one
               ``validate``; host syncs 0 per Adam step and one per L-BFGS
               evaluation; median ms per Adam step and per L-BFGS iteration
               with kernel 2 and on the plain path, in turns, and the plain
               bundle's residual loss and gradients at N = 40000 by CUDA-graph
               replay, with its share of an L-BFGS iteration.
 24. shipped  — wave as shipped (``load_config(pde_type="wave")``: SIREN
               124x7, omega_0 30, batch 2048 of 5000): kernel 3 against its
               plain version at its shapes on wave's weights, wave's order-2
               residual loss and gradients through kernel 3 against the plain
               path, then 6 Adam steps and a validation with kernel 3
               exactly 5 x 7 times per loss; the pendulum as shipped (ResNet
               512x7 on the generic engine) for 6 Adam steps, no kernel;
               finite losses and ``validate`` metrics.
 25. cahn-hilliard — the three Cahn-Hilliard recipes through
               ``run_convergence(key, seed=0, epochs=E, device="cuda")``:
               the 2-D headline (attention 124x4, the mixed form, Dirichlet
               and Neumann; Adam only) for 12 steps, the dynamics (Fourier
               256x3, the mixed form against its ETDRK4 trajectory, mass and
               mu-H2 penalties, causal) for 12 Adam steps and 3 L-BFGS
               iterations on all 40000 points, the biharmonic (Fourier
               128x3, the direct form: four nested jvps) for 9 Adam steps and
               1 L-BFGS iteration. Losses finite, falling, not rising within
               the L-BFGS round; the penalties in the dynamics loss; kernel 1
               never; kernel 2 exactly ``CH_FF_PER_LOSS`` per loss (launches,
               jvp-rule calls) and once per ``validate``, also counted alone
               for one Adam step, one L-BFGS iteration and one ``validate``;
               host syncs 0 per Adam step and at most one per evaluation of
               an eager L-BFGS iteration (none in the replayed runs);
               median ms per Adam step and per L-BFGS iteration with kernel 2
               and on its plain version, in turns.
 26. order 4  — kernel 2's jvp rule nested to order 4 along x on the
               biharmonic recipe's network (its basis's t-row zero) against
               the plain version at each order, and kernel 2 timed there at
               (4096,2)x(2,64) by CUDA-graph replay; the direct residual, its loss
               and every parameter gradient through kernel 2 (N = 4096), and
               the dynamics recipe's mixed residual and gradients (N = 8192),
               against the plain version.
 27. shipped CH — Cahn-Hilliard as shipped (``load_config(pde_type=
               "cahn_hilliard")``: ResNet 512x7, the direct form in 1-D, the
               random IC, Dirichlet and Neumann) for 4 Adam steps: finite, no
               kernel.
 28. inverse — both ``benchmarks/inverse.py`` recipes as shipped (Fourier
               128x3, mapping 64, batch 4096 of 20000, BC/IC 2048, 2000
               observations at 1% noise; heat's alpha, Black-Scholes' sigma
               and r), cut to 200 of their 2000 epochs, through
               ``run_inverse``: kernel 1 never (live coefficients), kernel 2
               three times per loss (heat with one jvp-rule call), every
               coefficient nearer the truth at the end than at the start, 0
               host syncs per Adam step; kernel 2 against its plain version
               on the data term's (2000,2)x(2,64) and on the loss's gradients
               (each coefficient's and every leaf's); Adam-step ms with kernel
               2 and plain, in turns.
 29. data_augmented — the Burgers recipe for 6 epochs forward and with 2000
               synthetic observations: kernel 1 once per Adam step, L-BFGS
               evaluation and validation in both, kernel 2 twice and three
               times per loss; the data_augmented loss and gradients with
               kernel 1 against the plain path.
 30. cli     — ``training.train.main`` in-process in a temporary directory:
               heat inverse and Burgers on the shipped Fourier 512x4 trunk
               (mapping 512) with ``--rl``, 4 epochs each: the experiment
               directory's files, metadata, history and exact launches of
               kernels 1, 2 and 4 (one more kernel-2 launch per validation for
               the live snapshot, and for heat one for ``fdm_comparison.json``;
               ``report.html`` in both), kernel 1 at 512x4 against its plain
               version, ``final_model.npz`` and ``rl_agent.npz`` loaded back;
               then ``benchmarks.cli inverse --pde heat --epochs 4 --csv``.
 31. sampling — ``benchmarks/sampling.py``'s ``run_sampling_benchmark`` at
               the harness's own width (64x3 Fourier MLP, mapping 32; DQN
               hidden 64, replay 4096, batch 64), batch 1024: Burgers under
               every strategy, ``adaptive[resfeat_improve]`` and a
               ``windows=2`` run, and wave (kernel 2's jvp rule), 30 and 12
               steps: kernel 1 never, kernel 4 once per adaptive step,
               kernel 2 per BC/IC loss and per ``_evaluate`` (the warm-up
               copy's steps counted too), each strategy's loss falling; ms
               per step, points/s and host syncs per step per strategy;
               kernel 4 at (10000, 2) and (10000, 3) -> 64 on the harness's
               agents and kernel 2 at mapping 32 on its BC, IC and
               evaluation rows against their plain versions (and kernel 2's
               jvp rule at orders 1-2), timed by CUDA-graph replay beside
               the bound and, for kernel 4, cuBLAS's three products.
 32. fdm     — ``benchmarks.cli fdm --pde all`` on the card; each solve's
               L2 error and field against a CPU run of the same solve;
               both stability guards raise.
 33. operator — in a temporary ``PINNRL_WELL_CACHE``: the point-wise
               ``run_operator_benchmark("synthetic_heat_2d")`` (the
               registry's FNO 256x4, 16 modes, 8192 points, 6 epochs; no
               kernel; the training loss falls), the gridded run (width 32,
               12 modes, 4 blocks, 40 steps, a 96^2 transfer row),
               ``GridFNO2D`` on the card against the CPU on the same weights
               (48^2 and 96^2), and ``training.train --pde heat_2d
               --dataset synthetic_heat_2d --epochs 2``.
 34. levers  — the Burgers recipe slice (phase 4's: Fourier 256x3,
               mapping 128, batch 8192 of 40000, uniform), 4 epochs per
               lever, each run's launches counted: RBW and LRW adaptive
               weights (kernel 1 exactly once per step and validation, the
               weighted loss finite and falling, the weights summing to 1);
               ``reduce_lr`` with patience 1 at lr 1e-2 (the scale after
               every step printed; it must drop); ``param_ema`` 0.99 with adam_lbfgs
               (phase 2 must start from the debiased average; kernel 1 once
               per Adam step, L-BFGS evaluation and validation); the
               smoothness and gPINN penalties at 0.1 (kernel 1 per loss,
               kernel 2's jvp rule under gPINN); a run checkpointed at epoch
               2 and resumed in a fresh trainer, against the uninterrupted
               run (bit-identity printed; within 1e-6); ``profile_dir`` (a
               Chrome trace of the second chunk, its device kernel events
               counted); host syncs of one Adam step under each of RBW, LRW,
               the plateau, EMA and the penalties: none.
 35. marching — ``run_time_marching("kdv", n_windows=4,
               epochs_per_window=2)`` at the recipe's width (Fourier 256x3,
               mapping 256, ``feature_seed`` 0, batch 8192, causal): per
               window kernel 1 once per loss and kernel 2 twice per loss (the
               Dirichlet faces and the IC), three times from window 1 on
               (the inherited IC through the previous window's model); each
               window's parameters unchanged by the later windows;
               ``benchmarks.cli convergence --pde heat --time-marching 2
               --epochs 8``; ``run_multistage`` on the heat recipe with one
               correction stage, 4 epochs each (kernel 1 on stage 0 only;
               the base unchanged); hard IC on the wave recipe and on the
               Burgers slice, 3 epochs (the IC loss under 1e-10, kernel 1
               never); ``CollocationAgent`` on the card, 5 updates.
 36. basis   — the Burgers recipe slice with ``trainable_features``, 2
               epochs: kernel 1 exactly once per step and validation, B a
               parameter that moves, the loss falling; kernel 1's dL/dB (and
               every gradient) through the CUDA launcher against its plain
               twins (``_TorchOps``) on the same card tensors at N = 8192 and
               40000 (1e-4 relative to max, bit-identical in two calls);
               kernel 1 with and without dL/dB and the dB variant's plain
               version by CUDA-graph replay, beside the added work's bound
               and cuBLAS's (a) and (c) products.
 37. ensemble — the same slice with ``ensemble_size`` 4, 2 epochs: kernel 1
               exactly once per step and validation for all 4 members (one
               member-batched call, serving 4 members each; every kernel
               runs the members on its member axis), every leaf with a
               member axis, finite falling member-mean losses; that call at
               N = 8192 per member against 4 single calls (bit-identical)
               and the float64 twins (FUSED_TOLS), bit-identical in two
               calls, timed by CUDA-graph replay beside the 4 single calls,
               the plain (vmapped) version, cuBLAS's torch.bmm of the same
               products and its bound; median ms per step at E = 1 and E = 4
               in turns; no host sync per step; kernel 1 on 3 small stacked
               members of every kind of entry point (``MEMBER_CASES``);
               kernels 2 and 3 member-batched (B (4, 2, 128), W (4, 124,
               124)) against their plain versions and per-member launches,
               one launch through their vmap rules, timed; and the vmapped
               residual path of a SIREN and a trainable-basis ensemble (one
               launch per layer for all members, one epoch trained).
 38. trunks  — the modified Fourier trunk (256x3, mapping 128), the
               autoencoder as shipped (124/248/124, latent 64) and the
               slice with dropout 0.1, 2 epochs each: kernel 1 never on the
               two trunks (the generic engine; kernel 2 inside it on the
               modified one) and once per loss under dropout (identity on
               every trainer path).
 39. plots   — ``training.train.main`` for heat (``save_plots`` on, 2
               epochs) in a temporary directory: ``report.html`` and
               ``fdm_comparison.json`` written, the run completed, the PNGs
               present exactly when matplotlib imports.
 40. float64 — the Burgers recipe slice with ``adam_lbfgs`` and
               ``residual_dtype="float64"``, 4 epochs: 2 Adam epochs (kernel
               1 once and kernel 2 twice per loss), then 2 float64 L-BFGS
               iterations on all 40000 points (kernel 1 and kernel 2 never;
               kernel 2's float64 plain calls counted: BC and IC per
               evaluation and validation); float64 parameters in the phase,
               float32 ``model.params`` and a float64 final state at the
               end; one float64 loss and its gradients at N 8192, card
               against CPU (1e-10 relative); kernels 2 and 3 on float64 and
               float32 CUDA tensors (the dtype gate); one L-BFGS iteration
               at N 40000 in float64 and in float32 on the plain bundle, in
               turns.
 41. mesh    — ``make_mesh()`` as a world of 1 under NCCL (a ``file://``
               store in a temporary directory): the slice for 2 epochs with
               and without the mesh, histories within 1e-6 and kernel 1's
               launches equal; then 2 ranks sharing the card through gloo
               (spawned processes), each against the unsharded run, or the
               error that gloo gave.
 42. dashboard — a ``DashboardServer`` on a free localhost port in a thread:
               ``POST /api/launch`` a 2-epoch heat run on the card, poll
               ``/api/experiments`` until it completes (120 s deadline),
               then fetch its history, snapshot, the solution explorer (9
               forward calls on the card, one kernel-2 launch each) and the
               report; the launched process has ended.
 43. activations — kernel 1 with gelu (flax's tanh approximation),
               sigmoid, silu and sin (tanh beside them): the CUDA launcher
               against its plain twins (``_TorchOps``) run in float64 on the
               same card tensors, at FUSED_TOLS' bounds, on the Burgers
               recipe's width (Fourier 256x3, mapping 128) at N = 8192 and
               40000, with LayerNorm off and with a trainable basis, KdV
               causal (order 3) and heat_2d (d = 2) at their recipes' widths
               and Black-Scholes's shipped feedforward 128x7; the float32
               twins' gap to float64 printed beside, two calls bit-identical;
               each activation timed at N = 8192 and 40000 by CUDA-graph
               replay beside the plain version, its bound (the GEMMs and the
               activation's derivatives) and cuBLAS on its products; ptxas's
               registers and spills of the transport kernels (one kernel per
               (D, K) for every activation). Then the Burgers recipe with
               gelu through ``PDETrainer`` (adam_lbfgs, 6 epochs: kernel 1
               exactly once per Adam step, L-BFGS evaluation and validation)
               beside the same run on the plain path, sigmoid and silu on the
               Burgers slice (2 epochs), sin on the shipped Fourier 512x4
               (mapping 512; 2 epochs of 2 steps), each with exact kernel-1
               launches, and silu on the wave recipe (temporal order 2: the
               bundle, kernel 1 never).
 44. nd4     — kernel 1 in four or more space dimensions (the ``*_nd``
               kernels, d a run-time argument): ptxas's registers and spills
               of each (none may spill); every residual at d = 4 (KdV: 14
               stacked streams), heat at d = 5 and 8, heat at d = 4 on the
               feedforward trunk and with causal weights, a frame of speed
               0.7, a trainable basis and gelu together (64x48, mapping 32,
               N = 4096), and heat-4D on the shipped Fourier trunk (512x4,
               mapping 512, tanh + LayerNorm, 10 stacked streams) at N = 8192
               and 40000, each against its plain twins run in float64 and
               bit-identical in two calls; heat-4D timed by CUDA-graph replay
               beside the plain version, its bound, its products on the
               GEMM core and on cuBLAS and the kernels' peak memory; kernel
               2 at (8192,5) x (5,512), its edge path, against plain and
               timed; the basket below (feedforward 128x7) at its Adam batch
               (2048) and its validation points (1000) against its plain
               twins in float64. Then through
               ``PDETrainer``: heat-4D (heat_2d's block on [0, pi]^4 with the
               ``sin_exp_decay`` IC, exact solution and Dirichlet BC) with
               ``adam_lbfgs`` for 4 epochs (8 Adam steps of 8192, 2 L-BFGS
               iterations on all 40000 points), and Black-Scholes as shipped
               (feedforward 128x7) on a basket of 4 assets for 3 epochs of 2
               Adam steps: kernel 1 exactly once per Adam step, L-BFGS
               evaluation and validation, kernel 2 exactly twice per loss on
               the heat path, finite losses.
 45. generated — kernel 1's generated residual (any registered PDE's
               ``residual_pointwise`` traced by ``residual_codegen`` and
               compiled into ``csrc/residual_generated.cuh``'s kernel):
               user PDEs that subclass shipped classes, registered with
               ``@register_pde`` (``register_user_pdes``: Fisher-KPP with
               its Ablowitz-Zeppetella traveling wave, an advection whose
               velocity sin(x) is read from z, Burgers with a sin(x)
               forcing that keeps ``pde_type = "burgers"``, a first-order
               ODE with no x-group, a steady problem); no generated
               residual launched in phases 1-44, where the six shipped PDEs
               take their hand residuals. Every program built by nvcc in
               parallel, ptxas's registers and spills of each (none may
               spill); each generated kernel alone against its program's
               float64 twin (N 8192, plain and causal), bit-identical in two
               calls; kernel 1 through the generated residual against its
               plain twins run in float64: Fisher-KPP (plain and causal) and
               the forced Burgers on the Burgers recipe's width (Fourier
               256x3, mapping 128) at N = 8192 and 40000, Fisher-KPP in two
               dimensions on heat_2d's trunk, and small (64x48, mapping 32,
               N = 4096) the z-reading advection at d = 1 and 4, the ODE on
               both trunks, with a trainable basis and at d = 4, the steady
               problem. Burgers timed by CUDA-graph replay at N = 8192 and
               40000 through the generated residual against burgers_kernel
               (in turns), each residual kernel alone, the plain version
               and the bounds. Then through ``PDETrainer``: Fisher-KPP on
               the Burgers recipe's width with ``adam_lbfgs`` for 4 epochs
               (8 Adam steps of 8192, 2 L-BFGS iterations on all 40000
               points) and in two dimensions on heat_2d's trunk for 2 Adam
               epochs: kernel 1 and the generated residual exactly once per
               Adam step, L-BFGS evaluation and validation, finite losses,
               the 1-D loss falling. Selects (``select_runs``): two more user PDEs
               whose residuals run selects, comparisons and clamps, built in
               the same parallel nvcc build: Allen-Cahn with u clamped at
               +-10 on the allen_cahn recipe and Burgers with clamp, where,
               maximum, minimum, relu, a viscosity switched on x_0, atan2,
               asinh, log10, erfc and softplus on the Burgers recipe, each
               against the float64 twins at N = 8192 and 40000 (the select
               Burgers causal too); the select Burgers kernel alone on NaN
               and +-inf points, its NaNs and infinities where its twin's;
               the clamped Allen-Cahn call against the hand allen_cahn call
               and the select residual alone against the Burgers residuals
               (its launch floor), in turns; the clamped Allen-Cahn trained
               as Fisher-KPP is, with exact launches and a falling loss.
 46. graph   — every Adam phase of ``PDETrainer.train`` runs from one
               captured CUDA graph of its step, replayed once per step
               (``training/step_program.py``), in every phase above too.
               Here, each against the same run on the eager step program
               (``eager_steps``: it never captures), same seed: the
               Burgers recipe at full width with RAR, 2 chunks of 5 epochs
               (40 Adam steps), and cut to 2 chunks of 2 epochs uniform
               with the DQN agent, 4 members, the plateau (patience 1, lr
               1e-2) with EMA 0.99 and LRW, KdV on a SIREN 124x3, and
               Fisher-KPP through the generated residual. Each run is
               profiled: the device launches of kernels 1-4 and the
               generated residual are counted by kernel name in its trace
               (``GRAPH_KERNELS``). Each must capture after its warm-up
               step and replay the rest; count every kernel's launches as
               the eager run does, kernel 1 once per step and validation,
               with the trace witnessing each count (never more, at most
               ``TRACE_LOSS`` fewer: the profiler can drop an event);
               read the host once per chunk and never in a replayed step
               (``set_sync_debug_mode``; an eager step's syncs, such as a
               process's first fill of the samplers' caches, are listed
               apart); and equal the eager run bit for
               bit (the largest differences printed). Then ms per step of
               the RAR step in turns: the
               replayed step, the eager program, and the eager program with
               the Adam class it replaced (``parent_adam``); a graph run
               resumed from its first chunk's checkpoint against the
               uninterrupted one; and, in a subprocess, a step with a host
               read forced into it, which must raise at the capture after
               one eager step (no fallback).
 47. lbfgs graph — every L-BFGS phase replays its iteration
               (``training/step_program.py``, ``Search``): start, the
               line-search trial under a CUDA-graph IF node on ``active``
               (``csrc/graph_cond.cu``) 25 times, finish. The Burgers
               recipe at full width (RAR Adam 3 epochs, then 3 L-BFGS
               iterations on all 40000 points, chunks of 2 and 1), heat
               (kernel 2's jvp rule), wave (the plain t-order-2 bundle),
               Burgers with a float64 L-BFGS phase, with the DQN agent
               (its update after every iteration) and with a new round
               every 2 iterations (4 iterations), each against the eager
               program (``eager_steps``: every trial guarded by a host
               read), same seed: bit-identical histories, parameters,
               accepted stepsizes and trial counts per iteration (recorded
               on the device by ``finish``, ``search_record``),
               evaluations and launches; each kernel's device launches in a
               traced graph run, in a process of its own
               (``lbfgs_traced_case``), witnessing its counter; one host read per
               chunk and none in a replay; no search read
               (``LBFGS.host_reads``) on the graph path. Then a pure
               L-BFGS run resumed from its first chunk's checkpoint
               against the uninterrupted one, and ms per iteration of
               Burgers, heat and wave in turns (graph, eager, eager,
               graph; ``lbfgs_program_for``) with each side's device busy
               share and launches under the profiler, capture seconds and
               bytes.

Phase 2 prints ``ptxas``'s report (registers, shared memory, stack frame,
spills) for every kernel and fails unless each library that runs the GEMM
core (kernels 1, 3 and 4) has core kernels and none of them spills, and
unless kernel 2's four instantiations (d = 1..3 and the edge path) are
built without spills. Phase 3 holds kernel 2 against its plain version at
the main path's shapes ((4096,2)x(2,128), (4096,2)x(2,256), (20000,2)x(2,128))
and at a ragged (4999,3)x(3,127) with x and B one float past a 16-byte
boundary, each bit-identical in two calls, and kernel 1 against its plain
version in six variants: Burgers, heat and KdV, each plain and causal (eps
1.0), at N = 8192, and KdV-causal again
at N = 5000 (not a multiple of the scan block); Burgers and heat again at
N = 40000 (the L-BFGS phase's batch); Burgers and KdV-causal at 8192, and
Burgers and heat at 40000, must give bit-identical loss and gradients in two
calls on the same inputs (L-BFGS needs a deterministic objective); and
kernel 4 against its plain version at three widths, with its product's
split as chosen and forced to each setting, bit-identical in two calls.

The second-to-last line is a JSON object describing each kernel: its
``launches`` are those of the RL slice for kernels 1, 2 and 4 (the path
that runs all three) and of the siren-kdv slice for kernel 3, as the
wrappers count them (a replayed step counts on the device, in the step
program's tally); ``launches_in_trace`` the same runs' launches counted
by kernel name in a ``torch.profiler`` trace (``device_launches``), which
must witness the counts (``trace_agrees``: never more, at most
``TRACE_LOSS`` fewer, as a trace can drop an event);
``kdv_launches`` and ``heat_launches`` those of the KdV and heat slices;
``ms`` and ``plain_ms`` device time per call by CUDA-graph replay (the
kernels' eager calls are host-bound: ``eager_ms``); ``bound_ms`` the larger
of its operations over the card's FP32 peak and its bytes over the memory
rate, for the shapes it is timed at; ``library_ms`` the cuBLAS FP32
products of the same shapes by CUDA-graph replay (``library_call`` says
which). Kernel 1's entry also carries phase 16's summed ms per PDE:
``gemm_ms`` (its products as it runs them) and ``gemm_library_ms``, and
the L-BFGS phase's numbers: ``lbfgs_launches`` (phase 17, per recipe),
``n40000_ms``, ``n40000_plain_ms``, ``n40000_bound_ms`` and
``n40000_library_ms`` (phase 18) and ``lbfgs_iteration_ms`` (kernels and
plain), ``lbfgs_evaluations_per_iteration`` and
``lbfgs_syncs_per_iteration``, phase 19's ``scope_1d`` (per variant: its
streams, trunk, ``ms``, ``plain_ms``, ``bound_ms``, ``bound_by``,
``library_ms``, and the same with ``n40000_``), phase 20's
``scope_1d_launches`` (per recipe: kernel 1's and kernel 2's launches, the
jvp rule's, the L-BFGS evaluations, rel-L2 and wall seconds), phase 21's
``scope_nd`` (per variant: its dimension, streams, frame speed, trunk and,
at full width, the timings as ``scope_1d``'s) and phase 22's
``heat_2d_launches``, phase 23's ``second_order_launches`` (0 per recipe),
``float64_params_launches`` and phases 25 and 27's ``cahn_hilliard_launches``
(0 per recipe); kernel 2's carries its phase-17 launches
and heat's jvps (``lbfgs_launches``), its phase-22 launches and phase 23's
``second_order`` (per recipe: launches, jvps, evaluations, ``per`` step,
host syncs, Adam-step and L-BFGS-iteration ms with the kernel and plain,
the bundle's ms and share of an iteration, rel-L2 and wall seconds), ``zero_x_row`` (its timing there),
phase 25's ``cahn_hilliard`` (per recipe: the run's launches and jvps, per
loss and per step, host syncs, Adam-step and L-BFGS-iteration ms with the
kernel and plain, rel-L2 and wall seconds), phase 26's ``order4`` (each
order's error, the residuals' and gradients') and phase 27's
``cahn_hilliard_shipped_launches``, phase 28's ``inverse`` (per recipe:
launches, jvps, identified values, syncs, the data term's timing and
errors, Adam-step ms), phase 29's ``data_augmented_launches`` and phase
30's ``cli_launches``; kernel 1's also ``inverse_launches`` (0),
``data_augmented`` (per mode) and its parity there, ``cli_launches`` and
``shipped_fourier_512`` (its parity on the shipped trunk); kernel 4's
``cli_launches``, and ``sampling`` (phase 31: its shapes' parity and
timings, its launches per run); kernel 2's ``sampling`` the same and the
harness's rows; kernel 1's ``sampling_launches`` and ``operator_launches``
(0); kernel
3's carries ``blocks``, the thread blocks it launches at (2048, 124) -> 124,
and phase 24's ``wave_launches``, ``wave_max_abs_err`` and
``shipped_second_order``, and phases 25 and 27's ``cahn_hilliard_launches``;
kernel 4's ``launch_ms`` (each launch), ``splits`` (the launcher's choice,
``mlp._product_split``) and ``blocks`` of its product (read from the
launch's own grid, ``ms_gemm_blocks``), and phase 9's A/Bs
``product_ab_ms`` and ``split_ab_ms``. Kernel 2's carries ``floor_ms`` (the
empty kernel on its grid), ``shapes`` (ms, plain, eager and bound at each
shape timed), ``host_us`` (the split of its eager call) and ``ptxas``.
A ``[harnesses]`` line before it carries phases 31-33's rows, a
``[levers]`` line phases 34-35's (kernel 1's entry carries their launches,
``resume`` and, per window, ``kdv_time_marching_launches``; kernel 2's
its launches there), and a ``[trunks]`` line phases 36-39's (kernel 1's
entry carries ``trainable_basis_launches``, ``trainable_basis`` (its
parity and timings), ``ensemble_launches``, ``ensemble_step_ms`` and
``trunk_launches``; kernel 2's its ``trunk_launches``), and a
``[slice17]`` line phases 40-42's: kernel 1's entry carries
``float64_launches`` (before the switch and in the float64 phase),
``float64_card_vs_cpu``, ``float64_lbfgs`` (iteration ms, float64 and the
float32 plain bundle) and ``mesh_launches`` (the NCCL world of 1 and each
gloo rank); kernel 2's ``float64`` (launches before and in the phase, its
plain calls there, the dtype gate), ``mesh_launches`` and
``dashboard_solution_launches``; kernel 3's ``float64_gate``; kernel 4's
``float64_launches`` (0: no agent in phase 40). Kernel 1's entry also
carries phase 43's ``activations`` (per activation: ``launches`` on its
run, ``max_abs_err`` against the float32 twins and ``max_abs_err_f64``,
``parity`` per case, ``ms``, ``plain_ms``, ``bound_ms``, ``library_ms`` and
their ``n40000_`` twins, ``ptxas`` per transport kernel, and the run's
losses) and phase 44's ``nd4`` (``ptxas`` per d >= 4 kernel, ``parity`` per
small case, ``heat_4d`` per N: parity, ``ms``, ``plain_ms``, ``bound_ms``,
``library_ms``, ``gemm_core_ms`` and peak memory, ``basket_4`` per N:
parity, ``runs`` with their
launches and losses) and phase 45's ``generated`` (``ptxas`` and build
seconds per program, ``residual_alone`` per program, ``parity`` per case,
``burgers_ab`` per N: kernel 1's ``ms`` with the generated residual and
``hand_ms`` with burgers_kernel, ``plain_ms``, ``bound_ms``, the residual
kernels alone, ``fisher_residual`` per N, ``runs`` with their launches and
losses, ``k1i``: the select programs' ``ptxas``, ``nan_parity``,
``allen_cahn_ab`` and ``select_alone`` per N, the clamped Allen-Cahn
``run``), summed up in kernel 1's ``generated_selects``;
kernel 2's entry carries ``nd4_edge`` (its time at (8192,5) x (5,512)) and
``nd4_launches``. Kernel 1's entry carries phase 46's ``graph`` (per case:
the device launches counted in the trace and per step, bit-identity, host
reads per chunk, the step program's path, eager steps, replays, capture
seconds and bytes) and
``graph_ms_per_step``, and phase 47's ``lbfgs_graph`` (per case: traced
and counted launches, evaluations, trials per iteration, bit-identity,
host reads per chunk, the L-BFGS programs' stats) and ``lbfgs_graph_ms``
(per timed case and side: ms, busy ms, idle share, device launches per
iteration); ``[graph]`` and ``[lbfgs graph]`` lines before the last two
carry the whole phases. The last line is
``{"ok": true, "device": {...}}``. Imports no JAX.
"""

from __future__ import annotations

import contextlib
import json
import linecache
import math
import re
import statistics
import subprocess
import sys
import time
import traceback
import warnings
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

# The Burgers recipe: 13 epochs x 4 steps of batch 8192 on 40000 points = 52 steps.
EPOCHS = 13
# The KdV recipe: 5 epochs x 12 steps of batch 8192 on 100000 points = 60 steps.
KDV_EPOCHS = 5
# KdV as shipped: 25 epochs x 2 steps of batch 2048 on 5000 points = 50 steps.
SIREN_EPOCHS = 25
# Descent check of the shipped SIREN at a learning rate it descends at: 20 steps.
SIREN_DESCENT_EPOCHS = 10
SIREN_DESCENT_LR = 1e-4
# The heat recipe: 13 epochs x 4 steps of batch 8192 on 40000 points = 52 steps.
HEAT_EPOCHS = 13
SIREN_TOL = 1e-5    # rel to max: the JAX suite's bound for its SIREN kernel
JVP_TOL = 1e-4      # order k: JVP_TOL x 10^(k-1) rel to max (the JAX suite's kernel jvp bounds)
SIREN_GRAD_TOL = 1e-3  # each gradient of the order-3 residual loss, rel to its max
# Phase 16, rel to max |float64 ref|: an FP32 sum of K terms in another order
# drifts by about sqrt(K) eps; 1e-5 for K <= 512, 1e-4 for the dW products
# over K = 32768 / 40960 stacked rows.
GEMM_TOL, GEMM_TOL_LONG_K = 1e-5, 1e-4
# The card's peaks for the bounds (NVIDIA H100 SXM data sheet, 700 W): FP32
# outside the tensor cores (TF32 is excluded by the port's precision rule)
# and HBM3.
FP32_FLOPS = 67e12
HBM_BYTES_S = 3.35e12
FF_TOL = 1e-5       # rel to max |ref|: sincosf vs torch's sin/cos, same f32 inputs
MLP_TOL = 1e-4      # rel to max |ref| (the JAX suite's bound for the MLP scorer kernel)
RAR_STEPS = 4       # one epoch of 4 steps
# Phase 17: the recipes through run_convergence, Adam then L-BFGS: Burgers 4 +
# 4 epochs (switch ratio 0.5), heat 4 + 6 (0.4). Phase 18: L-BFGS iterations
# timed per path and turn, after 2 warm-up iterations.
LBFGS_EPOCHS = {"burgers": 8, "heat": 10}
LBFGS_TIMED = 6
LBFGS_N = 40000     # the recipes' collocation points: the L-BFGS batch
APPROX_DEC_RTOL = 1e-6  # optax's approximate-decrease slack of the zoom line search
# Kernel 1, (loss rel, each gradient rel to its max |ref|): sums run in another
# order than the plain version's. The JAX suite's bounds: fused kernel 1e-5 /
# 1e-4, causal 1e-4 / 1e-3 (tests/test_pallas_parity_tpu.py:152-155, 186-189),
# order 3 2e-4 on the loss (tests/test_kernels.py:271-273).
FUSED_TOLS = {"burgers": (1e-5, 1e-4), "burgers_causal": (1e-4, 1e-3),
              "heat": (1e-5, 1e-4), "heat_causal": (1e-4, 1e-3),
              "kdv": (2e-4, 1e-3), "kdv_causal": (2e-4, 1e-3),
              "convection": (1e-5, 1e-4), "convection_causal": (1e-4, 1e-3),
              "allen_cahn": (1e-5, 1e-4), "allen_cahn_causal": (1e-4, 1e-3),
              "black_scholes": (1e-5, 1e-4), "black_scholes_causal": (1e-4, 1e-3),
              "black_scholes_ff": (1e-5, 1e-4),
              **{k: (1e-4, 1e-3) if k.endswith("causal") else (1e-5, 1e-4)
                 for k in ("heat_2d", "heat_2d_causal", "heat_2d_ff", "heat_2d_frame",
                           "burgers_frame", "burgers_2d", "heat_3d", "convection_2d",
                           "allen_cahn_2d", "black_scholes_2d")},
              "kdv_2d": (2e-4, 1e-3)}
# Phase 19: kernel 1's one-dimensional scope. The recipes' variants (Fourier
# 256x3, mapping 128: convection with 3 stacked streams, Allen-Cahn and
# Black-Scholes to maturity with 4), plain and causal, and Black-Scholes as
# shipped (feedforward 128x7 with LayerNorm, calendar time).
SCOPE_VARIANTS = ("convection", "convection_causal", "allen_cahn", "allen_cahn_causal",
                  "black_scholes", "black_scholes_causal", "black_scholes_ff")
# Phase 20: the four recipes through run_convergence, 3 Adam epochs (12 steps)
# then 3 L-BFGS iterations; Black-Scholes as shipped for SHIPPED_BS_EPOCHS
# epochs of 2 Adam steps (batch 2048 of 5000).
SCOPE_RECIPE_EPOCHS = 6
SCOPE_RECIPES = ("convection", "allen_cahn", "black_scholes", "allen_cahn_dynamics")
SHIPPED_BS_EPOCHS = 5
# Phase 21: kernel 1 beyond one dimension and in a co-moving frame. At the
# heat_2d recipe's width (Fourier 256x3, mapping 128, 6 stacked streams):
# heat_2d at N 8192 and 40000, causal, on a feedforward 256x3 trunk, and in
# a frame of speed 0.7; the Burgers recipe in that frame (one dimension).
# Small (64x48, mapping 32, N 4096): every residual in two dimensions and
# heat in three. Bounds as phase 19's, by causal eps.
ND_VARIANTS = ("heat_2d", "heat_2d_causal", "heat_2d_ff", "heat_2d_frame", "burgers_frame")
ND_SMALL = ("burgers_2d", "heat_3d", "kdv_2d", "convection_2d", "allen_cahn_2d",
            "black_scholes_2d")
FRAME_SPEED = 0.7
ND_SMALL_N = 4096
# Phase 22: the heat_2d recipe through run_convergence, 3 Adam epochs (12
# steps of 8192) then 3 L-BFGS iterations on all 40000 points.
HEAT_2D_EPOCHS = 6
# Phase 23: the three recipes second order in time (wave, pendulum,
# pendulum_nonlinear) through run_convergence, 3 Adam epochs (12 steps of
# 8192) then 3 L-BFGS iterations on all 40000 points; then Adam steps and
# L-BFGS iterations timed with kernel 2 and on the plain path, in turns.
SECOND_ORDER_RECIPES = ("wave", "pendulum", "pendulum_nonlinear")
SECOND_ORDER_EPOCHS = 6
SECOND_ORDER_TIMED = 6
# Phase 24: wave and the pendulum as shipped (SIREN 124x7; ResNet 512x7),
# SHIPPED_SECOND_ORDER_EPOCHS epochs of 2 Adam steps (batch 2048 of 5000).
SHIPPED_SECOND_ORDER_EPOCHS = 3
F64_TOL = 1e-12     # float64 parameters: the loss against the plain path's, rel
# Phase 25: the Cahn-Hilliard recipes through run_convergence: the 2-D
# headline (attention 124x4, Adam only) 3 epochs of 4 steps of 4096; the
# dynamics 3 Adam epochs of 4 steps of 8192, then 3 L-BFGS iterations on all
# 40000 points; the biharmonic 10 epochs of one step of 4096, whose 0.9846
# switch leaves 9 Adam steps, then 1 L-BFGS iteration.
CH_RECIPES = ("cahn_hilliard", "cahn_hilliard_dynamics", "cahn_hilliard_biharmonic")
CH_EPOCHS = {"cahn_hilliard": 3, "cahn_hilliard_dynamics": 6, "cahn_hilliard_biharmonic": 10}
# Kernel 2 per loss (launches, jvp-rule calls), as
# tests/test_torch_cahn_hilliard.py counts them on the CPU (the plain version
# through _FourierFeaturesFn). Dynamics: the mixed residual twice (the loss
# and mu-H2), each the head, one order-2 nest along x (2 rule calls) and one
# jvp along t (1), the periodic faces (one jvp), the IC and the mass grid.
# Biharmonic: the direct residual (u_t, then the chemical potential's
# order-2 nest: 3 launches, 7 rule calls), the BC and the IC. One launch per
# validate.
CH_FF_PER_LOSS = {"cahn_hilliard": (0, 0), "cahn_hilliard_dynamics": (9, 7),
                  "cahn_hilliard_biharmonic": (5, 7)}
CH_TIMED = 3        # Adam steps and L-BFGS iterations timed per turn
# Phase 26: kernel 2 under nested jvp to order 4 (orders k = 1..4 at
# JVP_TOL x 10^(k-1), the JAX suite's progression); the direct residual, its
# loss and each parameter gradient, and the mixed residual and gradients, at
# CH_GRAD_TOL relative to max (phase 12's bound for the order-3 residual).
CH_JVP_ORDER = 4
CH_GRAD_TOL = 1e-3
CH_PARITY_N = {"cahn_hilliard_biharmonic": 4096, "cahn_hilliard_dynamics": 8192}
# Phase 27: Cahn-Hilliard as shipped (ResNet 512x7, the direct form in 1-D,
# the random IC, Dirichlet and Neumann): 2 epochs of 2 Adam steps of 2048.
SHIPPED_CH_EPOCHS = 2


# Phase 28: both inverse recipes as shipped, cut to 200 of their 2000 epochs
# (800 Adam steps of batch 4096 each). Kernel 2 per loss (launches, jvp-rule
# calls): heat IC, periodic faces (through the rule) and data; Black-Scholes
# Dirichlet, IC and data (tests/test_torch_inverse.py counts them on the CPU).
INVERSE_EPOCHS = 200
INVERSE_FF_PER_LOSS = {"heat": (3, 1), "black_scholes": (3, 0)}
INVERSE_TIMED = 10
# Phase 29: the Burgers recipe forward and with 2000 synthetic observations
# (data_augmented), 6 epochs: 3 Adam (12 RAR steps), then 3 L-BFGS.
DATA_AUG_EPOCHS = 6
DATA_AUG_OBS = 2000
# Phase 30: the training CLI, 4 epochs of 2 Adam steps (batch 2048 of 5000).
CLI_EPOCHS = 4
# Phase 31: the sampling harness (``benchmarks/sampling.py``) at its own
# width (64x3, mapping 32; DQN hidden 64, replay 4096, batch 64), batch 1024:
# (pde, strategy, windows), SAMPLING_EPOCHS steps each, after the harness's
# warm-up copy. Kernel 2 per step (launches, jvp-rule calls): Burgers BC and
# IC; wave BC, IC and the velocity IC through the rule; one launch per
# ``_evaluate``.
SAMPLING_BATCH = 1024
SAMPLING_EPOCHS = {"burgers": 30, "wave": 12}
SAMPLING_CASES = (("burgers", "uniform", 0), ("burgers", "stratified", 0),
                  ("burgers", "residual_based", 0), ("burgers", "adaptive", 0),
                  ("burgers", "adaptive[resfeat_improve]", 0), ("burgers", "adaptive", 2),
                  ("wave", "uniform", 0))
SAMPLING_FF_PER_STEP = {"burgers": (2, 0), "wave": (3, 1)}
# Phase 32: the FDM L2 errors and fields, card against CPU.
FDM_TOL = 1e-5
# Phase 33: the point-wise operator run's epochs (2 steps of 4096 each) and
# the gridded run's steps; GridFNO2D card against CPU, rel to max (cuFFT and
# pocketfft sum in other orders).
OPERATOR_EPOCHS = 6
GRIDDED_EPOCHS = 40
GRID_FNO_TOL = 1e-5
CLI_FILES = {"checkpoint.json", "checkpoint.npz", "config.yaml", "experiment.log",
             "final_model.json", "final_model.npz", "history.json", "live_snapshot.npz",
             "metadata.json", "metrics.json", "report.html", "visualizations"}
# Phase 34: the Burgers recipe slice per lever, 4 epochs of 4 steps (with
# adam_lbfgs: 2 Adam epochs, then 2 L-BFGS iterations on all 40000 points).
LEVER_EPOCHS = 4
# Phase 35: the heat recipe and its correction stage, epochs each; hard IC
# on wave and the Burgers slice, epochs; the IC loss's bound under hard IC
# (MSE: the velocity IC's target against the exact solution's jvp, float32
# rounding); CollocationAgent updates.
MULTISTAGE_EPOCHS = 4
HARD_IC_EPOCHS = 3
HARD_IC_TOL = 1e-10
COLLOCATION_UPDATES = 5
# Phases 36-39 (the trunk options, ensembles, the experiment's plots).
TRUNK_EPOCHS = 2      # phases 36-38: epochs of 4 steps of the Burgers slice per run
ENSEMBLE_E = 4        # phase 37's members
TIMED_STEPS = 10      # phase 37's steps timed per turn (E = 1 and E = 4, in turns)
# Phase 37's member axis at small size: kernel 1 on MEMBER_SMALL_E stacked
# members of N MEMBER_SMALL_N points per case (64x48, mapping 32, LayerNorm
# off for the generated residual; Black-Scholes as shipped and phase 44's
# 4-D case as they are), and the vmapped residual path's ensembles.
MEMBER_SMALL_E = 3
MEMBER_SMALL_N = 2048
MEMBER_CASES = ("burgers_causal_basis", "kdv_causal", "black_scholes_ff", "heat_4d_variants",
                "burgers_generated")
DB_TOL = 1e-4         # dL/dB against _TorchOps: the gradients' bound, rel to max
EXPECT_DROPOUT = 0.1  # phase 38's dropout rate (identity on the trainer's paths)
# Phase 40: float64 residuals on the Burgers slice: epochs (half Adam, half
# float64 L-BFGS on all 40000 points); one float64 loss and its gradients,
# card against CPU, relative (to max for the gradients); L-BFGS iterations
# timed per turn.
F64_EPOCHS = 4
F64_CPU_TOL = 1e-10
F64_TIMED = 3
# Phase 41: the Burgers slice's epochs under a mesh; histories against the
# unsharded run, relative: a world of 1 (the same computation) and 2 gloo
# ranks on one card (each rank's kernel-1 mean over half the batch).
MESH_EPOCHS = 2
MESH_TOL = 1e-6
MESH_GLOO_TOL = 1e-4
# Phase 42: the run launched from the dashboard, and its deadline.
DASHBOARD_EPOCHS = 2
DASHBOARD_DEADLINE_S = 120


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def burgers_recipe_config(device: str):
    """The shipped Burgers recipe with Adam only and uniform sampling (its
    L-BFGS phase runs in phase 17)."""
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


def kdv_recipe_config(device: str, causal: bool = True):
    """The shipped KdV recipe (``build_recipe_config("kdv")``), cut to
    ``KDV_EPOCHS`` epochs; ``causal=False`` drops its causal weighting."""
    from pinnrl_tpu_torch.benchmarks.convergence import build_recipe_config

    cfg = build_recipe_config("kdv", epochs=KDV_EPOCHS, device=device)
    if not causal:
        cfg.training.causal_eps = 0.0
    return cfg


def siren_kdv_config(device: str):
    """KdV exactly as shipped (``load_config(pde_type="kdv")``: a 124x7
    SIREN, omega_0 30), cut in depth to ``SIREN_EPOCHS`` epochs."""
    from pinnrl_tpu_torch.config import load_config

    cfg = load_config(pde_type="kdv", device=device)
    cfg.training.num_epochs = SIREN_EPOCHS
    return cfg


def heat_recipe_config(device: str, causal: bool = False):
    """The heat recipe (``build_recipe_config("heat")``) with Adam only
    (its L-BFGS phase runs in phase 17), cut to ``HEAT_EPOCHS`` epochs."""
    from pinnrl_tpu_torch.benchmarks.convergence import build_recipe_config

    cfg = build_recipe_config("heat", epochs=HEAT_EPOCHS, device=device)
    cfg.training.optimizer = "adam"
    cfg.training.causal_eps = 1.0 if causal else 0.0
    return cfg


def scope_variant_config(name: str, device: str):
    """The configuration of a phase-19 variant (``SCOPE_VARIANTS``)."""
    from pinnrl_tpu_torch.benchmarks.convergence import build_recipe_config
    from pinnrl_tpu_torch.config import load_config

    if name == "black_scholes_ff":
        return load_config(pde_type="black_scholes", device=device)
    key = name.removesuffix("_causal")
    cfg = build_recipe_config(key, device=device)
    cfg.training.causal_eps = 1.0 if name.endswith("_causal") else 0.0
    return cfg


def nd_variant_config(name: str, device: str):
    """The configuration of a phase-21 variant (``ND_VARIANTS``, ``ND_SMALL``)."""
    from pinnrl_tpu_torch.benchmarks.convergence import build_recipe_config

    if name in ND_VARIANTS:
        cfg = build_recipe_config(name.split("_")[0] if name.startswith("burgers") else "heat_2d",
                                  device=device)
        if name.startswith("burgers"):
            cfg.training.collocation_distribution = "uniform"
        if name.endswith("_ff"):
            cfg.model.architecture = "feedforward"
        if name.endswith("_frame"):
            cfg.model.arch_params["moving_frame_speed"] = FRAME_SPEED
        cfg.training.causal_eps = 1.0 if name.endswith("_causal") else 0.0
        return cfg
    key, dim = name.rsplit("_", 1)
    dim = int(dim[0])
    cfg = build_recipe_config(key, device=device)
    cfg.pde.dimension, cfg.model.input_dim = dim, dim + 1
    cfg.pde.domain = [list(cfg.pde.domain[0])] * dim
    if key == "convection":
        cfg.pde.parameters["velocity"] = [1.0, -0.5, 0.25][:dim]
    cfg.model.hidden_dims = [64, 48]
    cfg.model.arch_params["mapping_size"] = 32
    cfg.model.arch_params.pop("feature_seed", None)  # the shipped bases are for one dimension
    cfg.training.causal_eps = 0.0
    return cfg


def kernel1_bound(params, x_order: int, z, B, dim: int = 1):
    """(ms, what bounds it) of one kernel-1 loss + gradients call: its GEMMs'
    operations; its bytes: z, the parameters read, the gradients written,
    the Fourier basis and the loss."""
    n_params = sum(v.numel() for v in params.values())
    return bound(sum(2.0 * m * k * n for m, k, n in fused_gemms(params, x_order, z.shape[0], dim)),
                 4.0 * (z.numel() + 2 * n_params + (0 if B is None else B.numel()) + 1))


def bound(ops: float, nbytes: float):
    """(ms, what bounds it): the least time the card could take, the larger
    of ``ops`` over the FP32 peak and ``nbytes`` over the memory rate."""
    t_ops, t_bytes = ops / FP32_FLOPS, nbytes / HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def gemm_tol(K: int) -> float:
    return GEMM_TOL if K <= 512 else GEMM_TOL_LONG_K


def gemm_products(params, x_order: int, n: int, dim: int = 1):
    """(kind, (M, K, N)) of the products of one kernel-1 loss + gradients
    call on ``n`` points in ``dim`` space dimensions: per layer the stacked
    forward X W^T ("fwd"), dW = dY^T X ("dw") and (past the first layer)
    dX = dY W ("dx"), over (2 + dim x_order) n stacked rows."""
    rows = (2 + dim * x_order) * n
    prods = []
    n_dense = sum(1 for k in params if k.startswith("Dense_") and k.endswith(".weight"))
    for i in range(n_dense):
        out, inp = params[f"Dense_{i}.weight"].shape
        prods += [("fwd", (rows, inp, out)), ("dw", (out, rows, inp))]
        prods += [("dx", (rows, out, inp))] if i else []
    return prods


def fused_gemms(params, x_order: int, n: int, dim: int = 1):
    """The (M, K, N) shapes of ``gemm_products``."""
    return [shape for _, shape in gemm_products(params, x_order, n, dim)]


def gemm_routes(kind: str, P, Q, ops):
    """(core, cuBLAS) callables for one product on operands P, Q: "fwd"
    X (R, K), W (N, K) -> X W^T; "dx" G (R, out), W (out, K) -> G W; "dw"
    G (R, out), X (R, K) -> G^T X. core: kernel 1's launcher
    (``fused_step._linear*``: the GEMM core, or a row pass for one column)."""
    import torch

    from pinnrl_tpu_torch.ops.kernels import fused_step

    return {
        "fwd": (lambda: fused_step._linear(ops, P, Q, None, 0), lambda: torch.mm(P, Q.t())),
        "dx": (lambda: fused_step._linear_dx(ops, P, Q), lambda: torch.mm(P, Q)),
        "dw": (lambda: fused_step._linear_dw(ops, P, Q), lambda: torch.mm(P.t(), Q)),
    }[kind]


def scorer_launches(ops, x, P, eps: float = 1e-6):
    """Kernel 4's launches as ``mlp._score`` makes them for grid ``x``, each
    a callable on its own inputs: ({"transpose", "first_pass", "product",
    "head"}, the product per (splits, W2 transposed) for the A/Bs, the
    splits ``mlp._product_split`` picks)."""
    import torch

    from pinnrl_tpu_torch.ops.kernels import _gemm_core, mlp

    n, h = x.shape[0], P["Dense_1.weight"].shape[0]
    W2, b2 = P["Dense_1.weight"], P["Dense_1.bias"]
    first = (x, P["Dense_0.weight"], P["Dense_0.bias"], P["LayerNorm_0.weight"],
             P["LayerNorm_0.bias"], eps)
    H1, W2t = ops.dense_ln_relu_in(*first), ops.transpose(W2)
    plans = {s: _gemm_core.split_chunks(h, s) for s in (1, 2)}
    partials = {s: torch.empty((plans[s][0], n, h), device=x.device) for s in plans}

    def product(s: int, transposed: bool):
        splits, k_chunk = plans[s]
        B, sbk, sbn = (W2t, h, 1) if transposed else (W2, 1, h)
        bias = b2 if splits == 1 else None
        return lambda: ops.gemm(n, h, h, H1, h, 1, B, sbk, sbn, partials[s], h, bias, n, splits,
                                k_chunk)

    chosen = mlp._product_split(n, h, h)[0]
    product(chosen, True)()  # the head's input
    head = (partials[chosen], None if chosen == 1 else b2, P["LayerNorm_1.weight"],
            P["LayerNorm_1.bias"], P["Dense_2.weight"], P["Dense_2.bias"], eps)
    launches = {"transpose": lambda: ops.transpose(W2),
                "first_pass": lambda: ops.dense_ln_relu_in(*first),
                "product": product(chosen, True),
                "head": lambda: ops.ln_relu_head(*head)}
    return launches, {(s, t): product(s, t) for s in plans for t in (True, False)}, chosen


def gemm_operands(kind: str, shape, gen, device):
    """Seeded normal operands (P, Q) of one product, laid out as kernel 1
    holds them (see ``gemm_routes``)."""
    import torch

    M, K, N = shape
    if kind == "fwd":
        dims = ((M, K), (N, K))
    elif kind == "dx":
        dims = ((M, K), (K, N))
    else:
        dims = ((K, M), (K, N))
    return tuple(torch.randn(d, generator=gen, device=device) for d in dims)


def ptxas_report(log: str):
    """(entry, registers, smem bytes, spill store bytes, spill load bytes,
    stack frame bytes) per kernel in an ``nvcc -Xptxas -v`` log."""
    rows, name, spill = [], None, (0, 0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), (0, 0, 0)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spill = (int(m.group(2)), int(m.group(3)), int(m.group(1)))
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name:
            rows.append((name, int(m.group(1)), int(m.group(2) or 0), *spill))
            name = None
    return rows


def cublas_ms(shapes, device, iters: int = 20) -> float:
    """Device ms of one FP32 cuBLAS product (``torch.mm``, TF32 off) of each
    (M, K, N) in ``shapes``, in sequence, on random operands, by CUDA-graph
    replay."""
    import torch

    gen = torch.Generator(device=device).manual_seed(0)
    ops = [(torch.randn((m, k), generator=gen, device=device),
            torch.randn((k, n), generator=gen, device=device)) for m, k, n in shapes]
    assert not torch.backends.cuda.matmul.allow_tf32
    return graph_ms(lambda: [torch.mm(a, b) for a, b in ops], iters=iters)


def time_sorted(x, t):
    """(x, t) -> z sorted by time, as ``compute_loss`` hands it to the
    causal kernel."""
    import torch

    return torch.cat([x, t], dim=-1)[torch.argsort(t.reshape(-1), stable=True)]


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


def graph_ms(fn, iters: int = 50, replays: int = 10) -> float:
    """Device ms per call of ``fn``, from CUDA-graph replays of ``iters``
    calls: a small kernel's own time, without the host's launch overhead
    (which ``cuda_ms`` includes once the host is slower than the card)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def ff_empty_launch(x, B):
    """A callable that launches the empty kernel of ``fourier_feats.cu`` on
    the grid ``fourier_features(x, B)`` launches: the floor of one launch
    of that shape."""
    from pinnrl_tpu_torch.ops.kernels import _build, fourier_feats

    n, d = x.shape
    m = B.shape[1]
    path, _, rows = fourier_feats.launch_plan(n, d, m, B.data_ptr() % 16 == 0,
                                              fourier_feats._sm_count(x.get_device()))
    lib = fourier_feats._lib()
    return lambda: _build.check(lib.ff_empty(m, path, rows, _build.stream_handle(x.device)),
                                "empty_kernel")


def host_us(fn, calls: int = 1000, warmup: int = 50) -> float:
    """Host microseconds per call of ``fn`` (perf_counter over ``calls``
    calls, then one ``synchronize``)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def ff_host_split(x, B, calls: int = 1000):
    """Host microseconds of one eager ``fourier_features(x, B)`` call on the
    card ("call") and of each piece of its launch path alone: the device
    dispatch and ``needs_rules``, the input check, the launch plan, the bound
    library, the current stream, the output's allocation, the ctypes call
    with its kernel launch and status check; "rest" is the call less the
    pieces. "function" is a call through ``_FourierFeaturesFn`` (where a
    derivative rule can be asked)."""
    from pinnrl_tpu_torch.ops.kernels import _build, fourier_feats as ff

    n, d = x.shape
    m = B.shape[1]
    index = x.get_device()
    path, _, rows = ff.launch_plan(n, d, m, B.data_ptr() % 16 == 0, ff._sm_count(index))
    lib, out, stream = ff._lib(), x.new_empty((n, 2 * m)), _build.stream_handle(index)
    pieces = {
        "dispatch": lambda: (x.is_cpu and B.is_cpu) or (x.is_cuda and ff.needs_rules(x, B)),
        "check": lambda: ff._accepts(x, B),
        "plan": lambda: ff.launch_plan(n, d, m, B.data_ptr() % 16 == 0, ff._sm_count(index)),
        "library": ff._lib,
        "stream": lambda: _build.stream_handle(index),
        "alloc": lambda: x.new_empty((n, 2 * m)),
        "launch": lambda: _build.check(lib.ff_forward(x.data_ptr(), B.data_ptr(), out.data_ptr(), n, d,
                                                      m, path, rows, 1, 1, 0, 0, stream),
                                       "ff_forward"),
    }
    split = {"call": host_us(lambda: ff.fourier_features(x, B, True), calls)}
    split.update({k: host_us(f, calls) for k, f in pieces.items()})
    split["rest"] = split["call"] - sum(split[k] for k in pieces)
    split["function"] = host_us(lambda: ff._FourierFeaturesFn.apply(x, B, True, ff.fourier_features_cuda),
                                calls)
    return split


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
def plain_siren():
    """Route every SIREN layer to the plain version (timing and parity)."""
    from pinnrl_tpu_torch.ops.kernels import siren

    kernel = siren.siren_layer
    siren.siren_layer = siren.siren_layer_plain
    try:
        yield
    finally:
        siren.siren_layer = kernel


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


@contextlib.contextmanager
def captured_trainers():
    """The ``PDETrainer``s whose ``train`` runs inside the block, in order
    (their histories, for the checks)."""
    from pinnrl_tpu_torch.training import trainer as trainer_mod

    seen = []
    train = trainer_mod.PDETrainer.train

    def recording(self, *args, **kwargs):
        seen.append(self)
        return train(self, *args, **kwargs)

    trainer_mod.PDETrainer.train = recording
    try:
        yield seen
    finally:
        trainer_mod.PDETrainer.train = train


def lbfgs_iteration_times(tr, batch, n: int, seed: int = 3):
    """Host-clock ms of ``n`` L-BFGS iterations of ``tr`` on ``batch`` (a
    fresh optimizer, 2 warm-up iterations), each ending in
    ``torch.cuda.synchronize()``; and the objective's evaluations per
    iteration over all of them."""
    import torch

    from pinnrl_tpu_torch.training.lbfgs import LBFGS

    params = tr.model.params
    opt = tr._make_lbfgs(tr._leaves(params))
    g = torch.Generator(device=tr.device).manual_seed(seed)
    evals = LBFGS.evaluations
    times = []
    for i in range(n + 2):
        torch.cuda.synchronize()
        s = time.perf_counter()
        tr._lbfgs_step(params, opt, batch, g)
        torch.cuda.synchronize()
        if i >= 2:
            times.append((time.perf_counter() - s) * 1e3)
    return times, (LBFGS.evaluations - evals) / (n + 2)


def step_times(tr, n: int, epochs: int, batch: int, seed: int = 7):
    """Host-clock ms of ``n`` training steps after 3 warm-up steps, each
    ending in ``torch.cuda.synchronize()``."""
    import torch

    params = tr.model.params
    steps_per_epoch = tr.tcfg.num_collocation_points // batch
    opt = tr._make_adam(epochs, steps_per_epoch, tr._leaves(params))
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


def eager_search_reads(reads: int, evals: int) -> bool:
    """Whether an eager L-BFGS iteration's host reads are its search's: one
    per trial after the first, and one that stops the search unless it ran
    out of steps; its evaluations are the start's and one per trial. At most
    one read per evaluation."""
    return evals - 2 <= reads <= evals - 1


def count_syncs(tr, batch: int):
    """Host round trips of one warm training step (see ``record_syncs``)."""
    import torch

    params = tr.model.params
    opt = tr._make_adam(1, 1, tr._leaves(params))
    g = torch.Generator(device=tr.device).manual_seed(11)
    if tr.rl_agent is not None and tr._rl_state is None:
        tr._rl_state = tr._init_rl_state(0)
    tr._step(params, opt, g, batch)  # warm-up
    sites = record_syncs(lambda: tr._step(params, opt, g, batch))
    return len(sites), sorted(set(sites))


def ch_recipe_runs(dev, card: str):
    """Phase 25 (see the module docstring): per recipe, the run's launches,
    the launches of one Adam step, L-BFGS iteration and validate alone, host
    syncs, and Adam-step and L-BFGS-iteration ms with kernel 2 and plain."""
    import torch

    from pinnrl_tpu_torch.benchmarks.convergence import build_recipe_config, run_convergence
    from pinnrl_tpu_torch.ops.kernels import fourier_feats, fused_step, siren
    from pinnrl_tpu_torch.training.lbfgs import LBFGS

    ff = fourier_feats.fourier_features
    runs = {}
    for key in CH_RECIPES:
        epochs = CH_EPOCHS[key]
        rt = build_recipe_config(key, epochs=epochs, device="cuda").training
        has_lbfgs = rt.optimizer == "adam_lbfgs"
        switch = int(rt.adam_lbfgs_switch_ratio * epochs) if has_lbfgs else epochs
        adam_steps = switch * (rt.num_collocation_points // rt.batch_size)
        per_launches, per_jvps = CH_FF_PER_LOSS[key]
        fused_step.fused_residual_loss.launches = siren.siren_layer.launches = 0
        ff.launches = ff.jvps = 0
        evals0, reads0 = LBFGS.evaluations, LBFGS.host_reads
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with captured_trainers() as seen:
            conv = run_convergence(key, seed=0, epochs=epochs, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run = {"fused_residual_loss": fused_step.fused_residual_loss.launches,
               "siren_layer": siren.siren_layer.launches, "fourier_features": ff.launches,
               "fourier_features_jvps": ff.jvps, "evaluations": LBFGS.evaluations - evals0,
               "host_reads": LBFGS.host_reads - reads0}
        (ltr,) = seen
        hist = ltr.history
        losses, n_vals = hist["train_loss"], len(hist["val_loss"])
        n_losses = adam_steps + run["evaluations"] + n_vals
        # Per loss as CH_FF_PER_LOSS; one more launch for run_convergence's
        # validate(20000) on a Fourier trunk.
        fourier = ltr.model.architecture_name == "fourier"
        want = {"fused_residual_loss": 0, "siren_layer": 0,
                "fourier_features": per_launches * n_losses + int(fourier),
                "fourier_features_jvps": per_jvps * n_losses}
        print(f"[cahn-hilliard] {key}: run_convergence(seed=0, epochs={epochs}) {wall:.2f} s: "
              f"Adam {switch} epochs ({adam_steps} steps of {rt.batch_size}), then "
              f"{len(losses) - switch} L-BFGS iterations on "
              f"{min(rt.lbfgs.batch_size or rt.num_collocation_points, rt.num_collocation_points)} "
              f"points; validations {n_vals}; {run} (want {want}) ({card})", flush=True)
        print(f"[cahn-hilliard] {key}: epoch losses {' '.join(f'{v:.6e}' for v in losses)}; "
              f"rel_l2 {conv.rel_l2:.4e} max_error {conv.max_error:.4e} (no bar at {epochs} "
              f"epochs)", flush=True)
        if not (ltr.switch_epoch == (switch if has_lbfgs else None) and len(losses) == epochs
                and not ltr.fast_bundle_active and not ltr.fused_kernel_active
                and all(map(math.isfinite, losses + hist["val_loss"]))):
            raise AssertionError(f"{key}: switch {ltr.switch_epoch}, bundle "
                                 f"{ltr.fast_bundle_active}, kernel 1 {ltr.fused_kernel_active}, "
                                 f"losses {losses}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"{key}: the loss did not fall: {losses}")
        lbfgs_losses = losses[switch:]
        for a, b in zip(lbfgs_losses, lbfgs_losses[1:]):
            if not b <= a + APPROX_DEC_RTOL * abs(a):
                raise AssertionError(f"{key}: the L-BFGS loss rose within its round: {lbfgs_losses}")
        if (any(run[k] != w for k, w in want.items()) or run["host_reads"] != 0
                or (has_lbfgs and run["evaluations"] < 2)):
            raise AssertionError(f"{key}: launches {run}, want {want} ({adam_steps} Adam steps + "
                                 f"{run['evaluations']} L-BFGS evaluations + {n_vals} validations)")
        if not all(math.isfinite(v) for v in (conv.rel_l2, conv.max_error, conv.points_per_sec)):
            raise AssertionError(f"{key}: non-finite result {conv}")

        params = ltr.model.params
        pde = ltr.pde
        gen = torch.Generator(device=dev).manual_seed(25)
        x, t = pde.generate_collocation_points(gen, rt.batch_size, "uniform")
        with torch.no_grad():
            terms = pde.compute_loss(ltr.model.apply, params, x, t, generator=gen)
        want_terms = {"mass", "mu_h2"} if key == "cahn_hilliard_dynamics" else set()
        if ({"mass", "mu_h2"} & set(terms)) != want_terms or not all(
                math.isfinite(float(v)) for v in terms.values()):
            raise AssertionError(f"{key}: loss terms {sorted(terms)}, want the penalties "
                                 f"{sorted(want_terms)}, all finite")

        # Kernel 2's launches of one Adam step, one L-BFGS iteration and one
        # validate, each counted alone.
        lbatch = ltr._lbfgs_batch(0, 0, rt.num_collocation_points) if has_lbfgs else None
        aopt = ltr._make_adam(1, 1, list(params.values()))
        sopt = ltr._make_lbfgs(list(params.values()))
        sgen = torch.Generator(device=dev).manual_seed(5)
        steps = [("adam_step", lambda: ltr._step(params, aopt, sgen, rt.batch_size)),
                 ("validate", lambda: pde.validate(ltr.model.apply, params, num_points=20000))]
        if has_lbfgs:
            steps.insert(1, ("lbfgs_iteration", lambda: ltr._lbfgs_step(params, sopt, lbatch, sgen)))
        per = {}
        for what, fn in steps:
            ff.launches = ff.jvps = 0
            evals0 = LBFGS.evaluations
            fn()
            torch.cuda.synchronize()
            per[what] = {"launches": ff.launches, "jvps": ff.jvps,
                         "evaluations": LBFGS.evaluations - evals0}
        it = per.get("lbfgs_iteration")
        if not (per["adam_step"] == {"launches": per_launches, "jvps": per_jvps, "evaluations": 0}
                and per["validate"] == {"launches": int(fourier), "jvps": 0, "evaluations": 0}
                and (it is None or (it["evaluations"] >= 2
                                    and it["launches"] == per_launches * it["evaluations"]
                                    and it["jvps"] == per_jvps * it["evaluations"]))):
            raise AssertionError(f"{key}: kernel 2's launches per step {per}")
        adam_syncs, adam_sites = count_syncs(ltr, rt.batch_size)
        l_sites, l_evals, l_reads = [], 0, 0
        if has_lbfgs:
            evals0, reads0 = LBFGS.evaluations, LBFGS.host_reads
            l_sites = record_syncs(lambda: ltr._lbfgs_step(params, sopt, lbatch, sgen))
            l_evals, l_reads = LBFGS.evaluations - evals0, LBFGS.host_reads - reads0
        print(f"[syncs] {key}: one warm Adam step {adam_syncs} {adam_sites}; one L-BFGS iteration "
              f"{len(l_sites)} {sorted(set(l_sites))}, {l_evals} evaluations, {l_reads} host reads",
              flush=True)
        if adam_syncs or len(l_sites) != l_reads or (has_lbfgs
                                                     and not eager_search_reads(l_reads, l_evals)):
            raise AssertionError(f"{key}: {adam_syncs} host syncs per Adam step; {len(l_sites)} "
                                 f"per L-BFGS iteration of {l_evals} evaluations")

        timed = {o: {"adam": [], "lbfgs": [], "evals": []} for o in ("kernels", "plain")}
        for order in ("plain", "kernels", "kernels", "plain"):
            with plain_fourier_features() if order == "plain" else contextlib.nullcontext():
                timed[order]["adam"] += step_times(ltr, CH_TIMED, 1, rt.batch_size)
                if has_lbfgs:
                    times, evals = lbfgs_iteration_times(ltr, lbatch, CH_TIMED)
                    timed[order]["lbfgs"] += times
                    timed[order]["evals"].append(evals)
        ms = {o: {"adam_step_ms": statistics.median(v["adam"]),
                  "lbfgs_iteration_ms": statistics.median(v["lbfgs"]) if v["lbfgs"] else None,
                  "evaluations_per_iteration": (sum(v["evals"]) / len(v["evals"])
                                                if v["evals"] else None)}
              for o, v in timed.items()}
        print(f"[timing] {key}: Adam step (batch {rt.batch_size}), median of "
              f"{len(timed['kernels']['adam'])}: kernel 2 {ms['kernels']['adam_step_ms']:.3f} ms, "
              f"plain {ms['plain']['adam_step_ms']:.3f} ms; L-BFGS iteration: kernel 2 "
              f"{ms['kernels']['lbfgs_iteration_ms']} ms "
              f"({ms['kernels']['evaluations_per_iteration']} evaluations), plain "
              f"{ms['plain']['lbfgs_iteration_ms']} ms ({card})", flush=True)
        runs[key] = {**run, "per_loss": {"launches": per_launches, "jvps": per_jvps},
                     "rel_l2": conv.rel_l2, "wall_s": wall, "per": per, "adam_syncs": adam_syncs,
                     "lbfgs_syncs": len(l_sites), "lbfgs_evaluations": l_evals, **ms}
        del ltr, seen, pde, params
    return runs


def ch_order4_parity(dev, card: str):
    """Phase 26: kernel 2 against its plain version under nested jvp to
    order 4 on the biharmonic recipe's network (its basis's t-row zero), the
    direct residual, its loss and parameter gradients there, and the
    dynamics recipe's mixed residual and gradients."""
    import torch

    from pinnrl_tpu_torch.benchmarks.convergence import build_recipe_config
    from pinnrl_tpu_torch.models import PINNModel
    from pinnrl_tpu_torch.ops.derivatives import directional_derivative, make_scalar_fn
    from pinnrl_tpu_torch.ops.kernels import fourier_feats
    from pinnrl_tpu_torch.pdes import create_pde

    ff = fourier_feats.fourier_features
    out = {}
    for key, n in CH_PARITY_N.items():
        cfg = build_recipe_config(key, device="cuda")
        pde, model = create_pde(cfg), PINNModel(cfg, seed=0)
        gen = torch.Generator(device=dev).manual_seed(26)
        x, t = pde.generate_collocation_points(gen, n, "uniform")
        entry = {"n": n}
        if key == "cahn_hilliard_biharmonic":
            B = model.constants["FourierFeatures_0.B"]
            if B[1].any():
                raise AssertionError("the biharmonic recipe's basis has a non-zero t-row")
            z = torch.cat([x, t], dim=-1)
            u = make_scalar_fn(model.apply, model.params)
            ff.launches = ff.jvps = 0
            with torch.no_grad():
                dk = directional_derivative(u, z, 0, CH_JVP_ORDER)
                entry["launches"], entry["jvps"] = ff.launches, ff.jvps
                with plain_fourier_features():
                    dp = directional_derivative(u, z, 0, CH_JVP_ORDER)
            torch.cuda.synchronize()
            entry["orders"] = []
            for k, (a, b) in enumerate(zip(dk, dp), start=1):
                err = float((a - b).abs().max())
                rel = err / float(b.abs().max())
                tol = JVP_TOL * 10 ** (k - 1)
                entry["orders"].append({"order": k, "max_abs_err": err, "rel": rel, "tol": tol})
                print(f"[order-4] fourier_features jvp rule, order {k} d/dx of the biharmonic "
                      f"recipe's network ({n} points): max_abs_err {err:.3e} rel {rel:.3e} "
                      f"(tol {tol:g})", flush=True)
                if not rel < tol:
                    raise AssertionError(f"kernel 2's jvp rule disagrees at order {k}")
            # One nest of CH_JVP_ORDER jvps: one launch, the rule once per level.
            if not (entry["launches"] == 1 and entry["jvps"] == CH_JVP_ORDER):
                raise AssertionError(f"the order-{CH_JVP_ORDER} chain did not go through kernel 2 "
                                     f"once with {CH_JVP_ORDER} rule calls: {entry}")
            # Kernel 2 alone at the recipe's embedding, (n, 2) x (2, 64).
            zm = model.map_inputs(z)
            m = B.shape[1]
            entry["ms"] = graph_ms(lambda: fourier_feats.fourier_features(zm, B, True))
            entry["plain_ms"] = graph_ms(lambda: fourier_feats.fourier_features_plain(zm, B, True))
            entry["bound_ms"], entry["bound_by"] = bound(2.0 * n * 2 * m + 3.0 * n * m,
                                                         4.0 * (n * 2 + 2 * m + 2 * n * m))
            print(f"[timing] fourier_features ({n},2)x(2,{m}) zero t-row, device time per call "
                  f"(CUDA graph): kernel {entry['ms']:.5f} ms, plain {entry['plain_ms']:.5f} ms, "
                  f"bound {entry['bound_ms']:.5f} ms ({entry['bound_by']}) ({card})", flush=True)
        p = {k: v.detach().requires_grad_(True) for k, v in model.params.items()}

        def residual_grads():
            r = pde.compute_residual(model.apply, p, x, t)
            loss = pde._residual_loss(r, t)
            return r.detach(), loss.detach(), torch.autograd.grad(
                loss, list(p.values()), allow_unused=True, materialize_grads=True)

        ff.launches = 0
        rk, lk, gk = residual_grads()
        torch.cuda.synchronize()
        if not ff.launches:
            raise AssertionError(f"{key}: the residual did not go through kernel 2")
        with plain_fourier_features():
            rp, lp, gp = residual_grads()
        torch.cuda.synchronize()
        err = float((rk - rp).abs().max())
        rel = err / float(rp.abs().max())
        loss_rel = abs(float(lk) - float(lp)) / abs(float(lp))
        grad_rels = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                     for a, b in zip(gk, gp)]
        entry.update({"residual_shape": list(rk.shape), "residual_max_abs_err": err,
                      "residual_rel": rel, "loss_rel": loss_rel, "worst_gradient_rel": max(grad_rels),
                      "tol": CH_GRAD_TOL})
        print(f"[order-4] {key}: residual {tuple(rk.shape)} through kernel 2 against plain "
              f"(N={n}): max_abs_err {err:.3e} rel {rel:.3e}; residual loss rel {loss_rel:.3e}; "
              f"worst gradient rel {max(grad_rels):.3e} (tol {CH_GRAD_TOL:g}) ({card})", flush=True)
        if not (rel < CH_GRAD_TOL and loss_rel < CH_GRAD_TOL and max(grad_rels) < CH_GRAD_TOL
                and all(map(math.isfinite, grad_rels))):
            raise AssertionError(f"{key}: the residual through kernel 2 disagrees with plain")
        out[key] = entry
        del pde, model, p, gk, gp
    return out


def ch_shipped(dev, card: str):
    """Phase 27: Cahn-Hilliard as shipped (``load_config(pde_type=
    "cahn_hilliard")``): a few Adam steps on the card, finite, no kernel."""
    import torch

    from pinnrl_tpu_torch.config import load_config
    from pinnrl_tpu_torch.models import PINNModel
    from pinnrl_tpu_torch.ops.kernels import fourier_feats, fused_step, siren
    from pinnrl_tpu_torch.pdes import create_pde
    from pinnrl_tpu_torch.training import PDETrainer

    cfg = load_config(pde_type="cahn_hilliard", device="cuda")
    st = cfg.training
    st.num_epochs = SHIPPED_CH_EPOCHS
    pde, model = create_pde(cfg), PINNModel(cfg, seed=0)
    if not (cfg.model.architecture == "resnet"
            and (cfg.model.hidden_dim, cfg.model.num_blocks) == (512, 7)
            and pde.system_size == 1 and pde.dimension == 1
            and cfg.pde.initial_condition.get("type") == "random"
            and list(pde.boundary_conditions) == ["dirichlet", "neumann", "initial"]):
        raise AssertionError("the shipped Cahn-Hilliard configuration is not the ResNet 512x7 "
                             "direct 1-D form with the random IC, Dirichlet and Neumann")
    trainer = PDETrainer(model, pde, cfg)
    if trainer.fast_bundle_active or trainer.fused_kernel_active:
        raise AssertionError("Cahn-Hilliard as shipped is not on the generic engine")
    steps = SHIPPED_CH_EPOCHS * (st.num_collocation_points // st.batch_size)
    vals = sum(1 for e in range(1, SHIPPED_CH_EPOCHS + 1)
               if e % st.validation_frequency == 0 or e == SHIPPED_CH_EPOCHS)
    siren.siren_layer.launches = fourier_feats.fourier_features.launches = 0
    fused_step.fused_residual_loss.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = trainer.train(seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run = {"siren_layer": siren.siren_layer.launches,
           "fourier_features": fourier_feats.fourier_features.launches,
           "fused_residual_loss": fused_step.fused_residual_loss.launches}
    hist = res["history"]["train_loss"]
    val = pde.validate(model.apply, trainer._final_state["params"]["net"], num_points=20000)
    print(f"[shipped] cahn_hilliard as shipped (resnet 512x7, direct 1-D, random IC, Dirichlet + "
          f"Neumann, batch {st.batch_size} of {st.num_collocation_points}, BC/IC "
          f"{st.num_boundary_points}): {steps} Adam steps, {vals} validation(s), {wall:.2f} s; "
          f"launches {run}; epoch losses {' '.join(f'{v:.4e}' for v in hist)}; validate(20000) "
          f"rel_l2 {val['rel_l2']:.4e} (no bar) ({card})", flush=True)
    if not (len(hist) == SHIPPED_CH_EPOCHS and all(map(math.isfinite, hist))
            and len(res["history"]["val_loss"]) == vals
            and all(math.isfinite(v) for v in val.values())):
        raise AssertionError(f"cahn_hilliard as shipped: losses {hist}, validation {val}")
    if any(run.values()):
        raise AssertionError(f"cahn_hilliard as shipped launched a kernel: {run}")
    return {**run, "steps": steps, "validations": vals, "wall_s": wall, "rel_l2": val["rel_l2"],
            "epoch_losses": hist}


def grad_rel(a, b) -> float:
    """max |a - b| / max |b| (0-d tensors too)."""
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def inverse_runs(dev, card: str):
    """Phase 28 (see the module docstring): per inverse recipe, the run's
    launches (kernel 1 none, kernel 2 exact per loss), the coefficients'
    approach to the truth, host syncs per Adam step, kernel 2 against its
    plain version on the data term and on the loss's gradients, and Adam-step
    ms with kernel 2 and plain, in turns."""
    import torch

    from pinnrl_tpu_torch.benchmarks.inverse import RECIPES, run_inverse
    from pinnrl_tpu_torch.ops.kernels import fourier_feats, fused_step

    ff = fourier_feats.fourier_features
    loss_tol, grad_tol = FUSED_TOLS["burgers"]
    runs = {}
    for key, recipe in RECIPES.items():
        fused_step.fused_residual_loss.launches = 0
        ff.launches = ff.jvps = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with captured_trainers() as seen:
            results = run_inverse(key, seed=0, epochs=INVERSE_EPOCHS, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        (tr,) = seen
        t = tr.tcfg
        run = {"fused_residual_loss": fused_step.fused_residual_loss.launches,
               "fourier_features": ff.launches, "fourier_features_jvps": ff.jvps}
        hist = tr.history
        steps = INVERSE_EPOCHS * (t.num_collocation_points // t.batch_size)
        n_losses = steps + len(hist["val_loss"])
        per_launches, per_jvps = INVERSE_FF_PER_LOSS[key]
        want = {"fused_residual_loss": 0, "fourier_features": per_launches * n_losses,
                "fourier_features_jvps": per_jvps * n_losses}
        approach = {r.parameter: (abs(r.initial_guess - r.true_value), abs(r.identified - r.true_value))
                    for r in results}
        print(f"[inverse] {key}: run_inverse(seed=0, epochs={INVERSE_EPOCHS}) {wall:.2f} s: {steps} "
              f"Adam steps of {t.batch_size}, {len(hist['val_loss'])} validations, "
              f"{tr.pde.observations[0].shape[0]} observations; launches {run} (want {want}); "
              + "; ".join(f"{r.parameter} {r.initial_guess:g} -> {r.identified:.6g} (truth "
                          f"{r.true_value:g}, rel error {r.rel_error:.4e})" for r in results)
              + f" ({card})", flush=True)
        losses = hist["train_loss"]
        if not (len(losses) == INVERSE_EPOCHS and all(map(math.isfinite, losses + hist["val_loss"]))
                and not tr.fused_kernel_active and tr.fast_bundle_active
                and all(len(hist[f"param_{r.parameter}"]) == INVERSE_EPOCHS for r in results)):
            raise AssertionError(f"{key}: losses {losses[-3:]}, kernel 1 {tr.fused_kernel_active}")
        if run != want:
            raise AssertionError(f"{key}: launches {run}, want {want}")
        if not all(end < start for start, end in approach.values()):
            raise AssertionError(f"{key}: |coefficient - truth| at start and end {approach}")

        syncs, sites = count_syncs(tr, t.batch_size)
        print(f"[syncs] {key} inverse: one warm Adam step {syncs} {sites}", flush=True)
        if syncs:
            raise AssertionError(f"{key}: {syncs} host syncs per Adam step")

        # Kernel 2 against its plain version on the data term's embedding.
        model, pde = tr.model, tr.pde
        x_obs, t_obs, _ = pde.observations
        z_obs = model.map_inputs(torch.cat([x_obs, t_obs], dim=-1)).contiguous()
        B = model.constants["FourierFeatures_0.B"]
        periodic = model.module.FourierFeatures_0.periodic
        with torch.no_grad():
            fk = fourier_feats.fourier_features(z_obs, B, periodic)
            fp = fourier_feats.fourier_features_plain(z_obs, B, periodic)
        torch.cuda.synchronize()
        data_err = float((fk - fp).abs().max())
        data_rel = data_err / float(fp.abs().max())
        n_o, d_o, m_o = z_obs.shape[0], z_obs.shape[1], B.shape[1]
        data_ms = {"ms": graph_ms(lambda: fourier_feats.fourier_features(z_obs, B, periodic)),
                   "plain_ms": graph_ms(lambda: fourier_feats.fourier_features_plain(z_obs, B, periodic))}
        data_ms["bound_ms"], data_ms["bound_by"] = bound(2.0 * n_o * d_o * m_o + 3.0 * n_o * m_o,
                                                         4.0 * (n_o * d_o + d_o * m_o + 2 * n_o * m_o))

        # The loss and its gradients (each coefficient's, every leaf's).
        params = model.params
        gen = torch.Generator(device=dev).manual_seed(28)
        x, tt = pde.generate_collocation_points(gen, t.batch_size, "uniform")

        def loss_and_grads():
            losses = tr._loss_components(params, x, tt, torch.Generator(device=dev).manual_seed(29))
            return losses["total"].detach(), torch.autograd.grad(losses["total"], tr._leaves(params))

        l_k, g_k = loss_and_grads()
        with plain_fourier_features():
            l_p, g_p = loss_and_grads()
        torch.cuda.synchronize()
        names = sorted(tr.coeffs)
        loss_rel = abs(float(l_k) - float(l_p)) / abs(float(l_p))
        coeff_rel = {n: grad_rel(a, b) for n, a, b in zip(names, g_k, g_p)}
        leaf_rel = max(grad_rel(a, b) for a, b in zip(g_k[len(names):], g_p[len(names):]))
        print(f"[parity] {key} inverse: fourier_features on the data term ({n_o},{d_o})x({d_o},{m_o}): "
              f"max_abs_err {data_err:.3e} rel {data_rel:.3e} (tol {FF_TOL:g}); {data_ms['ms']:.5f} ms, "
              f"plain {data_ms['plain_ms']:.5f} ms, bound {data_ms['bound_ms']:.5f} ms "
              f"({data_ms['bound_by']}); loss through kernel 2 rel {loss_rel:.3e} (tol {loss_tol:g}), "
              f"coefficient gradients rel {coeff_rel}, worst leaf gradient rel {leaf_rel:.3e} "
              f"(tol {grad_tol:g}) ({card})", flush=True)
        if not (data_rel < FF_TOL and loss_rel < loss_tol and leaf_rel < grad_tol
                and all(v < grad_tol for v in coeff_rel.values())):
            raise AssertionError(f"{key}: kernel 2 disagrees with its plain version in inverse mode")

        timed = {"kernels": [], "plain": []}
        for order in ("plain", "kernels", "kernels", "plain"):
            with plain_fourier_features() if order == "plain" else contextlib.nullcontext():
                timed[order] += step_times(tr, INVERSE_TIMED, 1, t.batch_size)
        ms = {o: statistics.median(v) for o, v in timed.items()}
        print(f"[timing] {key} inverse: Adam step (batch {t.batch_size}), median of "
              f"{len(timed['kernels'])}: kernel 2 {ms['kernels']:.3f} ms, plain {ms['plain']:.3f} ms "
              f"({card})", flush=True)
        runs[key] = {**run, "per_loss": {"launches": per_launches, "jvps": per_jvps},
                     "steps": steps, "validations": len(hist["val_loss"]), "wall_s": wall,
                     "identified": {r.parameter: r.identified for r in results},
                     "rel_error": {r.parameter: r.rel_error for r in results},
                     "adam_syncs": syncs, "data_term": {"shape": [n_o, d_o, m_o],
                                                        "max_abs_err": data_err, **data_ms},
                     "loss_rel": loss_rel, "coefficient_grad_rel": coeff_rel,
                     "leaf_grad_rel": leaf_rel, "adam_step_ms": ms}
        del tr, seen, model, pde, params
    return runs


def data_augmented_runs(dev, card: str):
    """Phase 29: the Burgers recipe forward and in data_augmented mode with
    synthetic observations; kernel 1 once per Adam step, L-BFGS evaluation
    and validation in both, kernel 2 once more per loss with the data term,
    and the data_augmented loss and gradients with kernel 1 against plain."""
    import torch

    from pinnrl_tpu_torch.benchmarks.convergence import build_recipe_config
    from pinnrl_tpu_torch.models import PINNModel
    from pinnrl_tpu_torch.ops.kernels import fourier_feats, fused_step
    from pinnrl_tpu_torch.pdes import create_pde
    from pinnrl_tpu_torch.training import PDETrainer
    from pinnrl_tpu_torch.training.lbfgs import LBFGS

    ff = fourier_feats.fourier_features
    runs = {}
    for mode in ("forward", "data_augmented"):
        cfg = build_recipe_config("burgers", epochs=DATA_AUG_EPOCHS, device="cuda")
        cfg.training.mode = mode
        pde = create_pde(cfg)
        if mode == "data_augmented":
            pde.generate_synthetic_observations(
                torch.Generator(device=dev).manual_seed(cfg.pde.observation_seed), DATA_AUG_OBS, 0.01)
        tr = PDETrainer(PINNModel(cfg, seed=0), pde, cfg)
        if not (tr.fused_kernel_active and tr.coeffs == {}):
            raise AssertionError(f"{mode}: kernel 1 {tr.fused_kernel_active}, coefficients {tr.coeffs}")
        t = cfg.training
        fused_step.fused_residual_loss.launches = 0
        ff.launches = ff.jvps = 0
        evals0 = LBFGS.evaluations
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = tr.train(seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        evals = LBFGS.evaluations - evals0
        adam_steps = tr.switch_epoch * (t.num_collocation_points // t.batch_size)
        n_losses = adam_steps + evals + len(tr.history["val_loss"])
        per_ff = 3 if mode == "data_augmented" else 2
        run = {"fused_residual_loss": fused_step.fused_residual_loss.launches,
               "fourier_features": ff.launches, "fourier_features_jvps": ff.jvps}
        want = {"fused_residual_loss": n_losses, "fourier_features": per_ff * n_losses,
                "fourier_features_jvps": 0}
        losses = res["history"]["train_loss"]
        data = res["history"]["loss_components"]["data"]
        print(f"[data] burgers {mode}: {wall:.2f} s, {adam_steps} Adam steps, {evals} L-BFGS "
              f"evaluations, {len(tr.history['val_loss'])} validations; launches {run} (want {want}); "
              f"epoch losses {' '.join(f'{v:.4e}' for v in losses)}; data term "
              f"{' '.join(f'{v:.3e}' for v in data)} ({card})", flush=True)
        if not (len(losses) == DATA_AUG_EPOCHS and all(map(math.isfinite, losses))):
            raise AssertionError(f"{mode}: losses {losses}")
        if run != want:
            raise AssertionError(f"{mode}: launches {run}, want {want}")
        if (mode == "data_augmented") != all(v > 0.0 for v in data):
            raise AssertionError(f"{mode}: data term {data}")
        runs[mode] = {**run, "adam_steps": adam_steps, "evaluations": evals,
                      "validations": len(tr.history["val_loss"]), "wall_s": wall,
                      "per_loss": {"fused_residual_loss": 1, "fourier_features": per_ff}}

    # The data_augmented loss and gradients with kernel 1 and on the plain path.
    loss_tol, grad_tol = FUSED_TOLS["burgers"]
    params = tr.model.params
    x, tt = pde.generate_collocation_points(torch.Generator(device=dev).manual_seed(29),
                                            t.batch_size, "uniform")

    def loss_and_grads():
        losses = tr._loss_components(params, x, tt, torch.Generator(device=dev).manual_seed(30))
        grads = torch.autograd.grad(losses["total"], tr._leaves(params), allow_unused=True,
                                    materialize_grads=True)
        return {k: float(v.detach()) for k, v in losses.items()}, grads

    before = fused_step.fused_residual_loss.launches
    l_k, g_k = loss_and_grads()
    fused = pde._fused_residual_loss
    pde._fused_residual_loss = None
    try:
        l_p, g_p = loss_and_grads()
    finally:
        pde._fused_residual_loss = fused
    rels = {k: abs(l_k[k] - l_p[k]) / abs(l_p[k]) for k in ("total", "residual", "data")}
    worst = max(grad_rel(a, b) for a, b in zip(g_k, g_p))
    print(f"[parity] burgers data_augmented at the trained parameters (N={t.batch_size}): loss "
          f"rel {rels} (tol {loss_tol:g}); worst gradient rel {worst:.3e} (tol {grad_tol:g}); kernel 1 "
          f"launched {fused_step.fused_residual_loss.launches - before} ({card})", flush=True)
    if not (all(v < loss_tol for v in rels.values()) and worst < grad_tol
            and fused_step.fused_residual_loss.launches - before == 1):
        raise AssertionError("data_augmented: kernel 1's loss disagrees with the plain path")
    runs["parity"] = {"loss_rel": rels, "grad_rel": worst}
    return runs


def cli_runs(dev, card: str):
    """Phase 30: ``training.train.main`` in-process (heat inverse, Burgers on
    the shipped Fourier trunk with --rl), each directory's files, metadata,
    history and launches, kernel 1 on the shipped 512x4 trunk against its
    plain version, the saved model and agent state round-tripped, then the
    benchmark CLI's inverse subcommand and its CSV."""
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from pinnrl_tpu_torch.benchmarks import cli as bench_cli
    from pinnrl_tpu_torch.config import Config
    from pinnrl_tpu_torch.models import PINNModel
    from pinnrl_tpu_torch.ops.jet_mlp import make_bundle_fn
    from pinnrl_tpu_torch.ops.kernels import fourier_feats, fused_step, mlp
    from pinnrl_tpu_torch.training import train as train_cli

    ff = fourier_feats.fourier_features
    counters = {"fused_residual_loss": fused_step.fused_residual_loss, "fourier_features": ff,
                "fused_mlp_score": mlp.fused_mlp_score}
    runs = {}
    common = ["--epochs", str(CLI_EPOCHS)]
    cases = {"heat_inverse": ["--pde", "heat", "--mode", "inverse", "--identify", "alpha",
                              "--initial-guess", "alpha=0.5", "--obs-noise", "0.01"],
             "burgers_rl": ["--pde", "burgers", "--arch", "fourier", "--rl"]}
    with tempfile.TemporaryDirectory() as tmp:
        for name, argv in cases.items():
            for c in counters.values():
                c.launches = 0
            ff.jvps = 0
            out = Path(tmp) / name
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with captured_trainers() as seen:
                rc = train_cli.main(argv + common + ["--results-dir", str(out)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            (tr,) = seen
            (exp,) = out.iterdir()
            run = {k: c.launches for k, c in counters.items()}
            run["fourier_features_jvps"] = ff.jvps
            files = {p.name for p in exp.iterdir()}
            meta = json.loads((exp / "metadata.json").read_text())
            hist = json.loads((exp / "history.json").read_text())
            t = tr.tcfg
            steps = CLI_EPOCHS * (t.num_collocation_points // t.batch_size)
            vals = len(hist["val_loss"])
            inverse = name == "heat_inverse"
            # Per loss: heat inverse IC, periodic faces (rule) and data; Burgers
            # BC and IC; one more launch per validation for the live snapshot,
            # and for heat one at the end for the FDM comparison's grid.
            want = {"fused_residual_loss": 0 if inverse else steps + vals,
                    "fourier_features": (3 if inverse else 2) * (steps + vals) + vals
                    + int(inverse),
                    "fused_mlp_score": 0 if inverse else steps,
                    "fourier_features_jvps": (steps + vals) if inverse else 0}
            want_files = CLI_FILES | ({"fdm_comparison.json"} if inverse else {"rl_agent.npz"})
            print(f"[cli] {name}: main({' '.join(argv + common)}) rc {rc}, {wall:.2f} s, {steps} "
                  f"steps, {vals} validation(s), trunk {tr.model.config.hidden_dims}, mapping {tr.model.config.arch_params.get('mapping_size')}; files "
                  f"{sorted(files)}; status {meta['status']}; identified "
                  f"{meta.get('identified_parameters')}; launches {run} (want {want}) ({card})",
                  flush=True)
            if not (rc == 0 and files == want_files and meta["status"] == "completed"
                    and len(hist["train_loss"]) == CLI_EPOCHS
                    and all(map(math.isfinite, hist["train_loss"]))):
                raise AssertionError(f"{name}: rc {rc}, files {sorted(files)}, meta {meta}")
            if inverse and len(hist["param_alpha"]) != CLI_EPOCHS:
                raise AssertionError(f"{name}: param_alpha {hist['param_alpha']}")
            if run != want:
                raise AssertionError(f"{name}: launches {run}, want {want}")
            with np.load(exp / "live_snapshot.npz") as snap:
                if snap["u_pred"].shape != (60, 60) or not np.isfinite(snap["residual"]).all():
                    raise AssertionError(f"{name}: live snapshot {snap['u_pred'].shape}")

            # The saved model and agent state, loaded back.
            snap_cfg = Config.from_snapshot(json.loads((exp / "config.yaml").read_text()))
            loaded = PINNModel(snap_cfg, seed=1)
            loaded.load_state(str(exp / "final_model.npz"))
            if not all(torch.equal(loaded.module.state_dict()[k], v)
                       for k, v in tr.model.module.state_dict().items()):
                raise AssertionError(f"{name}: final_model.npz does not round-trip")
            entry = {**run, "steps": steps, "validations": vals, "wall_s": wall}
            if not inverse:
                agent, state = tr.rl_agent, tr._rl_state
                back = agent.load_state(str(exp / "rl_agent.npz"),
                                        agent.init(torch.Generator().manual_seed(1)))
                same = (all(torch.equal(back.policy_params[k], v) for k, v in state.policy_params.items())
                        and all(torch.equal(back.target_params[k], v)
                                for k, v in state.target_params.items())
                        and torch.equal(back.buf_state, state.buf_state)
                        and torch.equal(back.epsilon, state.epsilon)
                        and (back.ptr, back.size, back.steps) == (state.ptr, state.size, state.steps))
                if not same:
                    raise AssertionError(f"{name}: rl_agent.npz does not round-trip")

                # Kernel 1 on the shipped Fourier trunk against its plain version.
                pde = tr.pde
                loss_tol, grad_tol = FUSED_TOLS["burgers"]
                p = {k: v.detach().requires_grad_(True) for k, v in tr.model.params.items()}
                x, tt = pde.generate_collocation_points(torch.Generator(device=dev).manual_seed(31),
                                                        t.batch_size, "uniform")
                z = torch.cat([x, tt], dim=-1)
                lk = pde._fused_residual_loss(p, z)
                gk = torch.autograd.grad(lk, list(p.values()))
                bundle_fn = make_bundle_fn(tr.model, pde.dimension, max(pde.spatial_orders),
                                           max(pde.temporal_orders))
                lp = fused_step.fused_residual_loss_plain(bundle_fn, pde, p, z)
                gp = torch.autograd.grad(lp, list(p.values()), allow_unused=True,
                                         materialize_grads=True)
                torch.cuda.synchronize()
                loss_rel = abs(float(lk) - float(lp)) / abs(float(lp))
                worst = max(grad_rel(a, b) for a, b in zip(gk, gp))
                err = max(float((a - b).abs().max()) for a, b in zip(gk, gp))
                print(f"[parity] kernel 1 on the shipped Fourier trunk "
                      f"({tr.model.config.hidden_dims}, mapping "
                      f"{tr.model.config.arch_params.get('mapping_size')}, N={t.batch_size}): loss rel "
                      f"{loss_rel:.3e} (tol {loss_tol:g}); worst gradient rel {worst:.3e} (tol "
                      f"{grad_tol:g}), max_abs_err {err:.3e} ({card})", flush=True)
                if not (loss_rel < loss_tol and worst < grad_tol):
                    raise AssertionError("kernel 1 disagrees with its plain version at 512x4")
                entry["kernel1_512"] = {"loss_rel": loss_rel, "grad_rel": worst, "max_abs_err": err}
            runs[name] = entry

        csv_path = Path(tmp) / "inverse.csv"
        rc = bench_cli.main(["inverse", "--pde", "heat", "--epochs", str(CLI_EPOCHS),
                             "--csv", str(csv_path)])
        lines = csv_path.read_text().strip().split("\n")
        print(f"[cli] benchmarks.cli inverse --pde heat --epochs {CLI_EPOCHS}: rc {rc}; {lines}",
              flush=True)
        if not (rc == 0 and lines[0] == "pde,parameter,true_value,initial_guess,identified,"
                "rel_error,epochs,noise,wall_time_s,seed" and lines[1].startswith("heat,alpha,")):
            raise AssertionError(f"benchmarks.cli inverse: rc {rc}, {lines}")
    return runs


def _mlp_bound(n: int, d: int, h: int, params):
    """(ms, what bounds it) of one scorer call on (n, d) points, width h:
    its three products and LayerNorm / ReLU work; the grid, the weights and
    the scores moved once."""
    return bound(2.0 * n * (d * h + h * h + h) + 2 * 8.0 * n * h,
                 4.0 * (n * d + sum(v.numel() for v in params.values()) + n))


def _ff_bound(n: int, d: int, m: int):
    return bound(2.0 * n * d * m + 3.0 * n * m, 4.0 * (n * d + d * m + 2 * n * m))


def sampling_runs(dev, card: str):
    """Phase 31 (see the module docstring): the sampling harness's
    strategies, their exact launches, falling losses, ms per step, points/s
    and host syncs per step; kernel 4 at h = 64, d = 2 and 3, and kernel 2
    at mapping 32 on the harness's own shapes and weights."""
    import torch

    from pinnrl_tpu_torch.benchmarks import sampling
    from pinnrl_tpu_torch.ops.kernels import fourier_feats, fused_step, mlp
    from pinnrl_tpu_torch.sampling import make_grid

    ff = fourier_feats.fourier_features
    counters = {"fused_residual_loss": fused_step.fused_residual_loss, "fourier_features": ff,
                "fused_mlp_score": mlp.fused_mlp_score}
    seen = {}  # id(_Run) -> its losses, step by step (device tensors)
    step_on = sampling._Run.step_on

    def recording(self, *args, **kwargs):
        loss = step_on(self, *args, **kwargs)
        seen.setdefault(id(self), []).append(loss)
        return loss

    sampling._Run.step_on = recording
    rows = {}
    try:
        for pde_key, strategy, windows in SAMPLING_CASES:
            epochs = SAMPLING_EPOCHS[pde_key]
            for c in counters.values():
                c.launches = 0
            ff.jvps = 0
            seen.clear()
            (r,) = sampling.run_sampling_benchmark(pde=pde_key, strategies=[strategy],
                                                   epochs=epochs, batch=SAMPLING_BATCH, seed=0,
                                                   windows=windows, device="cuda")
            torch.cuda.synchronize()
            run = {k: c.launches for k, c in counters.items()}
            run["fourier_features_jvps"] = ff.jvps
            per_phase = sampling._phase_epochs(epochs, windows)
            steps = epochs + min(per_phase[0], sampling.WARMUP_STEPS)  # the warm-up copy's too
            adaptive = strategy.startswith("adaptive")
            per_step = SAMPLING_FF_PER_STEP[pde_key]
            want = {"fused_residual_loss": 0, "fourier_features": per_step[0] * steps + 1,
                    "fused_mlp_score": steps if adaptive else 0,
                    "fourier_features_jvps": per_step[1] * steps}
            (losses,) = [torch.stack(v).tolist() for v in seen.values() if len(v) == epochs]
            head, tail = statistics.mean(losses[:3]), statistics.mean(losses[-3:])
            label = f"{pde_key} {r.strategy}" + (f" windows={windows}" if windows else "")
            print(f"[sampling] {label}: {epochs} steps of {SAMPLING_BATCH} (+ {steps - epochs} "
                  f"warm-up), {r.wall_time_s * 1e3 / epochs:.3f} ms per step, "
                  f"{r.points_per_sec:.1f} points/s; loss {head:.4e} -> {tail:.4e} (mean of the "
                  f"first and last 3), final {r.final_loss:.4e}, rel_l2 {r.rel_l2:.4e}, l2 "
                  f"{r.l2_error:.4e}; launches {run} (want {want}) ({card})", flush=True)
            if not (all(map(math.isfinite, losses)) and math.isfinite(r.rel_l2)
                    and math.isfinite(r.l2_error) and r.epochs == epochs and tail < head):
                raise AssertionError(f"{label}: losses {losses}, row {r}")
            if run != want:
                raise AssertionError(f"{label}: launches {run}, want {want}")
            rows[label] = {**run, "steps": epochs, "warmup_steps": steps - epochs,
                           "ms_per_step": r.wall_time_s * 1e3 / epochs,
                           "points_per_sec": r.points_per_sec, "wall_s": r.wall_time_s,
                           "loss_head": head, "loss_tail": tail, "rel_l2": r.rel_l2}
    finally:
        sampling._Run.step_on = step_on

    # Host syncs of one warm step, per strategy.
    syncs = {}
    for strategy in ("uniform", "stratified", "residual_based", "adaptive",
                     "adaptive[resfeat_improve]"):
        ((base, variant),) = sampling.parse_strategies([strategy])
        run = sampling._Run("burgers", base, 10, SAMPLING_BATCH, 2e-3, 0, rl_variant=variant,
                            device="cuda")
        g = torch.Generator(device=dev).manual_seed(31)
        for _ in range(2):
            run.step(run.pde, g)
        sites = record_syncs(lambda: run.step(run.pde, g))
        syncs[strategy] = len(sites)
        print(f"[syncs] sampling {strategy}: one warm step {len(sites)} {sorted(set(sites))}",
              flush=True)

    # Kernel 4 at the harness's width on its agents' weights (after 10 steps),
    # on the 100 x 100 grid and the grid with the residual feature.
    k4 = {}
    for variant in ("coord", "resfeat"):
        run = sampling._Run("burgers", "adaptive", 10, SAMPLING_BATCH, 2e-3, 0, rl_variant=variant,
                            device="cuda")
        g = torch.Generator(device=dev).manual_seed(32)
        for _ in range(10):
            run.step(run.pde, g)
        q = {k: v.detach() for k, v in run.rl_state.policy_params.items()}
        grid = make_grid(run.pde.domain, run.pde.time_domain, 100, device=dev)
        with torch.no_grad():
            if variant == "resfeat":
                grid = torch.cat([grid, run.res_feature(run.params, grid)], dim=-1)
            n, d = grid.shape
            h = q["Dense_1.weight"].shape[0]
            s1 = mlp.fused_mlp_score(grid, q)
            s2 = mlp.fused_mlp_score(grid, q)
            sp = mlp.fused_mlp_score_plain(grid, q)
            torch.cuda.synchronize()
            err = float((s1 - sp).abs().max())
            rel = err / float(sp.abs().max())
            same = torch.equal(s1, s2)
            times = {"ms": graph_ms(lambda: mlp.fused_mlp_score(grid, q)),
                     "plain_ms": graph_ms(lambda: mlp.fused_mlp_score_plain(grid, q)),
                     "library_ms": cublas_ms([(n, d, h), (n, h, h), (n, h, 1)], dev, iters=50)}
        times["bound_ms"], times["bound_by"] = _mlp_bound(n, d, h, q)
        tag = f"({n},{d})->{h}->{h}->1"
        print(f"[parity] fused_mlp_score {tag} on the harness's {variant} agent: max_abs_err "
              f"{err:.3e} rel {rel:.3e} (tol {MLP_TOL:g}); two calls bit-identical {same}; "
              f"kernel {times['ms']:.5f} ms, plain {times['plain_ms']:.5f} ms, cuBLAS (its 3 "
              f"products) {times['library_ms']:.5f} ms, bound {times['bound_ms']:.5f} ms "
              f"({times['bound_by']}) (CUDA graph) ({card})", flush=True)
        if not (rel < MLP_TOL and same):
            raise AssertionError(f"fused_mlp_score disagrees with its plain version at {tag}")
        k4[tag] = {"max_abs_err": err, **times, "launches_per_step": 1}

    # Kernel 2 at mapping 32 on the harness's rows: the BC and IC batches
    # and the 64^2 evaluation grid, mapped as the network maps them.
    run = sampling._Run("burgers", "uniform", 10, SAMPLING_BATCH, 2e-3, 0, device="cuda")
    model, pde = run.model, run.pde
    B = model.constants["FourierFeatures_0.B"]
    periodic = model.module.FourierFeatures_0.periodic
    g = torch.Generator(device=dev).manual_seed(33)
    xb, tb = pde._sample_boundary_points(g, pde._bc_counts(SAMPLING_BATCH)[0])
    xi, ti = pde._sample_initial_points(g, pde._bc_counts(SAMPLING_BATCH)[1])
    xe, te = sampling._fixed_validation_grid(pde)
    k2 = {}
    for what, (xs, ts) in (("bc", (xb, tb)), ("ic", (xi, ti)), ("evaluate", (xe, te))):
        z = model.map_inputs(torch.cat([xs, ts], dim=-1)).contiguous()
        n, d, m = z.shape[0], z.shape[1], B.shape[1]
        with torch.no_grad():
            f1 = fourier_feats.fourier_features(z, B, periodic)
            f2 = fourier_feats.fourier_features(z, B, periodic)
            fp = fourier_feats.fourier_features_plain(z, B, periodic)
        torch.cuda.synchronize()
        err = float((f1 - fp).abs().max())
        rel = err / float(fp.abs().max())
        times = {"ms": graph_ms(lambda: fourier_feats.fourier_features(z, B, periodic)),
                 "plain_ms": graph_ms(lambda: fourier_feats.fourier_features_plain(z, B, periodic))}
        times["bound_ms"], times["bound_by"] = _ff_bound(n, d, m)
        plan = fourier_feats.launch_plan(n, d, m, B.data_ptr() % 16 == 0,
                                         fourier_feats._sm_count(z.get_device()))
        tag = f"({n},{d})x({d},{m}) {what}"
        print(f"[parity] fourier_features {tag} (path {plan[0]}, grid {plan[1]}x{plan[2]}): "
              f"max_abs_err {err:.3e} rel {rel:.3e} (tol {FF_TOL:g}); two calls bit-identical "
              f"{torch.equal(f1, f2)}; kernel {times['ms']:.5f} ms, plain {times['plain_ms']:.5f} "
              f"ms, bound {times['bound_ms']:.5f} ms ({times['bound_by']}) (CUDA graph) ({card})",
              flush=True)
        if not (rel < FF_TOL and torch.equal(f1, f2)):
            raise AssertionError(f"fourier_features disagrees with its plain version at {tag}")
        k2[tag] = {"max_abs_err": err, **times}
    # Its jvp rule at mapping 32 (wave's velocity IC runs through it): orders
    # 1-2 along t on the IC rows, against the plain version.
    z = model.map_inputs(torch.cat([xi, ti], dim=-1)).contiguous()
    v = torch.zeros_like(z)
    v[:, -1] = 1.0
    jvp_err = {}
    for order in (1, 2):
        def nest(fn, k):
            if k == 0:
                return lambda zz: fn(zz, B, periodic)
            inner = nest(fn, k - 1)
            return lambda zz: torch.func.jvp(inner, (zz,), (v,))[1]
        got = nest(fourier_feats.fourier_features, order)(z)
        ref = nest(fourier_feats.fourier_features_plain, order)(z)
        torch.cuda.synchronize()
        jvp_err[order] = float((got - ref).abs().max()) / float(ref.abs().max())
    print(f"[parity] fourier_features jvp rule at ({z.shape[0]},2)x(2,{B.shape[1]}), orders 1-2 "
          f"along t: rel {jvp_err} (tol JVP_TOL x 10^(k-1), {JVP_TOL:g})", flush=True)
    if not all(e < JVP_TOL * 10 ** (k - 1) for k, e in jvp_err.items()):
        raise AssertionError("fourier_features' jvp rule disagrees with its plain version at m = 32")
    return {"runs": rows, "syncs_per_step": syncs, "kernel4": k4, "kernel2": k2,
            "kernel2_jvp_rel": jvp_err}


def fdm_runs(dev, card: str):
    """Phase 32: ``cli fdm --pde all`` on the card, each L2 error against a
    CPU run of the same solve, the fields too, and both stability guards."""
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from pinnrl_tpu_torch.benchmarks import cli as bench_cli
    from pinnrl_tpu_torch.benchmarks.fdm import solve_heat_1d, solve_wave_1d

    with tempfile.TemporaryDirectory() as tmp:
        csv_path = Path(tmp) / "fdm.csv"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = bench_cli.main(["fdm", "--pde", "all", "--csv", str(csv_path)])
        cli_wall = time.perf_counter() - t0
        lines = csv_path.read_text().strip().split("\n")
    if not (rc == 0 and lines[0] == "pde,scheme,stability,l2_error" and len(lines) == 3):
        raise AssertionError(f"cli fdm: rc {rc}, {lines}")
    out = {"cli_wall_s": cli_wall}
    for name, solve in (("heat", solve_heat_1d), ("wave", solve_wave_1d)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card_res = solve(device="cuda")
        wall = time.perf_counter() - t0
        cpu_res = solve(device="cpu")
        field = float(np.abs(card_res.u - cpu_res.u).max())
        printed = float(next(ln for ln in lines if ln.startswith(name)).split(",")[-1])
        print(f"[fdm] {name} ({card_res.scheme}, {card_res.u.shape[0]} steps x "
              f"{card_res.u.shape[1]} points, stability {card_res.stability:.4f}): l2 card "
              f"{card_res.l2_error:.6e}, CPU {cpu_res.l2_error:.6e} (tol {FDM_TOL:g}), CSV "
              f"{printed:.3e}; field max |card - CPU| {field:.3e}; solve {wall * 1e3:.1f} ms on "
              f"the card ({card})", flush=True)
        if not (abs(card_res.l2_error - cpu_res.l2_error) < FDM_TOL and field < FDM_TOL
                and abs(printed - card_res.l2_error) <= 6e-4 * card_res.l2_error):
            raise AssertionError(f"fdm {name}: the card's solve disagrees with the CPU's")
        out[name] = {"l2_error": card_res.l2_error, "cpu_l2_error": cpu_res.l2_error,
                     "field_max_diff": field, "stability": card_res.stability, "solve_ms": wall * 1e3}
    for name, solve, kw, match in (("heat", solve_heat_1d, dict(alpha=1.0, nx=201, nt=11, t_max=1.0),
                                    "unstable"),
                                   ("wave", solve_wave_1d, dict(c=10.0, nx=1001, nt=11, t_max=1.0),
                                    "CFL")):
        try:
            solve(device="cuda", **kw)
        except ValueError as exc:
            if match not in str(exc):
                raise
            print(f"[fdm] {name} guard raised: {exc}", flush=True)
        else:
            raise AssertionError(f"fdm {name}: the stability guard did not raise")
    return out


def operator_runs(dev, card: str):
    """Phase 33: the point-wise operator run (the registry's FNO 256x4, 16
    modes, 8192 points, a few epochs; no kernel), the gridded run with a
    96^2 transfer row, ``GridFNO2D`` on the card against the CPU on the same
    weights, and ``train --dataset synthetic_heat_2d`` for 2 epochs; the
    Well cache in a temporary directory."""
    import os
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from pinnrl_tpu_torch.benchmarks import operator
    from pinnrl_tpu_torch.datasets.synthetic import ensure_synthetic_well_cache
    from pinnrl_tpu_torch.models.fno_grid import GridFNO2D
    from pinnrl_tpu_torch.ops.kernels import fourier_feats, fused_step, mlp, siren
    from pinnrl_tpu_torch.training import train as train_cli

    counters = {"fused_residual_loss": fused_step.fused_residual_loss,
                "fourier_features": fourier_feats.fourier_features,
                "siren_layer": siren.siren_layer, "fused_mlp_score": mlp.fused_mlp_score}
    old_cache = os.environ.get("PINNRL_WELL_CACHE")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["PINNRL_WELL_CACHE"] = str(Path(tmp) / "well")
        try:
            for c in counters.values():
                c.launches = 0
            torch.cuda.synchronize()
            with captured_trainers() as seen:
                r = operator.run_operator_benchmark("synthetic_heat_2d", epochs=OPERATOR_EPOCHS,
                                                    n_points=8192, seed=0, device="cuda")
            torch.cuda.synchronize()
            (tr,) = seen
            launches = {k: c.launches for k, c in counters.items()}
            hist = tr.history["train_loss"]
            ap = tr.model.config.arch_params
            steps = OPERATOR_EPOCHS * (tr.tcfg.num_collocation_points // tr.tcfg.batch_size)
            print(f"[operator] point-wise {r.dataset} ({r.architecture} {ap['hidden_dim']}x"
                  f"{ap['num_blocks']}, {ap['modes']} modes, {r.mode}, {r.train_points} points): "
                  f"{OPERATOR_EPOCHS} epochs ({steps} steps) in {r.wall_time_s:.2f} s, "
                  f"{r.wall_time_s * 1e3 / steps:.1f} ms per step; train loss "
                  f"{' '.join(f'{v:.4e}' for v in hist)}; held-out rel_l2 {r.test_rel_l2:.4e} "
                  f"(no bar at {OPERATOR_EPOCHS} epochs), max error {r.test_max_error:.4e}; "
                  f"launches {launches} ({card})", flush=True)
            if not ((ap["hidden_dim"], ap["num_blocks"], ap["modes"]) == (256, 4, 16)
                    and all(map(math.isfinite, hist)) and hist[-1] < hist[0]
                    and math.isfinite(r.test_rel_l2) and not any(launches.values())):
                raise AssertionError(f"point-wise operator: losses {hist}, row {r}, {launches}")
            out["pointwise"] = {"rel_l2": r.test_rel_l2, "wall_s": r.wall_time_s,
                                "ms_per_step": r.wall_time_s * 1e3 / steps, "losses": hist,
                                "launches": launches}

            rs = operator.run_gridded_operator_benchmark(epochs=GRIDDED_EPOCHS,
                                                         transfer_resolutions=(96,), seed=0,
                                                         device="cuda")
            print(f"[operator] gridded ({rs[0].epochs} steps of 16 pairs, width 32, 12 modes, 4 "
                  f"blocks): {rs[0].wall_time_s:.2f} s, {rs[0].wall_time_s * 1e3 / rs[0].epochs:.2f} "
                  f"ms per step, final loss {rs[0].final_train_loss:.4e}; "
                  + "; ".join(f"{x.dataset} rel_l2 {x.test_rel_l2:.4e} max {x.test_max_error:.4e}"
                              for x in rs) + f" ({card})", flush=True)
            if not (len(rs) == 2 and all(math.isfinite(x.test_rel_l2) for x in rs)
                    and math.isfinite(rs[0].final_train_loss)):
                raise AssertionError(f"gridded operator: rows {rs}")
            out["gridded"] = {x.dataset: {"rel_l2": x.test_rel_l2, "epochs": x.epochs,
                                          "wall_s": x.wall_time_s} for x in rs}

            # GridFNO2D on the card against the CPU, the same weights, at the
            # training grid and the transfer grid.
            fno = GridFNO2D(grid=(48, 48), generator=torch.Generator().manual_seed(0))
            fno_card = GridFNO2D(grid=(48, 48)).to(dev)
            fno_card.load_state_dict(fno.state_dict())
            grid_err = {}
            for res in (48, 96):
                a = torch.randn((4, res, res, 1), generator=torch.Generator().manual_seed(res))
                with torch.no_grad():
                    ref = fno(a)
                    got = fno_card(a.to(dev)).cpu()
                grid_err[res] = float((got - ref).abs().max()) / float(ref.abs().max())
            print(f"[operator] GridFNO2D card vs CPU forward, rel to max: {grid_err} (tol "
                  f"{GRID_FNO_TOL:g}) ({card})", flush=True)
            if not all(e < GRID_FNO_TOL for e in grid_err.values()):
                raise AssertionError(f"GridFNO2D's card forward disagrees with the CPU's: {grid_err}")
            out["grid_fno_card_vs_cpu"] = grid_err

            ensure_synthetic_well_cache(split="train", n_traj=1, n_points=4096, seed=0)
            results = Path(tmp) / "runs"
            argv = ["--pde", "heat_2d", "--dataset", "synthetic_heat_2d", "--epochs", "2",
                    "--results-dir", str(results)]
            t0 = time.perf_counter()
            rc = train_cli.main(argv)
            wall = time.perf_counter() - t0
            (exp,) = results.iterdir()
            meta = json.loads((exp / "metadata.json").read_text())
            thist = json.loads((exp / "history.json").read_text())["train_loss"]
            print(f"[operator] train {' '.join(argv[:6])}: rc {rc}, {wall:.2f} s, {exp.name}, "
                  f"mode {meta['mode']}, losses {thist} ({card})", flush=True)
            if not (rc == 0 and meta["status"] == "completed" and meta["mode"] == "data_only"
                    and "synthetic_heat_2d" in exp.name and len(thist) == 2
                    and all(map(math.isfinite, thist))):
                raise AssertionError(f"train --dataset: rc {rc}, {meta}")
            out["train_dataset"] = {"wall_s": wall, "losses": thist}
        finally:
            if old_cache is None:
                os.environ.pop("PINNRL_WELL_CACHE", None)
            else:
                os.environ["PINNRL_WELL_CACHE"] = old_cache
    return out


def _launches():
    """The four kernels' launch counters and kernel 2's jvp-rule calls."""
    from pinnrl_tpu_torch.ops.kernels import fourier_feats, fused_step, mlp, siren

    ff = fourier_feats.fourier_features
    return {"fused_residual_loss": fused_step.fused_residual_loss.launches,
            "fourier_features": ff.launches, "fourier_features_jvps": ff.jvps,
            "siren_layer": siren.siren_layer.launches,
            "fused_mlp_score": mlp.fused_mlp_score.launches}


@contextlib.contextmanager
def per_train_launches():
    """Each ``PDETrainer.train`` inside the block, in order: (trainer, the
    launches its run made, by difference, and a copy of the network's
    parameters at its end)."""
    import torch

    from pinnrl_tpu_torch.training import trainer as trainer_mod

    seen = []
    train = trainer_mod.PDETrainer.train

    def recording(self, *args, **kwargs):
        torch.cuda.synchronize()
        before = _launches()
        res = train(self, *args, **kwargs)
        torch.cuda.synchronize()
        seen.append((self, {k: v - before[k] for k, v in _launches().items()},
                     {k: v.detach().clone() for k, v in self.model.params.items()}))
        return res

    trainer_mod.PDETrainer.train = recording
    try:
        yield seen
    finally:
        trainer_mod.PDETrainer.train = train


def lever_config(device: str, **training):
    """The Burgers recipe slice (``burgers_recipe_config``: Fourier 256x3,
    mapping 128, batch 8192 of 40000, uniform, Adam) at ``LEVER_EPOCHS``
    epochs, one validation per epoch, with ``training``'s overrides."""
    cfg = burgers_recipe_config(device)
    t = cfg.training
    t.num_epochs, t.validation_frequency = LEVER_EPOCHS, 1
    for k, v in training.items():
        setattr(t, k, v)
    return cfg


def lever_runs(dev, card: str):
    """Phase 34: the trainer's levers on the Burgers recipe slice (see the
    module docstring)."""
    import tempfile
    from pathlib import Path

    import torch

    from pinnrl_tpu_torch.models import PINNModel
    from pinnrl_tpu_torch.pdes import create_pde
    from pinnrl_tpu_torch.training import PDETrainer
    from pinnrl_tpu_torch.training.lbfgs import LBFGS
    from pinnrl_tpu_torch.training.trainer import AdamStep

    steps_per_epoch = 40000 // 8192
    out = {}

    def trainer(cfg):
        return PDETrainer(PINNModel(cfg, seed=0), create_pde(cfg), cfg)

    def check_syncs(name, tr):
        """Host round trips of one warm Adam step of the lever's trainer
        (an EMA step too where the trainer keeps a shadow): none."""
        n, sites = count_syncs(tr, 8192)
        out[name]["syncs_per_step"] = n
        print(f"[levers] {name}: host syncs per Adam step {n} {sites} ({card})", flush=True)
        if n:
            raise AssertionError(f"{name}: {n} host syncs per Adam step at {sites}")

    def run(name, tr, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with per_train_launches() as seen:
            res = tr.train(seed=0, **kw)
        wall = time.perf_counter() - t0
        ((_, launches, _),) = seen
        hist = res["history"]
        entry = {"launches": launches, "train_loss": hist["train_loss"], "wall_s": wall,
                 "validations": len(hist["val_loss"])}
        out[name] = entry
        return res, entry

    # Adaptive weights: kernel 1 once per step and per validation, the loss
    # finite and falling, each epoch's mean weights summing to 1.
    for strategy in ("rbw", "lrw"):
        cfg = lever_config("cuda")
        cfg.training.adaptive_weights.enabled = True
        cfg.training.adaptive_weights.strategy = strategy
        tr = trainer(cfg)
        res, e = run(strategy, tr)
        hist = res["history"]
        steps = LEVER_EPOCHS * steps_per_epoch
        want = steps + e["validations"]
        sums = [sum(w[:3]) for w in hist["adaptive_weights"]]
        print(f"[levers] {strategy}: {steps} Adam steps, {e['validations']} validations in "
              f"{e['wall_s']:.2f} s; weighted loss "
              f"{' '.join(f'{v:.4e}' for v in hist['train_loss'])}; "
              f"weights {[[round(v, 4) for v in w[:3]] for w in hist['adaptive_weights']]}; "
              f"launches {e['launches']} (kernel 1 want {want}) ({card})", flush=True)
        if not (e["launches"]["fused_residual_loss"] == want
                and all(map(math.isfinite, hist["train_loss"]))
                and hist["train_loss"][-1] < hist["train_loss"][0]
                and all(abs(s - 1.0) < 1e-5 for s in sums)):
            raise AssertionError(f"{strategy}: {e}, weight sums {sums}")
        check_syncs(strategy, tr)

    # The plateau schedule: a patience of 1 step at lr 1e-2 (at the recipe's
    # 2e-3 the slice's loss falls at every one of its 16 steps); the scale
    # after every step.
    cfg = lever_config("cuda", scheduler_type="reduce_lr")
    cfg.training.lr_scheduler.patience = 1
    cfg.training.optimizer_config.learning_rate = 1e-2
    tr = trainer(cfg)
    scales = []
    advance = AdamStep.advance

    def recording_advance(self):
        # After every step, eager or replayed (a replay runs no step()).
        advance(self)
        if self.plateau is not None:
            scales.append(self.scale.clone())

    AdamStep.advance = recording_advance
    try:
        res, e = run("reduce_lr", tr)
    finally:
        AdamStep.advance = advance
    traj = [float(s) for s in scales]
    e["scales"] = traj
    print(f"[levers] reduce_lr (factor {cfg.training.lr_scheduler.factor}, patience 1, lr "
          f"1e-2): scale after each step {traj}; learning_rate history {res['history']['learning_rate']}; "
          f"launches {e['launches']} ({card})", flush=True)
    if not (len(traj) == LEVER_EPOCHS * steps_per_epoch and min(traj) < 1.0
            and all(map(math.isfinite, e["train_loss"]))):
        raise AssertionError(f"reduce_lr: scales {traj}")
    check_syncs("reduce_lr", tr)

    # EMA 0.99 with adam_lbfgs: phase 2 starts from the debiased average.
    cfg = lever_config("cuda", param_ema=0.99, optimizer="adam_lbfgs",
                       adam_lbfgs_switch_ratio=0.5)
    tr = trainer(cfg)
    at_switch, starts = [], []
    ema_apply, lbfgs_pieces = tr._ema_apply, tr._lbfgs_pieces

    def recording_apply(params):
        if not at_switch:
            at_switch.append([a.clone() for a in tr._ema_read()])
        ema_apply(params)

    def recording_lbfgs(params, *args):
        # The phase's iterations replay one capture: its first point is the
        # parameters when its pieces are built.
        if not starts:
            starts.append([p.detach().clone() for p in params.values()])
        return lbfgs_pieces(params, *args)

    tr._ema_apply, tr._lbfgs_pieces = recording_apply, recording_lbfgs
    evals0 = LBFGS.evaluations
    res, e = run("ema_adam_lbfgs", tr)
    evals = LBFGS.evaluations - evals0
    switch = LEVER_EPOCHS // 2
    want = switch * steps_per_epoch + evals + e["validations"]
    same = all(torch.equal(a, b) for a, b in zip(at_switch[0], starts[0]))
    e.update(evaluations=evals, starts_from_average=same)
    print(f"[levers] param_ema 0.99, adam_lbfgs: {switch} Adam epochs, {LEVER_EPOCHS - switch} "
          f"L-BFGS iterations ({evals} evaluations); phase 2 starts from the debiased average: "
          f"{same}; losses {e['train_loss']}; launches {e['launches']} (kernel 1 want {want}) "
          f"({card})", flush=True)
    if not (same and e["launches"]["fused_residual_loss"] == want
            and all(map(math.isfinite, e["train_loss"]))):
        raise AssertionError(f"ema: {e}")
    check_syncs("ema_adam_lbfgs", tr)

    # The smoothness and gPINN penalties at 0.1 each.
    cfg = lever_config("cuda")
    cfg.training.loss_weights.update({"smoothness": 0.1, "gpinn": 0.1})
    tr = trainer(cfg)
    res, e = run("penalties", tr)
    comps = res["history"]["loss_components"]
    want = LEVER_EPOCHS * steps_per_epoch + e["validations"]
    print(f"[levers] smoothness 0.1 + gPINN 0.1: losses {e['train_loss']}; smoothness "
          f"{comps['smoothness']}; {e['wall_s']:.2f} s; launches {e['launches']} (kernel 1 want "
          f"{want}) ({card})", flush=True)
    if not (e["launches"]["fused_residual_loss"] == want
            and e["launches"]["fourier_features_jvps"] > 0
            and all(map(math.isfinite, e["train_loss"]))
            and e["train_loss"][-1] < e["train_loss"][0] and min(comps["smoothness"]) > 0.0):
        raise AssertionError(f"penalties: {e}")
    check_syncs("penalties", tr)

    with tempfile.TemporaryDirectory() as tmp:
        # Checkpointed at epoch 2 and resumed against the uninterrupted run.
        keep = Path(tmp) / "ck"
        tr = trainer(lever_config("cuda", optimizer="adam_lbfgs", adam_lbfgs_switch_ratio=0.5,
                                  param_ema=0.9))
        save = tr._save_checkpoint

        def saving(path, epoch, *args):
            save(path, epoch, *args)
            if epoch == 2:
                keep.mkdir()
                for f in ("checkpoint.npz", "checkpoint.json"):
                    (keep / f).write_bytes((path.parent / f).read_bytes())

        tr._save_checkpoint = saving
        res, e = run("uninterrupted", tr, experiment_dir=str(Path(tmp) / "a"))
        tr2 = trainer(lever_config("cuda", optimizer="adam_lbfgs", adam_lbfgs_switch_ratio=0.5,
                                   param_ema=0.9))
        res2, e2 = run("resumed", tr2, experiment_dir=str(Path(tmp) / "b"),
                       resume_from=str(keep / "checkpoint.npz"))
        p1, p2 = tr.model.params, tr2.model.params
        bits = (res2["history"]["train_loss"] == res["history"]["train_loss"]
                and all(torch.equal(p1[k], p2[k]) for k in p1))
        p_diff = max(float((p1[k] - p2[k]).detach().abs().max()) for k in p1)
        l_diff = max(abs(a - b) / abs(b) for a, b in zip(res2["history"]["train_loss"],
                                                         res["history"]["train_loss"]))
        out["resume"] = {"bit_identical": bits, "max_param_diff": p_diff, "max_loss_rel": l_diff,
                         "resumed_launches": e2["launches"]}
        print(f"[levers] resume at epoch 2 of {LEVER_EPOCHS} (adam_lbfgs, EMA 0.9): bit-identical "
              f"to the uninterrupted run: {bits}; largest parameter difference {p_diff:.3e}, "
              f"largest train_loss relative difference {l_diff:.3e}; the resumed run's launches "
              f"{e2['launches']} ({card})", flush=True)
        if not (p_diff <= 1e-6 and l_diff <= 1e-6):
            raise AssertionError(f"resume: {out['resume']}")

        # One profiler trace of the chunk after the first.
        prof_dir = Path(tmp) / "prof"
        tr = trainer(lever_config("cuda", profile_dir=str(prof_dir)))
        res, e = run("profile", tr)
        files = sorted(p.name for p in prof_dir.iterdir())
        events = json.loads((prof_dir / files[0]).read_text())["traceEvents"]
        device_events = sum(1 for ev in events if ev.get("cat") == "kernel")
        e.update(files=files, events=len(events), kernel_events=device_events)
        print(f"[levers] profile_dir: {files}, {len(events)} events, {device_events} device kernel "
              f"events ({card})", flush=True)
        if files != ["trace_epoch1.json"] or not events:
            raise AssertionError(f"profile_dir: {files}")
    return out


def marching_runs(dev, card: str):
    """Phase 35: time-marching, the heat CLI's time-marching row,
    multi-stage correction, hard-IC and ``CollocationAgent`` (see the module
    docstring)."""
    import contextlib as _ctx
    import io

    import torch

    from pinnrl_tpu_torch.benchmarks import cli as bench_cli
    from pinnrl_tpu_torch.benchmarks.convergence import build_recipe_config, run_time_marching
    from pinnrl_tpu_torch.models import PINNModel
    from pinnrl_tpu_torch.pdes import create_pde
    from pinnrl_tpu_torch.rl import CollocationAgent
    from pinnrl_tpu_torch.training import PDETrainer, StageSpec, run_multistage

    out = {}
    # KdV in 4 windows of 2 epochs at the recipe's width.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with per_train_launches() as seen:
        r = run_time_marching("kdv", seed=0, n_windows=4, epochs_per_window=2, device="cuda")
    wall = time.perf_counter() - t0
    windows = []
    for w, (tr, launches, _) in enumerate(seen):
        steps = 2 * (tr.tcfg.num_collocation_points // tr.tcfg.batch_size)
        n_losses = steps + len(tr.history["val_loss"])
        # Per loss: the Dirichlet faces and the IC through the window's own
        # model, and from window 1 on the inherited IC's target through the
        # previous window's model.
        want = {"fused_residual_loss": n_losses, "fourier_features": (2 if w == 0 else 3) * n_losses}
        windows.append({"launches": launches, "want": want, "time_domain": tr.pde.time_domain,
                        "train_loss": tr.history["train_loss"]})
        if any(launches[k] != v for k, v in want.items()):
            raise AssertionError(f"kdv window {w}: launches {launches}, want {want}")
    # Each window's parameters as its training left them (the next window's
    # inherited IC reads them).
    unchanged = all(torch.equal(tr.model.params[k], end[k]) for tr, _, end in seen for k in end)
    tr0 = seen[0][0]
    ap = tr0.model.config.arch_params
    print(f"[marching] run_time_marching('kdv', 4 windows x 2 epochs; Fourier "
          f"{tr0.model.config.hidden_dims}, mapping {ap['mapping_size']}, feature_seed "
          f"{ap.get('feature_seed')}, batch {tr0.tcfg.batch_size}, causal {tr0.tcfg.causal_eps}): "
          f"{r.pde} rel_l2 {r.rel_l2:.4e}, max error {r.max_error:.4e}, {wall:.2f} s; per window "
          f"{windows}; earlier windows unchanged: {unchanged} ({card})", flush=True)
    if not (r.pde == "kdv_tm4" and len(seen) == 4 and unchanged and math.isfinite(r.rel_l2)):
        raise AssertionError(f"kdv time-marching: {r}, unchanged {unchanged}")
    out["kdv_tm4"] = {"rel_l2": r.rel_l2, "wall_s": wall, "windows": windows}

    # The benchmark CLI's time-marching row at the heat recipe's width.
    buf = io.StringIO()
    t0 = time.perf_counter()
    with _ctx.redirect_stdout(buf):
        rc = bench_cli.main(["convergence", "--pde", "heat", "--time-marching", "2", "--epochs",
                             "8", "--device", "cuda"])
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    print(f"[marching] benchmarks.cli convergence --pde heat --time-marching 2 --epochs 8: rc {rc}, "
          f"{wall:.2f} s:\n{text.rstrip()}\n({card})", flush=True)
    if not (rc == 0 and "heat_tm2" in text):
        raise AssertionError(f"cli --time-marching: rc {rc}, {text}")
    out["cli_heat_tm2"] = {"wall_s": wall, "table": text}

    # Multi-stage: the heat recipe and one correction stage, 4 epochs each.
    cfg = build_recipe_config("heat", epochs=MULTISTAGE_EPOCHS, device="cuda")
    t0 = time.perf_counter()
    with per_train_launches() as seen:
        ms = run_multistage(cfg, [StageSpec(epochs=MULTISTAGE_EPOCHS)], seed=0)
    wall = time.perf_counter() - t0
    k1 = [launches["fused_residual_loss"] for _, launches, _ in seen]
    base_tr, _, base_end = seen[0]
    base_same = all(torch.equal(base_tr.model.params[k], v) for k, v in base_end.items())
    print(f"[marching] run_multistage(heat, 1 correction stage, {MULTISTAGE_EPOCHS} epochs each): "
          f"eps {ms.eps_history}, rel_l2 per stage "
          f"{[m['rel_l2'] for m in ms.stage_metrics]}, {wall:.2f} s; kernel 1 per stage {k1}; "
          f"base unchanged by the correction stage: {base_same}; launches "
          f"{[launches for _, launches, _ in seen]} ({card})", flush=True)
    if not (len(k1) == 2 and k1[0] > 0 and k1[1] == 0 and base_same
            and all(math.isfinite(m["rel_l2"]) for m in ms.stage_metrics)):
        raise AssertionError(f"multistage: kernel 1 {k1}")
    out["multistage"] = {"kernel1_per_stage": k1, "eps": ms.eps_history, "wall_s": wall,
                         "rel_l2": [m["rel_l2"] for m in ms.stage_metrics],
                         "launches": [launches for _, launches, _ in seen]}

    # Hard IC: wave (second-order ramp) and the Burgers slice (kernel 1 off).
    for key in ("wave", "burgers"):
        if key == "wave":
            cfg = build_recipe_config("wave", epochs=HARD_IC_EPOCHS, device="cuda")
        else:
            cfg = lever_config("cuda")
            cfg.training.num_epochs = HARD_IC_EPOCHS
        cfg.model.hard_ic = True
        tr = PDETrainer(PINNModel(cfg, seed=0), create_pde(cfg), cfg)
        with per_train_launches() as seen:
            res = tr.train(seed=0)
        ((_, launches, _),) = seen
        ic = res["history"]["loss_components"]["initial"]
        print(f"[marching] hard IC on {key}: IC loss per epoch {ic}; losses "
              f"{res['history']['train_loss']}; launches {launches} ({card})", flush=True)
        if not (launches["fused_residual_loss"] == 0 and max(ic) < HARD_IC_TOL
                and all(map(math.isfinite, res["history"]["train_loss"]))):
            raise AssertionError(f"hard IC {key}: IC {ic}, {launches}")
        out[f"hard_ic_{key}"] = {"ic_loss": ic, "launches": launches}

    # CollocationAgent on the card.
    agent = CollocationAgent(device="cuda")
    state = agent.init(torch.Generator().manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(0)
    pts = torch.rand((4096, 2), generator=gen, device=dev)
    before = {k: v.detach().clone() for k, v in state.params.items()}
    for _ in range(COLLOCATION_UPDATES):
        reward = torch.rand((4096, 1), generator=gen, device=dev)
        state = agent.update(state, pts, reward, pts)
        state = agent.update_epsilon(state)
    scores = agent.get_action(state, pts, gen)
    moved = max(float((state.params[k].detach() - before[k]).abs().max()) for k in before)
    print(f"[marching] CollocationAgent: {COLLOCATION_UPDATES} updates on 4096 points, largest "
          f"parameter move {moved:.3e}, epsilon {float(state.epsilon):.4f}, scores "
          f"{tuple(scores.shape)} finite {bool(torch.isfinite(scores).all())} ({card})", flush=True)
    if not (moved > 0 and scores.shape == (4096, 1) and bool(torch.isfinite(scores).all())):
        raise AssertionError("CollocationAgent on the card")
    out["collocation_agent"] = {"updates": COLLOCATION_UPDATES, "moved": moved}
    return out


def _run_counted(tr, **kw):
    """(result, launches, wall s) of one ``train`` run."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with per_train_launches() as seen:
        res = tr.train(seed=0, **kw)
    ((_, launches, _),) = seen
    return res, launches, time.perf_counter() - t0


def _db_bound(n: int, d: int, kx: int, m: int, width: int):
    """(ms, what bounds it) of the work dL/dB adds to one kernel-1 call:
    (a) the embedding's cotangent G W0, S N x width x 2m FMAs, reading the
    layer's cotangent and W0 and writing G; (b) the fold of G with the
    sin/cos orders, ~8 operations per stream, point and feature, reading G,
    z and B; (c) dB = z^T A + sum_s v_s colsum(C_s), 2 (d+1) N m operations,
    writing dB. S = 2 + d kx streams."""
    S = 2 + d * kx
    ops = 2.0 * S * n * width * 2 * m + 8.0 * S * n * m + 2.0 * (d + 1) * n * m
    nbytes = 4.0 * (S * n * width + width * 2 * m + 2 * S * n * 2 * m + n * (d + 1)
                    + 2 * (d + 1) * m)
    return bound(ops, nbytes)


def _stacked_members(cfg, members: int):
    """(the first model, the PDE, the members' leaves stacked (E, ...)):
    ``members`` models of ``cfg`` from seeds 0.., sharing the first's fixed
    basis (as ``PDETrainer._stack_ensemble``)."""
    import torch

    from pinnrl_tpu_torch.models import PINNModel
    from pinnrl_tpu_torch.pdes import create_pde

    models = [PINNModel(cfg, seed=e) for e in range(members)]
    P = {k: torch.stack([m.params[k].detach() for m in models]) for k in models[0].params}
    return models[0], create_pde(cfg), P


def member_case_config(case: str, device: str):
    """The configuration of a small member-axis case (``MEMBER_CASES``)."""
    from pinnrl_tpu_torch.benchmarks.convergence import build_recipe_config
    from pinnrl_tpu_torch.config import load_config

    if case == "black_scholes_ff":
        return load_config(pde_type="black_scholes", device=device)
    if case == "heat_4d_variants":
        return nd4_small_config(case, device)
    cfg = (build_recipe_config("kdv", device=device) if case == "kdv_causal"
           else load_config(pde_type="burgers", architecture="fourier", device=device))
    cfg.model.hidden_dims = [64, 48]
    cfg.model.arch_params["mapping_size"] = 32
    cfg.model.arch_params.pop("feature_seed", None)
    cfg.model.layer_norm = case != "burgers_generated"
    cfg.model.arch_params["trainable_features"] = case == "burgers_causal_basis"
    cfg.training.causal_eps = 1.0 if "causal" in case else 0.0
    return cfg


def member_parity(dev, spec, P, z, tols, label: str):
    """Kernel 1 on E stacked members (z (E, N, d+1), leaves (E, ...)) in one
    sequence of launches: twice (bit-identical), against E single-member
    calls on copies of each member's tensors (bit-identical: the member axis
    changes which block computes, not the order of any sum), and against
    its plain twins run in float64 on the same card tensors, member by
    member, within ``tols`` (loss, gradients; relative, the gradients to
    each member's max). Raises otherwise. Returns (loss, grads, numbers)."""
    import torch

    from pinnrl_tpu_torch.ops.kernels import fused_step

    ops, plain = fused_step._cuda_ops(dev), fused_step._TorchOps()
    E = z.shape[0]
    lk, gk = fused_step._loss_and_grads(ops, spec, z, P)
    lk2, gk2 = fused_step._loss_and_grads(ops, spec, z, P)
    single = [fused_step._loss_and_grads(ops, spec, z[e].clone(),
                                         {k: v[e].clone() for k, v in P.items()})
              for e in range(E)]
    f64 = fused_step._Spec(**{**spec.__dict__, "lo": spec.lo.double(),
                              "scale": spec.scale.double(),
                              "B": None if spec.B is None else spec.B.double()})
    l64, g64 = fused_step._loss_and_grads(plain, f64, z.double(),
                                          {k: v.double() for k, v in P.items()})
    torch.cuda.synchronize()
    twice = torch.equal(lk, lk2) and all(torch.equal(gk[k], gk2[k]) for k in gk)
    diff = max([abs(float(lk[e]) - float(ls)) for e, (ls, _) in enumerate(single)]
               + [float((gk[k][e] - gs[k]).abs().max()) for e, (_, gs) in enumerate(single)
                  for k in gs])
    loss_rel = max(abs(float(lk[e]) - float(l64[e])) / abs(float(l64[e])) for e in range(E))
    grad_rel = max(float((gk[k][e].double() - g64[k][e]).abs().max())
                   / max(float(g64[k][e].abs().max()), 1e-30) for k in gk for e in range(E))
    abs_err = max(float((lk.double() - l64).abs().max()),
                  *(float((gk[k].double() - g64[k]).abs().max()) for k in gk))
    shapes_ok = all(gk[k].shape == P[k].shape for k in P) and lk.shape == (E,)
    print(f"[members] {label} E={E} N={z.shape[1]}: one member-batched call against {E} single "
          f"calls max diff {diff:.3e} (bit-identical {diff == 0.0}); against the float64 twins "
          f"loss rel {loss_rel:.3e} (tol {tols[0]:g}), grad rel {grad_rel:.3e} (tol {tols[1]:g}); "
          f"two calls bit-identical {twice}", flush=True)
    if not (diff == 0.0 and twice and shapes_ok and loss_rel < tols[0] and grad_rel < tols[1]
            and all(torch.isfinite(g).all() for g in gk.values())):
        raise AssertionError(f"{label}: the member-batched kernel 1 disagrees")
    return lk, gk, {"members": E, "n": z.shape[1], "single_max_diff": diff, "loss_rel": loss_rel,
                    "grad_rel": grad_rel, "max_abs_err": abs_err, "bit_identical": twice}


def member_points(pde, gen, members: int, n: int, causal: bool):
    """z (E, n, d+1): each member's own uniform points, sorted by time under
    causal weights."""
    import torch

    zs = []
    for _ in range(members):
        x, t = pde.generate_collocation_points(gen, n, "uniform")
        zs.append(time_sorted(x, t) if causal else torch.cat([x, t], dim=-1))
    return torch.stack(zs)


def cublas_bmm_ms(shapes, members: int, device, iters: int = 20) -> float:
    """Device ms of one FP32 cuBLAS batched product (``torch.bmm``, TF32
    off) over ``members`` of each (M, K, N) in ``shapes``, in sequence, by
    CUDA-graph replay."""
    import torch

    gen = torch.Generator(device=device).manual_seed(0)
    ops = [(torch.randn((members, m, k), generator=gen, device=device),
            torch.randn((members, k, n), generator=gen, device=device)) for m, k, n in shapes]
    assert not torch.backends.cuda.matmul.allow_tf32
    return graph_ms(lambda: [torch.bmm(a, b) for a, b in ops], iters=iters)


def member_kernel_runs(dev, card: str):
    """Phase 37's member axis of kernels 1-3 outside the trainer: kernel 1
    on small stacked members of every kind of entry point (``MEMBER_CASES``:
    trainable basis and causal scan, x-order 3, the feedforward trunk's
    input and z-reading residual, d >= 4 with its run-time-d kernels, the
    generated residual); kernels 2 and 3 member-batched (a trainable
    basis's B (E, d, m), SIREN layers' W (E, k, m)) against their plain
    versions and per-member launches, through their vmap rules in one
    launch, timed beside the per-member launches."""
    import torch

    from pinnrl_tpu_torch.ops.kernels import fourier_feats, fused_step, residual_codegen, siren

    out = {"cases": {}}
    gen = torch.Generator(device=dev).manual_seed(37)
    for case in MEMBER_CASES:
        cfg = member_case_config(case, "cuda")
        model, pde, P = _stacked_members(cfg, MEMBER_SMALL_E)
        spec = fused_step._spec(model, pde)
        if case == "burgers_generated":
            spec = fused_step._Spec(**{**spec.__dict__, "residual": "generated",
                                       "program": residual_codegen.trace(pde, 2, device=dev)})
        causal = spec.causal_eps > 0.0
        z = member_points(pde, gen, MEMBER_SMALL_E, MEMBER_SMALL_N, causal)
        key = {"kdv_causal": "kdv_causal", "black_scholes_ff": "black_scholes_ff"}.get(
            case, "burgers_causal" if causal else "burgers")
        generated = residual_codegen.launch.launches
        out["cases"][case] = member_parity(dev, spec, P, z, FUSED_TOLS[key], case)[2]
        # These launches hold the kernels against single calls and their
        # twins, no main path's: phase 45 counts the generated residual from 0.
        residual_codegen.launch.launches = generated

    # Kernel 2: a trainable basis's B per member, the Burgers recipe's rows.
    cfg = lever_config("cuda")
    cfg.model.arch_params["trainable_features"] = True
    model, pde, P = _stacked_members(cfg, ENSEMBLE_E)
    B = P["FourierFeatures_0.B"].contiguous()
    x = model.map_inputs(member_points(pde, gen, ENSEMBLE_E, 8192, False)).contiguous()
    ff = fourier_feats
    (E, n, d), m = x.shape, B.shape[-1]
    before = ff.fourier_features.launches
    got = ff.fourier_features_cuda(x, B)
    via_vmap = torch.func.vmap(ff.fourier_features)(x, B)
    torch.cuda.synchronize()
    vmap_launches = ff.fourier_features.launches - before - 1
    each = [ff.fourier_features_cuda(x[e].clone(), B[e].clone()) for e in range(E)]
    ref = ff.fourier_features_plain(x, B)
    ff_err = float((got - ref).abs().max())
    ff_same = all(torch.equal(got[e], each[e]) for e in range(E)) and torch.equal(got, via_vmap)
    singles = [(x[e].clone(), B[e].clone()) for e in range(E)]
    ff_ms = graph_ms(lambda: ff.fourier_features_cuda(x, B))
    ff_each_ms = graph_ms(lambda: [ff.fourier_features_cuda(a, b) for a, b in singles])
    ff_plain_ms = graph_ms(lambda: ff.fourier_features_plain(x, B))
    ff_bound = bound(E * (2.0 * n * d * m + 3.0 * n * m), 4.0 * E * (n * d + d * m + 2 * n * m))
    print(f"[members] kernel 2 E={E} x ({n},{d}) B ({d},{m}): one launch {ff_ms:.5f} ms against "
          f"{E} launches {ff_each_ms:.5f} ms, plain {ff_plain_ms:.5f} ms, bound {ff_bound[0]:.5f} "
          f"ms ({ff_bound[1]}); max_abs_err {ff_err:.3e}, equal to the per-member launches and "
          f"to vmap {ff_same}, vmap launches {vmap_launches} ({card})", flush=True)
    if not (ff_err < 1e-4 and ff_same and vmap_launches == 1):
        raise AssertionError("kernel 2's member axis disagrees or its vmap rule launches per member")
    out["kernel2"] = {"members": E, "shape": [n, d, m], "ms": ff_ms, "per_member_ms": ff_each_ms,
                      "plain_ms": ff_plain_ms, "bound_ms": ff_bound[0], "bound_by": ff_bound[1],
                      "library_ms": None, "max_abs_err": ff_err, "vmap_launches": vmap_launches}

    # Kernel 3: SIREN layers per member at the shipped 124 width, batch 2048.
    cfg = siren_kdv_config("cuda")
    model, pde, P = _stacked_members(cfg, ENSEMBLE_E)
    W, b = P["SIRENLayer_1.kernel"].contiguous(), P["SIRENLayer_1.bias"].contiguous()
    E, k, m = W.shape
    xs = torch.rand((E, 2048, k), generator=gen, device=dev) * 2.0 - 1.0
    omega = float(cfg.model.arch_params.get("omega_0", 30.0))
    before = siren.siren_layer.launches
    got = siren.siren_layer_cuda(xs, W, b, omega)
    via_vmap = torch.func.vmap(lambda a, w, c: siren.siren_layer(a, w, c, omega))(xs, W, b)
    torch.cuda.synchronize()
    s_vmap_launches = siren.siren_layer.launches - before - 1
    singles = [(xs[e].clone(), W[e].clone(), b[e].clone()) for e in range(E)]
    each = [siren.siren_layer_cuda(*s, omega) for s in singles]
    ref = siren.siren_layer_plain(xs, W, b, omega)
    s_err = float((got - ref).abs().max())
    s_same = all(torch.equal(got[e], each[e]) for e in range(E)) and torch.equal(got, via_vmap)
    s_ms = graph_ms(lambda: siren.siren_layer_cuda(xs, W, b, omega))
    s_each_ms = graph_ms(lambda: [siren.siren_layer_cuda(*s, omega) for s in singles])
    s_plain_ms = graph_ms(lambda: siren.siren_layer_plain(xs, W, b, omega))
    s_lib_ms = graph_ms(lambda: torch.baddbmm(b[:, None, :], xs, W))
    n = xs.shape[1]
    s_bound = bound(E * (2.0 * n * k * m + 3.0 * n * m), 4.0 * E * (n * k + k * m + m + n * m))
    print(f"[members] kernel 3 E={E} x ({n},{k}) W ({k},{m}): one launch {s_ms:.5f} ms against "
          f"{E} launches {s_each_ms:.5f} ms, plain {s_plain_ms:.5f} ms, torch.baddbmm "
          f"{s_lib_ms:.5f} ms, bound {s_bound[0]:.5f} ms ({s_bound[1]}); max_abs_err "
          f"{s_err:.3e}, equal to the per-member launches and to vmap {s_same}, vmap launches "
          f"{s_vmap_launches} ({card})", flush=True)
    if not (s_err < 1e-4 and s_same and s_vmap_launches == 1):
        raise AssertionError("kernel 3's member axis disagrees or its vmap rule launches per member")
    out["kernel3"] = {"members": E, "shape": [n, k, m], "ms": s_ms, "per_member_ms": s_each_ms,
                      "plain_ms": s_plain_ms, "bound_ms": s_bound[0], "bound_by": s_bound[1],
                      "library_ms": s_lib_ms, "max_abs_err": s_err,
                      "vmap_launches": s_vmap_launches}
    out["vmapped_path"] = member_vmap_path_runs(dev, card, gen)
    return out


def member_vmap_path_runs(dev, card: str, gen):
    """The trainer's vmapped residual path (``PDETrainer.member_path ==
    "vmap"``, where kernel 1 is not attached) on a SIREN ensemble (KdV's
    shipped 124-wide SIREN cut to 3 layers) and a trainable basis on the
    modified Fourier trunk (Burgers, 64x64, mapping 32; kernel 1 takes
    neither, and the residual runs kernel 2 inside the nested jvps): one
    vmapped residual term of all members launches kernel 3, or kernel 2, as
    often as one member's residual does (one launch per layer for all
    members), and agrees with the members' own residual terms; then one
    epoch trains."""
    import torch

    from pinnrl_tpu_torch.config import load_config
    from pinnrl_tpu_torch.models import PINNModel
    from pinnrl_tpu_torch.pdes import create_pde
    from pinnrl_tpu_torch.training import PDETrainer

    siren_cfg = siren_kdv_config("cuda")
    siren_cfg.model.hidden_dims = [124] * 3
    basis_cfg = load_config(pde_type="burgers", architecture="fourier", device="cuda")
    basis_cfg.model.hidden_dims = [64, 64]
    basis_cfg.model.arch_params.update({"mapping_size": 32, "modified": True,
                                        "trainable_features": True})
    out = {}
    for name, cfg, counter in (("siren", siren_cfg, "siren_layer"),
                               ("modified_basis", basis_cfg, "fourier_features")):
        t = cfg.training
        t.ensemble_size, t.num_epochs, t.validation_frequency = MEMBER_SMALL_E, 1, 1
        t.optimizer, t.scheduler_type = "adam", "cosine"
        t.num_collocation_points, t.batch_size = 4096, 2048
        tr = PDETrainer(PINNModel(cfg, seed=0), create_pde(cfg), cfg)
        params = tr._stack_ensemble(0)
        batches = [tr.pde.generate_collocation_points(gen, 2048, "uniform")
                   for _ in range(MEMBER_SMALL_E)]
        torch.cuda.synchronize()
        before = _launches()
        terms = tr._member_residual_losses(params, batches)
        torch.cuda.synchronize()
        mid = _launches()
        x0, t0 = batches[0]
        one = tr.pde._residual_loss(
            tr.pde.compute_residual(tr.model.apply, {k: v[0] for k, v in params.items()}, x0, t0,
                                    {}), t0)
        torch.cuda.synchronize()
        after = _launches()
        all_members, one_member = mid[counter] - before[counter], after[counter] - mid[counter]
        rel = abs(float(terms[0].detach()) - float(one.detach())) / abs(float(one.detach()))
        res, launches, wall = _run_counted(tr)
        hist = res["history"]
        print(f"[members] vmapped residual path, {name} ({tr.model.architecture_name}) E="
              f"{MEMBER_SMALL_E}: path {tr.member_path}, {counter} launches for all members' "
              f"residual terms {all_members}, for one member's {one_member}; member 0 against its "
              f"own residual term rel {rel:.3e}; 1 epoch: train {hist['train_loss']}, kernel 1 "
              f"{launches['fused_residual_loss']} launches, {wall:.1f} s ({card})", flush=True)
        if not (tr.member_path == "vmap" and all_members == one_member > 0 and rel < 1e-5
                and launches["fused_residual_loss"] == 0
                and all(map(math.isfinite, hist["train_loss"] + hist["val_loss"]))):
            raise AssertionError(f"the vmapped residual path of {name}: {all_members} launches "
                                 f"against {one_member}, rel {rel}, {launches}")
        out[name] = {"launches_all_members": all_members, "launches_one_member": one_member,
                     "rel": rel, "train_launches": launches, "train_loss": hist["train_loss"]}
    return out


def ensemble_runs(dev, card: str):
    """Phase 37: a deep ensemble of ``ENSEMBLE_E`` members on the Burgers
    recipe slice. The trainer's run (kernel 1 once per step and per
    validation for all members: ``steps + vals`` launches serving ``E (steps
    + vals)`` members); the member-batched call at the recipe's width (N
    8192 per member) against E single calls (bit-identical) and the float64
    twins, timed by CUDA-graph replay beside the E single calls, the plain
    version, the same products on cuBLAS (``torch.bmm`` over the members)
    and its bound; the step's ms at E = 1 and E = ``ENSEMBLE_E`` in turns;
    and ``member_kernel_runs``."""
    import torch

    from pinnrl_tpu_torch.models import PINNModel
    from pinnrl_tpu_torch.ops.jet_mlp import make_bundle_fn
    from pinnrl_tpu_torch.ops.kernels import fused_step
    from pinnrl_tpu_torch.pdes import create_pde
    from pinnrl_tpu_torch.training import PDETrainer

    def trainer(cfg):
        return PDETrainer(PINNModel(cfg, seed=0), create_pde(cfg), cfg)

    steps_per_epoch = 40000 // 8192
    steps = TRUNK_EPOCHS * steps_per_epoch
    cfg = lever_config("cuda", num_epochs=TRUNK_EPOCHS, ensemble_size=ENSEMBLE_E)
    tr = trainer(cfg)
    served = fused_step.fused_residual_loss.members
    res, launches, wall = _run_counted(tr)
    served = fused_step.fused_residual_loss.members - served
    hist = res["history"]
    vals = len(hist["val_loss"])
    want = steps + vals
    lead = {k: tuple(v.shape[:1]) for k, v in tr.model.params.items()}
    print(f"[trunks] ensemble E={ENSEMBLE_E}: {steps} steps + {vals} validations, path "
          f"{tr.member_path}, kernel 1 {launches['fused_residual_loss']} launches serving {served} "
          f"members (want {want} and {ENSEMBLE_E * want}: one member-batched call per step and "
          f"validation), train {hist['train_loss']}, val {hist['val_loss']}, {wall:.1f} s ({card})",
          flush=True)
    if (tr.member_path != "kernel1" or launches["fused_residual_loss"] != want
            or served != ENSEMBLE_E * want or set(lead.values()) != {(ENSEMBLE_E,)}):
        raise AssertionError(f"ensemble: kernel 1 {launches}, {served} members, want {want}; "
                             f"leading axes {lead}")
    if not (all(map(math.isfinite, hist["train_loss"] + hist["val_loss"]))
            and hist["train_loss"][-1] < hist["train_loss"][0]):
        raise AssertionError(f"ensemble: losses {hist['train_loss']}")

    # The member-batched call at the recipe's width, on the trained members.
    E, n = ENSEMBLE_E, 8192
    P = {k: v.detach() for k, v in tr.model.params.items()}
    spec = fused_step._spec(tr.model, tr.pde)
    causal = spec.causal_eps > 0.0
    gen = torch.Generator(device=dev).manual_seed(8)
    z = member_points(tr.pde, gen, E, n, causal)
    _, _, parity = member_parity(dev, spec, P, z, FUSED_TOLS["burgers_causal" if causal else
                                                            "burgers"], "Burgers recipe width")
    ops = fused_step._cuda_ops(dev)
    singles = [(z[e].clone(), {k: v[e].clone() for k, v in P.items()}) for e in range(E)]
    batched_ms = graph_ms(lambda: fused_step._loss_and_grads(ops, spec, z, P), iters=10, replays=5)
    singles_ms = graph_ms(lambda: [fused_step._loss_and_grads(ops, spec, zz, pp)
                                   for zz, pp in singles], iters=10, replays=5)
    bundle_fn = make_bundle_fn(tr.model, 1, 2, 1)
    p_leaf = {k: v.clone().requires_grad_(True) for k, v in P.items()}
    plain_ms = cuda_ms(lambda: torch.autograd.grad(
        fused_step.fused_residual_loss_plain(bundle_fn, tr.pde, p_leaf, z).sum(),
        list(p_leaf.values())), iters=5, warmup=2)
    one = singles[0][1]
    lib_ms = cublas_bmm_ms(fused_gemms(one, 2, n), E, dev)
    one_bound = kernel1_bound(one, 2, singles[0][0], spec.B)
    m_bound = (E * one_bound[0], one_bound[1])
    print(f"[trunks] kernel 1, {E} members in one call (Fourier 256x3, mapping 128, N={n} each): "
          f"{batched_ms:.4f} ms against {E} single calls {singles_ms:.4f} ms "
          f"({singles_ms / batched_ms:.2f}x), plain (vmapped) {plain_ms:.4f} ms, the same "
          f"products on cuBLAS (torch.bmm over the members) {lib_ms:.4f} ms, bound "
          f"{m_bound[0]:.4f} ms ({m_bound[1]}; {E} x {one_bound[0]:.4f}) ({card})", flush=True)

    # Step ms at E = 1 and E = 4, in turns (host clock, synchronized).
    one_tr = trainer(lever_config("cuda", num_epochs=TRUNK_EPOCHS))
    ens = tr
    e_params = ens.model.params
    e_opt = ens._make_adam(TRUNK_EPOCHS, steps_per_epoch, ens._leaves(e_params))
    e_gens = [torch.Generator(device=dev).manual_seed(20 + m) for m in range(ENSEMBLE_E)]

    def ens_step():
        ens._ensemble_step(e_params, e_opt, e_gens, 8192)

    def ens_times(count):
        times = []
        for i in range(count + 2):
            torch.cuda.synchronize()
            s = time.perf_counter()
            ens_step()
            torch.cuda.synchronize()
            if i >= 2:  # warm-up
                times.append((time.perf_counter() - s) * 1e3)
        return times

    turns = {"e1": [], "e4": []}
    for who in ("e1", "e4", "e4", "e1"):
        turns[who] += (step_times(one_tr, TIMED_STEPS, TRUNK_EPOCHS, 8192) if who == "e1"
                       else ens_times(TIMED_STEPS))
    ms = {k: statistics.median(v) for k, v in turns.items()}
    sync_sites = record_syncs(ens_step)
    print(f"[trunks] ensemble step ms (median, host clock, in turns): E=1 {ms['e1']:.3f}, "
          f"E={ENSEMBLE_E} {ms['e4']:.3f} ({ms['e4'] / ms['e1']:.2f}x); host syncs per "
          f"E={ENSEMBLE_E} step {len(sync_sites)} {sorted(set(sync_sites))} ({card})", flush=True)
    if sync_sites:
        raise AssertionError(f"ensemble: {len(sync_sites)} host syncs per step at {sync_sites}")
    del tr, ens, one_tr, e_params, e_opt
    kernels = member_kernel_runs(dev, card)
    return {"launches": launches, "want": want, "members_served": served, "steps": steps,
            "validations": vals, "train_loss": hist["train_loss"], "val_loss": hist["val_loss"],
            "wall_s": wall, "step_ms": ms, "syncs": len(sync_sites),
            "member_call": {**parity, "ms": batched_ms, "single_calls_ms": singles_ms,
                            "plain_ms": plain_ms, "bound_ms": m_bound[0], "bound_by": m_bound[1],
                            "single_bound_ms": one_bound[0], "library_ms": lib_ms,
                            "library_call": "torch.bmm (FP32, TF32 off) over the members of the "
                                            "call's GEMM shapes"},
            **kernels}


def trunk_runs(dev, card: str):
    """Phases 36-39: the trainable basis through kernel 1's dL/dB, deep
    ensembles, the modified and autoencoder trunks and dropout, and the heat
    CLI's plots, report and FDM comparison (see the module docstring)."""
    import tempfile
    from pathlib import Path

    import torch

    from pinnrl_tpu_torch.config import load_config
    from pinnrl_tpu_torch.models import PINNModel
    from pinnrl_tpu_torch.ops.jet_mlp import make_bundle_fn
    from pinnrl_tpu_torch.ops.kernels import fused_step
    from pinnrl_tpu_torch.pdes import create_pde
    from pinnrl_tpu_torch.training import PDETrainer
    from pinnrl_tpu_torch.training import train as train_cli

    steps_per_epoch = 40000 // 8192
    out = {}

    def trainer(cfg):
        return PDETrainer(PINNModel(cfg, seed=0), create_pde(cfg), cfg)

    # ---- 36. a trainable basis: kernel 1 with dL/dB ------------------------ #
    cfg = lever_config("cuda", num_epochs=TRUNK_EPOCHS)
    cfg.model.arch_params["trainable_features"] = True
    tr = trainer(cfg)
    if not tr.fused_kernel_active or "FourierFeatures_0.B" not in tr.model.params:
        raise AssertionError("trainable basis: kernel 1 not attached or B not a parameter")
    B0 = tr.model.params["FourierFeatures_0.B"].detach().clone()
    res, launches, wall = _run_counted(tr)
    hist = res["history"]
    steps, vals = TRUNK_EPOCHS * steps_per_epoch, len(hist["val_loss"])
    moved = float((tr.model.params["FourierFeatures_0.B"] - B0).abs().max())
    print(f"[trunks] trainable basis (Fourier 256x3, mapping 128, batch 8192): {steps} steps + "
          f"{vals} validations, kernel 1 {launches['fused_residual_loss']} launches, train "
          f"{hist['train_loss']}, B moved {moved:.3e}, {wall:.1f} s ({card})", flush=True)
    if launches["fused_residual_loss"] != steps + vals:
        raise AssertionError(f"trainable basis: kernel 1 {launches}, want {steps + vals}")
    if not (all(map(math.isfinite, hist["train_loss"])) and moved > 0.0
            and hist["train_loss"][-1] < hist["train_loss"][0]):
        raise AssertionError(f"trainable basis: losses {hist['train_loss']}, B moved {moved}")
    # dL/dB on the card: the CUDA launcher against its plain twins (_TorchOps)
    # on the same card tensors, the whole gradient set, bit-identical twice.
    model, pde = tr.model, tr.pde
    spec = fused_step._spec(model, pde)
    P = {k: v.detach() for k, v in model.params.items()}
    gen = torch.Generator(device=dev).manual_seed(5)
    timings = {}
    db_parity = {}
    for n in (8192, 40000):
        x, t = pde.generate_collocation_points(gen, n, "uniform")
        z = time_sorted(x, t)
        lk, gk = fused_step._loss_and_grads(fused_step._cuda_ops(dev), spec, z, P)
        lk2, gk2 = fused_step._loss_and_grads(fused_step._cuda_ops(dev), spec, z, P)
        lp, gp = fused_step._loss_and_grads(fused_step._TorchOps(), spec, z, P)
        torch.cuda.synchronize()
        rels = {k: float((gk[k] - gp[k]).abs().max()) / float(gp[k].abs().max()) for k in gp}
        loss_rel = abs(float(lk) - float(lp)) / abs(float(lp))
        same = torch.equal(lk, lk2) and all(torch.equal(gk[k], gk2[k]) for k in gk)
        db_parity[n] = {"loss_rel": loss_rel, "dB_rel": rels["FourierFeatures_0.B"],
                        "worst_rel": max(rels.values()), "bit_identical": same,
                        "max_abs_err": max(float((gk[k] - gp[k]).abs().max()) for k in gp)}
        print(f"[trunks] kernel 1 with dL/dB N={n}: loss rel {loss_rel:.3e}, dB rel "
              f"{rels['FourierFeatures_0.B']:.3e}, worst grad rel {max(rels.values()):.3e} "
              f"(tol {DB_TOL:g}), two calls bit-identical {same}", flush=True)
        if not (loss_rel < 1e-5 and max(rels.values()) < DB_TOL and same):
            raise AssertionError(f"kernel 1 with dL/dB disagrees with _TorchOps at N={n}: {rels}")
        # Kernel 1 with and without dL/dB (the same weights, B fixed), and
        # the plain version of the dB variant, by CUDA-graph replay.
        fixed = fused_step._Spec(**{**spec.__dict__, "trainable_basis": False,
                                    "B": P["FourierFeatures_0.B"].contiguous(),
                                    "leaf_names": spec.leaf_names[1:]})
        bundle_fn = make_bundle_fn(model, 1, 2, 1)
        p_leaf = {k: v.clone().requires_grad_(True) for k, v in P.items()}
        ops = fused_step._cuda_ops(dev)
        it = 5 if n > 8192 else 10
        with_db = graph_ms(lambda: fused_step._loss_and_grads(ops, spec, z, P), iters=it, replays=5)
        without = graph_ms(lambda: fused_step._loss_and_grads(ops, fixed, z, P), iters=it, replays=5)
        plain = graph_ms(lambda: torch.autograd.grad(
            fused_step.fused_residual_loss_plain(bundle_fn, pde, p_leaf, z),
            list(p_leaf.values())), iters=it, replays=5)
        S, m, width = 4, P["FourierFeatures_0.B"].shape[1], P["Dense_0.weight"].shape[0]
        a_lib = cublas_ms([(S * n, width, 2 * m)], dev)
        c_lib = cublas_ms([(2, n, m)], dev)
        db_bound = _db_bound(n, 1, 2, m, width)
        full_bound = kernel1_bound(P, 2, z, P["FourierFeatures_0.B"])
        timings[n] = {"with_db_ms": with_db, "without_db_ms": without, "plain_ms": plain,
                      "added_bound_ms": db_bound[0], "added_bound_by": db_bound[1],
                      "bound_ms": full_bound[0], "bound_by": full_bound[1],
                      "cublas_a_ms": a_lib, "cublas_c_ms": c_lib}
        print(f"[trunks] kernel 1 Burgers N={n}: with dL/dB {with_db:.4f} ms, without "
              f"{without:.4f} ms (added {with_db - without:.4f}; its bound {db_bound[0]:.4f} ms, "
              f"{db_bound[1]}), plain with B a leaf {plain:.4f} ms, call bound {full_bound[0]:.4f} "
              f"ms; cuBLAS (a) ({S * n}x{width})x({width}x{2 * m}) {a_lib:.4f} ms, (c) "
              f"(2x{n})x({n}x{m}) {c_lib:.4f} ms ({card})", flush=True)
    out["trainable_basis"] = {"launches": launches, "steps": steps, "validations": vals,
                              "train_loss": hist["train_loss"], "wall_s": wall,
                              "parity": db_parity, "timings": timings}
    del tr, model, pde

    # ---- 37. a deep ensemble of 4 ----------------------------------------- #
    out["ensemble"] = ensemble_runs(dev, card)

    # ---- 38. modified trunk, autoencoder, dropout --------------------------- #
    mod = lever_config("cuda", num_epochs=TRUNK_EPOCHS)
    mod.model.arch_params["modified"] = True
    auto = load_config(pde_type="burgers", architecture="autoencoder", device="cuda")
    slice_cfg = lever_config("cuda", num_epochs=TRUNK_EPOCHS)
    auto.pde, auto.training = slice_cfg.pde, slice_cfg.training
    auto.model.input_dim = slice_cfg.model.input_dim
    drop = lever_config("cuda", num_epochs=TRUNK_EPOCHS)
    drop.model.dropout = EXPECT_DROPOUT
    for name, c in (("modified", mod), ("autoencoder", auto), ("dropout", drop)):
        tr = trainer(c)
        res, launches, wall = _run_counted(tr)
        hist = res["history"]
        vals = len(hist["val_loss"])
        k1 = launches["fused_residual_loss"]
        want_k1 = steps + vals if name == "dropout" else 0
        print(f"[trunks] {name} ({tr.model.architecture_name}, {tr.model.count_parameters()} "
              f"parameters): {steps} steps, kernel 1 {k1} (want {want_k1}), kernel 2 "
              f"{launches['fourier_features']} (jvp rule {launches['fourier_features_jvps']}), "
              f"train {hist['train_loss']}, {wall:.1f} s ({card})", flush=True)
        if k1 != want_k1 or not all(map(math.isfinite, hist["train_loss"] + hist["val_loss"])):
            raise AssertionError(f"{name}: launches {launches}, losses {hist['train_loss']}")
        if name == "modified" and not launches["fourier_features"]:
            raise AssertionError("modified trunk: kernel 2 never launched")
        out[name] = {"launches": launches, "train_loss": hist["train_loss"], "wall_s": wall,
                     "parameters": tr.model.count_parameters()}
        del tr

    # ---- 39. the heat CLI's plots, report and FDM comparison ---------------- #
    try:
        import matplotlib  # noqa: F401
        has_mpl = True
    except ImportError:
        has_mpl = False
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = train_cli.main(["--pde", "heat", "--epochs", "2", "--results-dir", tmp])
        wall = time.perf_counter() - t0
        (exp,) = Path(tmp).iterdir()
        files = {p.relative_to(exp).as_posix() for p in exp.rglob("*")}
        meta = json.loads((exp / "metadata.json").read_text())
        fdm = json.loads((exp / "fdm_comparison.json").read_text()) if (
            exp / "fdm_comparison.json").exists() else None
        pngs = sorted(f for f in files if f.endswith(".png"))
        report = (exp / "report.html").read_text() if (exp / "report.html").exists() else ""
    print(f"[trunks] heat CLI (save_plots on): rc {rc}, status {meta.get('status')}, "
          f"report.html {len(report)} bytes, fdm_comparison {fdm}, PNGs {pngs} (matplotlib "
          f"{'present' if has_mpl else 'absent'}), {wall:.1f} s ({card})", flush=True)
    if rc != 0 or meta.get("status") != "completed" or not report or fdm is None:
        raise AssertionError(f"heat CLI: rc {rc}, files {sorted(files)}")
    if not all(map(math.isfinite, fdm.values())) or bool(pngs) != has_mpl:
        raise AssertionError(f"heat CLI: fdm {fdm}, PNGs {pngs}, matplotlib {has_mpl}")
    out["heat_cli"] = {"files": sorted(files), "fdm_comparison": fdm, "pngs": pngs,
                       "matplotlib": has_mpl, "wall_s": wall}
    return out


def _lbfgs_ms_in_turns(trainers: dict, n: int) -> dict:
    """Median host-clock ms of an L-BFGS iteration of each trainer on its
    round-0 batch of all 40000 points, in turns (a, b, b, a), and the
    evaluations per iteration."""
    turns = list(trainers) + list(trainers)[::-1]
    batches = {k: tr._lbfgs_batch(0, 0, 40000) for k, tr in trainers.items()}
    ms = {k: [] for k in trainers}
    evals = {k: [] for k in trainers}
    for k in turns:
        times, per = lbfgs_iteration_times(trainers[k], batches[k], n)
        ms[k] += times
        evals[k].append(per)
    return {k: {"iteration_ms": statistics.median(ms[k]),
                "evaluations_per_iteration": statistics.mean(evals[k])} for k in trainers}


def float64_runs(dev, card: str):
    """Phase 40: float64 residuals on the Burgers recipe slice (see the
    module docstring)."""
    import torch

    from pinnrl_tpu_torch.models import PINNModel
    from pinnrl_tpu_torch.ops.kernels import fourier_feats
    from pinnrl_tpu_torch.pdes import create_pde
    from pinnrl_tpu_torch.training import PDETrainer
    from pinnrl_tpu_torch.training.lbfgs import LBFGS

    def trainer(cfg):
        return PDETrainer(PINNModel(cfg, seed=0), create_pde(cfg), cfg)

    ff = fourier_feats.fourier_features
    cfg = lever_config("cuda", num_epochs=F64_EPOCHS, optimizer="adam_lbfgs",
                       residual_dtype="float64")
    cfg.training.adam_lbfgs_switch_ratio = 0.5
    tr = trainer(cfg)
    at_switch, phase_dtypes = {}, []
    promote, lbfgs_pieces = tr._maybe_promote_f64, tr._lbfgs_pieces

    def promoting(params):
        torch.cuda.synchronize()
        at_switch.update(_launches(), plain_f64=ff.plain_f64, evaluations=LBFGS.evaluations)
        promote(params)

    def building(params, *args):
        # The phase's iterations replay one capture: its dtype, per round.
        phase_dtypes.append(next(iter(params.values())).dtype)
        return lbfgs_pieces(params, *args)

    tr._maybe_promote_f64, tr._lbfgs_pieces = promoting, building
    torch.cuda.synchronize()
    start, plain0, evals0 = _launches(), ff.plain_f64, LBFGS.evaluations
    res, launches, wall = _run_counted(tr)
    hist = res["history"]
    adam_epochs = tr.switch_epoch
    adam_losses = adam_epochs * (40000 // 8192) + adam_epochs  # steps and validations
    phase_vals = len(hist["val_loss"]) - adam_epochs
    evals = LBFGS.evaluations - evals0
    # Launches before the switch, and in the float64 phase after it.
    adam = {k: at_switch[k] - start[k] for k in start}
    phase = {k: launches[k] - adam[k] for k in start}
    k1_adam, k1_phase = adam["fused_residual_loss"], phase["fused_residual_loss"]
    plain_phase = ff.plain_f64 - at_switch["plain_f64"]
    want_plain = 2 * (evals + phase_vals)  # BC and IC per evaluation and validation
    final = tr._final_state["params"]["net"]
    dtypes = {"phase": sorted({str(d) for d in phase_dtypes}),
              "final_state": sorted({str(v.dtype) for v in final.values()}),
              "model_params": sorted({str(v.dtype) for v in tr.model.params.values()})}
    print(f"[float64] Burgers slice (Fourier 256x3, mapping 128), adam_lbfgs: {adam_epochs} Adam "
          f"epochs ({adam_losses} losses), then {len(hist['train_loss']) - adam_epochs} float64 "
          f"L-BFGS iterations "
          f"({evals} evaluations) on all 40000 points; kernel 1 {k1_adam} launches before the "
          f"switch (want {adam_losses}), {k1_phase} after (want 0); kernel 2 "
          f"{adam['fourier_features']} launches before (want {2 * adam_losses}), "
          f"{phase['fourier_features']} after (want 0) and {plain_phase} float64 plain calls "
          f"(want {want_plain}); "
          f"dtypes {dtypes}; train {hist['train_loss']}, {wall:.1f} s ({card})", flush=True)
    if (k1_adam != adam_losses or k1_phase or adam["fourier_features"] != 2 * adam_losses
            or phase["fourier_features"] or plain_phase != want_plain
            or ff.plain_f64 - plain0 != want_plain):
        raise AssertionError(f"float64: launches {launches}, at the switch {at_switch}, "
                             f"plain {plain_phase} (want {want_plain})")
    if dtypes != {"phase": ["torch.float64"], "final_state": ["torch.float64"],
                  "model_params": ["torch.float32"]}:
        raise AssertionError(f"float64: dtypes {dtypes}")
    if not all(map(math.isfinite, hist["train_loss"] + hist["val_loss"])):
        raise AssertionError(f"float64: losses {hist}")

    # One float64 loss and its gradients on the card against the CPU, on the
    # same points, draws and parameters.
    def loss_on(device):
        c = lever_config(device)
        pde, model = create_pde(c), PINNModel(c, seed=0)
        # As the trainer attaches them: kernel 1's dtype gate then sends the
        # float64 residual to the plain bundle.
        pde.attach_fast_bundle(model)
        pde.attach_fused_residual_kernel(model)
        pde.dtype = torch.float64
        draws = [a.to(device) for a in f64_draws]
        pde._sample_boundary_points = lambda gen, n: (draws[0], draws[1])
        pde._sample_initial_points = lambda gen, n: (draws[2], draws[3])
        p = {k: v.detach().to(device).requires_grad_(True) for k, v in final.items()}
        losses = pde.compute_loss(model.apply, p, draws[4], draws[5],
                                  generator=torch.Generator(device=device))
        grads = torch.autograd.grad(losses["total"], list(p.values()))
        return float(losses["total"].detach()), {k: g.cpu() for k, g in zip(p, grads)}

    g = torch.Generator().manual_seed(40)
    cpu_pde = create_pde(lever_config("cpu"))
    cpu_pde.dtype = torch.float64
    xb, tb = cpu_pde._sample_boundary_points(g, 4096)
    xi, ti = cpu_pde._sample_initial_points(g, 4096)
    x, t = (a.double() for a in cpu_pde.generate_collocation_points(g, 8192, "uniform"))
    f64_draws = [xb, tb, xi, ti, x, t]
    torch.cuda.synchronize()
    plain_before, k1_before = ff.plain_f64, _launches()["fused_residual_loss"]
    card_loss, card_grads = loss_on("cuda")
    card_plain = ff.plain_f64 - plain_before
    card_k1 = _launches()["fused_residual_loss"] - k1_before
    cpu_loss, cpu_grads = loss_on("cpu")
    loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    grad_rel = max(float((card_grads[k] - cpu_grads[k]).abs().max()
                         / cpu_grads[k].abs().max().clamp(min=1e-300)) for k in cpu_grads)
    print(f"[float64] loss and gradients at N=8192, card against CPU (float64): loss rel "
          f"{loss_rel:.3e}, worst gradient rel {grad_rel:.3e} (tol {F64_CPU_TOL}); kernel 2 "
          f"float64 plain calls on the card {card_plain} (BC, IC), kernel 1 launches {card_k1} "
          f"({card})", flush=True)
    if not (loss_rel < F64_CPU_TOL and grad_rel < F64_CPU_TOL) or card_plain != 2 or card_k1:
        raise AssertionError(f"float64 card vs CPU: loss rel {loss_rel}, gradient rel {grad_rel}, "
                             f"plain calls {card_plain}")

    # Kernels 2 and 3 by the JAX kernels' dtype gate: float64 CUDA tensors
    # take the plain version, float32 ones the kernel.
    from pinnrl_tpu_torch.ops.kernels import siren

    gate = {}
    xg = torch.rand((4096, 2), generator=torch.Generator(device=dev).manual_seed(41), device=dev)
    Bg, Wg = tr.model.constants["FourierFeatures_0.B"], torch.randn((2, 124), device=dev)
    for name, fn, plain, args in (
            ("fourier_features", ff, fourier_feats.fourier_features_plain, (Bg, True)),
            ("siren_layer", siren.siren_layer, siren.siren_layer_plain,
             (Wg, torch.zeros(124, device=dev), 30.0))):
        for dtype in (torch.float64, torch.float32):
            cast = [a.to(dtype) if torch.is_tensor(a) else a for a in args]
            n0, p0 = fn.launches, fn.plain_f64
            got = fn(xg.to(dtype), *cast)
            torch.cuda.synchronize()
            ref = plain(xg.to(dtype), *cast)
            gate[f"{name}_{str(dtype)[6:]}"] = {
                "launches": fn.launches - n0, "plain": fn.plain_f64 - p0,
                "dtype": str(got.dtype)[6:], "max_abs_err": float((got - ref).abs().max())}
    print(f"[float64] dtype gate on the card: {gate} ({card})", flush=True)
    for key, g_ in gate.items():
        f64 = key.endswith("float64")
        if (g_["launches"], g_["plain"]) != ((0, 1) if f64 else (1, 0)) or \
                g_["dtype"] != key.rsplit("_", 1)[1] or (f64 and g_["max_abs_err"] != 0.0):
            raise AssertionError(f"dtype gate: {gate}")

    # An L-BFGS iteration at N = 40000: float64 against float32 on the plain
    # bundle (kernel 1 off), in turns.
    t64 = trainer(lever_config("cuda", optimizer="lbfgs", residual_dtype="float64"))
    t64._maybe_promote_f64(t64.model.params)
    t32 = trainer(lever_config("cuda", optimizer="lbfgs", fused_residual_kernel="off"))
    timed = _lbfgs_ms_in_turns({"float32_plain": t32, "float64": t64}, F64_TIMED)
    print(f"[float64] L-BFGS iteration at N=40000 (median ms, host clock, in turns): float64 "
          f"{timed['float64']['iteration_ms']:.3f} ({timed['float64']['evaluations_per_iteration']:.2f} "
          f"evaluations), float32 plain bundle {timed['float32_plain']['iteration_ms']:.3f} "
          f"({timed['float32_plain']['evaluations_per_iteration']:.2f}) ({card})", flush=True)
    return {"launches": launches, "adam_launches": adam, "phase_launches": phase,
            "kernel2_plain_f64": plain_phase, "evaluations": evals, "dtypes": dtypes,
            "train_loss": hist["train_loss"], "wall_s": wall, "card_vs_cpu":
            {"loss_rel": loss_rel, "grad_rel": grad_rel}, "gate": gate, "lbfgs": timed}


def _gloo_rank(rank: int, world: int, init_file: str, out_dir: str) -> None:
    """One of phase 41's ranks that share the card through gloo: the Burgers
    slice under the mesh; writes its history and launches."""
    import torch
    import torch.distributed as dist

    from pinnrl_tpu_torch.models import PINNModel
    from pinnrl_tpu_torch.parallel import make_mesh
    from pinnrl_tpu_torch.pdes import create_pde
    from pinnrl_tpu_torch.training import PDETrainer

    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh(devices=["cuda:0"] * world)
        cfg = lever_config("cuda", num_epochs=MESH_EPOCHS)
        tr = PDETrainer(PINNModel(cfg, seed=0), create_pde(cfg), cfg, mesh=mesh)
        res, launches, wall = _run_counted(tr)
        with open(f"{out_dir}/rank{rank}.json", "w") as f:
            json.dump({"train_loss": res["history"]["train_loss"],
                       "val_loss": res["history"]["val_loss"], "launches": launches,
                       "wall_s": wall}, f)
    finally:
        dist.destroy_process_group()


def _rel(a, b) -> float:
    return max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a, b))


def mesh_runs(dev, card: str):
    """Phase 41: the Burgers slice under a device mesh (see the module
    docstring)."""
    import tempfile

    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from pinnrl_tpu_torch.models import PINNModel
    from pinnrl_tpu_torch.parallel import make_mesh
    from pinnrl_tpu_torch.pdes import create_pde
    from pinnrl_tpu_torch.training import PDETrainer

    def run(mesh=None):
        cfg = lever_config("cuda", num_epochs=MESH_EPOCHS)
        tr = PDETrainer(PINNModel(cfg, seed=0), create_pde(cfg), cfg, mesh=mesh)
        res, launches, wall = _run_counted(tr)
        return res["history"], launches, wall

    out = {}
    steps = MESH_EPOCHS * (40000 // 8192)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/pg", rank=0, world_size=1)
        try:
            mesh = make_mesh()
            hist_m, launches_m, wall_m = run(mesh)
        finally:
            dist.destroy_process_group()
    hist_s, launches_s, wall_s = run()
    rel = max(_rel(hist_m["train_loss"], hist_s["train_loss"]),
              _rel(hist_m["val_loss"], hist_s["val_loss"]))
    print(f"[mesh] NCCL world of 1 on {mesh.device}: {steps} steps, train {hist_m['train_loss']} "
          f"against unsharded {hist_s['train_loss']}: worst rel {rel:.3e} (tol {MESH_TOL}); "
          f"kernel 1 {launches_m['fused_residual_loss']} launches under the mesh, "
          f"{launches_s['fused_residual_loss']} without; {wall_m:.1f} s and {wall_s:.1f} s ({card})",
          flush=True)
    if rel > MESH_TOL or launches_m["fused_residual_loss"] != launches_s["fused_residual_loss"]:
        raise AssertionError(f"mesh: rel {rel}, launches {launches_m} against {launches_s}")
    out["nccl_world1"] = {"rel": rel, "launches": launches_m, "wall_s": wall_m,
                          "unsharded_wall_s": wall_s, "train_loss": hist_m["train_loss"]}

    # Two ranks sharing the card: NCCL refuses two ranks on one device, so
    # gloo carries the collectives, if its build takes CUDA tensors.
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        try:
            mp.spawn(_gloo_rank, args=(2, f"{tmp}/pg", tmp), nprocs=2, join=True)
            ranks = [json.loads(open(f"{tmp}/rank{r}.json").read()) for r in range(2)]
            error = None
        except mp.ProcessRaisedException as e:
            ranks, error = None, str(e).strip().splitlines()[-1]
        wall = time.perf_counter() - t0
    if ranks is None:
        print(f"[mesh] 2 gloo ranks on one card: not supported here: {error} ({card})", flush=True)
        out["gloo_2ranks"] = {"error": error}
        return out
    rel2 = max(_rel(ranks[0]["train_loss"], hist_s["train_loss"]),
               _rel(ranks[0]["val_loss"], hist_s["val_loss"]))
    k1 = [r["launches"]["fused_residual_loss"] for r in ranks]
    print(f"[mesh] 2 gloo ranks sharing the card: train {ranks[0]['train_loss']}, worst rel to "
          f"unsharded {rel2:.3e} (tol {MESH_GLOO_TOL}); ranks agree "
          f"{ranks[0]['train_loss'] == ranks[1]['train_loss']}; kernel 1 per rank {k1} (want "
          f"{launches_s['fused_residual_loss']} each); training {[round(r['wall_s'], 3) for r in ranks]} s "
          f"per rank against {wall_s:.3f} s unsharded, {wall:.1f} s with process start ({card})",
          flush=True)
    if (rel2 > MESH_GLOO_TOL or ranks[0]["train_loss"] != ranks[1]["train_loss"]
            or k1 != [launches_s["fused_residual_loss"]] * 2):
        raise AssertionError(f"mesh, 2 gloo ranks: rel {rel2}, launches {k1}")
    out["gloo_2ranks"] = {"rel": rel2, "launches": [r["launches"] for r in ranks],
                          "wall_s": wall, "rank_wall_s": [r["wall_s"] for r in ranks]}
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dashboard_runs(dev, card: str):
    """Phase 42: the dashboard server on the card (see the module
    docstring)."""
    import tempfile
    import threading
    import urllib.request

    import torch

    from pinnrl_tpu_torch.dashboard.server import DashboardServer
    from pinnrl_tpu_torch.ops.kernels import fourier_feats

    def get(url, data=None):
        with urllib.request.urlopen(url, data=data, timeout=60) as r:
            return r.read()

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        srv = DashboardServer(results_dir=tmp, port=_free_port(), device="cuda")
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        base = f"http://localhost:{srv.port}"
        try:
            t0 = time.perf_counter()
            launched = json.loads(get(f"{base}/api/launch", json.dumps(
                {"pde": "heat", "epochs": DASHBOARD_EPOCHS}).encode()))
            cmd = launched.get("command", [])
            if not launched.get("ok") or cmd[cmd.index("--device") + 1] != "cuda":
                raise AssertionError(f"dashboard launch: {launched}")
            proc, exps = srv.launched[0], []
            while time.perf_counter() - t0 < DASHBOARD_DEADLINE_S:
                exps = json.loads(get(f"{base}/api/experiments"))
                if exps and exps[0]["status"] in ("completed", "failed"):
                    break
                if proc.poll() not in (None, 0):
                    break
                time.sleep(0.5)
            rc = proc.wait(timeout=DASHBOARD_DEADLINE_S)
            wall = time.perf_counter() - t0
            if rc != 0 or not exps or exps[0]["status"] != "completed":
                log = (srv.results_dir / "trainer_launch.log").read_text()[-2000:]
                raise AssertionError(f"dashboard run: rc {rc}, experiments {exps}\n{log}")
            name = exps[0]["name"]
            hist = json.loads(get(f"{base}/api/experiment/{name}/history"))
            snap = json.loads(get(f"{base}/api/experiment/{name}/snapshot"))
            torch.cuda.synchronize()
            before = fourier_feats.fourier_features.launches
            t1 = time.perf_counter()
            sol = json.loads(get(f"{base}/api/experiment/{name}/solution"))
            sol_ms = (time.perf_counter() - t1) * 1e3
            torch.cuda.synchronize()
            sol_launches = fourier_feats.fourier_features.launches - before
            report = get(f"{base}/api/experiment/{name}/report")
        finally:
            for p in srv.launched:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            srv.shutdown()
    u = sol.get("u_pred") or []
    print(f"[dashboard] POST /api/launch heat {DASHBOARD_EPOCHS} epochs on the card: "
          f"completed in {wall:.1f} s (process start included), history epochs "
          f"{len(hist.get('train_loss', []))}, snapshot {len(snap.get('u_pred', []))} rows, "
          f"solution explorer {len(u)} slices x {len(u[0]) if u else 0} points in {sol_ms:.1f} ms "
          f"with {sol_launches} kernel 2 launches (want {len(u)}), report {len(report)} bytes "
          f"({card})", flush=True)
    finite = all(math.isfinite(v) for row in u for v in row)
    if (len(hist.get("train_loss", [])) != DASHBOARD_EPOCHS or not snap.get("u_pred")
            or len(u) != 9 or not finite or sol_launches != len(u) or b"<html" not in report.lower()):
        raise AssertionError(f"dashboard: history {hist}, solution launches {sol_launches}, "
                             f"finite {finite}, report {report[:200]!r}")
    return {"wall_s": wall, "solution_ms": sol_ms, "solution_launches": sol_launches,
            "epochs": len(hist["train_loss"]), "report_bytes": len(report)}


# Phase 43: kernel 1 with each activation beyond tanh (tanh timed beside
# them). Parity cases (name: (config, N)): the Burgers recipe's width
# (Fourier 256x3, mapping 128) at N 8192 and 40000 and with LayerNorm off and
# a trainable basis at 8192, KdV causal (order 3) and heat_2d (d = 2) at
# their recipes' widths, Black-Scholes's shipped feedforward 128x7 with
# LayerNorm. The reference is the plain twins (``_TorchOps``) run in float64
# on the same inputs, at FUSED_TOLS' bounds; the float32 twins' own gap to
# it is printed beside (on the feedforward trunk with sin the float32 twins,
# not the kernel, are the far ones).
ACT_KERNEL_ACTS = ("gelu", "sigmoid", "silu", "sin")
ACT_CASES = {"burgers": ("burgers", 8192), "burgers_n40000": ("burgers", 40000),
             "no_ln": ("burgers", 8192), "trainable_basis": ("burgers", 8192),
             "kdv_causal": ("kdv_causal", 8192), "heat_2d": ("heat_2d", 8192),
             "feedforward": ("black_scholes_ff", 8192)}
ACT_RUN_EPOCHS = 6     # the gelu Burgers recipe, Adam then L-BFGS (12 Adam steps, 3 iterations)
ACT_SLICE_EPOCHS = 2   # sigmoid and silu on the Burgers slice: 8 Adam steps + 2 validations
ACT_SHIPPED_EPOCHS = 2  # sin on the shipped Fourier 512x4: 2 x 2 Adam steps of 2048 + 1 validation
ACT_WAVE_EPOCHS = 2    # silu on the wave recipe (the t-order-2 bundle): 8 Adam steps
# Float operations of one evaluation of act_derivs<4> in csrc/fused_residual.cu
# (d0..d3, Burgers' x-order 2), counted from its source: each +, -, *, / and
# negation as one, each tanhf, expf, sin or cos as one (its one special-function
# instruction), constant products folded. The function needs one evaluation per
# element of the value stream and layer; the reverse's recomputation of them
# is the kernel's choice and is not counted.
ACT_DERIV_OPS = {"tanh": 10, "gelu": 49, "sigmoid": 15, "silu": 25, "sin": 4}


def _act_case_config(case: str, act: str, device: str):
    """The configuration of a phase-43 parity case with ``act``."""
    from pinnrl_tpu_torch.benchmarks.convergence import build_recipe_config
    from pinnrl_tpu_torch.config import load_config

    key = ACT_CASES[case][0]
    if key == "black_scholes_ff":
        cfg = load_config(pde_type="black_scholes", device=device)
    elif key == "burgers":
        cfg = burgers_recipe_config(device)
    else:
        cfg = build_recipe_config(key.removesuffix("_causal"), device=device)
        cfg.training.causal_eps = 1.0 if key.endswith("_causal") else 0.0
    cfg.model.activation = act
    if case == "no_ln":
        cfg.model.layer_norm = False
    if case == "trainable_basis":
        cfg.model.arch_params["trainable_features"] = True
    return cfg


def _act_ptxas():
    """{"transport_fwd_kernel<D,K>": (registers, spill bytes)} and the same
    for the reverse, from kernel 1's build log."""
    from pinnrl_tpu_torch.ops.kernels import _build

    out = {}
    for entry, regs, _smem, spill_st, spill_ld, _stack in ptxas_report(
            _build.BUILD_LOG.get("fused_residual", "")):
        m = re.search(r"(transport_(?:fwd|bwd)_kernel)ILi(\d)ELi(\d)E", entry)
        if m:
            out[f"{m.group(1)}<{m.group(2)},{m.group(3)}>"] = (regs, spill_st + spill_ld)
    return out


def kernel1_vs_f64_twins(dev, model, pde, gen, n: int, tols, label: str):
    """Kernel 1 (the CUDA launcher) on ``n`` time-sorted uniform points of
    ``pde`` drawn from ``gen``, twice, against its plain twins
    (``_TorchOps``) run in float64 on the same card tensors, at ``tols``
    (loss, gradient) relative bounds; the float32 twins' own gap to float64
    printed beside. Raises unless within the bounds, finite and
    bit-identical in two calls. Returns (spec, params, z, the numbers)."""
    import torch

    from pinnrl_tpu_torch.ops.kernels import fused_step

    cuda_ops, plain_ops = fused_step._cuda_ops(dev), fused_step._TorchOps()
    spec = fused_step._spec(model, pde)
    f64_spec = fused_step._Spec(**{**spec.__dict__, "lo": spec.lo.double(),
                                   "scale": spec.scale.double(),
                                   "B": None if spec.B is None else spec.B.double()})
    P = {k: v.detach() for k, v in model.params.items()}
    z = time_sorted(*pde.generate_collocation_points(gen, n, "uniform"))
    lk, gk = fused_step._loss_and_grads(cuda_ops, spec, z, P)
    lk2, gk2 = fused_step._loss_and_grads(cuda_ops, spec, z, P)
    lp, gp = fused_step._loss_and_grads(plain_ops, spec, z, P)
    l64, g64 = fused_step._loss_and_grads(plain_ops, f64_spec, z.double(),
                                          {k: v.double() for k, v in P.items()})
    torch.cuda.synchronize()
    same = torch.equal(lk, lk2) and all(torch.equal(gk[k], gk2[k]) for k in gk)

    def rels(loss, grads):
        worst = max(grads, key=lambda k: float((grads[k].double() - g64[k]).abs().max())
                    / max(float(g64[k].abs().max()), 1e-30))
        return (abs(float(loss) - float(l64)) / abs(float(l64)),
                float((grads[worst].double() - g64[worst]).abs().max())
                / max(float(g64[worst].abs().max()), 1e-30), worst)

    k_loss, k_grad, k_name = rels(lk, gk)
    p_loss, p_grad, _ = rels(lp, gp)
    abs_err = max(abs(float(lk) - float(lp)), *(float((gk[k] - gp[k]).abs().max()) for k in gk))
    abs_err64 = max(abs(float(lk) - float(l64)),
                    *(float((gk[k].double() - g64[k]).abs().max()) for k in gk))
    loss_tol, grad_tol = tols
    print(f"{label} N={n}: against the float64 twins loss rel {k_loss:.3e} (tol {loss_tol:g}), "
          f"worst grad rel {k_grad:.3e} ({k_name}, tol {grad_tol:g}); the float32 twins "
          f"{p_loss:.3e}, {p_grad:.3e}; kernel against the float32 twins max_abs_err "
          f"{abs_err:.3e} (float64 {abs_err64:.3e}); two calls bit-identical {same}", flush=True)
    if not (k_loss < loss_tol and k_grad < grad_tol and same
            and all(torch.isfinite(g).all() for g in gk.values())):
        raise AssertionError(f"{label}: kernel 1 disagrees with its plain version")
    return spec, P, z, {"n": n, "loss_rel": k_loss, "grad_rel": k_grad,
                        "plain_f32_loss_rel": p_loss, "plain_f32_grad_rel": p_grad,
                        "max_abs_err": abs_err, "max_abs_err_f64": abs_err64,
                        "bit_identical": same}


def activation_runs(dev, card: str):
    """Phase 43: kernel 1 for gelu, sigmoid, silu and sin (see the module
    docstring)."""
    import torch

    from pinnrl_tpu_torch.benchmarks.convergence import build_recipe_config
    from pinnrl_tpu_torch.config import load_config
    from pinnrl_tpu_torch.models import PINNModel
    from pinnrl_tpu_torch.ops.jet_mlp import make_bundle_fn
    from pinnrl_tpu_torch.ops.kernels import fused_step
    from pinnrl_tpu_torch.pdes import create_pde
    from pinnrl_tpu_torch.training import PDETrainer
    from pinnrl_tpu_torch.training.lbfgs import LBFGS

    t_phase = time.perf_counter()
    ptx = _act_ptxas()
    bwd33 = ptx.get("transport_bwd_kernel<3,3>")
    print(f"[activations] ptxas transport kernels (registers, spill bytes), one kernel per (D, K) "
          f"for every activation: {ptx} ({card})", flush=True)
    # D = 1-3 x K = 1-3, and D = 0 (an ODE: no x-group) at K = 1, each way.
    if len(ptx) != 20 or bwd33 is None:
        raise AssertionError(f"transport kernels missing from the build log: {sorted(ptx)}")
    cuda_ops = fused_step._cuda_ops(dev)
    gen = torch.Generator(device=dev).manual_seed(43)
    out = {act: {"parity": {}} for act in ("tanh",) + ACT_KERNEL_ACTS}

    for act in ("tanh",) + ACT_KERNEL_ACTS:
        for case, (key, n) in ACT_CASES.items():
            if act == "tanh" and case not in ("burgers", "burgers_n40000"):
                continue
            cfg = _act_case_config(case, act, "cuda")
            pde, model = create_pde(cfg), PINNModel(cfg, seed=0)
            if not fused_step.supports(model, pde, cfg.training):
                raise AssertionError(f"{act} {case}: kernel 1 does not take it")
            tol_key = "kdv_causal" if key == "kdv_causal" else "burgers"
            spec, P, z, out[act]["parity"][case] = kernel1_vs_f64_twins(
                dev, model, pde, gen, n, FUSED_TOLS[tol_key], f"[activations] kernel 1 {act} {case}")
            if case in ("burgers", "burgers_n40000"):
                # Device ms of the kernels and of the plain version (bundle ->
                # residual -> autograd), by CUDA-graph replay.
                bundle_fn = make_bundle_fn(model, 1, 2, 1)
                p_leaf = {k: v.clone().requires_grad_(True) for k, v in P.items()}
                it = 5 if n > 8192 else 10
                ms = graph_ms(lambda: fused_step._loss_and_grads(cuda_ops, spec, z, P), iters=it,
                              replays=5)
                plain_ms = graph_ms(lambda: torch.autograd.grad(
                    fused_step.fused_residual_loss_plain(bundle_fn, pde, p_leaf, z),
                    list(p_leaf.values())), iters=it, replays=5)
                gemm = fused_gemms(P, 2, n)
                n_par = sum(v.numel() for v in P.values())
                width, layers = P["Dense_0.weight"].shape[0], spec.n_hidden
                act_ops = ACT_DERIV_OPS[act] * n * width * layers
                nbytes = 4.0 * (z.numel() + 2 * n_par + spec.B.numel() + 1)
                gemm_bound = bound(sum(2.0 * a * b * c for a, b, c in gemm), nbytes)
                full_bound = bound(sum(2.0 * a * b * c for a, b, c in gemm) + act_ops, nbytes)
                lib = cublas_ms(gemm, dev)
                tag = "" if n == 8192 else "n40000_"
                out[act].update({f"{tag}ms": ms, f"{tag}plain_ms": plain_ms,
                                 f"{tag}bound_ms": full_bound[0], f"{tag}bound_by": full_bound[1],
                                 f"{tag}gemm_bound_ms": gemm_bound[0], f"{tag}library_ms": lib})
                print(f"[activations] kernel 1 {act} Burgers N={n}: {ms:.4f} ms, plain {plain_ms:.4f} "
                      f"ms; bound {full_bound[0]:.4f} ms ({full_bound[1]}; its GEMMs alone "
                      f"{gemm_bound[0]:.4f}, the activation's derivatives "
                      f"{act_ops / FP32_FLOPS * 1e3:.4f}); cuBLAS on its products {lib:.4f} ms "
                      f"({card})", flush=True)
            del pde, model
        par = out[act]["parity"].values()
        out[act].update({"max_abs_err": max(v["max_abs_err"] for v in par),
                         "max_abs_err_f64": max(v["max_abs_err_f64"] for v in par), "ptxas": {k: list(v) for k, v in ptx.items()},
                         "ptxas_transport_bwd_3_3": {"registers": bwd33[0],
                                                     "spill_bytes": bwd33[1]}})

    # ---- runs on the main path ---------------------------------------------- #
    def run(cfg, label):
        tr = PDETrainer(PINNModel(cfg, seed=0), create_pde(cfg), cfg)
        fused_step.fused_residual_loss.launches = 0
        evals0 = LBFGS.evaluations
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = tr.train(seed=0)["history"]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fused_step.fused_residual_loss.launches
        losses = hist["train_loss"]
        if not all(map(math.isfinite, losses + hist["val_loss"])):
            raise AssertionError(f"{label}: non-finite losses {losses}")
        return tr, hist, launches, LBFGS.evaluations - evals0, wall

    # gelu: the Burgers recipe with adam_lbfgs, kernel 1 and the plain path.
    cfgs = {}
    for path in ("kernel", "plain"):
        c = build_recipe_config("burgers", epochs=ACT_RUN_EPOCHS, device="cuda")
        c.model.activation = "gelu"
        if path == "plain":
            c.training.fused_residual_kernel = "off"
        cfgs[path] = c
    rt = cfgs["kernel"].training
    switch = int(rt.adam_lbfgs_switch_ratio * ACT_RUN_EPOCHS)
    adam_steps = switch * (rt.num_collocation_points // rt.batch_size)
    tr, hist, launches, evals, wall = run(cfgs["kernel"], "gelu Burgers recipe")
    n_vals = len(hist["val_loss"])
    want = adam_steps + evals + n_vals
    ptr, phist, plaunches, pevals, pwall = run(cfgs["plain"], "gelu Burgers recipe, plain path")
    final_rel = abs(hist["train_loss"][-1] - phist["train_loss"][-1]) / abs(phist["train_loss"][-1])
    first_rel = abs(hist["train_loss"][0] - phist["train_loss"][0]) / abs(phist["train_loss"][0])
    print(f"[activations] gelu Burgers recipe (adam_lbfgs, {ACT_RUN_EPOCHS} epochs: {adam_steps} Adam "
          f"steps, {evals} L-BFGS evaluations, {n_vals} validations): kernel 1 {launches} launches "
          f"(want {want}), {wall:.2f} s; epoch losses "
          f"{' '.join(f'{v:.6e}' for v in hist['train_loss'])}; the plain path "
          f"{' '.join(f'{v:.6e}' for v in phist['train_loss'])} ({plaunches} launches, {pevals} "
          f"evaluations, {pwall:.2f} s); first epoch rel {first_rel:.3e}, last rel {final_rel:.3e} "
          f"({card})", flush=True)
    if not (tr.fused_kernel_active and not ptr.fused_kernel_active and launches == want > 0
            and plaunches == 0):
        raise AssertionError(f"gelu Burgers recipe: kernel 1 {launches}, want {want}; plain path "
                             f"{plaunches}")
    if not (hist["train_loss"][-1] < hist["train_loss"][0]
            and phist["train_loss"][-1] < phist["train_loss"][0]):
        raise AssertionError(f"gelu Burgers recipe: losses did not fall: {hist['train_loss']}, "
                             f"{phist['train_loss']}")
    out["gelu"].update({"launches": launches, "run": {
        "adam_steps": adam_steps, "lbfgs_evaluations": evals, "validations": n_vals,
        "train_loss": hist["train_loss"], "plain_train_loss": phist["train_loss"],
        "first_epoch_rel": first_rel, "last_epoch_rel": final_rel, "wall_s": wall,
        "plain_wall_s": pwall}})
    del tr, ptr

    # sigmoid and silu: the Burgers recipe slice, Adam.
    for act in ("sigmoid", "silu"):
        c = lever_config("cuda", num_epochs=ACT_SLICE_EPOCHS)
        c.model.activation = act
        tr, hist, launches, _, wall = run(c, f"{act} Burgers slice")
        steps = ACT_SLICE_EPOCHS * (c.training.num_collocation_points // c.training.batch_size)
        want = steps + len(hist["val_loss"])
        print(f"[activations] {act} Burgers slice: {steps} Adam steps, {len(hist['val_loss'])} "
              f"validations, kernel 1 {launches} launches (want {want}), epoch losses "
              f"{hist['train_loss']}, {wall:.2f} s ({card})", flush=True)
        if not (tr.fused_kernel_active and launches == want):
            raise AssertionError(f"{act} Burgers slice: kernel 1 {launches}, want {want}")
        out[act].update({"launches": launches, "run": {"steps": steps,
                                                       "train_loss": hist["train_loss"]}})
        del tr

    # sin: the shipped Fourier 512x4 (mapping 512), Adam.
    c = load_config(pde_type="burgers", architecture="fourier", device="cuda")
    c.model.activation = "sin"
    c.training.num_epochs = ACT_SHIPPED_EPOCHS
    st = c.training
    tr, hist, launches, _, wall = run(c, "sin on the shipped Fourier 512x4")
    steps = ACT_SHIPPED_EPOCHS * (st.num_collocation_points // st.batch_size)
    want = steps + len(hist["val_loss"])
    print(f"[activations] sin on the shipped Fourier {list(c.model.hidden_dims)}, mapping "
          f"{c.model.arch_params['mapping_size']} (batch {st.batch_size} of "
          f"{st.num_collocation_points}): {steps} Adam steps, {len(hist['val_loss'])} validations, "
          f"kernel 1 {launches} launches (want {want}), epoch losses {hist['train_loss']}, "
          f"{wall:.2f} s ({card})", flush=True)
    if not (tr.fused_kernel_active and launches == want):
        raise AssertionError(f"sin on the shipped Fourier 512x4: kernel 1 {launches}, want {want}")
    out["sin"].update({"launches": launches, "run": {"steps": steps, "train_loss": hist["train_loss"]}})
    del tr

    # silu on wave: temporal order 2 runs the bundle, not kernel 1.
    c = build_recipe_config("wave", epochs=ACT_WAVE_EPOCHS, device="cuda")
    c.model.activation = "silu"
    c.training.optimizer = "adam"
    tr, hist, launches, _, wall = run(c, "silu on the wave recipe")
    print(f"[activations] silu on the wave recipe (t-order 2): bundle {tr.fast_bundle_active}, "
          f"kernel 1 {tr.fused_kernel_active} with {launches} launches (want 0), epoch losses "
          f"{hist['train_loss']}, {wall:.2f} s ({card})", flush=True)
    if not (tr.fast_bundle_active and not tr.fused_kernel_active and launches == 0):
        raise AssertionError(f"silu on wave: bundle {tr.fast_bundle_active}, kernel 1 {launches}")
    out["silu"]["wave_run"] = {"launches": launches, "train_loss": hist["train_loss"]}
    del tr
    print(f"[activations] phase 43: {time.perf_counter() - t_phase:.1f} s ({card})", flush=True)
    return out


# Phase 44: kernel 1 in four or more space dimensions (the *_nd kernels of
# csrc/fused_residual.cu, which take d at run time). Small (64x48, mapping
# 32, N 4096; name: (PDE, d)): every residual at d = 4 (KdV: 14 stacked
# streams, the widest), heat at d = 5 and 8, heat at d = 4 on the
# feedforward trunk, and heat at d = 4 with causal weights, a frame of speed
# 0.7, a trainable basis and gelu together. Full width: heat in four
# dimensions on the shipped Fourier trunk (ND4_HEAT). Each against the plain
# twins run in float64 at FUSED_TOLS' bounds, bit-identical in two calls.
ND4_SMALL = {**{f"{p}_4d": (p, 4) for p in ("burgers", "heat", "kdv", "convection", "allen_cahn",
                                              "black_scholes")},
             "heat_5d": ("heat", 5), "heat_8d": ("heat", 8), "heat_4d_ff": ("heat", 4),
             "heat_4d_variants": ("heat", 4)}
ND4_SMALL_N = 4096
ND4_VELOCITY = [0.5, -1.5, 1.0, 0.25]
# The card paths: heat-4D with adam_lbfgs, 4 epochs (2 of 4 Adam steps of
# 8192, then 2 L-BFGS iterations on all 40000 points; a validation every 2);
# Black-Scholes as shipped on a basket of 4 assets, 3 epochs of 2 Adam steps.
ND4_HEAT_EPOCHS = 4
ND4_BASKET_EPOCHS = 3
ND4_KERNELS = 21  # the *_nd kernels in the build log (the input kernels at K = 0 too)


def heat4d_config(device: str):
    """heat_2d's block posed in four space dimensions on [0, pi]^4 with the
    ``sin_exp_decay`` IC, exact solution and its Dirichlet BC, on the shipped
    Fourier trunk (512x4, mapping 512, tanh + LayerNorm; 10 stacked
    streams), with ``adam_lbfgs``: Adam on batches of 8192, then L-BFGS on
    all 40000 points."""
    from pinnrl_tpu_torch.config import load_config

    cfg = load_config(pde_type="heat_2d", device=device)
    cfg.pde.dimension, cfg.model.input_dim = 4, 5
    cfg.pde.domain = [[0.0, math.pi]] * 4
    sol = {"type": "sin_exp_decay", "amplitude": 1.0, "frequency": 2.0}
    cfg.pde.initial_condition, cfg.pde.exact_solution = dict(sol), dict(sol)
    t = cfg.training
    t.optimizer, t.num_epochs = "adam_lbfgs", ND4_HEAT_EPOCHS
    t.num_collocation_points, t.batch_size = LBFGS_N, 8192
    t.validation_frequency = 2
    return cfg


def basket_config(device: str):
    """Black-Scholes as shipped (feedforward 128x7, LayerNorm) on a basket
    of four assets, [0, 200]^4."""
    from pinnrl_tpu_torch.config import load_config

    cfg = load_config(pde_type="black_scholes", device=device)
    cfg.pde.dimension, cfg.model.input_dim = 4, 5
    cfg.pde.domain = [[0.0, 200.0]] * 4
    cfg.training.num_epochs = ND4_BASKET_EPOCHS
    return cfg


def nd4_small_config(case: str, device: str):
    """The configuration of a small phase-44 case (``ND4_SMALL``)."""
    from pinnrl_tpu_torch.config import load_config

    pde_type, dim = ND4_SMALL[case]
    arch = "feedforward" if case.endswith("_ff") else "fourier"
    cfg = load_config(pde_type=pde_type, architecture=arch, device=device)
    cfg.pde.dimension, cfg.model.input_dim = dim, dim + 1
    cfg.pde.domain = [list(cfg.pde.domain[0])] * dim
    if pde_type == "convection":
        cfg.pde.parameters["velocity"] = list(ND4_VELOCITY)
    cfg.model.hidden_dims = [64, 48]
    cfg.model.arch_params["mapping_size"] = 32
    variants = case.endswith("_variants")
    if variants:
        cfg.model.activation = "gelu"
        cfg.model.arch_params.update({"trainable_features": True, "moving_frame_speed": FRAME_SPEED})
    cfg.training.causal_eps = 1.0 if variants else 0.0
    return cfg


def _nd_ptxas():
    """{"<name>_nd_kernel[<K>]": (registers, spill bytes)} of kernel 1's
    d >= 4 kernels, from its build log."""
    from pinnrl_tpu_torch.ops.kernels import _build

    out = {}
    for entry, regs, _smem, spill_st, spill_ld, _stack in ptxas_report(
            _build.BUILD_LOG.get("fused_residual", "")):
        m = re.search(r"\d([a-z][a-z_]*_nd(?:_partial)?_kernel)(?:ILi(\d)E)?", entry)
        if m:
            out[m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")] = (regs, spill_st + spill_ld)
    return out


def nd_runs(dev, card: str):
    """Phase 44: kernel 1 in four or more space dimensions (see the module
    docstring)."""
    import torch

    from pinnrl_tpu_torch.models import PINNModel
    from pinnrl_tpu_torch.ops.jet_mlp import make_bundle_fn
    from pinnrl_tpu_torch.ops.kernels import fourier_feats, fused_step
    from pinnrl_tpu_torch.pdes import create_pde
    from pinnrl_tpu_torch.training import PDETrainer
    from pinnrl_tpu_torch.training.lbfgs import LBFGS

    t_phase = time.perf_counter()
    ptx = _nd_ptxas()
    print(f"[nd4] ptxas of the d >= 4 kernels (registers, spill bytes): {ptx} ({card})", flush=True)
    if len(ptx) != ND4_KERNELS or any(spill for _, spill in ptx.values()):
        raise AssertionError(f"d >= 4 kernels missing from the build log or spilling: {ptx}")
    out = {"ptxas": {k: {"registers": r, "spill_bytes": b} for k, (r, b) in ptx.items()},
           "parity": {}}
    gen = torch.Generator(device=dev).manual_seed(44)
    for case in ND4_SMALL:
        cfg = nd4_small_config(case, "cuda")
        pde, model = create_pde(cfg), PINNModel(cfg, seed=0)
        if not fused_step.supports(model, pde, cfg.training):
            raise AssertionError(f"{case}: kernel 1 does not take it")
        tols = FUSED_TOLS["burgers_causal" if cfg.training.causal_eps > 0 else "burgers"]
        out["parity"][case] = kernel1_vs_f64_twins(dev, model, pde, gen, ND4_SMALL_N, tols,
                                                   f"[nd4] kernel 1 {case}")[3]
        del pde, model

    # Heat-4D at full width: parity, then device ms by CUDA-graph replay of
    # the kernels, of the plain version (bundle -> residual -> autograd) and
    # of cuBLAS on the call's products.
    cfg = heat4d_config("cuda")
    pde, model = create_pde(cfg), PINNModel(cfg, seed=0)
    cuda_ops = fused_step._cuda_ops(dev)
    bundle_fn = make_bundle_fn(model, 4, 2, 1)
    out["heat_4d"] = {}
    for n in (8192, LBFGS_N):
        spec, P, z, par = kernel1_vs_f64_twins(dev, model, pde, gen, n, FUSED_TOLS["burgers"],
                                               "[nd4] kernel 1 heat_4d 512x4")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fused_step._loss_and_grads(cuda_ops, spec, z, P)
        torch.cuda.synchronize()
        peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        small = n == 8192
        ms = graph_ms(lambda: fused_step._loss_and_grads(cuda_ops, spec, z, P),
                      iters=10 if small else 3, replays=5 if small else 3)
        p_leaf = {k: v.clone().requires_grad_(True) for k, v in P.items()}
        try:
            plain_ms = graph_ms(lambda: torch.autograd.grad(
                fused_step.fused_residual_loss_plain(bundle_fn, pde, p_leaf, z),
                list(p_leaf.values()), allow_unused=True), iters=3 if small else 2, replays=3)
        except torch.cuda.OutOfMemoryError:
            plain_ms = None  # written down as not measured
        del p_leaf
        torch.cuda.empty_cache()
        gemm = fused_gemms(P, 2, n, 4)
        kb = kernel1_bound(P, 2, z, spec.B, 4)
        lib = cublas_ms(gemm, dev, iters=5 if small else 2)
        torch.cuda.empty_cache()
        # The same products on the GEMM core as kernel 1 runs them (seeded
        # operands): what is left of the call is the transport, embedding,
        # residual and column-sum passes.
        prods = gemm_products(P, 2, n, 4)
        routes = [gemm_routes(kind, *gemm_operands(kind, shape, gen, dev), cuda_ops)[0]
                  for kind, shape in prods]
        core_ms = graph_ms(lambda: [r() for r in routes], iters=5 if small else 2, replays=3)
        del routes
        torch.cuda.empty_cache()
        out["heat_4d"][n] = {**par, "streams": 2 + 4 * 2, "ms": ms, "plain_ms": plain_ms,
                             "bound_ms": kb[0], "bound_by": kb[1],
                             "gemm_flop": sum(2.0 * a * b * c for a, b, c in gemm),
                             "library_ms": lib, "gemm_core_ms": core_ms, "peak_gb": peak_gb}
        plain_txt = "not measured (out of memory)" if plain_ms is None else f"{plain_ms:.4f} ms"
        print(f"[nd4] kernel 1 heat_4d (Fourier 512x4, mapping 512, 10 streams) N={n}: "
              f"{ms:.4f} ms, plain {plain_txt}; bound {kb[0]:.4f} ms ({kb[1]}); its "
              f"{len(gemm)} products on the GEMM core {core_ms:.4f} ms, on cuBLAS {lib:.4f} ms; "
              f"kernel peak memory {peak_gb:.2f} GB ({card})", flush=True)

    # Kernel 2 on the path's BC/IC points: (8192, 5) x (5, 512), its edge
    # path (d > 3), against its plain version.
    B5 = model.constants["FourierFeatures_0.B"]
    x5 = torch.rand((8192, 5), generator=gen, device=dev) * math.pi
    got = fourier_feats.fourier_features(x5, B5, True)
    ref = fourier_feats.fourier_features_plain(x5, B5, True)
    torch.cuda.synchronize()
    ff_err = float((got - ref).abs().max())
    ff_rel = ff_err / float(ref.abs().max())
    path = fourier_feats.launch_plan(8192, 5, 512, B5.data_ptr() % 16 == 0,
                                     fourier_feats._sm_count(x5.get_device()))[0]
    ff_ms = graph_ms(lambda: fourier_feats.fourier_features(x5, B5, True))
    ff_plain_ms = graph_ms(lambda: fourier_feats.fourier_features_plain(x5, B5, True))
    ffb = _ff_bound(8192, 5, 512)
    out["kernel2_edge"] = {"shape": [8192, 5, 512], "path": path, "max_abs_err": ff_err,
                           "rel_to_max": ff_rel, "ms": ff_ms, "plain_ms": ff_plain_ms,
                           "bound_ms": ffb[0], "bound_by": ffb[1]}
    print(f"[nd4] kernel 2 at (8192,5) x (5,512), path {path}: {ff_ms:.5f} ms, plain "
          f"{ff_plain_ms:.5f} ms, bound {ffb[0]:.5f} ms ({ffb[1]}); max_abs_err {ff_err:.3e} "
          f"(rel {ff_rel:.2e}) ({card})", flush=True)
    if not ff_rel < FF_TOL:
        raise AssertionError(f"kernel 2 at (8192, 5) disagrees with its plain version: {ff_rel}")
    del pde, model, got, ref

    # The basket at the shipped feedforward 128x7's full width, on the model
    # its card path trains (seed 0), at the sizes that path gives kernel 1:
    # its Adam batch and its validation points. S up to 200 on four axes:
    # the ill-conditioned float32 case of the feedforward trunk.
    cfg = basket_config("cuda")
    pde, model = create_pde(cfg), PINNModel(cfg, seed=0)
    out["basket_4"] = {}
    for n in sorted({cfg.training.batch_size, cfg.evaluation.num_points}):
        out["basket_4"][n] = kernel1_vs_f64_twins(
            dev, model, pde, gen, n, FUSED_TOLS["black_scholes_ff"],
            "[nd4] kernel 1 Black-Scholes basket_4 (feedforward 128x7)")[3]
    del pde, model

    # ---- the card paths, each with the counts set to 0 just before ------- #
    def run(cfg, label):
        tr = PDETrainer(PINNModel(cfg, seed=0), create_pde(cfg), cfg)
        fused_step.fused_residual_loss.launches = fourier_feats.fourier_features.launches = 0
        evals0 = LBFGS.evaluations
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = tr.train(seed=0)["history"]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {"fused_residual_loss": fused_step.fused_residual_loss.launches,
                  "fourier_features": fourier_feats.fourier_features.launches}
        t = cfg.training
        phase1 = (int(t.adam_lbfgs_switch_ratio * t.num_epochs) if t.optimizer == "adam_lbfgs"
                  else t.num_epochs)
        steps = phase1 * (t.num_collocation_points // t.batch_size)
        evals, vals = LBFGS.evaluations - evals0, len(hist["val_loss"])
        want = steps + evals + vals
        losses = hist["train_loss"] + hist["val_loss"]
        print(f"[nd4] {label}: {steps} Adam steps, {evals} L-BFGS evaluations, {vals} validations; "
              f"kernel 1 {counts['fused_residual_loss']} launches (want {want}), kernel 2 "
              f"{counts['fourier_features']}; epoch losses "
              f"{' '.join(f'{v:.6e}' for v in hist['train_loss'])}, validation "
              f"{' '.join(f'{v:.6e}' for v in hist['val_loss'])}; {wall:.2f} s ({card})", flush=True)
        if not (tr.fused_kernel_active and counts["fused_residual_loss"] == want > 0
                and all(map(math.isfinite, losses))):
            raise AssertionError(f"{label}: kernel 1 {counts}, want {want}; losses {losses}")
        return {"launches": counts, "adam_steps": steps, "lbfgs_evaluations": evals,
                "validations": vals, "train_loss": hist["train_loss"],
                "val_loss": hist["val_loss"], "wall_s": wall}

    out["runs"] = {"heat_4d": run(heat4d_config("cuda"), "heat-4D on the shipped Fourier 512x4, "
                                                        "adam_lbfgs"),
                   "basket_4": run(basket_config("cuda"), "Black-Scholes as shipped on a basket "
                                                          "of 4 assets")}
    heat = out["runs"]["heat_4d"]["launches"]
    # Kernel 2 on the heat path: the Dirichlet faces and the IC, twice per loss.
    if heat["fourier_features"] != 2 * heat["fused_residual_loss"]:
        raise AssertionError(f"heat-4D: kernel 2 {heat['fourier_features']} launches, want "
                             f"{2 * heat['fused_residual_loss']}")
    out["max_abs_err"] = max(v["max_abs_err"] for v in
                             (*out["parity"].values(), *out["heat_4d"].values(),
                              *out["basket_4"].values()))
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[nd4] phase 44: {out['seconds']:.1f} s ({card})", flush=True)
    return out


# Phase 45: kernel 1's generated residual (ops/kernels/residual_codegen.py):
# user PDEs that subclass shipped classes, registered with @register_pde
# (``register_user_pdes``). Fisher-KPP trained through PDETrainer on the
# Burgers recipe's full width (Fourier 256x3, mapping 128, Adam batches of
# 8192, then L-BFGS on all 40000 points): adam_lbfgs for GEN_EPOCHS epochs
# (2 of 4 Adam steps, then 2 L-BFGS iterations; a validation every 2).
# Fisher-KPP in two dimensions on heat_2d's trunk (its recipe, Fourier
# 256x3, mapping 128) for GEN_2D_EPOCHS Adam epochs. A first-order ODE (no
# x-group: the transport at D = 0, the input kernels at K = 0) trained the
# same way as Fisher-KPP on the Burgers recipe's width (``ode_config``).
# Parity against the plain twins run in float64 at N 8192 and 40000, the
# trainer's batches: the forced Burgers and Fisher-KPP on the Burgers
# recipe's width, plain and causal; the ODE on both trunks (that width, and
# the shipped feedforward 128x7 with LayerNorm); a steady problem (its
# t-stream unread) on the heat recipe's Fourier 256x3 (``GEN_FULL``). Small
# (64x48, mapping 32, N GEN_SMALL_N): the z-reading advection in one and
# four dimensions (d = 4: the *_nd transport), the ODE with a trainable
# basis and in four dimensions, and the steady problem.
GEN_EPOCHS = 4
GEN_2D_EPOCHS = 2
GEN_SMALL_N = 4096
GEN_SMALL = {"var_advection_1d": ("var_advection", "convection", 1, "fourier", False),
             "var_advection_4d": ("var_advection", "convection", 4, "fourier", False),
             "relaxation_fourier": ("relaxation", "pendulum", 1, "fourier", False),
             "relaxation_ff": ("relaxation", "pendulum", 1, "feedforward", False),
             "relaxation_basis": ("relaxation", "pendulum", 1, "fourier", True),
             "relaxation_4d": ("relaxation", "pendulum", 4, "feedforward", False),
             "relaxation_4d_basis": ("relaxation", "pendulum", 4, "fourier", True),
             "poisson": ("poisson", "heat", 1, "fourier", False)}
GEN_FULL = ("fisher_kpp", "forced_burgers", "relaxation_fourier_full", "relaxation_ff_full",
            "poisson_full", "clipped_allen_cahn", "select_burgers")
GEN_TOL = 1e-5  # the generated residual kernel alone against its float64 twin, rel to max
# Selects: the user PDEs whose residuals run selects, comparisons and clamps
# (``register_user_pdes``): Allen-Cahn with u clamped at +-10 on the
# allen_cahn recipe (its trunk, stationary interface, IC and BC), trained
# for GEN_EPOCHS and timed against the hand allen_cahn kernel; Burgers with
# selects that switch inside the network's range, on the Burgers recipe.
GEN_SELECTS = ("clipped_allen_cahn", "select_burgers")


def register_user_pdes():
    """Phase 45's user PDEs, each a subclass of a shipped class registered
    with ``@register_pde`` (the package's extension point): Fisher-KPP with
    the Ablowitz-Zeppetella traveling wave as its exact solution, IC and
    Dirichlet BC; an advection whose velocity sin(x) is read from z; Burgers
    with a forcing (``pde_type`` stays "burgers"); a first-order ODE; a
    steady problem; Allen-Cahn with u clamped at +-10; Burgers with
    selects, a piecewise viscosity and atan2, asinh, log10, erfc and
    softplus. Returns {name: class}."""
    import torch

    from pinnrl_tpu_torch.ops.derivatives import directional_derivative as dd
    from pinnrl_tpu_torch.ops.derivatives import laplacian
    from pinnrl_tpu_torch.pdes.allen_cahn import AllenCahnEquation
    from pinnrl_tpu_torch.pdes.base import PDE_CLASSES, register_pde
    from pinnrl_tpu_torch.pdes.burgers import BurgersEquation
    from pinnrl_tpu_torch.pdes.convection import ConvectionEquation
    from pinnrl_tpu_torch.pdes.heat import HeatEquation
    from pinnrl_tpu_torch.pdes.pendulum import PendulumEquation

    names = ("fisher_kpp", "var_advection", "forced_burgers", "relaxation", "poisson",
             *GEN_SELECTS)
    if all(n in PDE_CLASSES for n in names):
        return {n: PDE_CLASSES[n] for n in names}

    @register_pde
    class FisherKPP(BurgersEquation):
        """u_t - D lap u - rho u (1 - u); exact: (1 + exp(a x_0 - 5 rho t / 6))^-2,
        a = sqrt(rho / (6 D))."""

        pde_type = "fisher_kpp"
        default_parameters = {"diffusion": 0.1, "rho": 1.0}

        def residual_pointwise(self, u, z, coeffs):
            val = u(z)
            lap = 0.0
            for ax in range(self.dimension):
                lap = lap + dd(u, z, ax, 2)[1]
            D, rho = self.parameters["diffusion"], self.parameters["rho"]
            return dd(u, z, self.dimension, 1)[0] - D * lap - rho * val * (1.0 - val)

        def exact_solution(self, x, t, coeffs=None):
            D, rho = self.parameters["diffusion"], self.parameters["rho"]
            a = math.sqrt(rho / (6.0 * D))
            return (1.0 + torch.exp(a * x[:, 0:1] - (5.0 * rho / 6.0) * t)) ** -2

        def _create_initial_condition(self, params):
            return lambda x, t: self.exact_solution(x, torch.zeros_like(x[:, 0:1]))

        def _create_boundary_condition(self, bc_type, params):
            if bc_type == "initial":
                return self._create_initial_condition(params)
            return lambda x, t: self.exact_solution(x, t)

    @register_pde
    class VarAdvection(ConvectionEquation):
        """u_t + sum_ax sin(x_ax) u_ax."""

        pde_type = "var_advection"

        def residual_pointwise(self, u, z, coeffs):
            r = dd(u, z, self.dimension, 1)[0]
            for ax in range(self.dimension):
                r = r + torch.sin(z[:, ax]) * dd(u, z, ax, 1)[0]
            return r

    class ForcedBurgers(BurgersEquation):
        """Burgers' residual minus sin(x_0); pde_type stays "burgers"."""

        def residual_pointwise(self, u, z, coeffs):
            return super().residual_pointwise(u, z, coeffs) - torch.sin(z[:, 0])

    PDE_CLASSES["forced_burgers"] = ForcedBurgers

    @register_pde
    class Relaxation(PendulumEquation):
        """u_t + 0.5 tanh(u) + 0.2 sigmoid(u) - 0.1: first order, no x-group."""

        pde_type = "relaxation"
        temporal_orders = (1,)

        def residual_pointwise(self, u, z, coeffs):
            val = u(z)
            return dd(u, z, self.dimension, 1)[0] + 0.5 * torch.tanh(val) + 0.2 * torch.sigmoid(val) - 0.1

    @register_pde
    class Poisson(HeatEquation):
        """lap u + sin(x_0) exp(-u^2): temporal order 0."""

        pde_type = "poisson"
        temporal_orders = ()

        def residual_pointwise(self, u, z, coeffs):
            val = u(z)
            lap = 0.0
            for ax in range(self.dimension):
                lap = lap + dd(u, z, ax, 2)[1]
            return lap + torch.sin(z[:, 0]) * torch.exp(-val * val)

    @register_pde
    class ClippedAllenCahn(AllenCahnEquation):
        """u_t - eps^2 lap u - u + clamp(u, -10, 10)^3, as the reference's
        Cahn-Hilliard clips u (pinnrl_tpu/pdes/cahn_hilliard.py:79)."""

        pde_type = "clipped_allen_cahn"

        def residual_pointwise(self, u, z, coeffs):
            val = u(z)
            lap = laplacian(u, z, range(self.dimension))
            return (dd(u, z, self.dimension, 1)[0] - self._eps(coeffs) ** 2 * lap - val
                    + torch.clamp(val, -10.0, 10.0) ** 3)

    @register_pde
    class SelectBurgers(BurgersEquation):
        """Burgers' residual + 0.1 (clamp(u, -.5, .5) + where(u > 0, u, 0)
        + maximum(u, .2) + minimum(u, -.2) + relu(u - .3)) - where(x_0 > 0,
        .01/pi, .02/pi) u_x0x0 + 0.01 (atan2(u, 1 + u^2) + asinh(u)
        + log10(1 + u^2) + erfc(u) + softplus(u))."""

        pde_type = "select_burgers"

        def residual_pointwise(self, u, z, coeffs):
            val = u(z)
            selects = (torch.clamp(val, -0.5, 0.5) + torch.where(val > 0, val, 0.0)
                       + torch.maximum(val, torch.full_like(val, 0.2))
                       + torch.minimum(val, torch.full_like(val, -0.2)) + torch.relu(val - 0.3))
            nu_x = torch.where(z[:, 0] > 0, 0.01 / math.pi, 0.02 / math.pi)
            smooth = (torch.atan2(val, 1.0 + val * val) + torch.asinh(val)
                      + torch.log10(1.0 + val * val) + torch.erfc(val)
                      + torch.nn.functional.softplus(val))
            return (super().residual_pointwise(u, z, coeffs) + 0.1 * selects
                    - nu_x * dd(u, z, 0, 2)[1] + 0.01 * smooth)

    return {n: PDE_CLASSES[n] for n in names}


def clipped_ac_config(device: str):
    """The allen_cahn recipe (Fourier 256x3, mapping 128, scale 2; Adam on
    batches of 8192 of 40000 points, then L-BFGS on all of them; the
    stationary interface, its IC and Dirichlet BC) cut to GEN_EPOCHS epochs
    with a validation every 2, its residual clamped (``clipped_allen_cahn``)."""
    from pinnrl_tpu_torch.benchmarks.convergence import build_recipe_config

    cfg = build_recipe_config("allen_cahn", epochs=GEN_EPOCHS, device=device)
    cfg.pde_type = "clipped_allen_cahn"
    cfg.training.validation_frequency = 2
    return cfg


def fisher_config(device: str, dim: int = 1):
    """Fisher-KPP (D 0.1, rho 1) on [-4, 4]^d x [0, 2]: in one dimension the
    Burgers recipe's full width, adam_lbfgs (Adam on batches of 8192, then
    L-BFGS on all 40000 points); in two, heat_2d's recipe (its trunk, Adam
    only)."""
    from pinnrl_tpu_torch.benchmarks.convergence import build_recipe_config

    if dim == 1:
        cfg = burgers_recipe_config(device)
        t = cfg.training
        t.optimizer, t.num_epochs, t.validation_frequency = "adam_lbfgs", GEN_EPOCHS, 2
    else:
        cfg = build_recipe_config("heat_2d", epochs=GEN_2D_EPOCHS, device=device)
        cfg.training.optimizer = "adam"
        cfg.pde.boundary_conditions = {"dirichlet": {}}
    cfg.pde_type = "fisher_kpp"
    cfg.pde.domain = [[-4.0, 4.0]] * dim
    cfg.pde.time_domain = [0.0, 2.0]
    return cfg


def ode_config(device: str, arch: str = "fourier"):
    """The relaxation ODE on the pendulum block: on the Burgers recipe's
    Fourier 256x3 (mapping 128, scale 2) or the shipped feedforward 128x7
    with LayerNorm, trained as ``fisher_config`` trains Fisher-KPP (Adam on
    batches of 8192 of 40000 points, then L-BFGS on all of them)."""
    from pinnrl_tpu_torch.config import load_config

    recipe = fisher_config(device)
    cfg = load_config(pde_type="pendulum", architecture=arch, device=device)
    cfg.pde_type = "relaxation"
    if arch == "fourier":
        cfg.model.hidden_dims = list(recipe.model.hidden_dims)
        cfg.model.arch_params.update({k: recipe.model.arch_params[k]
                                      for k in ("mapping_size", "scale")})
    cfg.training = recipe.training
    return cfg


def gen_full_config(name: str, device: str):
    """The configuration of a full-width phase-45 parity case (``GEN_FULL``)."""
    from pinnrl_tpu_torch.benchmarks.convergence import build_recipe_config

    if name == "fisher_kpp":
        return fisher_config(device)
    if name in ("forced_burgers", "select_burgers"):
        cfg = burgers_recipe_config(device)
        cfg.pde_type = name
        return cfg
    if name == "clipped_allen_cahn":
        return clipped_ac_config(device)
    if name.startswith("relaxation"):
        return ode_config(device, "fourier" if name == "relaxation_fourier_full" else "feedforward")
    cfg = build_recipe_config("heat", device=device)
    cfg.pde_type = "poisson"
    return cfg


def gen_small_config(case: str, device: str):
    """The configuration of a small phase-45 case (``GEN_SMALL``)."""
    from pinnrl_tpu_torch.config import load_config

    pde_type, block, dim, arch, basis = GEN_SMALL[case]
    cfg = load_config(pde_type=block, architecture=arch, device=device)
    cfg.pde_type = pde_type
    cfg.pde.dimension, cfg.model.input_dim = dim, dim + 1
    cfg.pde.domain = [list(cfg.pde.domain[0])] * dim
    cfg.model.hidden_dims = [64, 48]
    cfg.model.arch_params["mapping_size"] = 32
    if basis:
        cfg.model.arch_params["trainable_features"] = True
    return cfg


def _gen_ptxas(name: str):
    """(registers, spill bytes) of the generated kernel in library ``name``."""
    from pinnrl_tpu_torch.ops.kernels import _build

    rows = [(regs, st + ld) for entry, regs, _smem, st, ld, _stack
            in ptxas_report(_build.BUILD_LOG.get(name, "")) if "generated_residual_kernel" in entry]
    if len(rows) != 1:
        raise AssertionError(f"{name}: generated_residual_kernel missing from the build log")
    return rows[0]


def _residual_bound(program, n: int):
    """(ms, what bounds it) of one generated residual call: U read and dU
    written ((S n) floats each), the z columns it reads, out written; one
    operation per table op per point."""
    live = program._live()
    cols = sum(1 for k in live if program.instrs[k][0] == "z")
    ops = sum(1 for k in live if program.instrs[k][0] not in ("u", "z", "const"))
    return bound(float(ops * n), 4.0 * (2 * program.n_streams * n + cols * n + n))


def select_runs(dev, card: str, models, specs, ptx, burgers_gen, burgers_hand):
    """Phase 45's checks of the two select programs (``GEN_SELECTS``),
    built in the phase's one parallel nvcc build: NaN parity of the select
    Burgers kernel alone against its twin; the clamped Allen-Cahn's kernel-1
    call against the hand allen_cahn call and the select Burgers residual
    alone against the Burgers one (its launch floor), each in turns."""
    import torch

    from pinnrl_tpu_torch.ops.jet_mlp import make_bundle_fn
    from pinnrl_tpu_torch.ops.kernels import fused_step, residual_codegen
    from pinnrl_tpu_torch.pdes import create_pde

    gen = torch.Generator(device=dev).manual_seed(21)
    cuda_ops, plain_ops = fused_step._cuda_ops(dev), fused_step._TorchOps()
    out = {"ptxas": {k: ptx[k] for k in GEN_SELECTS}}
    print(f"[k1i] select programs: {out['ptxas']} ({card})", flush=True)

    # ---- NaN parity: the select Burgers kernel alone -------------------------- #
    program = specs["select_burgers"].program
    n = 8192
    U = torch.randn((program.n_streams, n), generator=gen, device=dev)
    U[:, 0], U[:, 1], U[:, 2] = math.nan, math.inf, -math.inf  # every stream of three points
    U[0, 3], U[0, 4], U[0, 5] = math.nan, math.inf, -math.inf  # u alone at three more
    U = U.reshape(-1, 1)
    z = torch.rand((n, 2), generator=gen, device=dev) * 2.0 - 1.0
    out["nan_parity"] = {}
    for causal in (False, True):
        kd, ko = residual_codegen.launch(program, U, z, n, causal)
        td, to = plain_ops.generated(program, U, z, n, causal)
        d64, o64 = plain_ops.generated(program, U.double(), z.double(), n, causal)
        torch.cuda.synchronize()
        worst = 0.0
        for k, t in ((kd, d64), (ko, o64)):
            fin = torch.isfinite(t) & torch.isfinite(k)
            worst = max(worst, float((k.double() - t)[fin].abs().max() / t[fin].abs().max()))
        row = {"nan_out": int(ko.isnan().sum()), "nan_dU": int(kd.isnan().sum()),
               "inf_out": int(ko.isinf().sum()), "inf_dU": int(kd.isinf().sum()),
               "same_nan": torch.equal(ko.isnan(), to.isnan()) and torch.equal(kd.isnan(), td.isnan()),
               "same_inf": torch.equal(ko.isinf(), to.isinf()) and torch.equal(kd.isinf(), td.isinf()),
               "same_nan_f64": (torch.equal(ko.isnan(), o64.isnan())
                                and torch.equal(kd.isnan(), d64.isnan())),
               "finite_rel_to_max_f64": worst}
        out["nan_parity"]["causal" if causal else "plain"] = row
        print(f"[k1i] select Burgers kernel alone on NaN and +-inf points, "
              f"{'causal' if causal else 'plain'}: {row} ({card})", flush=True)
        if not (row["same_nan"] and row["same_inf"] and row["nan_out"] and worst < GEN_TOL):
            raise AssertionError(f"the select kernel's NaNs or infinities differ from its twin's: "
                                 f"{row}")

    # ---- the clamped Allen-Cahn call against the hand allen_cahn call -------- #
    model, pde = models["clipped_allen_cahn"]
    gen_spec = specs["clipped_allen_cahn"]
    hand_cfg = clipped_ac_config("cuda")
    hand_cfg.pde_type = "allen_cahn"
    hand_spec = fused_step._spec(model, create_pde(hand_cfg))
    if hand_spec.residual != "allen_cahn":
        raise AssertionError(f"Allen-Cahn as shipped took {hand_spec.residual}")
    bundle_fn = make_bundle_fn(model, 1, 2, 1)
    P = {k: v.detach() for k, v in model.params.items()}
    out["allen_cahn_ab"] = {}
    for n in (8192, LBFGS_N):
        small = n == 8192
        z = time_sorted(*pde.generate_collocation_points(gen, n, "uniform"))
        lh, gh = fused_step._loss_and_grads(cuda_ops, hand_spec, z, P)
        lg, gg = fused_step._loss_and_grads(cuda_ops, gen_spec, z, P)
        torch.cuda.synchronize()
        diff = max(abs(float(lh) - float(lg)), *(float((gh[k] - gg[k]).abs().max()) for k in gh))
        ms = {"hand": [], "generated": []}
        for which in ("hand", "generated", "generated", "hand"):
            spec = hand_spec if which == "hand" else gen_spec
            ms[which].append(graph_ms(lambda: fused_step._loss_and_grads(cuda_ops, spec, z, P),
                                      iters=10 if small else 3, replays=5 if small else 3))
        p_leaf = {k: v.clone().requires_grad_(True) for k, v in P.items()}
        plain_ms = graph_ms(lambda: torch.autograd.grad(
            fused_step.fused_residual_loss_plain(bundle_fn, pde, p_leaf, z),
            list(p_leaf.values())), iters=3 if small else 2, replays=3)
        del p_leaf
        torch.cuda.empty_cache()
        kb = kernel1_bound(P, 2, z, hand_spec.B)
        row = {"ms": statistics.mean(ms["generated"]), "hand_ms": statistics.mean(ms["hand"]),
               "ms_turns": ms, "plain_ms": plain_ms, "bound_ms": kb[0], "bound_by": kb[1],
               "library_ms": None, "hand_vs_generated_max_abs_diff": diff}
        out["allen_cahn_ab"][n] = row
        print(f"[k1i] allen_cahn recipe (Fourier 256x3) N={n}: kernel 1 with the clamped "
              f"generated residual {row['ms']:.4f} ms, with the hand allen_cahn residual "
              f"{row['hand_ms']:.4f} ms (turns {ms}), plain {plain_ms:.4f} ms, bound "
              f"{kb[0]:.4f} ms ({kb[1]}); hand vs generated max |diff| {diff:.3e} ({card})",
              flush=True)

    # ---- the select Burgers residual alone against the Burgers one ----------- #
    out["select_alone"] = {}
    for n in (8192, LBFGS_N):
        U = torch.randn((program.n_streams * n, 1), generator=gen, device=dev)
        z = torch.rand((n, 2), generator=gen, device=dev) * 2.0 - 1.0
        alone = {"select": [], "burgers_generated": [], "burgers_kernel": []}
        for which in ("select", "burgers_generated", "burgers_kernel", "burgers_kernel",
                      "burgers_generated", "select"):
            fn = {"select": lambda: residual_codegen.launch(program, U, z, n, False),
                  "burgers_generated": lambda: residual_codegen.launch(burgers_gen.program, U, z,
                                                                       n, False),
                  "burgers_kernel": lambda: cuda_ops.burgers(U, n, 1, burgers_hand.nu, False)}[which]
            alone[which].append(graph_ms(fn, iters=50, replays=10))
        twin_ms = graph_ms(lambda: plain_ops.generated(program, U, z, n, False), iters=20,
                           replays=5)
        rb = _residual_bound(program, n)
        row = {"ms": statistics.mean(alone["select"]),
               "burgers_generated_ms": statistics.mean(alone["burgers_generated"]),
               "burgers_kernel_ms": statistics.mean(alone["burgers_kernel"]), "turns": alone,
               "plain_ms": twin_ms, "bound_ms": rb[0], "bound_by": rb[1], "library_ms": None}
        out["select_alone"][n] = row
        print(f"[k1i] the select Burgers residual kernel alone N={n}: {row['ms']:.5f} ms; the "
              f"Burgers generated residual {row['burgers_generated_ms']:.5f} ms and "
              f"burgers_kernel {row['burgers_kernel_ms']:.5f} ms in the same turns (the launch "
              f"floor); twin {twin_ms:.5f} ms, bound {rb[0]:.6f} ms ({rb[1]}) ({card})",
              flush=True)
    return out


def gen_runs(dev, card: str):
    """Phase 45: kernel 1's generated residual (see the module docstring)."""
    import dataclasses

    import torch

    from pinnrl_tpu_torch.models import PINNModel
    from pinnrl_tpu_torch.ops.jet_mlp import make_bundle_fn
    from pinnrl_tpu_torch.ops.kernels import _build, fourier_feats, fused_step, residual_codegen
    from pinnrl_tpu_torch.pdes import create_pde
    from pinnrl_tpu_torch.training import PDETrainer
    from pinnrl_tpu_torch.training.lbfgs import LBFGS

    t_phase = time.perf_counter()
    # Phases 1-44 ran the six shipped PDEs: their hand residuals, never a generated one.
    earlier = residual_codegen.launch.launches
    if earlier:
        raise AssertionError(f"the generated residual launched {earlier} times before phase 45")
    register_user_pdes()
    out = {"earlier_generated_launches": earlier}

    # ---- the programs, built with one nvcc each, all started together ---- #
    burgers_cfg = burgers_recipe_config("cuda")
    burgers_pde, burgers_model = create_pde(burgers_cfg), PINNModel(burgers_cfg, seed=0)
    hand_spec = fused_step._spec(burgers_model, burgers_pde)
    if hand_spec.residual != "burgers":
        raise AssertionError(f"Burgers as shipped took {hand_spec.residual}, not its hand kernel")
    gen_spec = dataclasses.replace(hand_spec, residual="generated",
                                   program=residual_codegen.trace(burgers_pde, 2, dev))
    models = {"burgers_generated": (burgers_model, burgers_pde)}
    for name in GEN_FULL:
        cfg = gen_full_config(name, "cuda")
        models[name] = (PINNModel(cfg, seed=0), create_pde(cfg))
    cfg = fisher_config("cuda", 2)
    models["fisher_kpp_2d"] = (PINNModel(cfg, seed=0), create_pde(cfg))
    for case in GEN_SMALL:
        cfg = gen_small_config(case, "cuda")
        models[case] = (PINNModel(cfg, seed=0), create_pde(cfg))
    specs = {"burgers_generated": gen_spec}
    for name, (model, pde) in models.items():
        if name != "burgers_generated":
            if not fused_step.supports(model, pde):
                raise AssertionError(f"{name}: kernel 1 refuses it: "
                                     f"{fused_step.refusal(model, pde)}")
            specs[name] = fused_step._spec(model, pde)
        if specs[name].residual != "generated":
            raise AssertionError(f"{name}: took the hand residual {specs[name].residual}")
    programs = {}
    for name, spec in specs.items():
        programs.setdefault(spec.program.digest, (name, spec.program))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(programs)) as pool:
        libs = dict(zip(programs, pool.map(lambda p: residual_codegen.library(p[1])[0],
                                           programs.values())))
    build_s = time.perf_counter() - t0
    ptx = {}
    for digest, (name, program) in programs.items():
        regs, spill = _gen_ptxas(libs[digest])
        ptx[name] = {"library": libs[digest], "registers": regs, "spill_bytes": spill,
                     "streams": program.n_streams, "ops": program.ops,
                     "build_s": _build.BUILD_SECONDS[libs[digest]]}
    print(f"[generated] {len(programs)} generated residual kernels built in {build_s:.2f} s "
          f"(one nvcc each, in parallel); ptxas (registers, spill bytes) per program: "
          f"{ {k: (v['registers'], v['spill_bytes']) for k, v in ptx.items()} } ({card})",
          flush=True)
    if any(v["spill_bytes"] for v in ptx.values()):
        raise AssertionError(f"a generated residual kernel spills: {ptx}")
    out.update(build_s=build_s, ptxas=ptx)

    # ---- each generated kernel alone against its float64 twin ------------ #
    gen = torch.Generator(device=dev).manual_seed(45)
    cuda_ops, plain_ops = fused_step._cuda_ops(dev), fused_step._TorchOps()
    out["residual_alone"] = {}
    for digest, (name, program) in programs.items():
        n = 8192
        d = program.n_cols - 1
        U = torch.randn((program.n_streams * n, 1), generator=gen, device=dev)
        z = torch.rand((n, d + 1), generator=gen, device=dev) * 2.0
        worst, same = 0.0, True
        for causal in (False, True):
            a = residual_codegen.launch(program, U, z, n, causal)
            b = residual_codegen.launch(program, U, z, n, causal)
            ref = plain_ops.generated(program, U.double(), z.double(), n, causal)
            torch.cuda.synchronize()
            same = same and all(torch.equal(x, y) for x, y in zip(a, b))
            for x, r in zip(a, ref):
                worst = max(worst, float((x.double() - r).abs().max() / r.abs().max()))
        out["residual_alone"][name] = {"rel_to_max": worst, "bit_identical": same}
        if not (worst < GEN_TOL and same):
            raise AssertionError(f"{name}: the generated residual kernel disagrees with its "
                                 f"float64 twin ({worst}) or is not deterministic ({same})")
    alone_txt = ", ".join(f"{k} {v['rel_to_max']:.2e} {v['bit_identical']}"
                          for k, v in out["residual_alone"].items())
    print(f"[generated] each generated residual kernel alone (N 8192, plain and causal) against "
          f"its float64 twin, rel to max (tol {GEN_TOL:g}), bit-identical in two calls: "
          f"{alone_txt} ({card})", flush=True)

    # ---- kernel 1 through each generated residual, against the float64 twins -- #
    out["parity"] = {}
    for name, (model, pde) in models.items():
        if name == "burgers_generated":
            continue
        sizes = (8192, LBFGS_N) if name in GEN_FULL else (GEN_SMALL_N,)
        for causal in ((False, True) if name in ("fisher_kpp", "select_burgers") else (False,)):
            pde.training.causal_eps = 1.0 if causal else 0.0
            tols = FUSED_TOLS["burgers_causal" if causal else "burgers"]
            for n in sizes:
                out["parity"][f"{name}{'_causal' if causal else ''}_{n}"] = kernel1_vs_f64_twins(
                    dev, model, pde, gen, n, tols,
                    f"[generated] kernel 1 {name}{' causal' if causal else ''}")[3]
            pde.training.causal_eps = 0.0

    # ---- Burgers: the generated residual against burgers_kernel, timed ---- #
    # Kernel 1 by CUDA-graph replay with each residual (in turns: hand,
    # generated, generated, hand), each residual kernel alone, the plain
    # version (bundle -> residual -> autograd) and the residual's twin.
    bundle_fn = make_bundle_fn(burgers_model, 1, 2, 1)
    P = {k: v.detach() for k, v in burgers_model.params.items()}
    out["burgers_ab"] = {}
    for n in (8192, LBFGS_N):
        small = n == 8192
        z = time_sorted(*burgers_pde.generate_collocation_points(gen, n, "uniform"))
        lh, gh = fused_step._loss_and_grads(cuda_ops, hand_spec, z, P)
        lg, gg = fused_step._loss_and_grads(cuda_ops, gen_spec, z, P)
        torch.cuda.synchronize()
        diff = max(abs(float(lh) - float(lg)), *(float((gh[k] - gg[k]).abs().max()) for k in gh))
        ms = {"hand": [], "generated": []}
        for which in ("hand", "generated", "generated", "hand"):
            spec = hand_spec if which == "hand" else gen_spec
            ms[which].append(graph_ms(lambda: fused_step._loss_and_grads(cuda_ops, spec, z, P),
                                      iters=10 if small else 3, replays=5 if small else 3))
        p_leaf = {k: v.clone().requires_grad_(True) for k, v in P.items()}
        plain_ms = graph_ms(lambda: torch.autograd.grad(
            fused_step.fused_residual_loss_plain(bundle_fn, burgers_pde, p_leaf, z),
            list(p_leaf.values())), iters=3 if small else 2, replays=3)
        del p_leaf
        torch.cuda.empty_cache()
        U = torch.randn((4 * n, 1), generator=gen, device=dev)
        program = gen_spec.program
        alone = {"hand": [], "generated": []}
        for which in ("hand", "generated", "generated", "hand"):
            fn = ((lambda: cuda_ops.burgers(U, n, 1, hand_spec.nu, False)) if which == "hand"
                  else (lambda: residual_codegen.launch(program, U, z, n, False)))
            alone[which].append(graph_ms(fn, iters=50, replays=10))
        twin_ms = graph_ms(lambda: plain_ops.generated(program, U, z, n, False), iters=20,
                           replays=5)
        kb = kernel1_bound(P, 2, z, hand_spec.B)
        rb = _residual_bound(program, n)
        row = {"ms": statistics.mean(ms["generated"]), "hand_ms": statistics.mean(ms["hand"]),
               "ms_turns": ms, "plain_ms": plain_ms, "bound_ms": kb[0], "bound_by": kb[1],
               "hand_vs_generated_max_abs_diff": diff,
               "residual_ms": statistics.mean(alone["generated"]),
               "residual_hand_ms": statistics.mean(alone["hand"]), "residual_turns": alone,
               "residual_plain_ms": twin_ms, "residual_bound_ms": rb[0],
               "residual_bound_by": rb[1], "residual_library_ms": None}
        out["burgers_ab"][n] = row
        print(f"[generated] Burgers recipe (Fourier 256x3) N={n}: kernel 1 with the generated "
              f"residual {row['ms']:.4f} ms, with burgers_kernel {row['hand_ms']:.4f} ms (turns "
              f"{ms}), plain {plain_ms:.4f} ms, bound {kb[0]:.4f} ms ({kb[1]}); hand vs generated "
              f"max |diff| {diff:.3e}; the residual alone: generated {row['residual_ms']:.5f} ms, "
              f"burgers_kernel {row['residual_hand_ms']:.5f} ms, twin {twin_ms:.5f} ms, bound "
              f"{rb[0]:.6f} ms ({rb[1]}) ({card})", flush=True)
    # Fisher-KPP's generated residual alone at the trainer's batches.
    program = specs["fisher_kpp"].program
    out["fisher_residual"] = {}
    for n in (8192, LBFGS_N):
        U = torch.randn((program.n_streams * n, 1), generator=gen, device=dev)
        z = torch.rand((n, 2), generator=gen, device=dev)
        r_ms = graph_ms(lambda: residual_codegen.launch(program, U, z, n, False))
        r_twin = graph_ms(lambda: plain_ops.generated(program, U, z, n, False), iters=20,
                          replays=5)
        rb = _residual_bound(program, n)
        out["fisher_residual"][n] = {"ms": r_ms, "plain_ms": r_twin, "bound_ms": rb[0],
                                     "bound_by": rb[1], "library_ms": None}
        print(f"[generated] Fisher-KPP's residual kernel alone N={n}: {r_ms:.5f} ms, twin "
              f"{r_twin:.5f} ms, bound {rb[0]:.6f} ms ({rb[1]}) ({card})", flush=True)
    out["k1i"] = select_runs(dev, card, models, specs, ptx, gen_spec, hand_spec)

    # ---- the card paths, each with the counts set to 0 just before ------- #
    def run(cfg, label, falls: bool):
        tr = PDETrainer(PINNModel(cfg, seed=0), create_pde(cfg), cfg)
        fused_step.fused_residual_loss.launches = fourier_feats.fourier_features.launches = 0
        residual_codegen.launch.launches = 0
        evals0 = LBFGS.evaluations
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = tr.train(seed=0)["history"]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {"fused_residual_loss": fused_step.fused_residual_loss.launches,
                  "generated_residual": residual_codegen.launch.launches,
                  "fourier_features": fourier_feats.fourier_features.launches}
        t = cfg.training
        phase1 = (int(t.adam_lbfgs_switch_ratio * t.num_epochs) if t.optimizer == "adam_lbfgs"
                  else t.num_epochs)
        steps = phase1 * (t.num_collocation_points // t.batch_size)
        evals, vals = LBFGS.evaluations - evals0, len(hist["val_loss"])
        want = steps + evals + vals
        losses = hist["train_loss"] + hist["val_loss"]
        print(f"[generated] {label}: {steps} Adam steps, {evals} L-BFGS evaluations, {vals} "
              f"validations; kernel 1 {counts['fused_residual_loss']} launches (want {want}), the "
              f"generated residual {counts['generated_residual']}, kernel 2 "
              f"{counts['fourier_features']}; epoch losses "
              f"{' '.join(f'{v:.6e}' for v in hist['train_loss'])}, validation "
              f"{' '.join(f'{v:.6e}' for v in hist['val_loss'])}; {wall:.2f} s ({card})", flush=True)
        ok = (tr.fused_kernel_active and counts["fused_residual_loss"] == want > 0
              and counts["generated_residual"] == want and all(map(math.isfinite, losses)))
        if falls:
            ok = ok and hist["train_loss"][-1] < hist["train_loss"][0]
        if not ok:
            raise AssertionError(f"{label}: kernel 1 {counts}, want {want}; losses {losses}")
        return {"launches": counts, "adam_steps": steps, "lbfgs_evaluations": evals,
                "validations": vals, "train_loss": hist["train_loss"],
                "val_loss": hist["val_loss"], "wall_s": wall}

    out["runs"] = {
        "fisher_kpp": run(fisher_config("cuda"), "Fisher-KPP on the Burgers recipe's Fourier "
                                                 "256x3, adam_lbfgs", True),
        "fisher_kpp_2d": run(fisher_config("cuda", 2), "Fisher-KPP in two dimensions on "
                                                       "heat_2d's Fourier 256x3", False),
        "relaxation": run(ode_config("cuda"), "the relaxation ODE (no x-group) on the Burgers "
                                              "recipe's Fourier 256x3, adam_lbfgs", True),
        "clipped_allen_cahn": run(clipped_ac_config("cuda"), "Allen-Cahn clamped at +-10 on the "
                                  "allen_cahn recipe's Fourier 256x3, adam_lbfgs", True)}
    out["k1i"]["run"] = out["runs"]["clipped_allen_cahn"]
    out["launches"] = out["runs"]["fisher_kpp"]["launches"]["fused_residual_loss"]
    out["max_abs_err"] = max(v["max_abs_err"] for v in out["parity"].values())
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[generated] phase 45: {out['seconds']:.1f} s ({card})", flush=True)
    return out


# Phase 46: every Adam phase replays one captured CUDA graph of its step
# (training/step_program.py). The Burgers recipe with RAR: 2 chunks of 5
# epochs (40 Adam steps); the other cases 2 chunks of 2 epochs.
GRAPH_EPOCHS, GRAPH_CHUNK = 10, 5
GRAPH_CUT_EPOCHS = 4
GRAPH_TIMED, GRAPH_ROUNDS = 20, 3   # steps per side per round, rounds in turns
GRAPH_CASES = ("rar", "rl", "ensemble", "levers", "siren", "generated")
TRACE_MARGIN_S = 0.5  # idle host time at each end of a counted trace
# Launches a trace may lose (at least; 2% of the count above 100): late in a
# long process the profiler dropped one kernel event from a run now and
# then (phase 46: one of 16 scorer launches in both RL runs, one of 18
# kernel-1 launches in the eager E = 4 run), while the wrappers' counters
# and the runs' bits agreed.
TRACE_LOSS = 2


def trace_agrees(trace: int, counted: int) -> bool:
    """Whether a kernel's launches found in a profiler trace witness its
    counter: never more, and fewer by at most the events a trace loses."""
    return counted - max(TRACE_LOSS, counted // 50) <= trace <= counted
# A device kernel that runs once per launch of each wrapper: phase 46 counts
# them by name in a profiler trace of each run.
GRAPH_KERNELS = {
    "fused_residual_loss": re.compile(r"(?<![A-Za-z0-9_])((burgers|heat|kdv|convection|allen_cahn|"
                                      r"black_scholes)(_nd)?|generated_residual)_kernel\b"),
    "generated_residual": re.compile(r"(?<![A-Za-z0-9_])generated_residual_kernel\b"),
    "fourier_features": re.compile(r"(?<![A-Za-z0-9_])fourier_features_kernel\b"),
    "siren_layer": re.compile(r"(?<![A-Za-z0-9_])siren_sm90_kernel\b"),
    "fused_mlp_score": re.compile(r"(?<![A-Za-z0-9_])ln_relu_head_kernel\b"),
}


def graph_config(case: str, device: str):
    """Phase 46's cases: the Burgers recipe at full width with RAR (``rar``),
    uniform with the DQN agent (``rl``), 4 members (``ensemble``), the
    plateau at patience 1 with EMA 0.99 and LRW (``levers``), KdV on a
    SIREN 124x3 (``siren``), and Fisher-KPP through kernel 1's generated
    residual on the same trunk, Adam only (``generated``)."""
    if case == "siren":
        cfg = siren_kdv_config(device)
        cfg.model.hidden_dims = [124] * 3
        cfg.training.num_epochs, cfg.training.validation_frequency = 2, 1
        return cfg
    cfg = fisher_config(device) if case == "generated" else burgers_recipe_config(device)
    cfg.training.optimizer = "adam"
    t = cfg.training
    t.num_epochs, t.validation_frequency = GRAPH_CUT_EPOCHS, GRAPH_CUT_EPOCHS // 2
    if case == "rar":
        t.num_epochs, t.validation_frequency = GRAPH_EPOCHS, GRAPH_CHUNK
        t.collocation_distribution = "residual_based"
    elif case == "rl":
        cfg.rl.enabled = True
    elif case == "ensemble":
        t.ensemble_size, t.scheduler_type = 4, "cosine"
    elif case == "levers":
        t.scheduler_type, t.lr_scheduler.patience = "reduce_lr", 1
        t.optimizer_config.learning_rate = 1e-2
        t.param_ema = 0.99
        t.adaptive_weights.enabled, t.adaptive_weights.strategy = True, "lrw"
    return cfg


def graph_trainer(case: str):
    from pinnrl_tpu_torch.models import PINNModel
    from pinnrl_tpu_torch.pdes import create_pde
    from pinnrl_tpu_torch.training import PDETrainer
    from pinnrl_tpu_torch.training.train import make_agent

    if case == "generated":
        register_user_pdes()  # Fisher-KPP
    cfg = graph_config(case, "cuda")
    return PDETrainer(PINNModel(cfg, seed=0), create_pde(cfg), cfg,
                      rl_agent=make_agent(cfg) if cfg.rl.enabled else None)


@contextlib.contextmanager
def eager_steps():
    """The step program never leaves its warm-up: every step of a run in
    this block is eager (on the warm-up's stream, with the same capturable
    Adam), the graph runs' reference."""
    from pinnrl_tpu_torch.training import step_program

    warm, step_program.WARMUP_STEPS = step_program.WARMUP_STEPS, sys.maxsize
    try:
        yield
    finally:
        step_program.WARMUP_STEPS = warm


def device_launches(fn, names_into=None):
    """Run ``fn`` under ``torch.profiler`` (device activity only); return
    its result, the device launches of each kernel of ``GRAPH_KERNELS`` by
    name, and all the device kernels it ran (``names_into``, a dict, takes
    the launches of every kernel name)."""
    import tempfile
    from pathlib import Path

    import torch
    from torch.profiler import ProfilerActivity, profile

    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            # Margins at both ends: a kernel launched just after the start
            # went missing from the trace late in a long process (phase 46's
            # RL case, one of its 16 scorer launches, in the eager run and
            # the graph run alike), as if the trace's mapping of the card's
            # clock onto the host's had put it outside the window.
            torch.cuda.synchronize()
            time.sleep(TRACE_MARGIN_S)
            out = fn()
            torch.cuda.synchronize()
            time.sleep(TRACE_MARGIN_S)
        trace = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
    names = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            names[e["name"]] = names.get(e["name"], 0) + 1
    found = {k: sum(n for name, n in names.items() if rx.search(name))
             for k, rx in GRAPH_KERNELS.items()}
    if names_into is not None:
        names_into.update(names)
    return out, found, sum(names.values())


def sync_stacks(fn):
    """Run ``fn`` under ``torch.cuda.set_sync_debug_mode("warn")``; each
    host round trip as the names of the port's frames that led to it, the
    innermost one last with its file and line."""
    import torch

    torch.cuda.synchronize()
    stacks = []

    def record(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" in str(message):
            frames = [f for f in traceback.extract_stack()[:-1] if "pinnrl_tpu_torch" in f.filename]
            where = (f"{frames[-1].filename.rsplit('pinnrl_tpu_torch', 1)[-1]}:{frames[-1].lineno}"
                     if frames else "?")
            stacks.append(tuple(f.name for f in frames) + (where,))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out, stacks


def parent_adam(opt) -> None:
    """Make ``opt`` step as before the step program: torch's Adam not
    capturable, its learning rate a host float (the other steps' code is
    the eager program's)."""
    import torch

    o = opt.optimizer
    opt.optimizer = torch.optim.Adam(opt.params, lr=opt.schedule(0), betas=o.defaults["betas"],
                                     eps=o.defaults["eps"], capturable=False)
    opt.lr = opt._group_lr = None


def program_for(tr, capacity: int, parent: bool = False, graph: bool = True):
    """The trainer's step program, set up as ``train`` sets it up (one step
    per ``run()``; its rows restart when full); with ``graph`` False it runs
    every step eagerly."""
    import torch

    t = tr.tcfg
    if tr.members:
        tr.model.ensemble = tr._stack_ensemble(7)
    params = tr.model.params
    opt = tr._make_adam(t.num_epochs, t.num_collocation_points // t.batch_size, tr._leaves(params))
    if parent:
        parent_adam(opt)
    gens = [torch.Generator(device=tr.device).manual_seed(s)
            for s in (tr._member_seeds(7, 1) if tr.members else [7])]
    if tr.rl_agent is not None:
        tr._rl_state = tr._init_rl_state(0)
    tr._aw_state = tr.adaptive_weights.init()
    tr._ema_init(params)
    program = tr._start_program(params, opt, gens, t.batch_size, None, 0, capacity, 1)
    if not graph:
        program.path = "eager"

    def step():
        if (program.eager_steps + program.replays) % capacity == 0:
            program.start_chunk()
        program.run()

    return step, program


def graph_runs(dev, card: str):
    """Phase 46: the step program captured against eager (see the module
    docstring)."""
    import os
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from pinnrl_tpu_torch.ops.kernels import fourier_feats, fused_step, mlp, residual_codegen, siren
    from pinnrl_tpu_torch.training import trainer as trainer_mod

    t_phase = time.perf_counter()
    counters = {"fused_residual_loss": fused_step.fused_residual_loss,
                "generated_residual": residual_codegen.launch,
                "fourier_features": fourier_feats.fourier_features,
                "siren_layer": siren.siren_layer, "fused_mlp_score": mlp.fused_mlp_score}
    out = {"card": card}
    for case in GRAPH_CASES:
        # The graph run twice, unprofiled (its host syncs, its wall time) and
        # profiled (the device's launches), then the eager run, profiled.
        runs = {}
        for side in ("graph", "graph_traced", "eager"):
            tr = graph_trainer(case)
            for c in counters.values():
                c.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.ExitStack() as stack:
                if side == "eager":
                    stack.enter_context(eager_steps())
                if side == "graph":
                    (res, stacks), device, kernels = sync_stacks(lambda: tr.train(seed=0)), None, None
                else:
                    (res, stacks), device, kernels = device_launches(
                        lambda: sync_stacks(lambda: tr.train(seed=0)))
            wall = time.perf_counter() - t0
            launches = {k: c.launches for k, c in counters.items()}
            params = tr.model.ensemble if tr.members else tr.model.params
            # A replay's syncs are "step"; an eager step's (the warm-up's, or
            # every step of the eager run) "eager_step": a process's first
            # step fills the samplers' per-device caches by a copy to the card.
            kinds, sites = classify_syncs(stacks)
            runs[side] = {"trainer": tr, "history": res["history"], "launches": launches,
                          "device": device, "kernels": kernels,
                          "params": {k: v.detach().clone() for k, v in params.items()},
                          "syncs": kinds, "sync_sites": sites, "wall_s": wall,
                          "programs": [p.stats() for p in tr.programs]}
        g, gt, e = runs["graph"], runs["graph_traced"], runs["eager"]
        traced_bits = (gt["history"]["train_loss"] == g["history"]["train_loss"]
                       and all(torch.equal(v, g["params"][k]) for k, v in gt["params"].items()))
        g = {**g, "device": gt["device"], "kernels": gt["kernels"]}
        tr = g["trainer"]
        t = tr.tcfg
        steps = t.num_epochs * (t.num_collocation_points // t.batch_size)
        chunks = len(g["history"]["val_loss"])
        (prog,), (eprog,) = g["programs"], e["programs"]
        bits = (g["history"]["train_loss"] == e["history"]["train_loss"]
                and all(torch.equal(v, e["params"][k]) for k, v in g["params"].items()))
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(g["history"]["train_loss"],
                                                          e["history"]["train_loss"]))
        param_rel = max(float((v - e["params"][k]).abs().max()) / float(e["params"][k].abs().max())
                        for k, v in g["params"].items())
        # ``launches``: the device's own, found by kernel name in the trace;
        # ``counted``: the wrappers' counters, which the trace must witness.
        per_step = {k: v / steps for k, v in g["device"].items()}
        entry = {"steps": steps, "chunks": chunks, "bit_identical": bits,
                 "max_loss_rel": loss_rel, "max_param_rel": param_rel,
                 "launches": g["device"], "eager_launches": e["device"],
                 "counted": g["launches"], "eager_counted": e["launches"],
                 "launches_per_step": per_step, "device_kernels": g["kernels"],
                 "eager_device_kernels": e["kernels"],
                 "host_reads_per_chunk": g["syncs"]["chunk_read"] / chunks,
                 "syncs": g["syncs"], "eager_syncs": e["syncs"], "traced_syncs": gt["syncs"],
                 "sync_sites": {"graph": g["sync_sites"], "traced": gt["sync_sites"],
                                "eager": e["sync_sites"]},
                 "traced_counted": gt["launches"], "traced_bit_identical": traced_bits,
                 "traced_wall_s": gt["wall_s"], "program": prog,
                 "eager_program": eprog, "wall_s": g["wall_s"], "eager_wall_s": e["wall_s"],
                 "train_loss": g["history"]["train_loss"]}
        out[case] = entry
        print(f"[graph] {case}: {steps} Adam steps in {chunks} chunks; captured after "
              f"{prog['eager_steps']} eager step(s), {prog['replays']} replays, capture "
              f"{prog['capture_s']:.3f} s, {prog['pool_bytes']} bytes reserved; bit-identical to "
              f"the eager program's run: {bits} (largest train_loss rel difference {loss_rel:.3e}, "
              f"parameter rel {param_rel:.3e}); device launches in the trace {g['device']} (eager "
              f"{e['device']}), counted {g['launches']} (eager {e['launches']}); device kernels "
              f"{g['kernels']} (eager {e['kernels']}); host syncs {g['syncs']} (eager "
              f"{e['syncs']}; under the profiler {gt['syncs']}, sites {entry['sync_sites']}); wall "
              f"{g['wall_s']:.2f} s, profiled {gt['wall_s']:.2f} s, eager profiled "
              f"{e['wall_s']:.2f} s ({card})", flush=True)
        want_k1 = steps + chunks if tr.fused_kernel_active else 0
        if not (prog["path"] == "graph" and prog["replays"] == steps - prog["eager_steps"] >= 1
                and eprog["replays"] == 0 and eprog["eager_steps"] == steps
                and gt["launches"] == g["launches"] == e["launches"] and traced_bits
                and all(trace_agrees(g["device"][k], v) for k, v in g["launches"].items())
                and all(trace_agrees(e["device"][k], v) for k, v in e["launches"].items())
                and g["launches"]["fused_residual_loss"] == want_k1
                and (case != "rl" or g["launches"]["fused_mlp_score"] == steps)
                and (case != "siren" or g["device"]["siren_layer"] > 0)
                and (case != "generated" or g["launches"]["generated_residual"] == want_k1 > 0)
                and g["syncs"]["chunk_read"] == chunks and g["syncs"]["step"] == 0
                and gt["syncs"]["step"] == 0
                and all(map(math.isfinite, g["history"]["train_loss"])) and bits):
            raise AssertionError(f"graph {case}: {entry}")

    # ms per step in turns: the replayed step, the eager program, and the
    # eager program with the Adam class it replaced.
    sides = {}
    for side in ("graph", "eager", "parent_eager"):
        tr = graph_trainer("rar")
        sides[side] = program_for(tr, GRAPH_TIMED, parent=side == "parent_eager",
                                  graph=side == "graph") + (tr,)
        for _ in range(3):
            sides[side][0]()
    times = {side: [] for side in sides}
    for r in range(GRAPH_ROUNDS):
        order = list(sides) if r % 2 == 0 else list(reversed(sides))
        for side in order:
            step = sides[side][0]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(GRAPH_TIMED):
                step()
            torch.cuda.synchronize()
            times[side].append((time.perf_counter() - t0) * 1e3 / GRAPH_TIMED)
    ms = {side: statistics.median(v) for side, v in times.items()}
    out["rar"]["ms_per_step"] = ms
    out["rar"]["ms_per_step_rounds"] = times
    print(f"[graph] rar: ms per Adam step, {GRAPH_TIMED} steps back to back, median of "
          f"{GRAPH_ROUNDS} rounds in turns: graph {ms['graph']:.3f}, eager program "
          f"{ms['eager']:.3f}, eager with the replaced Adam {ms['parent_eager']:.3f} ({card})",
          flush=True)
    for side in sides:
        sides[side][1].release()

    # Resume: the graph run resumed from its first chunk's checkpoint.
    with tempfile.TemporaryDirectory() as tmp:
        keep = Path(tmp) / "ck"
        tr = graph_trainer("rar")
        save = tr._save_checkpoint

        def saving(path, epoch, *args):
            save(path, epoch, *args)
            if epoch == GRAPH_CHUNK:
                keep.mkdir()
                for f in ("checkpoint.npz", "checkpoint.json"):
                    shutil.copy(str(path.parent / f), str(keep / f))

        tr._save_checkpoint = saving
        full = tr.train(seed=0, experiment_dir=str(Path(tmp) / "a"))
        tr2 = graph_trainer("rar")
        resumed = tr2.train(seed=0, experiment_dir=str(Path(tmp) / "b"),
                            resume_from=str(keep / "checkpoint.npz"))
        bits = (full["history"]["train_loss"] == resumed["history"]["train_loss"]
                and all(torch.equal(v, tr2.model.params[k]) for k, v in tr.model.params.items()))
        p_rel = max(float((v - tr2.model.params[k]).abs().max()) / float(v.abs().max())
                    for k, v in tr.model.params.items())
        out["resume"] = {"bit_identical": bits, "max_param_rel": p_rel,
                         "resumed_program": tr2.programs[0].stats()}
        print(f"[graph] resume at epoch {GRAPH_CHUNK} of {GRAPH_EPOCHS}: equal to the "
              f"uninterrupted graph run bit for bit: {bits} (largest parameter rel difference "
              f"{p_rel:.3e}); resumed program {tr2.programs[0].stats()} ({card})", flush=True)
        if not (bits and tr2.programs[0].path == "graph" and tr2.programs[0].replays > 0):
            raise AssertionError(f"graph resume: {out['resume']}")

    # No fallback: a step that reads a value back raises at the capture.
    probe = (
        "import chip_smoke as c, torch\n"
        "tr = c.graph_trainer('rar')\n"
        "step = tr._step\n"
        "def reading(*a):\n"
        "    row = step(*a)\n"
        "    float(row[0])\n"
        "    return row\n"
        "tr._step = reading\n"
        "try:\n"
        "    tr.train(seed=0)\n"
        "    print('NO_RAISE')\n"
        "except RuntimeError as exc:\n"
        "    p = tr.programs[0]\n"
        "    print('RAISED', p.eager_steps, p.replays, type(exc).__name__)\n")
    here = os.path.dirname(os.path.abspath(__file__))
    done = subprocess.run([sys.executable, "-c", probe], cwd=here, capture_output=True, text=True,
                          timeout=300)
    line = [ln for ln in done.stdout.splitlines() if ln.startswith(("RAISED", "NO_RAISE"))]
    out["no_fallback"] = line[-1] if line else done.stderr[-500:]
    print(f"[graph] a host read forced into the step: {out['no_fallback']} ({card})", flush=True)
    if not (line and line[-1].startswith("RAISED 1 0")):
        raise AssertionError(f"graph no fallback: {out['no_fallback']}")
    if trainer_mod.step_path(dev, False, None)[0] != "graph":
        raise AssertionError("the capture rule does not take the graph on the card")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[graph] phase 46: {out['seconds']:.1f} s ({card})", flush=True)
    return out



# Phase 47: every L-BFGS phase replays its iteration (training/step_program.py,
# ``Search``): the recipes' Adam then L-BFGS at full width, cut to 3 Adam
# epochs and 3 L-BFGS iterations (chunks of 2 and 1; the round case 4 in 2
# rounds of 2), each graph run against the eager program's.
LBFGS_GRAPH_CASES = ("burgers", "heat", "wave", "float64", "rl", "round")
LBFGS_GRAPH_EPOCHS = 6
LBFGS_TIMED_CASES = ("burgers", "heat", "wave")
LBFGS_TIMED, LBFGS_ROUNDS, LBFGS_PROFILED = 4, 2, 2  # iterations per side per round; profiled


def lbfgs_graph_config(case: str, device: str):
    """Phase 47's cases: the Burgers recipe (RAR Adam, then L-BFGS on all
    40000 points), heat (kernel 2's jvp rule), wave (the plain bundle at
    temporal order 2), Burgers with its L-BFGS phase in float64, Burgers
    with the DQN agent (uniform Adam draws; the agent's update after every
    iteration) and Burgers with a new round every 2 iterations."""
    from pinnrl_tpu_torch.benchmarks.convergence import build_recipe_config

    cfg = build_recipe_config(case if case in ("heat", "wave") else "burgers",
                              epochs=LBFGS_GRAPH_EPOCHS, device=device)
    t = cfg.training
    t.adam_lbfgs_switch_ratio, t.validation_frequency = 0.5, 2
    if case == "float64":
        t.residual_dtype = "float64"
    elif case == "rl":
        cfg.rl.enabled = True
        t.collocation_distribution = "uniform"
    elif case == "round":
        t.num_epochs, t.lbfgs.resample_every = LBFGS_GRAPH_EPOCHS + 2, 2
    elif case == "resume":  # pure L-BFGS, its memory in the checkpoint
        t.optimizer, t.num_epochs = "lbfgs", 4
    return cfg


def lbfgs_graph_trainer(case: str):
    from pinnrl_tpu_torch.models import PINNModel
    from pinnrl_tpu_torch.pdes import create_pde
    from pinnrl_tpu_torch.training import PDETrainer
    from pinnrl_tpu_torch.training.train import make_agent

    cfg = lbfgs_graph_config(case, "cuda")
    return PDETrainer(PINNModel(cfg, seed=0), create_pde(cfg), cfg,
                      rl_agent=make_agent(cfg) if cfg.rl.enabled else None)


@contextlib.contextmanager
def search_record():
    """Each L-BFGS iteration's accepted stepsize and trial count, written on
    the device by its ``finish`` (so a replayed finish writes them too) into
    ``record`` of its optimizer; yields the optimizers, in order."""
    import torch

    from pinnrl_tpu_torch.training.lbfgs import LBFGS

    seen = []
    finish = LBFGS.finish

    def recording(self):
        finish(self)
        if not hasattr(self, "record"):  # the first finish runs eagerly
            self.record = torch.zeros((64, 2), dtype=torch.float64, device=self._guess.device)
            seen.append(self)
        row = torch.stack([self._guess.double(), self._trials.double()]).reshape(1, 2)
        self.record.index_copy_(0, (self._count - 1).reshape(1), row)

    LBFGS.finish = recording
    try:
        yield seen
    finally:
        LBFGS.finish = finish


def classify_syncs(stacks):
    """A run's host syncs by where they came from: the capture, the chunk
    read, validation, an eager step or piece, a replayed step, the rest."""
    kinds = {"chunk_read": 0, "validation": 0, "capture": 0, "step": 0, "eager_step": 0,
             "setup": 0}
    sites = {}
    for names in stacks:
        kind = ("capture" if "_capture" in names else "chunk_read" if "_read_chunk" in names
                else "validation" if "_val_loss" in names
                else "eager_step" if ("_call" in names or "_eager" in names)
                else "step" if "run" in names else "setup")
        kinds[kind] += 1
        if kind in ("step", "eager_step", "setup"):
            sites[names[-1]] = sites.get(names[-1], 0) + 1
    return kinds, sites


def lbfgs_program_for(tr, capacity: int, graph: bool = True):
    """An L-BFGS program of ``tr`` on one fixed batch of the recipe's
    points, set up as ``train`` sets up a round (one iteration per
    ``run()``; its rows restart when full); with ``graph`` False every
    iteration runs eagerly."""
    import torch

    t = tr.tcfg
    params = tr.model.params
    tr._maybe_promote_f64(params)
    opt = tr._make_lbfgs(tr._leaves(params))
    gens = [torch.Generator(device=tr.device).manual_seed(7)]
    if tr.rl_agent is not None:
        tr._rl_state = tr._init_rl_state(0)
    n = t.num_collocation_points
    program = tr._start_program(params, opt, gens, n, tr._lbfgs_batch(7, 0, n), 0, capacity, 1)
    if not graph:
        program.path = "eager"

    def step():
        if (program.eager_steps + program.replays) % capacity == 0:
            program.start_chunk()
        program.run()

    return step, program


def device_busy(step, n: int):
    """``step()`` ``n`` times under ``torch.profiler``: the device's busy ms
    per step (the union of its kernel, memcpy and memset intervals) and its
    device launches per step."""
    import tempfile
    from pathlib import Path

    import torch
    from torch.profiler import ProfilerActivity, profile

    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                step()
            torch.cuda.synchronize()
        trace = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
    ivs = sorted((float(e["ts"]), float(e["dur"])) for e in events if e.get("ph") == "X"
                 and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, float("-inf")
    for ts, dur in ivs:
        lo, hi = max(ts, end), ts + dur
        if hi > lo:
            busy += hi - lo
        end = max(end, hi)
    return busy / 1e3 / n, len(ivs) / n


def lbfgs_case_run(case: str, side: str) -> dict:
    """One phase-47 run of ``case`` from a fresh trainer: ``graph``,
    ``eager`` (the eager program) or ``graph_traced`` (under
    ``torch.profiler``); its history, the stepsizes and trials it recorded,
    evaluations, launches, host syncs, search reads, parameters and
    programs."""
    import hashlib

    import torch

    from pinnrl_tpu_torch.ops.kernels import fourier_feats, fused_step, mlp, residual_codegen, siren
    from pinnrl_tpu_torch.training.lbfgs import LBFGS

    counters = {"fused_residual_loss": fused_step.fused_residual_loss,
                "generated_residual": residual_codegen.launch,
                "fourier_features": fourier_feats.fourier_features,
                "siren_layer": siren.siren_layer, "fused_mlp_score": mlp.fused_mlp_score}
    tr = lbfgs_graph_trainer(case)
    for c in counters.values():
        c.launches = 0
    e0, r0 = LBFGS.evaluations, LBFGS.host_reads
    names = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        if side == "eager":
            stack.enter_context(eager_steps())
        seen = stack.enter_context(search_record())
        if side == "graph_traced":
            (res, stacks), device, _ = device_launches(
                lambda: sync_stacks(lambda: tr.train(seed=0)), names_into=names)
        else:
            (res, stacks), device = sync_stacks(lambda: tr.train(seed=0)), None
    wall = time.perf_counter() - t0
    kinds, sites = classify_syncs(stacks)
    final = tr._final_state["params"]["net"]
    digest = hashlib.sha256()
    for k in sorted(final):
        digest.update(final[k].detach().cpu().numpy().tobytes())
    return {"trainer": tr, "history": res["history"], "wall_s": wall,
            "launches": {k: c.launches for k, c in counters.items()},
            "device": device, "names": names, "syncs": kinds, "sync_sites": sites,
            "evaluations": LBFGS.evaluations - e0, "search_reads": LBFGS.host_reads - r0,
            "record": [row for o in seen for row in o.record[:o.count].tolist()],
            "params": digest.hexdigest(), "programs": [p.stats() for p in tr.programs]}


def lbfgs_traced_case(case: str) -> None:
    """Phase 47's traced graph run of ``case``, in a process of its own:
    prints it as one JSON line. A trace late in a long process named
    kernels the run never launched (8 of kernel 1's heat kernel and 8 of
    kernel 2's in a float64 Burgers run after the heat and wave cases,
    reproducibly, inside the run's window, with the counters, the eager run
    and the bits agreeing); in a fresh process its names were right."""
    run = lbfgs_case_run(case, "graph_traced")
    del run["trainer"]
    print("TRACED " + json.dumps(run), flush=True)


def lbfgs_graph_runs(dev, card: str):
    """Phase 47: the L-BFGS phase captured against eager (see the module
    docstring)."""
    import os
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from pinnrl_tpu_torch.training import trainer as trainer_mod

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    out = {"card": card}
    for case in LBFGS_GRAPH_CASES:
        runs = {side: lbfgs_case_run(case, side) for side in ("graph", "eager")}
        done = subprocess.run([sys.executable, "-c",
                               f"import chip_smoke as c; c.lbfgs_traced_case({case!r})"],
                              cwd=here, capture_output=True, text=True, timeout=300)
        line = [ln for ln in done.stdout.splitlines() if ln.startswith("TRACED ")]
        if not line:
            raise AssertionError(f"lbfgs graph {case}: the traced run failed: "
                                 f"{done.stderr[-2000:]}")
        runs["graph_traced"] = json.loads(line[-1][len("TRACED "):])
        names = runs["graph_traced"]["names"]
        g, gt, e = runs["graph"], runs["graph_traced"], runs["eager"]
        tr = g["trainer"]
        t = tr.tcfg
        chunks = len(g["history"]["val_loss"])
        adam_steps = tr.switch_epoch * (t.num_collocation_points // t.batch_size)
        iterations = t.num_epochs - tr.switch_epoch
        lprogs = [p for p in g["programs"] if p["name"] == "L-BFGS"]
        eprogs = [p for p in e["programs"] if p["name"] == "L-BFGS"]

        def same(a, b):
            return all(a[k] == b[k] for k in ("record", "evaluations", "launches", "params")) \
                and all(a["history"][k] == b["history"][k] for k in ("train_loss", "val_loss"))

        bits, traced_bits = same(g, e), same(gt, g)
        evals_recorded = sum(1 + int(n) for _, n in g["record"])
        k1_f32 = tr.fused_kernel_active and case != "float64"
        want_k1 = adam_steps + g["evaluations"] + chunks if k1_f32 else None
        entry = {"iterations": iterations, "chunks": chunks, "bit_identical": bits,
                 "stepsizes": [s for s, _ in g["record"]],
                 "trials": [int(n) for _, n in g["record"]], "evaluations": g["evaluations"],
                 "launches": gt["device"], "counted": g["launches"],
                 "eager_counted": e["launches"], "syncs": g["syncs"],
                 "traced_syncs": gt["syncs"], "eager_syncs": e["syncs"],
                 "sync_sites": {"graph": g["sync_sites"], "eager": e["sync_sites"]},
                 "host_reads_per_chunk": g["syncs"]["chunk_read"] / chunks,
                 "search_reads": g["search_reads"], "eager_search_reads": e["search_reads"],
                 "programs": lprogs, "eager_programs": eprogs, "wall_s": g["wall_s"],
                 "eager_wall_s": e["wall_s"], "train_loss": g["history"]["train_loss"]}
        out[case] = entry
        print(f"[lbfgs graph] {case}: {adam_steps} Adam steps, then {iterations} L-BFGS "
              f"iterations (stepsizes {entry['stepsizes']}, trials {entry['trials']}, "
              f"{g['evaluations']} evaluations) in {chunks} chunks; L-BFGS programs {lprogs}; "
              f"bit-identical to the eager program's run: {bits} (traced run {traced_bits}); "
              f"device launches in the trace {gt['device']}, counted {g['launches']} (eager "
              f"{e['launches']}); host syncs {g['syncs']} (eager {e['syncs']}; sites "
              f"{entry['sync_sites']}); search host reads {g['search_reads']} (eager "
              f"{e['search_reads']}); wall {g['wall_s']:.2f} s, eager {e['wall_s']:.2f} s "
              f"({card})", flush=True)
        rounds = 2 if case == "round" else 1
        if not (bits and traced_bits and len(lprogs) == rounds
                and all(p["path"] == "graph" and p["eager_steps"] == 0 for p in lprogs)
                and sum(p["replays"] for p in lprogs) == iterations == len(g["record"])
                and all(p["eager_steps"] > 0 and p["replays"] == 0 for p in eprogs)
                and g["evaluations"] == evals_recorded >= 2 * iterations
                and all(trace_agrees(gt["device"][k], v) for k, v in g["launches"].items())
                and (want_k1 is None or g["launches"]["fused_residual_loss"] == want_k1)
                and (case != "rl" or g["launches"]["fused_mlp_score"] > 0)
                and g["syncs"]["chunk_read"] == chunks and g["syncs"]["step"] == 0
                and gt["syncs"]["step"] == 0 and g["search_reads"] == 0
                and 0 < e["search_reads"] < e["evaluations"]
                and all(map(math.isfinite, g["history"]["train_loss"]))):
            traced = {name: n for name, n in names.items()
                      if any(rx.search(name) for rx in GRAPH_KERNELS.values())}
            raise AssertionError(f"lbfgs graph {case}: {entry}; the trace's kernels {traced}")

    # Resume inside a pure L-BFGS run: from its first chunk's checkpoint
    # (the memory restored), against the uninterrupted graph run.
    with tempfile.TemporaryDirectory() as tmp:
        keep = Path(tmp) / "ck"
        tr = lbfgs_graph_trainer("resume")
        save = tr._save_checkpoint

        def saving(path, epoch, *args):
            save(path, epoch, *args)
            if epoch == 2:
                keep.mkdir()
                for f in ("checkpoint.npz", "checkpoint.json"):
                    shutil.copy(str(path.parent / f), str(keep / f))

        tr._save_checkpoint = saving
        full = tr.train(seed=0, experiment_dir=str(Path(tmp) / "a"))
        tr2 = lbfgs_graph_trainer("resume")
        resumed = tr2.train(seed=0, experiment_dir=str(Path(tmp) / "b"),
                            resume_from=str(keep / "checkpoint.npz"))
        bits = (full["history"]["train_loss"] == resumed["history"]["train_loss"]
                and all(torch.equal(v, tr2.model.params[k]) for k, v in tr.model.params.items()))
        out["resume"] = {"bit_identical": bits, "programs": [p.stats() for p in tr2.programs]}
        print(f"[lbfgs graph] resume of a pure L-BFGS run at epoch 2 of 4 (its memory restored): "
              f"equal to the uninterrupted graph run bit for bit: {bits}; resumed program "
              f"{out['resume']['programs']} ({card})", flush=True)
        (prog,) = tr2.programs
        if not (bits and prog.path == "graph" and prog.replays == 2):
            raise AssertionError(f"lbfgs graph resume: {out['resume']}")

    # ms per iteration in turns (graph, eager, eager, graph) on one fixed
    # batch from a fresh optimizer, then each side's busy share under the
    # profiler.
    timed = {}
    for case in LBFGS_TIMED_CASES:
        sides = {}
        for side in ("graph", "eager"):
            tr = lbfgs_graph_trainer(case)
            sides[side] = lbfgs_program_for(tr, 64, graph=side == "graph")
            for _ in range(2):
                sides[side][0]()
        times = {side: [] for side in sides}
        for r in range(LBFGS_ROUNDS):
            for side in (("graph", "eager") if r % 2 == 0 else ("eager", "graph")):
                step = sides[side][0]
                for _ in range(LBFGS_TIMED):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    step()
                    torch.cuda.synchronize()
                    times[side].append((time.perf_counter() - t0) * 1e3)
        res = {}
        for side, (step, program) in sides.items():
            ms = statistics.median(times[side])
            busy, launches = device_busy(step, LBFGS_PROFILED)
            res[side] = {"ms": ms, "ms_all": times[side], "busy_ms": busy,
                         "idle_share": 1.0 - busy / ms, "device_launches": launches,
                         "program": program.stats()}
            program.release()
        res["launch_difference"] = res["graph"]["device_launches"] - res["eager"]["device_launches"]
        timed[case] = res
        print(f"[lbfgs graph] {case}: ms per L-BFGS iteration at N=40000, median of "
              f"{LBFGS_ROUNDS * LBFGS_TIMED} in turns: graph {res['graph']['ms']:.3f} (busy "
              f"{res['graph']['busy_ms']:.3f}, idle {res['graph']['idle_share']:.3f}, "
              f"{res['graph']['device_launches']:.1f} launches), eager {res['eager']['ms']:.3f} "
              f"(busy {res['eager']['busy_ms']:.3f}, idle {res['eager']['idle_share']:.3f}, "
              f"{res['eager']['device_launches']:.1f} launches); capture "
              f"{res['graph']['program']['capture_s']:.3f} s, "
              f"{res['graph']['program']['pool_bytes']} bytes reserved ({card})", flush=True)
    out["timed"] = timed
    if trainer_mod.step_path(dev, True, None)[0] != "graph":
        raise AssertionError("the capture rule does not take the graph for L-BFGS on the card")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[lbfgs graph] phase 47: {out['seconds']:.1f} s ({card})", flush=True)
    return out


def main() -> int:
    import torch

    # ---- 1. device ----------------------------------------------------- #
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to run", file=sys.stderr)
        return 2
    import pinnrl_tpu_torch  # noqa: F401 — fails outside a checkout of the repo
    from pinnrl_tpu_torch.config import load_config
    from pinnrl_tpu_torch.models import PINNModel
    from pinnrl_tpu_torch.ops.derivatives import make_scalar_fn
    from pinnrl_tpu_torch.ops.jet_mlp import make_bundle_fn
    from pinnrl_tpu_torch.ops.kernels import _build, fourier_feats, fused_step, mlp, siren
    from pinnrl_tpu_torch.sampling import make_grid
    from pinnrl_tpu_torch.pdes import create_pde
    from pinnrl_tpu_torch.training import PDETrainer
    from pinnrl_tpu_torch.training.train import make_agent

    dev = torch.device("cuda")
    card = nvidia_smi_line()
    print(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # ---- 2. build ------------------------------------------------------ #
    t0 = time.perf_counter()
    names = ("fourier_feats", "fused_residual", "mlp_score", "siren")
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        list(pool.map(_build.load_library, names))  # one nvcc per source, all at once
    core_spills = {name: [] for name in ("fused_residual", "siren", "mlp_score")}
    ff_ptxas = {}  # kernel 2's instantiations: (registers, spill bytes, stack frame bytes)
    for name in names:
        print(f"[build] {name}: {_build.BUILD_SECONDS[name]:.2f} s", flush=True)
        for entry, regs, smem, spill_st, spill_ld, stack in ptxas_report(_build.BUILD_LOG.get(name, "")):
            print(f"[build]   ptxas {entry}: {regs} registers, {smem} bytes smem, stack frame "
                  f"{stack} B, spill stores {spill_st} B, spill loads {spill_ld} B")
            if "_sm90_kernel" in entry:
                core_spills[name].append(spill_st + spill_ld)
            if "fourier_features_kernel" in entry:
                ff_ptxas[entry] = (regs, spill_st + spill_ld, stack)
    print(f"[build] total {time.perf_counter() - t0:.2f} s; GEMM-core kernels' spill bytes per "
          f"library: {core_spills}; fourier_features_kernel<D> (registers, spill bytes, stack "
          f"frame bytes): {sorted(ff_ptxas.values())} ({card})", flush=True)
    if not all(core_spills.values()) or any(map(any, core_spills.values())):
        raise AssertionError(f"GEMM core kernels: spill bytes {core_spills} (want kernels, all 0)")
    if len(ff_ptxas) != 4 or any(spill for _, spill, _ in ff_ptxas.values()):
        raise AssertionError(f"fourier_features_kernel: {ff_ptxas} (want D = 0..3, 0 spill bytes)")

    # ---- 3. parity ----------------------------------------------------- #
    cfg = burgers_recipe_config("cuda")
    pde = create_pde(cfg)
    model = PINNModel(cfg, seed=0)
    gen = torch.Generator(device=dev).manual_seed(123)

    from pinnrl_tpu_torch.models.fourier import feature_basis

    x_ff = 2.0 * torch.rand((4096, 2), generator=gen, device=dev) - 1.0
    B = model.constants["FourierFeatures_0.B"]
    B256 = (0.75 * feature_basis(0, 2, 256)).to(dev)  # the KdV recipe's basis
    x_val = 2.0 * torch.rand((20000, 2), generator=gen, device=dev) - 1.0  # validation's rows
    # The main path's shapes (BC / IC of the Burgers and heat recipes, of the
    # KdV recipe, validation) and a ragged one with x and B one float past a
    # 16-byte boundary (the edge path).
    ff_shapes = {"(4096,2)x(2,128)": (x_ff, B), "(4096,2)x(2,256)": (x_ff, B256),
                 "(20000,2)x(2,128)": (x_val, B)}
    x_rag = torch.empty(4999 * 3 + 1, device=dev)[1:].view(4999, 3).uniform_(-1.0, 1.0, generator=gen)
    B_rag = torch.empty(3 * 127 + 1, device=dev)[1:].view(3, 127).normal_(0.0, 1.33, generator=gen)
    ff_err = 0.0
    for tag, (xs, Bs) in list(ff_shapes.items()) + [("(4999,3)x(3,127) unaligned", (x_rag, B_rag))]:
        ff_k = fourier_feats.fourier_features(xs, Bs, True)
        ff_k2 = fourier_feats.fourier_features(xs, Bs, True)
        ff_p = fourier_feats.fourier_features_plain(xs, Bs, True)
        torch.cuda.synchronize()
        err = float((ff_k - ff_p).abs().max())
        ff_rel = err / float(ff_p.abs().max())
        ff_err = max(ff_err, err)
        path = fourier_feats.launch_plan(*xs.shape, Bs.shape[1], Bs.data_ptr() % 16 == 0,
                                         fourier_feats._sm_count(xs.get_device()))
        print(f"[parity] fourier_features {tag} (path {path[0]}, grid {path[1]}x{path[2]}): "
              f"max_abs_err {err:.3e} rel {ff_rel:.3e} (tol {FF_TOL:g}); max phase "
              f"{float((xs @ Bs).abs().max()) * fourier_feats._TWO_PI:.1f} rad; two calls "
              f"bit-identical {torch.equal(ff_k, ff_k2)}", flush=True)
        if not (ff_rel < FF_TOL and torch.equal(ff_k, ff_k2)):
            raise AssertionError(f"fourier_features kernel disagrees with its plain version ({tag})")
    xg = x_ff.clone().requires_grad_(True)
    g_out = torch.randn((4096, 256), generator=gen, device=dev)
    gk = torch.autograd.grad(fourier_feats.fourier_features(xg, B, True), xg, g_out)[0]
    gp = torch.autograd.grad(fourier_feats.fourier_features_plain(xg, B, True), xg, g_out)[0]
    torch.cuda.synchronize()
    ff_grad_rel = float((gk - gp).abs().max()) / float(gp.abs().max())
    print(f"[parity] fourier_features (4096,2)x(2,128) gradient: rel {ff_grad_rel:.3e} "
          f"(tol {FF_TOL:g})", flush=True)
    if not ff_grad_rel < FF_TOL:
        raise AssertionError("fourier_features kernel's gradient disagrees with its plain version")

    def fused_grads(v, p, zz):
        loss = v.fn(p, zz)
        return loss, torch.autograd.grad(loss, list(p.values()))

    def plain_grads(v, p, zz):
        loss = fused_step.fused_residual_loss_plain(v.bundle_fn, v.pde, p, zz)
        # Heat's residual does not depend on the output bias: its gradient is 0.
        return loss, torch.autograd.grad(loss, list(p.values()), allow_unused=True,
                                         materialize_grads=True)

    def variant(vcfg):
        """Kernel 1 and its plain version for one configuration, seeded init."""
        vpde, vmodel = create_pde(vcfg), PINNModel(vcfg, seed=0)
        assert vpde.attach_fast_bundle(vmodel) and fused_step.supports(vmodel, vpde, vcfg.training)
        return SimpleNamespace(
            pde=vpde, model=vmodel, fn=fused_step.make_fused_residual_loss(vmodel, vpde),
            bundle_fn=make_bundle_fn(vmodel, vpde.dimension, max(vpde.spatial_orders),
                                     max(vpde.temporal_orders)))

    def compare(name, tag, p, zz):
        """Kernel 1 against its plain version (loss and every gradient) on
        time-sorted points ``zz``; keeps the worst absolute error per variant
        in ``fused_errs``."""
        v = variants[name]
        loss_tol, grad_tol = FUSED_TOLS[name]
        lk, gk_ = fused_grads(v, p, zz)
        lk = lk.detach()
        lp, gp_ = plain_grads(v, p, zz)
        lp = lp.detach()
        torch.cuda.synchronize()
        loss_rel = abs(float(lk) - float(lp)) / max(abs(float(lp)), 1e-30)
        worst_abs, worst_rel, worst_name = abs(float(lk) - float(lp)), 0.0, ""
        for pname, a, b in zip(p.keys(), gk_, gp_):
            if not torch.isfinite(a).all():
                raise AssertionError(f"{name} {tag}: non-finite kernel gradient for {pname}")
            d = float((a - b).abs().max())
            rel = d / max(float(b.abs().max()), 1e-30)
            worst_abs = max(worst_abs, d)
            if rel > worst_rel:
                worst_rel, worst_name = rel, pname
        print(f"[parity] fused_residual_loss {name} {tag}: loss {float(lk):.8e} vs plain "
              f"{float(lp):.8e} (rel {loss_rel:.3e}, tol {loss_tol:g}); worst grad rel "
              f"{worst_rel:.3e} ({worst_name}, tol {grad_tol:g}); max_abs_err {worst_abs:.3e}",
              flush=True)
        if not (loss_rel < loss_tol and worst_rel < grad_tol):
            raise AssertionError(f"fused_residual_loss kernel disagrees with its plain version "
                                 f"({name}, {tag})")
        fused_errs[name] = max(fused_errs.get(name, 0.0), worst_abs)

    burgers_causal_cfg = burgers_recipe_config("cuda")
    burgers_causal_cfg.training.causal_eps = 1.0
    variants = {"burgers": variant(burgers_recipe_config("cuda")),
                "burgers_causal": variant(burgers_causal_cfg),
                "heat": variant(heat_recipe_config("cuda")),
                "heat_causal": variant(heat_recipe_config("cuda", causal=True)),
                "kdv": variant(kdv_recipe_config("cuda", causal=False)),
                "kdv_causal": variant(kdv_recipe_config("cuda"))}
    fused_errs = {}
    parity_z = {}
    for name, v in variants.items():
        z = parity_z[name] = time_sorted(*v.pde.generate_collocation_points(gen, 8192, "uniform"))
        compare(name, "N=8192 seeded init", v.model.params, z)
    for name in ("burgers", "kdv_causal"):  # split-K partials in a fixed order: no drift
        v = variants[name]
        (l1, g1), (l2, g2) = (fused_grads(v, v.model.params, parity_z[name]) for _ in range(2))
        same = torch.equal(l1, l2) and all(torch.equal(a, b) for a, b in zip(g1, g2))
        print(f"[parity] fused_residual_loss {name}: two calls on the same inputs bit-identical "
              f"{same}", flush=True)
        if not same:
            raise AssertionError(f"kernel 1 ({name}) is not deterministic")
    v = variants["kdv_causal"]
    compare("kdv_causal", "N=5000 seeded init", v.model.params,
            time_sorted(*v.pde.generate_collocation_points(gen, 5000, "uniform")))
    for name in ("burgers", "heat"):  # the L-BFGS phase's batch: every collocation point
        v = variants[name]
        z = parity_z[f"{name}_{LBFGS_N}"] = torch.cat(
            v.pde.generate_collocation_points(gen, LBFGS_N, "uniform"), dim=-1)
        compare(name, f"N={LBFGS_N} seeded init", v.model.params, z)
        (l1, g1), (l2, g2) = (fused_grads(v, v.model.params, z) for _ in range(2))
        same = torch.equal(l1, l2) and all(torch.equal(a, b) for a, b in zip(g1, g2))
        print(f"[parity] fused_residual_loss {name} N={LBFGS_N}: two calls on the same inputs "
              f"bit-identical {same}", flush=True)
        if not same:
            raise AssertionError(f"kernel 1 ({name}, N={LBFGS_N}) is not deterministic")

    rl_cfg = burgers_recipe_config("cuda")
    rl_cfg.rl.enabled = True
    grid = make_grid(pde.domain, pde.time_domain, 100, dev)
    mlp_err = 0.0
    mlp_ops = mlp._cuda_ops(dev)
    for hidden, a_dim, xs in ((rl_cfg.rl.hidden_dim, rl_cfg.rl.action_dim, grid),
                              (128, 4, 2.0 * torch.rand((1000, 2), generator=gen, device=dev) - 1.0),
                              (40, 3, 2.0 * torch.rand((37, 2), generator=gen, device=dev) - 1.0)):
        rl_cfg.rl.hidden_dim, rl_cfg.rl.action_dim = hidden, a_dim
        q_params = make_agent(rl_cfg).init(torch.Generator().manual_seed(1)).policy_params
        # LayerNorm away from its init (1, 0), so its terms count.
        q_params = {k: v.detach() + (0.1 * torch.randn(v.shape, generator=gen, device=dev)
                                     if k.startswith("LayerNorm") else 0.0)
                    for k, v in q_params.items()}
        chosen = mlp._product_split(xs.shape[0], hidden, hidden)[0]
        with torch.no_grad():
            qk = mlp.fused_mlp_score(xs, q_params)
            qk2 = mlp.fused_mlp_score(xs, q_params)
            qp = mlp.fused_mlp_score_plain(xs, q_params)
            forced = {s: mlp._score(mlp_ops, xs, q_params, 1e-6, splits=s) for s in (1, 2)}
        torch.cuda.synchronize()
        tag = f"({xs.shape[0]},2)->{hidden}->{hidden}->{a_dim}"
        for label, q in [(f"split {chosen} (chosen)", qk)] + [(f"split {s} forced", v)
                                                               for s, v in forced.items()]:
            err = float((q - qp).abs().max())
            rel = err / float(qp.abs().max())
            mlp_err = max(mlp_err, err)
            print(f"[parity] fused_mlp_score {tag}, product {label}: max_abs_err {err:.3e} "
                  f"rel {rel:.3e} (tol {MLP_TOL:g})", flush=True)
            if not (tuple(q.shape) == (xs.shape[0], a_dim) and rel < MLP_TOL):
                raise AssertionError(f"fused_mlp_score kernel disagrees with its plain version "
                                     f"({tag}, {label})")
        same = torch.equal(qk, qk2)
        print(f"[parity] fused_mlp_score {tag}: two calls on the same inputs bit-identical {same}",
              flush=True)
        if not same:
            raise AssertionError(f"kernel 4 is not deterministic ({tag})")
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
    compare("burgers", "N=8192 trained params",
            {k: v.detach().requires_grad_(True) for k, v in net.items()}, torch.cat([x, t], dim=-1))

    # ---- 5. timing ----------------------------------------------------- #
    ff_times = {}
    for tag, (xs, Bs) in ff_shapes.items():
        n_s, d_s, m_s = xs.shape[0], xs.shape[1], Bs.shape[1]
        ff_times[tag] = {
            "ms": graph_ms(lambda: fourier_feats.fourier_features(xs, Bs, True)),
            "plain_ms": graph_ms(lambda: fourier_feats.fourier_features_plain(xs, Bs, True)),
            "eager_ms": cuda_ms(lambda: fourier_feats.fourier_features(xs, Bs, True), iters=200)}
        ff_times[tag]["bound_ms"], ff_times[tag]["bound_by"] = bound(
            2.0 * n_s * d_s * m_s + 3.0 * n_s * m_s, 4.0 * (n_s * d_s + d_s * m_s + 2 * n_s * m_s))
    ff_ms, ff_plain_ms, ff_eager_ms, ff_bound_ms, ff_bound_by = (
        ff_times["(4096,2)x(2,128)"][k] for k in ("ms", "plain_ms", "eager_ms", "bound_ms", "bound_by"))
    ff_floor_ms = graph_ms(ff_empty_launch(x_ff, B))
    ff_host = ff_host_split(x_ff, B)
    for tag, v in ff_times.items():
        print(f"[timing] fourier_features {tag}, device time per call (CUDA graph): kernel "
              f"{v['ms']:.5f} ms, plain {v['plain_ms']:.5f} ms, bound {v['bound_ms']:.5f} ms "
              f"({v['bound_ms'] / v['ms']:.0%} of it); eager calls, CUDA events: kernel "
              f"{v['eager_ms']:.5f} ms ({card})", flush=True)
    print(f"[timing] fourier_features launch floor: an empty kernel on the (4096,2)x(2,128) call's "
          f"grid {ff_floor_ms:.5f} ms per launch (CUDA graph) against the kernel's {ff_ms:.5f} ms "
          f"({card})", flush=True)
    print("[timing] fourier_features eager host cost per call, us (perf_counter, 1000 calls each): "
          + ", ".join(f"{k} {v:.2f}" for k, v in ff_host.items()) + f" ({card})", flush=True)
    z = torch.cat([x, t], dim=-1)
    p = {k: v.detach().requires_grad_(True) for k, v in net.items()}
    fused_ms = graph_ms(lambda: fused_grads(variants["burgers"], p, z), iters=10, replays=5)
    fused_plain_ms = graph_ms(lambda: plain_grads(variants["burgers"], p, z), iters=10, replays=5)
    fused_eager_ms = cuda_ms(lambda: fused_grads(variants["burgers"], p, z), iters=20)
    print(f"[timing] fused_residual_loss N=8192 loss+grads, device time per call (CUDA graph): "
          f"kernel {fused_ms:.3f} ms, plain {fused_plain_ms:.3f} ms; eager calls, CUDA events: "
          f"kernel {fused_eager_ms:.3f} ms ({card})", flush=True)

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
    # Profiled: the device's own launches of kernels 1, 2 and 4, by name in
    # the trace, which the counters must equal.
    rl_res, rl_trace, _ = device_launches(lambda: rl_trainer.train(seed=0))
    rl_s = time.perf_counter() - t0
    rl_launches = {"fused_residual_loss": fused_step.fused_residual_loss.launches,
                   "fourier_features": fourier_feats.fourier_features.launches,
                   "fused_mlp_score": mlp.fused_mlp_score.launches}
    if not all(trace_agrees(rl_trace[k], v) for k, v in rl_launches.items()):
        raise AssertionError(f"RL slice: device launches in the trace {rl_trace}, counted "
                             f"{rl_launches}")
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
    g_n, h_mlp = grid.shape[0], q_params["Dense_1.weight"].shape[0]
    mlp_shapes = [(g_n, 2, h_mlp), (g_n, h_mlp, h_mlp), (g_n, h_mlp, 1)]
    with torch.no_grad():
        mlp_eager_ms = cuda_ms(lambda: mlp.fused_mlp_score(grid, q_params), iters=100)
        mlp_ms = graph_ms(lambda: mlp.fused_mlp_score(grid, q_params))
        mlp_plain_ms = graph_ms(lambda: mlp.fused_mlp_score_plain(grid, q_params))
        mlp_lib_ms = cublas_ms(mlp_shapes, dev, iters=50)
        launches, products, mlp_splits = scorer_launches(mlp_ops, grid, q_params)
        mlp_launch_ms = {k: graph_ms(f) for k, f in launches.items()}
        product_ab = {k: 0.0 for k in products}
        for k in list(products) + list(reversed(products)):  # in turns
            product_ab[k] += graph_ms(products[k]) / 2.0
        split_ab = {1: 0.0, 2: 0.0}
        for s in (1, 2, 2, 1):
            split_ab[s] += graph_ms(lambda s=s: mlp._score(mlp_ops, grid, q_params, 1e-6, splits=s)) / 2.0
    mlp_blocks = mlp_ops.gemm_blocks(g_n, h_mlp, mlp_splits)  # the launch's own grid
    print(f"[timing] fused_mlp_score ({g_n},2)->{h_mlp}->{h_mlp}->1, device time per call (CUDA "
          f"graph): kernel {mlp_ms:.4f} ms, plain {mlp_plain_ms:.4f} ms, cuBLAS (its 3 products, "
          f"no LayerNorm) {mlp_lib_ms:.4f} ms; eager calls, CUDA events: kernel {mlp_eager_ms:.4f} "
          f"ms ({card})", flush=True)
    flop = 2.0 * g_n * h_mlp * h_mlp
    print(f"[timing] fused_mlp_score launches (CUDA graph): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in mlp_launch_ms.items())
          + f" (sum {sum(mlp_launch_ms.values()):.4f}); product split {mlp_splits} over K, "
          f"{mlp_blocks} blocks of 128x128, {flop / mlp_launch_ms['product'] / 1e9:.1f} TFLOP/s "
          f"({card})", flush=True)
    print("[timing] fused_mlp_score product A/B (CUDA graph, in turns): "
          + ", ".join(f"{'W2^T (B n-contiguous)' if t else 'W2 as is (B k-contiguous)'} split {s} "
                      f"{v:.4f} ms ({flop / v / 1e9:.1f} TFLOP/s)" for (s, t), v in product_ab.items())
          + f"; whole call split 1 {split_ab[1]:.4f} ms, split 2 {split_ab[2]:.4f} ms ({card})",
          flush=True)
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

    # ---- 10. kdv slice --------------------------------------------------- #
    kcfg = kdv_recipe_config("cuda")
    kpde = create_pde(kcfg)
    kmodel = PINNModel(kcfg, seed=0)
    ktrainer = PDETrainer(kmodel, kpde, kcfg)
    kt = kcfg.training
    if not (ktrainer.fused_kernel_active and kt.causal_eps == 1.0 and max(kpde.spatial_orders) == 3):
        raise AssertionError("the KdV slice is not on kernel 1's causal order-3 variant")
    kB = kmodel.constants["FourierFeatures_0.B"]
    if not (tuple(kcfg.model.hidden_dims) == (256, 256, 256) and tuple(kB.shape) == (2, 256)
            and torch.equal(kB.cpu(), 0.75 * feature_basis(0, 2, 256))):
        raise AssertionError("the KdV model is not the recipe's 256x3 trunk on the shipped "
                             "feature_seed 0 basis x 0.75")
    k_steps_per_epoch = kt.num_collocation_points // kt.batch_size
    k_steps = KDV_EPOCHS * k_steps_per_epoch
    k_val_every = kt.validation_frequency
    k_vals = sum(1 for e in range(1, KDV_EPOCHS + 1) if e % k_val_every == 0 or e == KDV_EPOCHS)
    fourier_feats.fourier_features.launches = 0
    fused_step.fused_residual_loss.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    k_res = ktrainer.train(seed=0)
    torch.cuda.synchronize()
    k_s = time.perf_counter() - t0
    kdv_launches = {"fused_residual_loss": fused_step.fused_residual_loss.launches,
                    "fourier_features": fourier_feats.fourier_features.launches}
    k_hist = k_res["history"]["train_loss"]
    print(f"[kdv] fused_kernel_active={ktrainer.fused_kernel_active} causal_eps={kt.causal_eps} "
          f"steps={k_steps} ({KDV_EPOCHS} epochs x {k_steps_per_epoch}, batch {kt.batch_size} of "
          f"{kt.num_collocation_points}) validations={k_vals} train {k_s:.2f} s; launches: "
          f"{kdv_launches}; B = 0.75 x shipped seed0_2x256: True", flush=True)
    print(f"[kdv] epoch mean losses: {' '.join(f'{v:.4e}' for v in k_hist)}", flush=True)
    if len(k_hist) != KDV_EPOCHS or not all(v == v and abs(v) != float("inf") for v in k_hist):
        raise AssertionError(f"KdV slice: non-finite or missing losses: {k_hist}")
    if not k_hist[-1] < k_hist[0]:
        raise AssertionError(f"KdV slice: loss did not fall: first epoch {k_hist[0]}, last {k_hist[-1]}")
    if len(k_res["history"]["val_loss"]) != k_vals:
        raise AssertionError(f"KdV slice: {len(k_res['history']['val_loss'])} validations, "
                             f"expected {k_vals}")
    if kdv_launches["fused_residual_loss"] != k_steps + k_vals:
        raise AssertionError(f"KdV slice: fused kernel launched {kdv_launches['fused_residual_loss']} "
                             f"times in {k_steps} steps and {k_vals} validations")
    if kdv_launches["fourier_features"] < 2 * (k_steps + k_vals):
        raise AssertionError(f"KdV slice: fourier_features launched {kdv_launches['fourier_features']} "
                             f"times, expected >= {2 * (k_steps + k_vals)}")
    k_net = ktrainer._final_state["params"]["net"]
    k_val = kpde.validate(kmodel.apply, k_net, num_points=20000)
    if not all(v == v for v in k_val.values()):
        raise AssertionError(f"KdV slice: non-finite validation metrics {k_val}")
    print(f"[kdv] validate(20000): rel_l2 {k_val['rel_l2']:.4e} max_error {k_val['max_error']:.4e} "
          f"(no bar at {k_steps} steps; the JAX rows reach < 1e-3 after 1500 epochs)", flush=True)
    k_p = {k: v.detach().requires_grad_(True) for k, v in k_net.items()}
    k_z = time_sorted(*kpde.generate_collocation_points(gen, 8192, "uniform"))
    compare("kdv_causal", "N=8192 trained params", k_p, k_z)

    # ---- 11. kdv syncs and timing ------------------------------------------ #
    n_sync_kdv, kdv_sites = count_syncs(ktrainer, kt.batch_size)
    print(f"[syncs] one warm KdV step (time sort included): {n_sync_kdv} {kdv_sites}; "
          f"uniform Burgers step {n_sync_uni}", flush=True)
    if n_sync_kdv > n_sync_uni:
        raise AssertionError(f"the KdV step makes {n_sync_kdv} host syncs, the uniform step {n_sync_uni}")
    kdv_ms = graph_ms(lambda: fused_grads(variants["kdv_causal"], k_p, k_z), iters=10, replays=5)
    kdv_plain_ms = graph_ms(lambda: plain_grads(variants["kdv_causal"], k_p, k_z), iters=10, replays=5)
    kdv_eager_ms = cuda_ms(lambda: fused_grads(variants["kdv_causal"], k_p, k_z), iters=20)
    print(f"[timing] fused_residual_loss KdV causal N=8192 (5 streams) loss+grads: kernel "
          f"{kdv_ms:.3f} ms, plain {kdv_plain_ms:.3f} ms (CUDA graph); eager calls, CUDA events: "
          f"kernel {kdv_eager_ms:.3f} ms ({card})", flush=True)
    plain_kcfg = kdv_recipe_config("cuda")
    plain_kcfg.training.fused_residual_kernel = "off"
    plain_ktrainer = PDETrainer(PINNModel(plain_kcfg, seed=0), create_pde(plain_kcfg), plain_kcfg)
    assert not plain_ktrainer.fused_kernel_active
    k_kernel_times, k_plain_times = [], []
    for order in ("plain", "kernel", "kernel", "plain"):
        if order == "kernel":
            k_kernel_times += step_times(ktrainer, 15, KDV_EPOCHS, kt.batch_size)
        else:
            with plain_fourier_features():
                k_plain_times += step_times(plain_ktrainer, 15, KDV_EPOCHS, kt.batch_size)
    print(f"[timing] KdV train step (batch 8192 causal, BC 4096, IC 4096), median of "
          f"{len(k_kernel_times)}: kernels {statistics.median(k_kernel_times):.3f} ms, plain path "
          f"{statistics.median(k_plain_times):.3f} ms ({card})", flush=True)

    # ---- 12. siren parity ------------------------------------------------- #
    from pinnrl_tpu_torch.ops.derivatives import directional_derivative

    scfg = siren_kdv_config("cuda")
    spde = create_pde(scfg)
    smodel = PINNModel(scfg, seed=0)
    sp = smodel.params
    n_layers = len(scfg.model.hidden_dims)
    omega = float(scfg.model.arch_params["omega_0"])
    if not (scfg.model.architecture == "siren" and tuple(scfg.model.hidden_dims) == (124,) * 7
            and omega == 30.0 and scfg.training.batch_size == 2048):
        raise AssertionError("the shipped KdV configuration is not the 124x7 SIREN at omega 30")
    s_x, s_t = spde.generate_collocation_points(gen, 5000, "uniform")
    s_in = [smodel.map_inputs(torch.cat([s_x, s_t], dim=-1))]
    with torch.no_grad():
        for i in range(2):  # the inputs the first two layers see
            s_in.append(siren.siren_layer_plain(s_in[-1], sp[f"SIRENLayer_{i}.kernel"],
                                                sp[f"SIRENLayer_{i}.bias"], omega))
    siren_cases = {"(2048,2)->124": (s_in[0][:2048], 0), "(2048,124)->124": (s_in[1][:2048], 1),
                   "(5000,124)->124": (s_in[1], 1)}
    siren_err = 0.0
    for tag, (xs, i) in siren_cases.items():
        W, b = sp[f"SIRENLayer_{i}.kernel"].detach(), sp[f"SIRENLayer_{i}.bias"].detach()
        with torch.no_grad():
            sk = siren.siren_layer(xs, W, b, omega)
            spl = siren.siren_layer_plain(xs, W, b, omega)
        torch.cuda.synchronize()
        err = float((sk - spl).abs().max())
        rel = err / float(spl.abs().max())
        siren_err = max(siren_err, err)
        print(f"[parity] siren_layer {tag} omega {omega:g}: max_abs_err {err:.3e} rel {rel:.3e} "
              f"(tol {SIREN_TOL:g})", flush=True)
        if not (tuple(sk.shape) == (xs.shape[0], 124) and rel < SIREN_TOL):
            raise AssertionError(f"siren_layer kernel disagrees with its plain version at {tag}")
    siren_blocks = siren.launch_blocks(2048, 124)
    print(f"[parity] siren_layer (2048,124)->124 launches {siren_blocks} blocks "
          f"((5000,124)->124: {siren.launch_blocks(5000, 124)}) for "
          f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs", flush=True)
    if siren_blocks < torch.cuda.get_device_properties(0).multi_processor_count:
        raise AssertionError(f"kernel 3 launches {siren_blocks} blocks, fewer than the card's SMs")

    hcfg = heat_recipe_config("cuda")
    hpde = create_pde(hcfg)
    hmodel = PINNModel(hcfg, seed=0)
    z_s = torch.cat([s_x, s_t], dim=-1)[:2048]
    z_h = torch.cat(hpde.generate_collocation_points(gen, 4096, "uniform"), dim=-1)
    for label, mdl, zz, plain in (("siren_layer", smodel, z_s, plain_siren),
                                  ("fourier_features", hmodel, z_h, plain_fourier_features)):
        u = make_scalar_fn(mdl.apply, {k: v.detach() for k, v in mdl.params.items()})
        with torch.no_grad():
            dk = directional_derivative(u, zz, 0, 3)
            with plain():
                dp = directional_derivative(u, zz, 0, 3)
        torch.cuda.synchronize()
        for k, (a, b) in enumerate(zip(dk, dp), start=1):
            rel = float((a - b).abs().max()) / float(b.abs().max())
            tol = JVP_TOL * 10 ** (k - 1)
            print(f"[parity] {label} jvp rule, order {k} d/dx of the {mdl.config.architecture} "
                  f"network ({zz.shape[0]} points): rel {rel:.3e} (tol {tol:g})", flush=True)
            if not rel < tol:
                raise AssertionError(f"{label}'s jvp rule disagrees at order {k}")

    def siren_residual_grads(p, zz):
        r = spde.compute_residual(smodel.apply, p, zz[:, :1], zz[:, 1:])
        loss = torch.mean(r * r)
        return loss, torch.autograd.grad(loss, list(p.values()))

    s_p = {k: v.detach().requires_grad_(True) for k, v in sp.items()}
    lk, gk_ = siren_residual_grads(s_p, z_s)
    with plain_siren():
        lp, gp_ = siren_residual_grads(s_p, z_s)
    torch.cuda.synchronize()
    worst, worst_name = 0.0, ""
    for pname, a, b in zip(s_p, gk_, gp_):
        rel = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        if rel > worst:
            worst, worst_name = rel, pname
    loss_rel = abs(float(lk.detach()) - float(lp.detach())) / abs(float(lp.detach()))
    print(f"[parity] order-3 KdV residual loss through kernel 3 (N=2048, 124x7): loss rel "
          f"{loss_rel:.3e}; worst gradient rel {worst:.3e} ({worst_name}, tol {SIREN_GRAD_TOL:g})",
          flush=True)
    if not (loss_rel < SIREN_GRAD_TOL and worst < SIREN_GRAD_TOL):
        raise AssertionError("the residual loss's gradients through kernel 3 disagree with plain")

    # ---- 13. siren-kdv slice ------------------------------------------------ #
    strainer = PDETrainer(smodel, spde, scfg)
    if strainer.fast_bundle_active or strainer.fused_kernel_active:
        raise AssertionError("the SIREN slice is not on the generic engine")
    st_ = scfg.training
    s_steps = SIREN_EPOCHS * (st_.num_collocation_points // st_.batch_size)
    s_vals = sum(1 for e in range(1, SIREN_EPOCHS + 1)
                 if e % st_.validation_frequency == 0 or e == SIREN_EPOCHS)
    # Per loss, the network is evaluated on u, on u_t (one jvp), on u_x, u_xx
    # and u_xxx (one nest of three jvps), on the BC and on the IC points: 5
    # evaluations, each through every layer.
    s_evals = 1 + 1 + 1 + 2
    siren.siren_layer.launches = 0
    fourier_feats.fourier_features.launches = 0
    fused_step.fused_residual_loss.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # Profiled: the device's own launches of kernel 3, by name in the trace.
    s_res, s_trace, _ = device_launches(lambda: strainer.train(seed=0))
    s_s = time.perf_counter() - t0
    siren_launches = siren.siren_layer.launches
    if not trace_agrees(s_trace["siren_layer"], siren_launches):
        raise AssertionError(f"SIREN slice: kernel 3 ran {s_trace['siren_layer']} times on the "
                             f"device, its counter says {siren_launches}")
    s_hist = s_res["history"]["train_loss"]
    print(f"[siren-kdv] generic engine (bundle {strainer.fast_bundle_active}, kernel 1 "
          f"{strainer.fused_kernel_active}); steps={s_steps} ({SIREN_EPOCHS} epochs x "
          f"{st_.num_collocation_points // st_.batch_size}, batch {st_.batch_size} of "
          f"{st_.num_collocation_points}, BC {st_.num_boundary_points}, IC {st_.num_initial_points}) "
          f"validations={s_vals} train {s_s:.2f} s; siren_layer launches {siren_launches} "
          f"(= {s_evals} evaluations x {n_layers} layers x {s_steps + s_vals} losses)", flush=True)
    print(f"[siren-kdv] epoch mean losses: {' '.join(f'{v:.4e}' for v in s_hist)}", flush=True)
    if len(s_hist) != SIREN_EPOCHS or not all(v == v and abs(v) != float("inf") for v in s_hist):
        raise AssertionError(f"SIREN slice: non-finite or missing losses: {s_hist}")
    if len(s_res["history"]["val_loss"]) != s_vals:
        raise AssertionError(f"SIREN slice: {len(s_res['history']['val_loss'])} validations, "
                             f"expected {s_vals}")
    if siren_launches != s_evals * n_layers * (s_steps + s_vals):
        raise AssertionError(f"siren_layer launched {siren_launches} times, expected "
                             f"{s_evals * n_layers * (s_steps + s_vals)}")
    if fused_step.fused_residual_loss.launches or fourier_feats.fourier_features.launches:
        raise AssertionError("the SIREN slice launched kernel 1 or kernel 2")
    s_net = strainer._final_state["params"]["net"]
    s_val = spde.validate(smodel.apply, s_net, num_points=20000)
    if not all(v == v for v in s_val.values()):
        raise AssertionError(f"SIREN slice: non-finite validation metrics {s_val}")
    print(f"[siren-kdv] validate(20000): rel_l2 {s_val['rel_l2']:.4e} max_error "
          f"{s_val['max_error']:.4e} (no bar at {s_steps} steps)", flush=True)
    # The shipped learning rate (5e-3) drives this network's loss up from the
    # first step, in the JAX package as here (tests/test_torch_kdv_siren.py
    # takes that step in both). Descent is checked at SIREN_DESCENT_LR, the
    # shipped configuration otherwise.
    dcfg = siren_kdv_config("cuda")
    dcfg.training.num_epochs = SIREN_DESCENT_EPOCHS
    dcfg.training.optimizer_config.learning_rate = SIREN_DESCENT_LR
    dtrainer = PDETrainer(PINNModel(dcfg, seed=0), create_pde(dcfg), dcfg)
    d_steps = SIREN_DESCENT_EPOCHS * (st_.num_collocation_points // st_.batch_size)
    d_vals = sum(1 for e in range(1, SIREN_DESCENT_EPOCHS + 1)
                 if e % st_.validation_frequency == 0 or e == SIREN_DESCENT_EPOCHS)
    siren.siren_layer.launches = 0
    d_res = dtrainer.train(seed=0)
    torch.cuda.synchronize()
    d_hist = d_res["history"]["train_loss"]
    print(f"[siren-kdv] lr {SIREN_DESCENT_LR:g}, {d_steps} steps, {d_vals} validation(s): epoch mean "
          f"losses {' '.join(f'{v:.4e}' for v in d_hist)}; siren_layer launches "
          f"{siren.siren_layer.launches}", flush=True)
    if not (all(v == v and abs(v) != float("inf") for v in d_hist) and d_hist[-1] < d_hist[0]):
        raise AssertionError(f"SIREN slice at lr {SIREN_DESCENT_LR:g}: loss did not fall: {d_hist}")
    if siren.siren_layer.launches != s_evals * n_layers * (d_steps + d_vals):
        raise AssertionError(f"SIREN descent check: siren_layer launched {siren.siren_layer.launches} "
                             f"times, expected {s_evals * n_layers * (d_steps + d_vals)}")

    # ---- 14. heat slice ------------------------------------------------------ #
    htrainer = PDETrainer(hmodel, hpde, hcfg)
    if not (htrainer.fused_kernel_active and "periodic" in hpde.boundary_conditions):
        raise AssertionError("the heat slice is not on kernel 1 with periodic BCs")
    ht = hcfg.training
    h_steps = HEAT_EPOCHS * (ht.num_collocation_points // ht.batch_size)
    h_vals = sum(1 for e in range(1, HEAT_EPOCHS + 1)
                 if e % ht.validation_frequency == 0 or e == HEAT_EPOCHS)
    fourier_feats.fourier_features.launches = 0
    fourier_feats.fourier_features.jvps = 0
    fused_step.fused_residual_loss.launches = 0
    siren.siren_layer.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h_res = htrainer.train(seed=0)
    torch.cuda.synchronize()
    h_s = time.perf_counter() - t0
    heat_launches = {"fused_residual_loss": fused_step.fused_residual_loss.launches,
                     "fourier_features": fourier_feats.fourier_features.launches,
                     "fourier_features_jvps": fourier_feats.fourier_features.jvps}
    h_hist = h_res["history"]["train_loss"]
    h_losses = h_steps + h_vals
    print(f"[heat] steps={h_steps} ({HEAT_EPOCHS} epochs x {ht.num_collocation_points // ht.batch_size}, "
          f"batch {ht.batch_size}, BC {ht.num_boundary_points} periodic, IC {ht.num_initial_points}) "
          f"validations={h_vals} train {h_s:.2f} s; {heat_launches}", flush=True)
    print(f"[heat] epoch mean losses: {' '.join(f'{v:.4e}' for v in h_hist)}", flush=True)
    if len(h_hist) != HEAT_EPOCHS or not all(v == v and abs(v) != float("inf") for v in h_hist):
        raise AssertionError(f"heat slice: non-finite or missing losses: {h_hist}")
    if not h_hist[-1] < h_hist[0]:
        raise AssertionError(f"heat slice: loss did not fall: first epoch {h_hist[0]}, last {h_hist[-1]}")
    want = {"fused_residual_loss": h_losses, "fourier_features": 2 * h_losses,
            "fourier_features_jvps": h_losses}
    if heat_launches != want or siren.siren_layer.launches:
        raise AssertionError(f"heat slice: launches {heat_launches}, expected {want}")
    h_net = htrainer._final_state["params"]["net"]
    h_val = hpde.validate(hmodel.apply, h_net, num_points=20000)
    if not all(v == v for v in h_val.values()):
        raise AssertionError(f"heat slice: non-finite validation metrics {h_val}")
    print(f"[heat] validate(20000): rel_l2 {h_val['rel_l2']:.4e} max_error {h_val['max_error']:.4e} "
          f"periodic_bc_error {h_val['periodic_bc_error']:.4e} (no bar at {h_steps} steps)", flush=True)

    # ---- 15. siren/heat syncs and timing -------------------------------------- #
    n_sync_s, s_sites = count_syncs(strainer, st_.batch_size)
    n_sync_h, h_sites = count_syncs(htrainer, ht.batch_size)
    print(f"[syncs] one warm step: SIREN KdV {n_sync_s} {s_sites}; heat {n_sync_h} {h_sites}; "
          f"uniform Burgers {n_sync_uni}", flush=True)
    if max(n_sync_s, n_sync_h) > n_sync_uni:
        raise AssertionError(f"host syncs per step: SIREN {n_sync_s}, heat {n_sync_h}, "
                             f"uniform {n_sync_uni}")
    xs3, W3, b3 = s_in[1][:2048], sp["SIRENLayer_1.kernel"].detach(), sp["SIRENLayer_1.bias"].detach()
    with torch.no_grad():
        siren_eager_ms = cuda_ms(lambda: siren.siren_layer(xs3, W3, b3, omega), iters=200)
        siren_ms = graph_ms(lambda: siren.siren_layer(xs3, W3, b3, omega))
        siren_plain_ms = graph_ms(lambda: siren.siren_layer_plain(xs3, W3, b3, omega))
        siren_lib_ms = graph_ms(lambda: torch.addmm(b3, xs3, W3))
    print(f"[timing] siren_layer (2048,124)->124, device time per call (CUDA graph): kernel "
          f"{siren_ms:.4f} ms, plain {siren_plain_ms:.4f} ms, cuBLAS addmm (product only) "
          f"{siren_lib_ms:.4f} ms; eager calls, CUDA events: kernel {siren_eager_ms:.4f} ms ({card})",
          flush=True)
    hv = variants["heat"]
    h_z = torch.cat(hpde.generate_collocation_points(gen, 8192, "uniform"), dim=-1)
    h_p = {k: v.detach().requires_grad_(True) for k, v in h_net.items()}
    compare("heat", "N=8192 trained params", h_p, h_z)
    heat_ms = graph_ms(lambda: fused_grads(hv, h_p, h_z), iters=10, replays=5)
    heat_plain_ms = graph_ms(lambda: plain_grads(hv, h_p, h_z), iters=10, replays=5)
    heat_eager_ms = cuda_ms(lambda: fused_grads(hv, h_p, h_z), iters=20)
    print(f"[timing] fused_residual_loss heat N=8192 loss+grads: kernel {heat_ms:.3f} ms, plain "
          f"{heat_plain_ms:.3f} ms (CUDA graph); eager calls, CUDA events: kernel "
          f"{heat_eager_ms:.3f} ms ({card})", flush=True)
    s_kernel_times, s_plain_times = [], []
    for order in ("plain", "kernel", "kernel", "plain"):
        if order == "kernel":
            s_kernel_times += step_times(strainer, 5, SIREN_EPOCHS, st_.batch_size)
        else:
            with plain_siren():
                s_plain_times += step_times(strainer, 5, SIREN_EPOCHS, st_.batch_size)
    print(f"[timing] SIREN KdV train step (124x7, batch 2048, BC 5000, IC 5000), median of "
          f"{len(s_kernel_times)}: kernels {statistics.median(s_kernel_times):.3f} ms, plain path "
          f"{statistics.median(s_plain_times):.3f} ms ({card})", flush=True)
    plain_hcfg = heat_recipe_config("cuda")
    plain_hcfg.training.fused_residual_kernel = "off"
    plain_htrainer = PDETrainer(PINNModel(plain_hcfg, seed=0), create_pde(plain_hcfg), plain_hcfg)
    assert not plain_htrainer.fused_kernel_active
    h_kernel_times, h_plain_times = [], []
    for order in ("plain", "kernel", "kernel", "plain"):
        if order == "kernel":
            h_kernel_times += step_times(htrainer, 15, HEAT_EPOCHS, ht.batch_size)
        else:
            with plain_fourier_features():
                h_plain_times += step_times(plain_htrainer, 15, HEAT_EPOCHS, ht.batch_size)
    print(f"[timing] heat train step (batch 8192, periodic BC 4096, IC 4096), median of "
          f"{len(h_kernel_times)}: kernels {statistics.median(h_kernel_times):.3f} ms, plain path "
          f"{statistics.median(h_plain_times):.3f} ms ({card})", flush=True)

    # ---- 16. gemm: the core against cuBLAS ------------------------------------ #
    core_ops = fused_step._cuda_ops(dev)
    gemm_sum = {}
    for pde_name, x_order, gparams in (("burgers", 2, variants["burgers"].model.params),
                                       ("kdv", 3, variants["kdv_causal"].model.params)):
        prods = gemm_products(gparams, x_order, 8192)
        ops_ = [gemm_operands(kind, shape, gen, dev) for kind, shape in prods]
        routes = [gemm_routes(kind, P, Q, core_ops) for (kind, _), (P, Q) in zip(prods, ops_)]
        errs = []
        for (kind, (M, K, N)), (P, Q), fns in zip(prods, ops_, routes):
            P64, Q64 = P.double(), Q.double()
            ref = {"fwd": lambda: P64 @ Q64.t(), "dx": lambda: P64 @ Q64,
                   "dw": lambda: P64.t() @ Q64}[kind]()
            scale = float(ref.abs().max())
            got = [float((f().double() - ref).abs().max()) / scale for f in fns]
            errs.append(got)
            tol = gemm_tol(K)
            if not max(got) < tol:
                raise AssertionError(f"GEMM {pde_name} {kind} {M}x{K}x{N}: rel err (core, cuBLAS) "
                                     f"{got} above {tol:g}")
        ms = {r: [0.0] * len(prods) for r in ("new", "lib")}
        for route in ("new", "lib", "lib", "new"):
            col = ("new", "lib").index(route)
            for i, fns in enumerate(routes):
                ms[route][i] += graph_ms(fns[col], iters=10, replays=5) / 2.0
        torch.cuda.synchronize()
        for i, (kind, (M, K, N)) in enumerate(prods):
            large = min(M, K, N) > 1
            print(f"[gemm] {pde_name} {kind} {M}x{K}x{N}{'' if large else ' (row pass)'}: core "
                  f"{ms['new'][i]:.4f} ms, cuBLAS {ms['lib'][i]:.4f} ms; rel err core "
                  f"{errs[i][0]:.2e} cuBLAS {errs[i][1]:.2e} (tol {gemm_tol(K):g})", flush=True)
        gemm_sum[pde_name] = {r: sum(v) for r, v in ms.items()}
        print(f"[gemm] {pde_name} N=8192, {len(prods)} products summed: core "
              f"{gemm_sum[pde_name]['new']:.4f} ms, cuBLAS {gemm_sum[pde_name]['lib']:.4f} ms "
              f"({card})", flush=True)
        del ops_, routes

    # ---- 17. lbfgs: the recipes as shipped, Adam then L-BFGS -------------------- #
    from pinnrl_tpu_torch.benchmarks.convergence import build_recipe_config, run_convergence
    from pinnrl_tpu_torch.training.lbfgs import LBFGS

    lbfgs_runs = {}
    for key, epochs in LBFGS_EPOCHS.items():
        rt = build_recipe_config(key, epochs=epochs, device="cuda").training
        switch = int(rt.adam_lbfgs_switch_ratio * epochs)
        adam_steps = switch * (rt.num_collocation_points // rt.batch_size)
        fused_step.fused_residual_loss.launches = 0
        fourier_feats.fourier_features.launches = 0
        fourier_feats.fourier_features.jvps = 0
        evals0, reads0 = LBFGS.evaluations, LBFGS.host_reads
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with captured_trainers() as seen:
            conv = run_convergence(key, seed=0, epochs=epochs, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run = {"fused_residual_loss": fused_step.fused_residual_loss.launches,
               "fourier_features": fourier_feats.fourier_features.launches,
               "fourier_features_jvps": fourier_feats.fourier_features.jvps,
               "evaluations": LBFGS.evaluations - evals0, "host_reads": LBFGS.host_reads - reads0}
        (ltr,) = seen
        hist = ltr.history
        losses, n_vals = hist["train_loss"], len(hist["val_loss"])
        lbfgs_losses = losses[switch:]
        print(f"[lbfgs] {key}: run_convergence(seed=0, epochs={epochs}) {wall:.2f} s: "
              f"{rt.collocation_distribution} Adam {switch} epochs ({adam_steps} steps of "
              f"{rt.batch_size}), then {len(lbfgs_losses)} L-BFGS iterations on "
              f"{rt.num_collocation_points} points; validations {n_vals}; {run}", flush=True)
        print(f"[lbfgs] {key}: epoch losses {' '.join(f'{v:.6e}' for v in losses)}; "
              f"rel_l2 {conv.rel_l2:.4e} max_error {conv.max_error:.4e} (no bar at {epochs} "
              f"epochs); points/s {conv.points_per_sec:.0f} ({card})", flush=True)
        if not (ltr.switch_epoch == switch and len(losses) == epochs and len(lbfgs_losses) > 0):
            raise AssertionError(f"{key}: switch {ltr.switch_epoch}, {len(losses)} epochs")
        if not (ltr.fused_kernel_active and all(map(math.isfinite, losses + hist["val_loss"]))):
            raise AssertionError(f"{key}: kernel 1 off or non-finite losses {losses}")
        for a, b in zip(lbfgs_losses, lbfgs_losses[1:]):
            if not b <= a + APPROX_DEC_RTOL * abs(a):
                raise AssertionError(f"{key}: the L-BFGS loss rose within its round: {lbfgs_losses}")
        want = adam_steps + run["evaluations"] + n_vals
        if run["fused_residual_loss"] != want:
            raise AssertionError(f"{key}: kernel 1 launched {run['fused_residual_loss']} times, want "
                                 f"{adam_steps} Adam steps + {run['evaluations']} L-BFGS evaluations "
                                 f"+ {n_vals} validations = {want}")
        # The phase replays its iterations: the search reads nothing (the
        # chunk's one read is phase 47's check).
        if run["evaluations"] < 2 * len(lbfgs_losses) or run["host_reads"] != 0:
            raise AssertionError(f"{key}: {run['evaluations']} evaluations and {run['host_reads']} "
                                 f"search host reads in {len(lbfgs_losses)} iterations")
        if key == "heat" and run["fourier_features_jvps"] != want:
            raise AssertionError(f"heat: kernel 2's jvp rule ran {run['fourier_features_jvps']} "
                                 f"times, want one per loss ({want})")
        if not all(math.isfinite(v) for v in (conv.rel_l2, conv.max_error, conv.points_per_sec)):
            raise AssertionError(f"{key}: non-finite result {conv}")
        lbfgs_runs[key] = (run, ltr)

    # ---- 18. lbfgs timing ------------------------------------------------------ #
    lt = lbfgs_runs["burgers"][1]
    lbatch = lt._lbfgs_batch(0, 0, LBFGS_N)
    plain_lcfg = build_recipe_config("burgers", epochs=LBFGS_EPOCHS["burgers"], device="cuda")
    plain_lcfg.training.fused_residual_kernel = "off"
    plain_lmodel = PINNModel(plain_lcfg, seed=0)
    plain_lmodel.module.load_state_dict(lt.model.module.state_dict())
    plain_lt = PDETrainer(plain_lmodel, create_pde(plain_lcfg), plain_lcfg)
    assert lt.fused_kernel_active and not plain_lt.fused_kernel_active
    it_ms = {"kernels": [], "plain": []}
    it_evals = {"kernels": [], "plain": []}
    for order in ("plain", "kernels", "kernels", "plain"):
        with plain_fourier_features() if order == "plain" else contextlib.nullcontext():
            times, evals = lbfgs_iteration_times(plain_lt if order == "plain" else lt, lbatch,
                                                 LBFGS_TIMED)
        it_ms[order] += times
        it_evals[order].append(evals)
    lbfgs_ms = {k: statistics.median(v) for k, v in it_ms.items()}
    lbfgs_evals = {k: sum(v) / len(v) for k, v in it_evals.items()}
    sopt = lt._make_lbfgs(list(lt.model.params.values()))
    sgen = torch.Generator(device=dev).manual_seed(5)
    lt._lbfgs_step(lt.model.params, sopt, lbatch, sgen)  # warm: the ring holds a pair
    evals0, reads0 = LBFGS.evaluations, LBFGS.host_reads
    sync_sites = record_syncs(lambda: lt._lbfgs_step(lt.model.params, sopt, lbatch, sgen))
    sync_evals, sync_reads = LBFGS.evaluations - evals0, LBFGS.host_reads - reads0
    print(f"[lbfgs timing] one L-BFGS iteration (N={LBFGS_N}, BC/IC 4096, memory 50), median of "
          f"{len(it_ms['kernels'])}: kernels {lbfgs_ms['kernels']:.3f} ms, plain path "
          f"{lbfgs_ms['plain']:.3f} ms; evaluations per iteration: kernels "
          f"{lbfgs_evals['kernels']:.2f}, plain {lbfgs_evals['plain']:.2f} ({card})", flush=True)
    print(f"[syncs] one warm L-BFGS iteration: {len(sync_sites)} {sorted(set(sync_sites))}; "
          f"{sync_evals} evaluations, {sync_reads} host reads", flush=True)
    if len(sync_sites) != sync_reads or not eager_search_reads(sync_reads, sync_evals):
        raise AssertionError(f"an L-BFGS iteration made {len(sync_sites)} host syncs for "
                             f"{sync_evals} evaluations and {sync_reads} host reads")
    v = variants["burgers"]
    z40 = parity_z[f"burgers_{LBFGS_N}"]
    p40 = {k: p.detach().requires_grad_(True) for k, p in v.model.params.items()}
    n40_ms = graph_ms(lambda: fused_grads(v, p40, z40), iters=5, replays=5)
    n40_plain_ms = graph_ms(lambda: plain_grads(v, p40, z40), iters=5, replays=5)
    n40_shapes = fused_gemms(v.model.params, 2, LBFGS_N)
    n40_bound = bound(sum(2.0 * m * k * n for m, k, n in n40_shapes),
                      4.0 * (z40.numel() + 2 * sum(p.numel() for p in p40.values()) + B.numel() + 1))
    n40_lib_ms = cublas_ms(n40_shapes, dev, iters=5)
    print(f"[timing] fused_residual_loss Burgers N={LBFGS_N} loss+grads, device time per call (CUDA "
          f"graph): kernel {n40_ms:.3f} ms, plain {n40_plain_ms:.3f} ms, bound {n40_bound[0]:.3f} ms "
          f"({n40_bound[1]}; {n40_bound[0] / n40_ms:.0%} of it), cuBLAS on its {len(n40_shapes)} "
          f"products {n40_lib_ms:.3f} ms ({card})", flush=True)
    del p40, plain_lt, plain_lmodel

    # ---- 19. kernel 1's one-dimensional scope ---------------------------------- #
    def bit_identical(v, p, zz):
        (l1, g1), (l2, g2) = (fused_grads(v, p, zz) for _ in range(2))
        return torch.equal(l1, l2) and all(torch.equal(a, b) for a, b in zip(g1, g2))

    scope = {}
    for name in SCOPE_VARIANTS:
        v = variants[name] = variant(scope_variant_config(name, "cuda"))
        x_order, B_v = max(v.pde.spatial_orders), v.model.constants.get("FourierFeatures_0.B")
        p = {k: t_.detach().requires_grad_(True) for k, t_ in v.model.params.items()}
        row = scope[name] = {"streams": 2 + x_order, "trunk": v.model.config.architecture,
                             "widths": list(v.model.config.hidden_dims)}
        for n in ((8192,) if name == "black_scholes_ff" else (8192, LBFGS_N)):
            zz = time_sorted(*v.pde.generate_collocation_points(gen, n, "uniform"))
            compare(name, f"N={n} seeded init", p, zz)
            same = bit_identical(v, p, zz)
            print(f"[scope] fused_residual_loss {name} N={n}: two calls on the same inputs "
                  f"bit-identical {same}", flush=True)
            if not same:
                raise AssertionError(f"kernel 1 ({name}, N={n}) is not deterministic")
            if n != 8192 and name.endswith("_causal"):
                continue  # the L-BFGS batch is timed for the recipes as shipped (not causal)
            tag = "" if n == 8192 else f"n{n}_"
            iters = 10 if n == 8192 else 5
            row[f"{tag}ms"] = graph_ms(lambda: fused_grads(v, p, zz), iters=iters, replays=5)
            row[f"{tag}plain_ms"] = graph_ms(lambda: plain_grads(v, p, zz), iters=iters, replays=5)
            row[f"{tag}bound_ms"], row[f"{tag}bound_by"] = kernel1_bound(p, x_order, zz, B_v)
            shapes = fused_gemms(p, x_order, n)
            row[f"{tag}library_ms"] = cublas_ms(shapes, dev, iters=iters)
            print(f"[timing] fused_residual_loss {name} N={n} ({row['streams']} streams, "
                  f"{row['trunk']} {row['widths']}) loss+grads, device time per call (CUDA graph): "
                  f"kernel {row[f'{tag}ms']:.3f} ms, plain {row[f'{tag}plain_ms']:.3f} ms, bound "
                  f"{row[f'{tag}bound_ms']:.3f} ms ({row[f'{tag}bound_by']}; "
                  f"{row[f'{tag}bound_ms'] / row[f'{tag}ms']:.0%} of it), cuBLAS on its "
                  f"{len(shapes)} products {row[f'{tag}library_ms']:.3f} ms ({card})", flush=True)
        del p

    # ---- 20. the new recipes, Adam then L-BFGS, and Black-Scholes as shipped ---- #
    scope_runs = {}
    for key in SCOPE_RECIPES:
        rt = build_recipe_config(key, epochs=SCOPE_RECIPE_EPOCHS, device="cuda").training
        switch = int(rt.adam_lbfgs_switch_ratio * SCOPE_RECIPE_EPOCHS)
        adam_steps = switch * (rt.num_collocation_points // rt.batch_size)
        fused_step.fused_residual_loss.launches = 0
        fourier_feats.fourier_features.launches = 0
        fourier_feats.fourier_features.jvps = 0
        evals0 = LBFGS.evaluations
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with captured_trainers() as seen:
            conv = run_convergence(key, seed=0, epochs=SCOPE_RECIPE_EPOCHS, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run = {"fused_residual_loss": fused_step.fused_residual_loss.launches,
               "fourier_features": fourier_feats.fourier_features.launches,
               "fourier_features_jvps": fourier_feats.fourier_features.jvps,
               "evaluations": LBFGS.evaluations - evals0}
        (ltr,) = seen
        hist = ltr.history
        losses, n_vals = hist["train_loss"], len(hist["val_loss"])
        lbfgs_losses = losses[switch:]
        periodic = "periodic" in ltr.pde.boundary_conditions
        n_losses = adam_steps + run["evaluations"] + n_vals
        # Per loss: kernel 1 once; kernel 2 on the BC (or periodic faces) and
        # the IC points, and its jvp rule once where the BC is periodic; one
        # more kernel-2 launch for run_convergence's validate(20000).
        want = {"fused_residual_loss": n_losses, "fourier_features": 2 * n_losses + 1,
                "fourier_features_jvps": n_losses if periodic else 0}
        print(f"[scope] {key}: run_convergence(seed=0, epochs={SCOPE_RECIPE_EPOCHS}) {wall:.2f} s: "
              f"Adam {switch} epochs ({adam_steps} steps of {rt.batch_size}), then "
              f"{len(lbfgs_losses)} L-BFGS iterations on {rt.num_collocation_points} points; "
              f"validations {n_vals}; {run} ({card})", flush=True)
        print(f"[scope] {key}: epoch losses {' '.join(f'{x_:.6e}' for x_ in losses)}; rel_l2 "
              f"{conv.rel_l2:.4e} max_error {conv.max_error:.4e} (no bar at "
              f"{SCOPE_RECIPE_EPOCHS} epochs)", flush=True)
        if not (ltr.switch_epoch == switch and len(losses) == SCOPE_RECIPE_EPOCHS
                and ltr.fused_kernel_active and all(map(math.isfinite, losses + hist["val_loss"]))):
            raise AssertionError(f"{key}: switch {ltr.switch_epoch}, kernel 1 "
                                 f"{ltr.fused_kernel_active}, losses {losses}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"{key}: the loss did not fall: {losses}")
        for a, b in zip(lbfgs_losses, lbfgs_losses[1:]):
            if not b <= a + APPROX_DEC_RTOL * abs(a):
                raise AssertionError(f"{key}: the L-BFGS loss rose within its round: {lbfgs_losses}")
        if any(run[k] != w for k, w in want.items()):
            raise AssertionError(f"{key}: launches {run}, want {want} ({adam_steps} Adam steps + "
                                 f"{run['evaluations']} L-BFGS evaluations + {n_vals} validations)")
        if not all(math.isfinite(x_) for x_ in (conv.rel_l2, conv.max_error, conv.points_per_sec)):
            raise AssertionError(f"{key}: non-finite result {conv}")
        scope_runs[key] = {**run, "rel_l2": conv.rel_l2, "wall_s": wall}

    bs_cfg = load_config(pde_type="black_scholes", device="cuda")
    bs_t = bs_cfg.training
    bs_t.num_epochs = SHIPPED_BS_EPOCHS
    bs_trainer = PDETrainer(PINNModel(bs_cfg, seed=0), create_pde(bs_cfg), bs_cfg)
    if not (bs_trainer.fused_kernel_active and bs_cfg.model.architecture == "feedforward"):
        raise AssertionError("Black-Scholes as shipped is not on kernel 1's feedforward path")
    bs_steps = SHIPPED_BS_EPOCHS * (bs_t.num_collocation_points // bs_t.batch_size)
    bs_vals = sum(1 for e in range(1, SHIPPED_BS_EPOCHS + 1)
                  if e % bs_t.validation_frequency == 0 or e == SHIPPED_BS_EPOCHS)
    fused_step.fused_residual_loss.launches = 0
    fourier_feats.fourier_features.launches = 0
    bs_hist = bs_trainer.train(seed=0)["history"]["train_loss"]
    torch.cuda.synchronize()
    bs_run = {"fused_residual_loss": fused_step.fused_residual_loss.launches,
              "fourier_features": fourier_feats.fourier_features.launches}
    print(f"[scope] black_scholes as shipped (feedforward {list(bs_cfg.model.hidden_dims)}, "
          f"LayerNorm {bs_cfg.model.layer_norm}, batch {bs_t.batch_size} of "
          f"{bs_t.num_collocation_points}): {bs_steps} Adam steps, {bs_vals} validations; {bs_run}; "
          f"epoch losses {' '.join(f'{x_:.6e}' for x_ in bs_hist)}", flush=True)
    if bs_run != {"fused_residual_loss": bs_steps + bs_vals, "fourier_features": 0}:
        raise AssertionError(f"black_scholes as shipped: launches {bs_run}, want "
                             f"{bs_steps + bs_vals} of kernel 1 and none of kernel 2")
    # Shipped, the residual reads calendar time against a payoff IC at t = 0
    # (pdes/black_scholes.py) and Adam runs at lr 5e-3: its loss wanders over
    # a few steps, so only finiteness is checked here.
    if not all(map(math.isfinite, bs_hist)):
        raise AssertionError(f"black_scholes as shipped: losses {bs_hist}")
    scope_runs["black_scholes_shipped"] = bs_run

    # ---- 21. kernel 1 beyond one dimension and in a co-moving frame ------------ #
    scope_nd = {}
    for name in ND_VARIANTS + ND_SMALL:
        v = variants[name] = variant(nd_variant_config(name, "cuda"))
        dim, x_order = v.pde.dimension, max(v.pde.spatial_orders)
        B_v = v.model.constants.get("FourierFeatures_0.B")
        p = {k: t_.detach().requires_grad_(True) for k, t_ in v.model.params.items()}
        row = scope_nd[name] = {"dimension": dim, "streams": 2 + dim * x_order,
                                "frame_speed": v.model._frame_speed,
                                "trunk": v.model.config.architecture,
                                "widths": list(v.model.config.hidden_dims)}
        sizes = (8192, LBFGS_N) if name == "heat_2d" else (ND_SMALL_N if name in ND_SMALL else 8192,)
        for n in sizes:
            zz = time_sorted(*v.pde.generate_collocation_points(gen, n, "uniform"))
            compare(name, f"N={n} seeded init", p, zz)
            same = bit_identical(v, p, zz)
            print(f"[nd] fused_residual_loss {name} N={n}: two calls on the same inputs "
                  f"bit-identical {same}", flush=True)
            if not same:
                raise AssertionError(f"kernel 1 ({name}, N={n}) is not deterministic")
            if name in ND_SMALL:
                continue  # checked, not timed: not a shipped shape
            tag = "" if n == 8192 else f"n{n}_"
            iters = 10 if n == 8192 else 5
            row[f"{tag}ms"] = graph_ms(lambda: fused_grads(v, p, zz), iters=iters, replays=5)
            row[f"{tag}plain_ms"] = graph_ms(lambda: plain_grads(v, p, zz), iters=iters, replays=5)
            row[f"{tag}bound_ms"], row[f"{tag}bound_by"] = kernel1_bound(p, x_order, zz, B_v, dim)
            shapes = fused_gemms(p, x_order, n, dim)
            row[f"{tag}library_ms"] = cublas_ms(shapes, dev, iters=iters)
            print(f"[timing] fused_residual_loss {name} N={n} ({row['streams']} streams, "
                  f"{row['trunk']} {row['widths']}, frame {row['frame_speed']}) loss+grads, device "
                  f"time per call (CUDA graph): kernel {row[f'{tag}ms']:.3f} ms, plain "
                  f"{row[f'{tag}plain_ms']:.3f} ms, bound {row[f'{tag}bound_ms']:.3f} ms "
                  f"({row[f'{tag}bound_by']}; {row[f'{tag}bound_ms'] / row[f'{tag}ms']:.0%} of it), "
                  f"cuBLAS on its {len(shapes)} products {row[f'{tag}library_ms']:.3f} ms ({card})",
                  flush=True)
        del p

    # ---- 22. the heat_2d recipe, Adam then L-BFGS ------------------------------- #
    rt = build_recipe_config("heat_2d", epochs=HEAT_2D_EPOCHS, device="cuda").training
    switch = int(rt.adam_lbfgs_switch_ratio * HEAT_2D_EPOCHS)
    adam_steps = switch * (rt.num_collocation_points // rt.batch_size)
    fused_step.fused_residual_loss.launches = 0
    fourier_feats.fourier_features.launches = 0
    fourier_feats.fourier_features.jvps = 0
    evals0 = LBFGS.evaluations
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with captured_trainers() as seen:
        conv = run_convergence("heat_2d", seed=0, epochs=HEAT_2D_EPOCHS, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    heat_2d_run = {"fused_residual_loss": fused_step.fused_residual_loss.launches,
                   "fourier_features": fourier_feats.fourier_features.launches,
                   "fourier_features_jvps": fourier_feats.fourier_features.jvps,
                   "evaluations": LBFGS.evaluations - evals0}
    (ltr,) = seen
    hist = ltr.history
    losses, n_vals = hist["train_loss"], len(hist["val_loss"])
    lbfgs_losses = losses[switch:]
    B2 = ltr.model.constants["FourierFeatures_0.B"]
    n_losses = adam_steps + heat_2d_run["evaluations"] + n_vals
    # Per loss: kernel 1 once; kernel 2 on the (N, 3) BC and IC points (the
    # Dirichlet box, no jvp); two more kernel-2 launches for validate(20000)
    # (heat's metrics and its NaN and bound checks each run the network).
    want = {"fused_residual_loss": n_losses, "fourier_features": 2 * n_losses + 2,
            "fourier_features_jvps": 0}
    print(f"[heat_2d] run_convergence(seed=0, epochs={HEAT_2D_EPOCHS}) {wall:.2f} s: Adam {switch} "
          f"epochs ({adam_steps} steps of {rt.batch_size}), then {len(lbfgs_losses)} L-BFGS "
          f"iterations on {rt.num_collocation_points} points; validations {n_vals}; kernel 2's "
          f"basis {tuple(B2.shape)}; {heat_2d_run} ({card})", flush=True)
    print(f"[heat_2d] epoch losses {' '.join(f'{x_:.6e}' for x_ in losses)}; rel_l2 "
          f"{conv.rel_l2:.4e} max_error {conv.max_error:.4e} (no bar at {HEAT_2D_EPOCHS} epochs)",
          flush=True)
    if not (ltr.switch_epoch == switch and len(losses) == HEAT_2D_EPOCHS
            and ltr.fused_kernel_active and ltr.pde.dimension == 2 and tuple(B2.shape) == (3, 128)
            and all(map(math.isfinite, losses + hist["val_loss"]))):
        raise AssertionError(f"heat_2d: switch {ltr.switch_epoch}, kernel 1 "
                             f"{ltr.fused_kernel_active}, basis {tuple(B2.shape)}, losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"heat_2d: the loss did not fall: {losses}")
    for a, b in zip(lbfgs_losses, lbfgs_losses[1:]):
        if not b <= a + APPROX_DEC_RTOL * abs(a):
            raise AssertionError(f"heat_2d: the L-BFGS loss rose within its round: {lbfgs_losses}")
    if any(heat_2d_run[k] != w for k, w in want.items()):
        raise AssertionError(f"heat_2d: launches {heat_2d_run}, want {want} ({adam_steps} Adam "
                             f"steps + {heat_2d_run['evaluations']} L-BFGS evaluations + {n_vals} "
                             f"validations)")
    if not all(math.isfinite(x_) for x_ in (conv.rel_l2, conv.max_error, conv.points_per_sec)):
        raise AssertionError(f"heat_2d: non-finite result {conv}")
    heat_2d_run.update(rel_l2=conv.rel_l2, wall_s=wall)

    # ---- 23. wave and the pendulums: temporal order 2, Adam then L-BFGS -------- #
    # Float64 parameters take the plain path (kernel 1 refuses them), float32
    # points and all, as the JAX package gates its kernel.
    f64_tr = lbfgs_runs["burgers"][1]
    p64 = {k: t_.detach().double() for k, t_ in f64_tr.model.params.items()}
    x64, t64 = f64_tr.pde.generate_collocation_points(gen, 8192, "uniform")
    fused_step.fused_residual_loss.launches = 0
    l64 = f64_tr.pde.compute_loss(f64_tr.model.apply, p64, x64, t64,
                                  generator=torch.Generator(device=dev).manual_seed(0))
    r64 = f64_tr.pde._residual_loss(f64_tr.pde.compute_residual(f64_tr.model.apply, p64, x64, t64),
                                    t64)
    torch.cuda.synchronize()
    f64_rel = abs(float(l64["residual"]) - float(r64)) / abs(float(r64))
    f64_launches = fused_step.fused_residual_loss.launches
    print(f"[second-order] Burgers recipe, float64 parameters and float32 points: kernel 1 "
          f"launched {f64_launches} times; residual loss "
          f"{float(l64['residual']):.6e} ({l64['residual'].dtype}) against the plain path's: rel "
          f"{f64_rel:.3e} (tol {F64_TOL:g})", flush=True)
    if not (f64_launches == 0 and l64["residual"].dtype == torch.float64
            and f64_rel < F64_TOL and all(math.isfinite(float(v)) for v in l64.values())):
        raise AssertionError("float64 parameters did not take the plain path")
    del p64, l64, r64

    # Kernel 2 at the pendulum recipes' shape: the IC points (4096, 2) on the
    # basis whose x-row is zero (scale (0, 1)); forward, and its jvp rule
    # along t at orders 1-2 through the network, each against its plain
    # version.
    pcfg = build_recipe_config("pendulum_nonlinear", device="cuda")
    ppde, pmodel = create_pde(pcfg), PINNModel(pcfg, seed=0)
    Bp = pmodel.constants["FourierFeatures_0.B"]
    zp = torch.cat(ppde._sample_initial_points(gen, 4096), dim=-1)
    xp = pmodel.map_inputs(zp)
    with torch.no_grad():
        fk = fourier_feats.fourier_features(xp, Bp, True)
        fp = fourier_feats.fourier_features_plain(xp, Bp, True)
    torch.cuda.synchronize()
    zero_row = not bool(Bp[0].any())
    ff0_err = float((fk - fp).abs().max())
    ff0_rel = ff0_err / float(fp.abs().max())
    print(f"[second-order] fourier_features (4096,2)x(2,128), the x-row of B zero {zero_row}: "
          f"max_abs_err {ff0_err:.3e} rel {ff0_rel:.3e} (tol {FF_TOL:g})", flush=True)
    if not (zero_row and tuple(Bp.shape) == (2, 128) and ff0_rel < FF_TOL):
        raise AssertionError("fourier_features disagrees with its plain version on the zero x-row")
    ff_err = max(ff_err, ff0_err)
    up = make_scalar_fn(pmodel.apply, {k: v.detach() for k, v in pmodel.params.items()})
    with torch.no_grad():
        dk = directional_derivative(up, zp, 1, 2)
        with plain_fourier_features():
            dp = directional_derivative(up, zp, 1, 2)
    torch.cuda.synchronize()
    for k, (a, b) in enumerate(zip(dk, dp), start=1):
        rel = float((a - b).abs().max()) / float(b.abs().max())
        tol = JVP_TOL * 10 ** (k - 1)
        print(f"[second-order] fourier_features jvp rule, order {k} d/dt of the pendulum recipe's "
              f"network (4096 IC points): rel {rel:.3e} (tol {tol:g})", flush=True)
        if not rel < tol:
            raise AssertionError(f"fourier_features's jvp rule disagrees at order {k} (zero x-row)")
    ff0 = {"ms": graph_ms(lambda: fourier_feats.fourier_features(xp, Bp, True)),
           "plain_ms": graph_ms(lambda: fourier_feats.fourier_features_plain(xp, Bp, True))}
    ff0["bound_ms"], ff0["bound_by"] = bound(2.0 * 4096 * 2 * 128 + 3.0 * 4096 * 128,
                                             4.0 * (4096 * 2 + 2 * 128 + 2 * 4096 * 128))
    print(f"[timing] fourier_features (4096,2)x(2,128) zero x-row, device time per call (CUDA "
          f"graph): kernel {ff0['ms']:.5f} ms, plain {ff0['plain_ms']:.5f} ms, bound "
          f"{ff0['bound_ms']:.5f} ms ({card})", flush=True)
    del ppde, pmodel

    second_runs = {}
    for key in SECOND_ORDER_RECIPES:
        rt = build_recipe_config(key, epochs=SECOND_ORDER_EPOCHS, device="cuda").training
        switch = int(rt.adam_lbfgs_switch_ratio * SECOND_ORDER_EPOCHS)
        adam_steps = switch * (rt.num_collocation_points // rt.batch_size)
        fused_step.fused_residual_loss.launches = 0
        fourier_feats.fourier_features.launches = 0
        fourier_feats.fourier_features.jvps = 0
        evals0, reads0 = LBFGS.evaluations, LBFGS.host_reads
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with captured_trainers() as seen:
            conv = run_convergence(key, seed=0, epochs=SECOND_ORDER_EPOCHS, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run = {"fused_residual_loss": fused_step.fused_residual_loss.launches,
               "fourier_features": fourier_feats.fourier_features.launches,
               "fourier_features_jvps": fourier_feats.fourier_features.jvps,
               "evaluations": LBFGS.evaluations - evals0, "host_reads": LBFGS.host_reads - reads0}
        (ltr,) = seen
        hist = ltr.history
        losses, n_vals = hist["train_loss"], len(hist["val_loss"])
        lbfgs_losses = losses[switch:]
        n_losses = adam_steps + run["evaluations"] + n_vals
        # Per loss: kernel 2 on the BC, the IC and the velocity IC's points,
        # its jvp rule once (the velocity IC's u_t); the residual runs on the
        # plain bundle (kernel 1 refuses temporal order 2); one more kernel-2
        # launch for run_convergence's validate(20000).
        want = {"fused_residual_loss": 0, "fourier_features": 3 * n_losses + 1,
                "fourier_features_jvps": n_losses}
        print(f"[second-order] {key}: run_convergence(seed=0, epochs={SECOND_ORDER_EPOCHS}) "
              f"{wall:.2f} s: Adam {switch} epochs ({adam_steps} steps of {rt.batch_size}), then "
              f"{len(lbfgs_losses)} L-BFGS iterations on {rt.num_collocation_points} points; "
              f"validations {n_vals}; {run} ({card})", flush=True)
        print(f"[second-order] {key}: epoch losses {' '.join(f'{x_:.6e}' for x_ in losses)}; "
              f"rel_l2 {conv.rel_l2:.4e} max_error {conv.max_error:.4e} (no bar at "
              f"{SECOND_ORDER_EPOCHS} epochs)", flush=True)
        if not (ltr.switch_epoch == switch and len(losses) == SECOND_ORDER_EPOCHS
                and ltr.fast_bundle_active and not ltr.fused_kernel_active
                and all(map(math.isfinite, losses + hist["val_loss"]))):
            raise AssertionError(f"{key}: switch {ltr.switch_epoch}, bundle {ltr.fast_bundle_active}, "
                                 f"kernel 1 {ltr.fused_kernel_active}, losses {losses}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"{key}: the loss did not fall: {losses}")
        for a, b in zip(lbfgs_losses, lbfgs_losses[1:]):
            if not b <= a + APPROX_DEC_RTOL * abs(a):
                raise AssertionError(f"{key}: the L-BFGS loss rose within its round: {lbfgs_losses}")
        if any(run[k] != w for k, w in want.items()) or run["host_reads"] != 0:
            raise AssertionError(f"{key}: launches {run}, want {want} ({adam_steps} Adam steps + "
                                 f"{run['evaluations']} L-BFGS evaluations + {n_vals} validations)")
        if not all(math.isfinite(x_) for x_ in (conv.rel_l2, conv.max_error, conv.points_per_sec)):
            raise AssertionError(f"{key}: non-finite result {conv}")

        # Launches of one Adam step, one L-BFGS iteration and one validate,
        # each counted alone.
        lbatch = ltr._lbfgs_batch(0, 0, LBFGS_N)
        per = {}
        params = ltr.model.params
        aopt = ltr._make_adam(1, 1, list(params.values()))
        sopt = ltr._make_lbfgs(list(params.values()))
        sgen = torch.Generator(device=dev).manual_seed(5)
        for what, fn in (("adam_step", lambda: ltr._step(params, aopt, sgen, rt.batch_size)),
                         ("lbfgs_iteration", lambda: ltr._lbfgs_step(params, sopt, lbatch, sgen)),
                         ("validate", lambda: ltr.pde.validate(ltr.model.apply, params,
                                                               num_points=20000))):
            fourier_feats.fourier_features.launches = 0
            fourier_feats.fourier_features.jvps = 0
            evals0 = LBFGS.evaluations
            fn()
            torch.cuda.synchronize()
            per[what] = {"launches": fourier_feats.fourier_features.launches,
                         "jvps": fourier_feats.fourier_features.jvps,
                         "evaluations": LBFGS.evaluations - evals0}
        it = per["lbfgs_iteration"]
        if not (per["adam_step"] == {"launches": 3, "jvps": 1, "evaluations": 0}
                and it["evaluations"] >= 2 and it["launches"] == 3 * it["evaluations"]
                and it["jvps"] == it["evaluations"]
                and per["validate"] == {"launches": 1, "jvps": 0, "evaluations": 0}):
            raise AssertionError(f"{key}: kernel 2's launches per step {per}")
        adam_syncs, adam_sites = count_syncs(ltr, rt.batch_size)
        evals0, reads0 = LBFGS.evaluations, LBFGS.host_reads
        l_sites = record_syncs(lambda: ltr._lbfgs_step(params, sopt, lbatch, sgen))
        l_evals, l_reads = LBFGS.evaluations - evals0, LBFGS.host_reads - reads0
        print(f"[syncs] {key}: one warm Adam step {adam_syncs} {adam_sites}; one L-BFGS iteration "
              f"{len(l_sites)} {sorted(set(l_sites))}, {l_evals} evaluations, {l_reads} host reads",
              flush=True)
        if adam_syncs or len(l_sites) != l_reads or not eager_search_reads(l_reads, l_evals):
            raise AssertionError(f"{key}: {adam_syncs} host syncs per Adam step; {len(l_sites)} "
                                 f"per L-BFGS iteration of {l_evals} evaluations")
        timed = {"kernels": {"adam": [], "lbfgs": [], "evals": []},
                 "plain": {"adam": [], "lbfgs": [], "evals": []}}
        for order in ("plain", "kernels", "kernels", "plain"):
            with plain_fourier_features() if order == "plain" else contextlib.nullcontext():
                timed[order]["adam"] += step_times(ltr, SECOND_ORDER_TIMED, 1, rt.batch_size)
                times, evals = lbfgs_iteration_times(ltr, lbatch, SECOND_ORDER_TIMED)
            timed[order]["lbfgs"] += times
            timed[order]["evals"].append(evals)
        ms = {o: {"adam_step_ms": statistics.median(v["adam"]),
                  "lbfgs_iteration_ms": statistics.median(v["lbfgs"]),
                  "evaluations_per_iteration": sum(v["evals"]) / len(v["evals"])}
              for o, v in timed.items()}
        # The plain bundle's share of an L-BFGS iteration: the residual loss
        # and its parameter gradients on the iteration's 40000 points (device
        # time by CUDA-graph replay) times the evaluations per iteration,
        # over the iteration's host-clock median.
        xl, tl, _ = lbatch
        pr = {k: v.detach().requires_grad_(True) for k, v in params.items()}

        def bundle_grads():
            r = ltr.pde.compute_residual(ltr.model.apply, pr, xl, tl)
            return torch.autograd.grad(ltr.pde._residual_loss(r, tl), list(pr.values()),
                                       allow_unused=True, materialize_grads=True)

        bundle_ms = graph_ms(bundle_grads, iters=5, replays=5)
        bundle_share = (bundle_ms * ms["kernels"]["evaluations_per_iteration"]
                        / ms["kernels"]["lbfgs_iteration_ms"])
        print(f"[timing] {key}: the plain bundle's residual loss + gradients at N={LBFGS_N}, "
              f"device time per call (CUDA graph) {bundle_ms:.3f} ms: "
              f"{bundle_share:.1%} of an L-BFGS iteration ({card})", flush=True)
        del pr
        print(f"[timing] {key}: Adam step (batch {rt.batch_size}, BC/IC {rt.num_initial_points}), "
              f"median of {len(timed['kernels']['adam'])}: kernel 2 "
              f"{ms['kernels']['adam_step_ms']:.3f} ms, plain {ms['plain']['adam_step_ms']:.3f} ms; "
              f"L-BFGS iteration (N={LBFGS_N}), median of {len(timed['kernels']['lbfgs'])}: kernel 2 "
              f"{ms['kernels']['lbfgs_iteration_ms']:.3f} ms "
              f"({ms['kernels']['evaluations_per_iteration']:.2f} evaluations), plain "
              f"{ms['plain']['lbfgs_iteration_ms']:.3f} ms "
              f"({ms['plain']['evaluations_per_iteration']:.2f}) ({card})", flush=True)
        second_runs[key] = {**run, "rel_l2": conv.rel_l2, "wall_s": wall, "per": per,
                            "adam_syncs": adam_syncs, "lbfgs_syncs": len(l_sites),
                            "lbfgs_evaluations": l_evals, "bundle_ms": bundle_ms,
                            "bundle_share_of_lbfgs_iteration": bundle_share, **ms}
        del ltr, seen

    # ---- 24. the shipped defaults: wave on its SIREN, the pendulum on its ResNet - #
    wcfg = load_config(pde_type="wave", device="cuda")
    wt = wcfg.training
    wt.num_epochs = SHIPPED_SECOND_ORDER_EPOCHS
    w_omega = float(wcfg.model.arch_params["omega_0"])
    if not (wcfg.model.architecture == "siren" and tuple(wcfg.model.hidden_dims) == (124,) * 7
            and w_omega == 30.0 and wt.batch_size == 2048):
        raise AssertionError("the shipped wave configuration is not the 124x7 SIREN at omega 30")
    wpde, wmodel = create_pde(wcfg), PINNModel(wcfg, seed=0)
    wp = wmodel.params
    w_x, w_t = wpde.generate_collocation_points(gen, wt.num_initial_points, "uniform")
    w_in = [wmodel.map_inputs(torch.cat([w_x, w_t], dim=-1))]
    with torch.no_grad():
        w_in.append(siren.siren_layer_plain(w_in[0], wp["SIRENLayer_0.kernel"],
                                            wp["SIRENLayer_0.bias"], w_omega))
    wave_siren_err = 0.0
    for tag, (xs, i) in {"(2048,2)->124": (w_in[0][:2048], 0),
                         "(2048,124)->124": (w_in[1][:2048], 1),
                         "(5000,124)->124": (w_in[1], 1)}.items():
        W, b = wp[f"SIRENLayer_{i}.kernel"].detach(), wp[f"SIRENLayer_{i}.bias"].detach()
        with torch.no_grad():
            sk = siren.siren_layer(xs, W, b, w_omega)
            spl = siren.siren_layer_plain(xs, W, b, w_omega)
        torch.cuda.synchronize()
        err = float((sk - spl).abs().max())
        rel = err / float(spl.abs().max())
        wave_siren_err = max(wave_siren_err, err)
        print(f"[shipped] wave SIREN: siren_layer {tag}: max_abs_err {err:.3e} rel {rel:.3e} "
              f"(tol {SIREN_TOL:g})", flush=True)
        if not rel < SIREN_TOL:
            raise AssertionError(f"siren_layer disagrees with its plain version on wave at {tag}")
    siren_err = max(siren_err, wave_siren_err)

    def wave_residual_grads(p, zz):
        r = wpde.compute_residual(wmodel.apply, p, zz[:, :1], zz[:, 1:])
        loss = torch.mean(r * r)
        # The residual u_tt - c^2 u_xx does not depend on the head's bias: its gradient is 0.
        return loss, torch.autograd.grad(loss, list(p.values()), allow_unused=True,
                                         materialize_grads=True)

    w_z = torch.cat([w_x, w_t], dim=-1)[:2048]
    w_p = {k: v.detach().requires_grad_(True) for k, v in wp.items()}
    lk, gk_ = wave_residual_grads(w_p, w_z)
    with plain_siren():
        lp, gp_ = wave_residual_grads(w_p, w_z)
    torch.cuda.synchronize()
    worst = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                for a, b in zip(gk_, gp_))
    loss_rel = abs(float(lk.detach()) - float(lp.detach())) / abs(float(lp.detach()))
    print(f"[shipped] wave's order-2 residual loss through kernel 3 (N=2048, 124x7): loss rel "
          f"{loss_rel:.3e}; worst gradient rel {worst:.3e} (tol {SIREN_GRAD_TOL:g})", flush=True)
    if not (loss_rel < SIREN_GRAD_TOL and worst < SIREN_GRAD_TOL):
        raise AssertionError("wave's residual-loss gradients through kernel 3 disagree with plain")
    del w_p, gk_, gp_

    pend_cfg = load_config(pde_type="pendulum", device="cuda")
    shipped_second = {}
    for name, scfg_, spde_, smodel_ in (
            ("wave", wcfg, wpde, wmodel),
            ("pendulum", pend_cfg, create_pde(pend_cfg), PINNModel(pend_cfg, seed=0))):
        st2 = scfg_.training
        st2.num_epochs = SHIPPED_SECOND_ORDER_EPOCHS
        trainer2 = PDETrainer(smodel_, spde_, scfg_)
        if trainer2.fast_bundle_active or trainer2.fused_kernel_active:
            raise AssertionError(f"{name} as shipped is not on the generic engine")
        if name == "pendulum" and not (scfg_.model.architecture == "resnet"
                                       and (scfg_.model.hidden_dim, scfg_.model.num_blocks) == (512, 7)):
            raise AssertionError("the shipped pendulum configuration is not the ResNet 512x7")
        steps2 = SHIPPED_SECOND_ORDER_EPOCHS * (st2.num_collocation_points // st2.batch_size)
        vals2 = sum(1 for e in range(1, SHIPPED_SECOND_ORDER_EPOCHS + 1)
                    if e % st2.validation_frequency == 0 or e == SHIPPED_SECOND_ORDER_EPOCHS)
        siren.siren_layer.launches = 0
        fourier_feats.fourier_features.launches = 0
        fused_step.fused_residual_loss.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res2 = trainer2.train(seed=0)
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
        run2 = {"siren_layer": siren.siren_layer.launches,
                "fourier_features": fourier_feats.fourier_features.launches,
                "fused_residual_loss": fused_step.fused_residual_loss.launches}
        hist2 = res2["history"]["train_loss"]
        net2 = trainer2._final_state["params"]["net"]
        val2 = spde_.validate(smodel_.apply, net2, num_points=20000)
        if name == "wave":
            n_layers2 = len(scfg_.model.hidden_dims)
            # Per loss: u_tt and u_xx (one nest of two jvps each), the BC,
            # the IC and the velocity IC (one jvp): 5 evaluations, each
            # through every layer.
            evals2 = 1 + 1 + 3
            want2 = {"siren_layer": evals2 * n_layers2 * (steps2 + vals2), "fourier_features": 0,
                     "fused_residual_loss": 0}
        else:
            want2 = {"siren_layer": 0, "fourier_features": 0, "fused_residual_loss": 0}
        arch2 = scfg_.model.architecture
        print(f"[shipped] {name} as shipped ({arch2} {list(scfg_.model.hidden_dims)}, batch "
              f"{st2.batch_size} of {st2.num_collocation_points}, BC/IC {st2.num_boundary_points}): "
              f"{steps2} Adam steps, {vals2} validation(s), {wall2:.2f} s; launches {run2} (want "
              f"{want2}); epoch losses {' '.join(f'{v:.4e}' for v in hist2)}; validate(20000) rel_l2 "
              f"{val2['rel_l2']:.4e} (no bar) ({card})", flush=True)
        if not (len(hist2) == SHIPPED_SECOND_ORDER_EPOCHS and all(map(math.isfinite, hist2))
                and len(res2["history"]["val_loss"]) == vals2
                and all(math.isfinite(v) for v in val2.values())):
            raise AssertionError(f"{name} as shipped: losses {hist2}, validation {val2}")
        if run2 != want2:
            raise AssertionError(f"{name} as shipped: launches {run2}, want {want2}")
        shipped_second[name] = {**run2, "steps": steps2, "validations": vals2, "wall_s": wall2,
                                "rel_l2": val2["rel_l2"]}
    del wpde, wmodel

    # ---- 25-27. Cahn-Hilliard: the three recipes, order-4 parity, as shipped -- #
    ch_runs = ch_recipe_runs(dev, card)
    ch_parity = ch_order4_parity(dev, card)
    ch_shipped_run = ch_shipped(dev, card)

    # ---- 28-30. inverse recipes, data_augmented, the CLIs ------------------- #
    inv_runs = inverse_runs(dev, card)
    aug_runs = data_augmented_runs(dev, card)
    cli = cli_runs(dev, card)

    # ---- 31-33. the sampling, fdm and operator harnesses --------------------- #
    samp = sampling_runs(dev, card)
    fdm = fdm_runs(dev, card)
    op = operator_runs(dev, card)

    # ---- 34-35. the trainer's levers; time-marching and multi-stage -------- #
    levers = lever_runs(dev, card)
    marching = marching_runs(dev, card)

    # ---- 36-39. trainable basis, ensembles, trunks, the heat CLI's plots ---- #
    trunks = trunk_runs(dev, card)
    f64 = float64_runs(dev, card)
    meshes = mesh_runs(dev, card)
    dash = dashboard_runs(dev, card)

    # ---- 43. kernel 1 with gelu, sigmoid, silu and sin ----------------------- #
    acts = activation_runs(dev, card)

    # ---- 44. kernel 1 in four or more space dimensions ----------------------- #
    nd4 = nd_runs(dev, card)

    # ---- 45. kernel 1's generated residual: any registered PDE -------------- #
    gen45 = gen_runs(dev, card)

    # ---- 46. every Adam phase replays one captured graph of its step -------- #
    graph46 = graph_runs(dev, card)

    # ---- 47. every L-BFGS phase replays its iteration ------------------------ #
    lbfgs47 = lbfgs_graph_runs(dev, card)

    # ---- bounds and cuBLAS yardsticks --------------------------------------- #
    bp = variants["burgers"].model.params
    fused_shapes = fused_gemms(bp, 2, 8192)  # the Burgers call timed in phase 5
    n_params = sum(v.numel() for v in bp.values())
    fused_bound = bound(sum(2.0 * m * k * n for m, k, n in fused_shapes),
                        4.0 * (z.numel() + 2 * n_params + B.numel() + 1))
    fused_lib_ms = cublas_ms(fused_shapes, dev)
    mlp_bound = bound(sum(2.0 * m * k * n for m, k, n in mlp_shapes) + 2 * 8.0 * g_n * h_mlp,
                      4.0 * (grid.numel() + sum(v.numel() for v in q_params.values()) + g_n))
    n3, k3, m3 = xs3.shape[0], W3.shape[0], W3.shape[1]
    siren_bound = bound(2.0 * n3 * k3 * m3 + 3.0 * n3 * m3, 4.0 * (n3 * k3 + k3 * m3 + m3 + n3 * m3))
    print(f"[bounds] FP32 {FP32_FLOPS:.3g} FLOP/s, HBM {HBM_BYTES_S:.3g} B/s: fused_residual_loss "
          f"Burgers N=8192 {fused_bound[0]:.4f} ms ({fused_bound[1]}), its GEMMs on cuBLAS "
          f"{fused_lib_ms:.3f} ms; fourier_features {ff_bound_ms:.5f} ms ({ff_bound_by}); "
          f"fused_mlp_score {mlp_bound[0]:.4f} ms ({mlp_bound[1]}), cuBLAS {mlp_lib_ms:.4f} ms; "
          f"siren_layer {siren_bound[0]:.5f} ms ({siren_bound[1]}) ({card})", flush=True)

    if "jax" in sys.modules:
        raise AssertionError("chip_smoke imported jax")
    kernels = [
        {"name": "fused_residual_loss", "route": "cuda",
         "source": "pinnrl_tpu_torch/csrc/fused_residual.cu",
         "replaces": "pinnrl_tpu/ops/kernels/fused_step.py:277",
         "launches": rl_launches["fused_residual_loss"],
         "launches_in_trace": rl_trace["fused_residual_loss"],
         "kdv_launches": kdv_launches["fused_residual_loss"],
         "heat_launches": heat_launches["fused_residual_loss"],
         "variants": list(FUSED_TOLS),
         "max_abs_err": max(*fused_errs.values(),
                            *(v["max_abs_err"] for v in trunks["trainable_basis"]["parity"].values()),
                            nd4["max_abs_err"], gen45["max_abs_err"]),
         "ms": fused_ms, "plain_ms": fused_plain_ms, "eager_ms": fused_eager_ms,
         "bound_ms": fused_bound[0], "bound_by": fused_bound[1], "library_ms": fused_lib_ms,
         "library_call": "torch.mm (FP32, TF32 off) of the call's GEMM shapes, Burgers N=8192",
         "kdv_causal_ms": kdv_ms, "kdv_causal_plain_ms": kdv_plain_ms,
         "kdv_causal_eager_ms": kdv_eager_ms,
         "heat_ms": heat_ms, "heat_plain_ms": heat_plain_ms, "heat_eager_ms": heat_eager_ms,
         "gemm_ms": {k: v["new"] for k, v in gemm_sum.items()},
         "gemm_library_ms": {k: v["lib"] for k, v in gemm_sum.items()},
         "lbfgs_launches": {k: r["fused_residual_loss"] for k, (r, _) in lbfgs_runs.items()},
         "n40000_ms": n40_ms, "n40000_plain_ms": n40_plain_ms, "n40000_bound_ms": n40_bound[0],
         "n40000_bound_by": n40_bound[1], "n40000_library_ms": n40_lib_ms,
         "lbfgs_iteration_ms": lbfgs_ms, "lbfgs_evaluations_per_iteration": lbfgs_evals,
         "lbfgs_syncs_per_iteration": len(sync_sites),
         "scope_1d": scope, "scope_1d_launches": scope_runs,
         "scope_nd": scope_nd, "heat_2d_launches": heat_2d_run,
         "second_order_launches": {k: r["fused_residual_loss"] for k, r in second_runs.items()},
         "float64_params_launches": f64_launches,
         "cahn_hilliard_launches": {**{k: r["fused_residual_loss"] for k, r in ch_runs.items()},
                                    "shipped": ch_shipped_run["fused_residual_loss"]},
         "inverse_launches": {k: r["fused_residual_loss"] for k, r in inv_runs.items()},
         "data_augmented": {k: aug_runs[k] for k in ("forward", "data_augmented")},
         "data_augmented_parity": aug_runs["parity"],
         "cli_launches": {k: r["fused_residual_loss"] for k, r in cli.items()},
         "shipped_fourier_512": cli["burgers_rl"]["kernel1_512"],
         "sampling_launches": {k: r["fused_residual_loss"] for k, r in samp["runs"].items()},
         "operator_launches": op["pointwise"]["launches"]["fused_residual_loss"],
         "lever_launches": {k: v["launches"]["fused_residual_loss"] for k, v in levers.items()
                            if "launches" in v},
         "resume": levers["resume"],
         "kdv_time_marching_launches": [w["launches"]["fused_residual_loss"]
                                        for w in marching["kdv_tm4"]["windows"]],
         "multistage_launches": marching["multistage"]["kernel1_per_stage"],
         "hard_ic_launches": {k: marching[f"hard_ic_{k}"]["launches"]["fused_residual_loss"]
                              for k in ("wave", "burgers")},
         "trainable_basis_launches": trunks["trainable_basis"]["launches"]["fused_residual_loss"],
         "trainable_basis": {k: trunks["trainable_basis"][k] for k in ("parity", "timings")},
         "ensemble_launches": trunks["ensemble"]["launches"]["fused_residual_loss"],
         "ensemble_members_served": trunks["ensemble"]["members_served"],
         "ensemble_step_ms": trunks["ensemble"]["step_ms"],
         "member_axis": {**trunks["ensemble"]["member_call"],
                         "cases": trunks["ensemble"]["cases"]},
         "trunk_launches": {k: trunks[k]["launches"]["fused_residual_loss"]
                            for k in ("modified", "autoencoder", "dropout")},
         "float64_launches": {"adam": f64["adam_launches"]["fused_residual_loss"],
                              "float64_phase": f64["phase_launches"]["fused_residual_loss"]},
         "float64_card_vs_cpu": f64["card_vs_cpu"], "float64_lbfgs": f64["lbfgs"],
         "mesh_launches": {"nccl_world1": meshes["nccl_world1"]["launches"]["fused_residual_loss"],
                           "gloo_2ranks": [r["fused_residual_loss"] for r in
                                           meshes["gloo_2ranks"].get("launches", [])]},
         "activations": {**acts, "tanh": {**acts["tanh"],
                                          "launches": rl_launches["fused_residual_loss"]}},
         "nd4": nd4, "generated": gen45,
         "graph": {k: {kk: v[kk] for kk in ("launches", "launches_per_step", "bit_identical",
                                            "host_reads_per_chunk", "program")}
                   for k, v in graph46.items() if isinstance(v, dict) and "program" in v},
         "graph_ms_per_step": graph46["rar"]["ms_per_step"],
         "lbfgs_graph": {k: {kk: v[kk] for kk in ("launches", "counted", "evaluations", "trials",
                                                  "bit_identical", "host_reads_per_chunk",
                                                  "programs")}
                         for k, v in lbfgs47.items() if isinstance(v, dict) and "programs" in v
                         and "launches" in v},
         "lbfgs_graph_ms": {k: {s: {kk: v[s][kk] for kk in ("ms", "busy_ms", "idle_share",
                                                            "device_launches")}
                                for s in ("graph", "eager")}
                            for k, v in lbfgs47["timed"].items()},
         "generated_selects": {
             "programs": gen45["k1i"]["ptxas"],
             "nan_parity": gen45["k1i"]["nan_parity"],
             "parity": {k: v for k, v in gen45["parity"].items()
                        if k.startswith(GEN_SELECTS)},
             "allen_cahn_clamped_ms": {n: {k: r[k] for k in ("ms", "hand_ms", "plain_ms",
                                                            "bound_ms", "bound_by", "library_ms")}
                                       for n, r in gen45["k1i"]["allen_cahn_ab"].items()},
             "select_residual_alone_ms": {
                 n: {k: r[k] for k in ("ms", "burgers_generated_ms", "burgers_kernel_ms",
                                       "plain_ms", "bound_ms", "bound_by", "library_ms")}
                 for n, r in gen45["k1i"]["select_alone"].items()},
             "launches": gen45["k1i"]["run"]["launches"]}},
        {"name": "fourier_features", "route": "cuda",
         "source": "pinnrl_tpu_torch/csrc/fourier_feats.cu",
         "replaces": "pinnrl_tpu/ops/kernels/fourier_feats.py:36",
         "launches": rl_launches["fourier_features"],
         "launches_in_trace": rl_trace["fourier_features"],
         "kdv_launches": kdv_launches["fourier_features"],
         "heat_launches": heat_launches["fourier_features"],
         "heat_jvps": heat_launches["fourier_features_jvps"],
         "max_abs_err": max(ff_err, trunks["ensemble"]["kernel2"]["max_abs_err"]),
         "lbfgs_launches": {k: {"launches": r["fourier_features"], "jvps": r["fourier_features_jvps"]}
                            for k, (r, _) in lbfgs_runs.items()},
         "heat_2d_launches": heat_2d_run["fourier_features"],
         "second_order": second_runs, "zero_x_row": {**ff0, "max_abs_err": ff0_err},
         "cahn_hilliard": ch_runs, "order4": ch_parity,
         "cahn_hilliard_shipped_launches": ch_shipped_run["fourier_features"],
         "inverse": inv_runs,
         "data_augmented_launches": {k: aug_runs[k]["fourier_features"]
                                     for k in ("forward", "data_augmented")},
         "cli_launches": {k: {"launches": r["fourier_features"], "jvps": r["fourier_features_jvps"]}
                          for k, r in cli.items()},
         "lever_launches": {k: {"launches": v["launches"]["fourier_features"],
                                "jvps": v["launches"]["fourier_features_jvps"]}
                            for k, v in levers.items() if "launches" in v},
         "kdv_time_marching_launches": [w["launches"]["fourier_features"]
                                        for w in marching["kdv_tm4"]["windows"]],
         "trunk_launches": {k: {"launches": trunks[k]["launches"]["fourier_features"],
                                "jvps": trunks[k]["launches"]["fourier_features_jvps"]}
                            for k in ("trainable_basis", "ensemble", "modified", "autoencoder",
                                      "dropout")},
         "multistage_launches": [{"launches": v["fourier_features"],
                                  "jvps": v["fourier_features_jvps"]}
                                 for v in marching["multistage"]["launches"]],
         "float64": {"adam_launches": f64["adam_launches"]["fourier_features"],
                     "phase_launches": f64["phase_launches"]["fourier_features"],
                     "phase_plain_f64": f64["kernel2_plain_f64"],
                     "gate": {k: v for k, v in f64["gate"].items() if k.startswith("fourier")}},
         "mesh_launches": meshes["nccl_world1"]["launches"]["fourier_features"],
         "dashboard_solution_launches": dash["solution_launches"],
         "nd4_edge": nd4["kernel2_edge"],
         "nd4_launches": {k: r["launches"]["fourier_features"] for k, r in nd4["runs"].items()},
         "sampling": {"shapes": samp["kernel2"], "jvp_rel": samp["kernel2_jvp_rel"],
                      "launches": {k: {"launches": r["fourier_features"],
                                       "jvps": r["fourier_features_jvps"]}
                                   for k, r in samp["runs"].items()},
                      "harness": samp["runs"], "syncs_per_step": samp["syncs_per_step"]},
         "member_axis": trunks["ensemble"]["kernel2"],
         "vmapped_ensemble": trunks["ensemble"]["vmapped_path"]["modified_basis"],
         "ms": ff_ms, "plain_ms": ff_plain_ms, "eager_ms": ff_eager_ms,
         "bound_ms": ff_bound_ms, "bound_by": ff_bound_by, "library_ms": None,
         "floor_ms": ff_floor_ms, "shapes": ff_times, "host_us": ff_host,
         "ptxas": {"registers": sorted({v[0] for v in ff_ptxas.values()}),
                   "stack_frame_bytes": sorted({v[2] for v in ff_ptxas.values()}),
                   "spill_bytes": sum(v[1] for v in ff_ptxas.values())}},
        {"name": "siren_layer", "route": "cuda",
         "source": "pinnrl_tpu_torch/csrc/siren.cu",
         "replaces": "pinnrl_tpu/ops/kernels/siren.py:29",
         "launches": siren_launches, "launches_in_trace": s_trace["siren_layer"],
         "max_abs_err": max(siren_err, trunks["ensemble"]["kernel3"]["max_abs_err"]),
         "blocks": siren_blocks,
         "wave_launches": shipped_second["wave"]["siren_layer"], "wave_max_abs_err": wave_siren_err,
         "cahn_hilliard_launches": {**{k: r["siren_layer"] for k, r in ch_runs.items()},
                                    "shipped": ch_shipped_run["siren_layer"]},
         "shipped_second_order": shipped_second,
         "float64_gate": {k: v for k, v in f64["gate"].items() if k.startswith("siren")},
         "member_axis": trunks["ensemble"]["kernel3"],
         "vmapped_ensemble": trunks["ensemble"]["vmapped_path"]["siren"],
         "ms": siren_ms, "plain_ms": siren_plain_ms, "eager_ms": siren_eager_ms,
         "bound_ms": siren_bound[0], "bound_by": siren_bound[1], "library_ms": siren_lib_ms,
         "library_call": "torch.addmm(b, x, W) (FP32, TF32 off) at (2048,124)x(124,124), no sin"},
        {"name": "fused_mlp_score", "route": "cuda",
         "source": "pinnrl_tpu_torch/csrc/mlp_score.cu",
         "replaces": "pinnrl_tpu/ops/kernels/mlp.py:75",
         "launches": rl_launches["fused_mlp_score"], "launches_in_trace": rl_trace["fused_mlp_score"],
         "max_abs_err": mlp_err,
         "cli_launches": {k: r["fused_mlp_score"] for k, r in cli.items()},
         "float64_launches": f64["launches"]["fused_mlp_score"],
         "sampling": {"shapes": samp["kernel4"],
                      "launches": {k: r["fused_mlp_score"] for k, r in samp["runs"].items()}},
         "ms": mlp_ms, "plain_ms": mlp_plain_ms, "eager_ms": mlp_eager_ms,
         "bound_ms": mlp_bound[0], "bound_by": mlp_bound[1], "library_ms": mlp_lib_ms,
         "library_call": "torch.mm (FP32, TF32 off) of its three layer products, no LayerNorm",
         "launch_ms": mlp_launch_ms, "splits": mlp_splits, "blocks": mlp_blocks,
         "product_ab_ms": {f"{'w2t' if t else 'w2'}_split{s}": v for (s, t), v in product_ab.items()},
         "split_ab_ms": {f"split{s}": v for s, v in split_ab.items()}},
    ]
    print(f"[harnesses] {json.dumps({'sampling': samp['runs'], 'fdm': fdm, 'operator': op})}")
    print(f"[levers] {json.dumps({'levers': levers, 'marching': marching}, default=str)}")
    print(f"[trunks] {json.dumps(trunks, default=str)}")
    print(f"[slice17] {json.dumps({'float64': f64, 'mesh': meshes, 'dashboard': dash}, default=str)}")
    print(f"[graph] {json.dumps(graph46, default=str)}")
    print(f"[card] {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
