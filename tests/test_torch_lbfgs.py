"""The port's L-BFGS (``pinnrl_tpu_torch/training/lbfgs.py``) against the
optax chain the JAX package builds (``pinnrl_tpu/training/trainer.py``,
``_make_lbfgs``): ``optax.lbfgs(memory_size, linesearch=
optax.scale_by_zoom_linesearch(max_linesearch_steps=25))``.

Tolerances:
- the two-loop direction against ``optax.scale_by_lbfgs``, float64:
  1e-12 relative to max;
- 30 iterations on Rosenbrock and on an ill-conditioned quadratic, float64:
  every iterate within 1e-9 relative to max, the same number of line-search
  trials per iteration and the same accepted stepsizes (1e-9 relative);
- a search that runs out of steps takes optax's safe step (same bounds);
- 5 iterations on the small Burgers problem, float32, on one fixed batch
  with the same BC/IC points: the loss at each iteration within 1e-5
  relative, the parameters after them within 1e-4 relative to max, the
  same trial count per iteration.

Float64 runs enable x64 only inside ``jax.enable_x64(True)``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_parity_helpers import burgers_pair, inject_points, jax_bc_ic_points, points, rel_to_max

from pinnrl_tpu.training.trainer import PDETrainer as JaxTrainer
from pinnrl_tpu_torch.ops.kernels import fused_step
from pinnrl_tpu_torch.training import PDETrainer
from pinnrl_tpu_torch.training.lbfgs import LBFGS

DIR_TOL = 1e-12
ITER_TOL = 1e-9
F32_LOSS_TOL = 1e-5
F32_PARAM_TOL = 1e-4


def _optax_chain(memory_size: int, max_linesearch_steps: int = 25):
    """The JAX package's L-BFGS chain (trainer.py, _make_lbfgs)."""
    return optax.lbfgs(memory_size=memory_size,
                       linesearch=optax.scale_by_zoom_linesearch(
                           max_linesearch_steps=max_linesearch_steps, verbose=False))


# ------------------------------------------------------------ (a) two-loop


@pytest.mark.parametrize("memory,iters", [(3, 2), (3, 8), (50, 25), (50, 57)])
def test_two_loop_direction_matches_optax(memory, iters):
    """Half-filled (iters < memory) and wrapped (iters > memory) rings,
    random (w, g) histories; the direction at every iteration."""
    rng = np.random.default_rng(memory * 100 + iters)
    n = 40
    ws = np.cumsum(rng.standard_normal((iters, n)), axis=0)
    A = rng.standard_normal((n, n))
    gs = ws @ (A @ A.T / n + np.eye(n)).T + 0.1 * rng.standard_normal((iters, n))
    gs[iters // 2] = gs[iters // 2 - 1] if iters > 2 else gs[iters // 2]  # a zero y: the guard
    with jax.enable_x64(True):
        tx = optax.scale_by_lbfgs(memory_size=memory)
        state = tx.init(jnp.zeros(n))
        update = jax.jit(tx.update)
        ref = []
        for w, g in zip(ws, gs):
            d, state = update(jnp.asarray(g), state, jnp.asarray(w))
            ref.append(np.asarray(d))
    opt = LBFGS([torch.zeros(n, dtype=torch.float64)], memory)
    for k, (w, g, r) in enumerate(zip(ws, gs, ref)):
        wt, gt = torch.from_numpy(w), torch.from_numpy(g)
        opt._w0.copy_(wt)
        opt._g0.copy_(gt)
        d = opt._direction()
        opt._w_prev.copy_(wt)
        opt._g_prev.copy_(gt)
        opt._count.fill_(k + 1)
        assert rel_to_max(d, r) < DIR_TOL, k


# --------------------------------------------------- (b), (c) full iterations


def _rosenbrock(xp):
    def f(x):
        return xp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)
    return f


def _quadratic(xp, n=30, seed=0):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = Q @ np.diag(np.logspace(0.0, 4.0, n)) @ Q.T
    b = rng.standard_normal(n)

    def f(x):
        return 0.5 * xp.sum(x * (xp.asarray(A) @ x)) - xp.sum(xp.asarray(b) * x)
    return f


def _vee(xp):
    """A V along every axis: the slope on a line jumps at each kink and the
    curvature test may never be met."""
    def f(x):
        return xp.sum(xp.abs(x - 0.5)) + 0.001 * xp.sum(x)
    return f


class _TorchNS:
    """The numpy-like namespace the objectives above need, for torch."""
    sum = staticmethod(torch.sum)
    abs = staticmethod(torch.abs)

    @staticmethod
    def asarray(a):
        return torch.as_tensor(a, dtype=torch.float64)


def _run_both(make_f, x0, iters, memory, max_steps):
    """(optax iterates, stepsizes, trials), (the port's), float64."""
    with jax.enable_x64(True):
        f = make_f(jnp)
        tx = _optax_chain(memory, max_steps)
        w = jnp.asarray(x0)
        state = tx.init(w)

        @jax.jit
        def iteration(w, state):
            value, grad = jax.value_and_grad(f)(w)
            updates, state = tx.update(grad, state, w, value=value, grad=grad, value_fn=f)
            return optax.apply_updates(w, updates), state

        ref = []
        for _ in range(iters):
            w, state = iteration(w, state)
            ls = state[-1]
            ref.append((np.asarray(w), float(ls.learning_rate), int(ls.info.num_linesearch_steps),
                        float(ls.info.decrease_error), float(ls.info.curvature_error)))
    ft = make_f(_TorchNS)
    x = torch.tensor(x0, dtype=torch.float64, requires_grad=True)
    opt = LBFGS([x], memory, max_linesearch_steps=max_steps)

    def closure():
        value = ft(x)
        return value, torch.autograd.grad(value, [x])

    got = []
    for _ in range(iters):
        opt.step(closure)
        got.append((x.detach().numpy().copy(), float(opt.stepsize), opt.trials))
    return ref, got


def _assert_same_iterates(ref, got):
    for k, ((w_r, lr_r, n_r, *_), (w_g, lr_g, n_g)) in enumerate(zip(ref, got)):
        assert n_g == n_r, (k, n_g, n_r)
        assert abs(lr_g - lr_r) <= ITER_TOL * abs(lr_r), (k, lr_g, lr_r)
        assert rel_to_max(w_g, w_r) < ITER_TOL, k


@pytest.mark.parametrize("objective,x0", [
    ("rosenbrock", np.array([-1.2, 1.0, -0.5, 0.8, 1.3, -1.0], np.float64)),
    ("quadratic", np.random.default_rng(7).standard_normal(30)),
])
def test_thirty_iterations_match_optax(objective, x0):
    make_f = {"rosenbrock": _rosenbrock, "quadratic": _quadratic}[objective]
    ref, got = _run_both(make_f, x0, 30, 50, 25)
    _assert_same_iterates(ref, got)
    assert len({n for _, _, n, *_ in ref}) > 1  # the searches did not all stop at their guess


@pytest.mark.parametrize("x0,max_steps", [((2.0,), 4), ((2.0,), 25)])
def test_search_out_of_steps_takes_the_safe_step(x0, max_steps):
    """On a V the search fails: it runs out of steps, or its interval shrinks
    below the stepsize precision, and returns the best point that met the
    decrease test (or, with none, its last point)."""
    ref, got = _run_both(_vee, np.array(x0, np.float64), 8, 10, max_steps)
    _assert_same_iterates(ref, got)
    failed = [n for _, _, n, dec, curv in ref if max(dec, curv) > 0.0]
    assert max_steps in failed and len(failed) >= 4, [(n, dec, curv) for _, _, n, dec, curv in ref]


def test_lbfgs_is_not_torch_optim(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("torch.optim.LBFGS was used")

    monkeypatch.setattr(torch.optim, "LBFGS", refuse)
    x = torch.tensor([-1.2, 1.0], dtype=torch.float64, requires_grad=True)
    opt = LBFGS([x], 5)
    assert not isinstance(opt, torch.optim.Optimizer)
    f = _rosenbrock(_TorchNS)
    before = LBFGS.evaluations, LBFGS.host_reads
    opt.step(lambda: (f(x), torch.autograd.grad(f(x), [x])))
    evals, reads = LBFGS.evaluations - before[0], LBFGS.host_reads - before[1]
    # One evaluation at the start and one per trial; the eager search reads
    # ``active`` once per trial after the first, and once more to stop
    # before it runs out of steps.
    assert evals == 1 + opt.trials and opt.trials >= 1
    assert reads == min(opt.trials, opt.max_linesearch_steps - 1)


# ------------------------------------------------------ (d) the Burgers pair


def _twin_kernel1(monkeypatch, pde, model):
    """Route the PDE's residual loss through kernel 1's autograd Function
    with the plain twins of its CUDA kernels (``_TorchOps``) on CPU
    tensors: the hand-derived backward the card runs."""
    spec = fused_step._spec(model, pde)
    monkeypatch.setattr(fused_step, "_cuda_ops", lambda device: fused_step._TorchOps())
    monkeypatch.setattr(fused_step.fused_residual_loss, "launches", 0)
    monkeypatch.setattr(pde, "_fused_residual_loss",
                        lambda params, z: fused_step._FusedResidualFn.apply(
                            spec, z, *[params[k] for k in spec.leaf_names]))


@functools.lru_cache(maxsize=1)
def _burgers_reference():
    """The JAX package's 5 iterations on the small Burgers pair (one fixed
    batch of 256 and the BC/IC points of one key): (batch, BC/IC points,
    value and trials per iteration, final parameters)."""
    pair = burgers_pair()
    jtr = JaxTrainer(pair.jmodel, pair.jpde, pair.jcfg)
    x, t = points(42, 256)
    key = jax.random.PRNGKey(5)

    def jloss(p):
        return jtr._loss_components(p, jnp.asarray(x), jnp.asarray(t), key)["total"]

    jopt = jtr._make_lbfgs()
    jparams = {"net": pair.jmodel.params, "coeffs": {}}
    jstate = jopt.init(jparams)

    @jax.jit
    def iteration(p, state):
        value, grads = jax.value_and_grad(jloss)(p)
        updates, state = jopt.update(grads, state, p, value=value, grad=grads, value_fn=jloss)
        return optax.apply_updates(p, updates), state, value

    per_iteration = []
    for _ in range(5):
        jparams, jstate, value = iteration(jparams, jstate)
        per_iteration.append((float(value), int(jstate[-1].info.num_linesearch_steps)))
    return (x, t), jax_bc_ic_points(pair.jpde, key, 256), per_iteration, jax.device_get(jparams["net"])


@pytest.mark.parametrize("route", ["kernel1_twin", "plain_bundle"])
def test_five_iterations_on_burgers_match_optax(monkeypatch, route):
    (x, t), bc_ic, per_iteration, jnet = _burgers_reference()
    pair = burgers_pair()
    if route == "plain_bundle":
        pair.tcfg.training.fused_residual_kernel = "off"
    ttr = PDETrainer(pair.tmodel, pair.tpde, pair.tcfg)
    assert ttr.fused_kernel_active == (route == "kernel1_twin")
    if route == "kernel1_twin":
        _twin_kernel1(monkeypatch, pair.tpde, pair.tmodel)
    inject_points(monkeypatch, pair.tpde, *bc_ic)
    params = pair.tmodel.params
    topt = ttr._make_lbfgs(list(params.values()))
    gen = torch.Generator().manual_seed(0)
    evals = LBFGS.evaluations
    for it, (value, trials) in enumerate(per_iteration):
        comps = ttr._lbfgs_step(params, topt, (torch.from_numpy(x), torch.from_numpy(t), 0), gen)
        assert abs(float(comps[0]) - value) / abs(value) < F32_LOSS_TOL, it
        assert topt.trials == trials, it
    if route == "kernel1_twin":
        assert fused_step.fused_residual_loss.launches == LBFGS.evaluations - evals
    for module, leaves in jnet.items():
        for leaf, ref in leaves.items():
            name = f"{module}.{ {'kernel': 'weight', 'scale': 'weight', 'bias': 'bias'}[leaf] }"
            got = params[name].detach().numpy()
            got = got.T if got.ndim == 2 else got
            assert rel_to_max(got, np.asarray(ref)) < F32_PARAM_TOL, name
