"""The port's L-BFGS search on the device (``training/lbfgs.py``) and the step
program's L-BFGS path (``training/step_program.py``), on the CPU.

- The tensor search against optax's ``scale_by_zoom_linesearch`` (the JAX
  package's chain, ``optax.lbfgs`` with a 25-step zoom search): in float64
  the chain jitted, at ``ITER_TOL`` (1e-9 relative: every iterate, every
  accepted stepsize, the same number of trials per iteration), on 30
  Rosenbrock and quadratic iterations, the V that runs out of steps at 4
  and at 25, a line whose trials reach NaN values, a concave line on which
  the second direction is not a descent direction (the search fails, and
  takes its safe step or its last) and a cubic line that zooms by cubic
  steps. In float32 the chain runs op by op (``jax.disable_jit``): XLA on
  the CPU contracts a product and a sum into one FMA inside a jitted
  program, and optax's ``_cubicmin`` forms its numerators by a 2x2
  ``jnp.dot``, which rounds so even op by op; a cubic step can then differ
  by a few ulps, so float32 holds the same trial counts and the stepsizes
  within ``F32_STEP_TOL`` (64 ulps) on the one-dimensional lines, and the
  multi-dimensional runs (where ulp differences in the objective's own
  reductions grow over 30 iterations) against the frozen search below.
- The tensor search against a frozen copy of the host search it replaced
  (numpy scalars, one host read per evaluation; ``FrozenLBFGS`` below, with
  the accepted point formed as the port now forms it, w0 + (s u)), bit for
  bit, in float32 and float64 on every case above, and on the small
  Burgers pair through the trainer's three-piece iteration with its eager
  guard (kernel 1's twins and the plain bundle): every parameter, the
  stepsizes and the trial counts.
- The two-loop's launch sequence is fixed (every slot of the ring, in
  optax's index order): the same operations at every count, and the
  direction against ``optax.scale_by_lbfgs`` at memory 1, 5 and 50, before
  and after the ring wraps.
- The evaluations counted on the device (a simulated capture's tally) and
  settled at the chunk read equal kernel 1's launches.
- ``step_path`` for L-BFGS with and without a mesh.
- The graph path's piece order (warm-up, capture, replays, reseeding),
  with the capture replaced by a recorder whose replay calls the piece
  (an IF node's: the trial only where ``active`` holds), against the eager
  program, bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch_parity_helpers import burgers_pair, points, rel_to_max

from pinnrl_tpu_torch.ops.kernels import counts, fused_step
from pinnrl_tpu_torch.rl import RLAgent
from pinnrl_tpu_torch.training import PDETrainer
from pinnrl_tpu_torch.training import step_program
from pinnrl_tpu_torch.training import trainer as trainer_mod
from pinnrl_tpu_torch.training.lbfgs import LBFGS
from pinnrl_tpu_torch.training.step_program import step_path

ITER_TOL = 1e-9
DIR_TOL = 1e-12
F32_STEP_TOL = 64 * float(np.finfo(np.float32).eps)


# --------------------------------------------------------------------------- #
# The host search the tensor search replaced (frozen)
# --------------------------------------------------------------------------- #

_HOST = {torch.float32: np.float32, torch.float64: np.float64}


def _sqrt(v):
    """torch's square root on the CPU (Sleef's, within 0.5001 ulp; the
    card's is correctly rounded, as numpy's)."""
    return type(v)(torch.sqrt(torch.tensor(v)).item())


def _host_cubicmin(a, fa, fpa, b, fb, c, fc):
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) * (db * dc) * (db - dc)
    r_b = fb - fa - C * db
    r_c = fc - fa - C * dc
    A = (dc * dc * r_b + -(db * db) * r_c) / denom
    B = (-(dc * dc * dc) * r_b + db * db * db * r_c) / denom
    radical = B * B - type(a)(3.0) * A * C
    return a + (-B + _sqrt(radical)) / (type(a)(3.0) * A)


def _host_quadmin(a, fa, fpa, b, fb):
    db = b - a
    B = (fb - fa - fpa * db) / (db * db)
    return a - fpa / (type(a)(2.0) * B)


class FrozenLBFGS:
    """The port's L-BFGS as it was before the search moved to the device:
    the two-loop over the written entries, the zoom search on numpy scalars
    after one read per evaluation. Changes, each to the arithmetic the
    tensor search does and none to a decision: the trial and accepted points
    are w0 + (s u), a product and a sum (it was ``torch.add(w0, u,
    alpha=s)``); the interpolants' powers are products, as XLA's
    ``integer_pow`` forms them (numpy's ``**`` rounds a cube once); and the
    cubic's square root is torch's (``_sqrt``)."""

    def __init__(self, params, memory_size, max_linesearch_steps=25):
        self.params = list(params)
        dtype = self.params[0].dtype
        self.F = F = _HOST[dtype]
        self._sizes = [p.numel() for p in self.params]
        n = sum(self._sizes)
        self.memory_size = memory_size
        self.max_linesearch_steps = max_linesearch_steps
        self.increase_factor = F(2.0)
        self.slope_rtol = F(1e-4)
        self.curv_rtol = F(0.9)
        self.approx_dec_rtol = F(1e-6)
        self.approx_slope = F(2 * 1e-4 - 1.0)
        self.stepsize_precision = F(1e-5)
        kw = dict(dtype=dtype, device=self.params[0].device)
        self.s_memory = torch.zeros((memory_size, n), **kw)
        self.y_memory = torch.zeros((memory_size, n), **kw)
        self.rho = torch.zeros(memory_size, **kw)
        self.count = 0
        self.stepsize = F(1.0)
        self._w_prev = self._g_prev = None
        self.trials = 0

    def _flat(self, tensors):
        return torch.cat([t.detach().reshape(-1) for t in tensors])

    @torch.no_grad()
    def _assign(self, w):
        views = [v.view_as(p) for v, p in zip(w.split(self._sizes), self.params)]
        torch._foreach_copy_(self.params, views)

    def _point(self, w0, u, stepsize):
        return torch.add(w0, torch.mul(u, float(stepsize)))

    def _evaluate(self, closure, w=None):
        if w is not None:
            self._assign(w)
        out = closure()
        return out, self._flat(out[1])

    def _read(self, *scalars):
        vals = torch.stack([s.detach().reshape(()).to(self.s_memory.dtype) for s in scalars]).cpu()
        return [self.F(v) for v in vals.numpy()]

    @torch.no_grad()
    def _direction(self, w, g):
        k, m = self.count, self.memory_size
        if k > 0:
            s, y = w - self._w_prev, g - self._g_prev
            ys = torch.dot(y, s)
            i = (k - 1) % m
            self.s_memory[i].copy_(s)
            self.y_memory[i].copy_(y)
            self.rho[i] = torch.where(ys == 0.0, torch.zeros_like(ys), 1.0 / ys)
            yy = torch.dot(y, y)
            gamma = torch.where(yy > 0.0, ys / yy, torch.ones_like(yy))
        else:
            gamma = torch.clamp(1.0 / torch.linalg.vector_norm(g), max=1.0)
        order = [(k - 1 - j) % m for j in range(min(k, m))]
        q = g.clone()
        alphas = []
        for i in order:
            alpha = self.rho[i] * torch.dot(self.s_memory[i], q)
            q.addcmul_(self.y_memory[i], alpha, value=-1.0)
            alphas.append(alpha)
        q.mul_(gamma)
        for i, alpha in zip(reversed(order), reversed(alphas)):
            beta = self.rho[i] * torch.dot(self.y_memory[i], q)
            q.addcmul_(self.s_memory[i], alpha - beta)
        return q

    def _trial(self, closure, w0, u, stepsize):
        out, g = self._evaluate(closure, self._point(w0, u, stepsize))
        return self._read(out[0], torch.dot(g, u))

    def _decrease_error(self, stepsize, value, slope, value_init, slope_init):
        err = value - value_init - self.slope_rtol * stepsize * slope_init
        approx = slope - self.approx_slope * slope_init
        approx = np.maximum(approx, value - value_init - self.approx_dec_rtol * np.abs(value_init))
        err = np.maximum(np.minimum(approx, err), self.F(0.0))
        return self.F(np.inf) if np.isnan(err) else err

    def _curvature_error(self, slope, slope_init):
        err = np.maximum(np.abs(slope) - self.curv_rtol * np.abs(slope_init), self.F(0.0))
        return self.F(np.inf) if np.isnan(err) else err

    def _line_search(self, closure, w0, u, value_init, slope_init):
        F = self.F
        zero = F(0.0)
        count = 0
        stepsize, value, slope = zero, value_init, slope_init
        dec_err = F(np.inf)
        interval_found = done = failed = False
        low = high = cubic_ref = zero
        value_low = value_high = value_cubic_ref = value_init
        slope_low = slope_high = slope_init
        safe_stepsize, safe_value = zero, value_init
        while not (done or failed):
            last = count + 1 >= self.max_linesearch_steps
            if not interval_found:
                new = self.stepsize if count == 0 else self.increase_factor * stepsize
                v, s = self._trial(closure, w0, u, new)
                dec_err = self._decrease_error(new, v, s, value_init, slope_init)
                err = np.maximum(dec_err, self._curvature_error(s, slope_init))
                if dec_err <= 0.0:
                    safe_stepsize, safe_value = new, v
                set_high = bool(dec_err > 0.0) or bool(v >= value and count > 0)
                set_low = bool(s >= 0.0) and not set_high
                if set_low:
                    low, value_low, slope_low, high, value_high, slope_high = (
                        new, v, s, stepsize, value, slope)
                else:
                    low, value_low, slope_low, high, value_high, slope_high = (
                        stepsize, value, slope, new, v, s)
                done = bool(err <= 0.0)
                interval_found = set_high or set_low or done
                failed = last and not done
                cubic_ref, value_cubic_ref = low, value_low
                stepsize, value, slope = new, v, s
            else:
                delta = np.abs(high - low)
                left, right = np.minimum(high, low), np.maximum(high, low)
                cubic_chk, quad_chk = F(0.2) * delta, F(0.1) * delta
                too_small = bool(delta <= self.stepsize_precision)
                middle = _host_cubicmin(low, value_low, slope_low, high, value_high, cubic_ref,
                                        value_cubic_ref)
                if not (middle > left + cubic_chk and middle < right - cubic_chk):
                    middle = _host_quadmin(low, value_low, slope_low, high, value_high)
                    if not (middle > left + quad_chk and middle < right - quad_chk):
                        middle = (low + high) / F(2.0)
                v, s = self._trial(closure, w0, u, middle)
                dec_err = self._decrease_error(middle, v, s, value_init, slope_init)
                err = np.maximum(dec_err, self._curvature_error(s, slope_init))
                if dec_err <= 0.0 and v < safe_value:
                    safe_stepsize, safe_value = middle, v
                done = bool(err <= 0.0)
                set_high_to_middle = bool(dec_err > 0.0) or bool(v >= value_low)
                set_high_to_low = bool(s * (high - low) >= 0.0) and not set_high_to_middle
                if set_high_to_middle or set_high_to_low:
                    cubic_ref, value_cubic_ref = high, value_high
                else:
                    cubic_ref, value_cubic_ref = low, value_low
                if set_high_to_middle:
                    high, value_high, slope_high = middle, v, s
                elif set_high_to_low:
                    high, value_high, slope_high = low, value_low, slope_low
                if not set_high_to_middle:
                    low, value_low, slope_low = middle, v, s
                failed = (last or (too_small and bool(safe_stepsize > 0.0))) and not done
                stepsize, value, slope = middle, v, s
            count += 1
        if failed and (safe_stepsize > 0.0 or np.isinf(dec_err)):
            stepsize = safe_stepsize
        return stepsize, count

    def step(self, closure):
        w0 = self._flat(self.params)
        out, g0 = self._evaluate(closure)
        u = self._direction(w0, g0).neg_()
        value_init, slope_init = self._read(out[0], torch.dot(u, g0))
        with np.errstate(all="ignore"):
            stepsize, self.trials = self._line_search(closure, w0, u, value_init, slope_init)
        self._assign(self._point(w0, u, stepsize))
        self._w_prev, self._g_prev = w0, g0
        self.count += 1
        self.stepsize = stepsize
        return out


# --------------------------------------------------------------------------- #
# Objectives, written once for numpy-like namespaces (jnp and torch)
# --------------------------------------------------------------------------- #

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
    """A V along every axis: the curvature test may never be met."""
    def f(x):
        return xp.sum(xp.abs(x - 0.5)) + 0.001 * xp.sum(x)
    return f


def _nan_line(xp):
    """A parabola whose values are NaN beyond x = 5: the expansion steps
    into the NaN region (a decrease error of inf), and the zoom comes back."""
    def f(x):
        return xp.sum((x - 20.0) * (x - 20.0) / 40.0) + xp.sum(xp.where(x > 5.0, xp.nan, 0.0))
    return f


def _concave(xp):
    """-x - x^2: the first search expands until it runs out of steps; the
    pair it leaves has y.s < 0, so the second direction is an ascent
    direction (slope > 0), and that search fails as well."""
    def f(x):
        return xp.sum(-x - x * x)
    return f


def _cubic(xp):
    """A cubic with a local minimum at x = 1 + sqrt(2): zooms by cubic
    steps."""
    def f(x):
        return xp.sum(x * x * x / 3.0 - 2.0 * x * x + 3.0 * x) - 4.0 * xp.sum(x)
    return f


class _TorchNS:
    """The numpy-like namespace the objectives above need, for torch."""
    sum = staticmethod(torch.sum)
    abs = staticmethod(torch.abs)
    nan = float("nan")

    def __init__(self, dtype):
        self.dtype = dtype

    def asarray(self, a):
        return torch.as_tensor(a, dtype=self.dtype)

    def where(self, c, a, b):
        return torch.where(c, torch.as_tensor(a, dtype=self.dtype),
                           torch.as_tensor(b, dtype=self.dtype))


# (objective, x0, iterations, memory, max line-search steps)
CASES = {
    "rosenbrock": (_rosenbrock, [-1.2, 1.0, -0.5, 0.8, 1.3, -1.0], 30, 50, 25),
    "quadratic": (_quadratic, list(np.random.default_rng(7).standard_normal(30)), 30, 50, 25),
    "vee_4": (_vee, [2.0], 8, 10, 4),
    "vee_25": (_vee, [2.0], 8, 10, 25),
    "nan": (_nan_line, [0.0], 2, 10, 25),
    "non_descent": (_concave, [0.0], 3, 10, 4),
    "cubic": (_cubic, [0.0], 1, 10, 25),
}
LINES = ("vee_4", "vee_25", "nan", "non_descent", "cubic")
DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "float64": (np.float64, jnp.float64, torch.float64)}


def _optax_chain(memory_size, max_linesearch_steps=25):
    """The JAX package's L-BFGS chain (trainer.py, _make_lbfgs)."""
    return optax.lbfgs(memory_size=memory_size,
                       linesearch=optax.scale_by_zoom_linesearch(
                           max_linesearch_steps=max_linesearch_steps, verbose=False))


@functools.lru_cache(maxsize=None)
def _optax_run(case, dtype):
    """optax's iterates, stepsizes, trial counts and slopes along the
    direction: float64 jitted, float32 op by op."""
    make_f, x0, iters, memory, max_steps = CASES[case]
    np_dt, jnp_dt, _ = DTYPES[dtype]
    with jax.enable_x64(dtype == "float64"), jax.disable_jit(dtype == "float32"):
        f = make_f(jnp)
        tx = _optax_chain(memory, max_steps)
        w = jnp.asarray(np.asarray(x0, np_dt), dtype=jnp_dt)
        state = tx.init(w)

        def iteration(w, state):
            value, grad = jax.value_and_grad(f)(w)
            updates, state = tx.update(grad, state, w, value=value, grad=grad, value_fn=f)
            return optax.apply_updates(w, updates), state, jnp.vdot(updates, grad)

        if dtype == "float64":
            iteration = jax.jit(iteration)
        out = []
        for _ in range(iters):
            w, state, slope = iteration(w, state)
            ls = state[-1]
            out.append((np.asarray(w), float(ls.learning_rate),
                        int(ls.info.num_linesearch_steps), float(slope)))
    return out


def _torch_run(case, dtype, cls):
    """(iterate, stepsize, trials) per iteration of ``cls`` (the port's
    LBFGS or the frozen host search) on the case's objective in torch."""
    make_f, x0, iters, memory, max_steps = CASES[case]
    tdt = DTYPES[dtype][2]
    f = make_f(_TorchNS(tdt))
    x = torch.tensor(x0, dtype=tdt, requires_grad=True)
    opt = cls([x], memory, max_linesearch_steps=max_steps)

    def closure():
        value = f(x)
        return value, torch.autograd.grad(value, [x])

    out = []
    for _ in range(iters):
        opt.step(closure)
        out.append((x.detach().numpy().copy(), float(opt.stepsize), int(opt.trials)))
    return out


# --------------------------------------------------------------------------- #
# (a) the tensor search against optax
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("case,dtype", [(c, "float64") for c in sorted(CASES)]
                         + [(c, "float32") for c in LINES])
def test_tensor_search_matches_optax(case, dtype):
    ref, got = _optax_run(case, dtype), _torch_run(case, dtype, LBFGS)
    tol = ITER_TOL if dtype == "float64" else F32_STEP_TOL
    for k, ((w_r, lr_r, n_r, _), (w_g, lr_g, n_g)) in enumerate(zip(ref, got)):
        assert n_g == n_r, (k, n_g, n_r)
        assert abs(lr_g - lr_r) <= tol * abs(lr_r), (k, lr_g, lr_r)
        assert rel_to_max(w_g, w_r) < tol, k
    trials = [n for _, _, n, _ in ref]
    if case in ("vee_4", "non_descent") or (case, dtype) == ("vee_25", "float64"):
        assert CASES[case][4] in trials  # a search that ran out of steps
    if case == "non_descent":
        assert any(slope > 0.0 for *_, slope in ref[1:])
    if case in ("rosenbrock", "quadratic"):
        assert len(set(trials)) > 1  # the searches did not all stop at their guess
    if case == "cubic":
        assert trials[0] > 2  # it zoomed


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_tensor_search_matches_the_frozen_host_search(case, dtype):
    """Bit for bit: the same trials, stepsizes and iterates as the host
    search it replaced, on the same torch objective."""
    got, ref = _torch_run(case, dtype, LBFGS), _torch_run(case, dtype, FrozenLBFGS)
    for k, ((w_g, lr_g, n_g), (w_r, lr_r, n_r)) in enumerate(zip(got, ref)):
        assert (n_g, lr_g) == (n_r, lr_r), k
        assert np.array_equal(w_g, w_r, equal_nan=True), k


# --------------------------------------------------------------------------- #
# (b) the three-piece iteration on the Burgers pair, bit for bit
# --------------------------------------------------------------------------- #


def _twin_kernel1(monkeypatch, pde, model):
    """Kernel 1's autograd Function with the plain twins of its CUDA
    kernels on CPU tensors (which counts its launches, from 0, restored
    after the test)."""
    spec = fused_step._spec(model, pde)
    monkeypatch.setattr(fused_step, "_cuda_ops", lambda device: fused_step._TorchOps())
    monkeypatch.setattr(fused_step.fused_residual_loss, "launches", 0)
    monkeypatch.setattr(fused_step.fused_residual_loss, "members", 0)
    monkeypatch.setattr(pde, "_fused_residual_loss",
                        lambda params, z: fused_step._FusedResidualFn.apply(
                            spec, z, *[params[k] for k in spec.leaf_names]))


@pytest.mark.parametrize("route", ["kernel1_twin", "plain_bundle"])
def test_three_pieces_match_the_frozen_step_on_burgers(monkeypatch, route):
    x, t = points(42, 256)
    batch = (torch.from_numpy(x), torch.from_numpy(t), 7)
    runs = []
    for cls in (LBFGS, FrozenLBFGS):
        pair = burgers_pair()
        if route == "plain_bundle":
            pair.tcfg.training.fused_residual_kernel = "off"
        tr = PDETrainer(pair.tmodel, pair.tpde, pair.tcfg)
        assert tr.fused_kernel_active == (route == "kernel1_twin")
        if route == "kernel1_twin":
            _twin_kernel1(monkeypatch, pair.tpde, pair.tmodel)
        params = pair.tmodel.params
        opt = cls(list(params.values()), 50, max_linesearch_steps=25)
        gen = torch.Generator().manual_seed(0)
        steps = []
        for _ in range(5):
            if cls is LBFGS:
                row = tr._lbfgs_step(params, opt, batch, gen)
            else:  # the trainer's objective as it was: reseeded per evaluation
                loss_gen = torch.Generator()

                def objective():
                    losses = tr._sharded_loss(params, batch[0], batch[1],
                                              loss_gen.manual_seed(batch[2]))
                    grads = torch.autograd.grad(losses["total"], opt.params,
                                                allow_unused=True, materialize_grads=True)
                    return losses["total"], grads, losses

                losses = opt.step(objective)[2]
                row = tr._row(losses["total"], losses,
                              tr.adaptive_weights.get_weights(tr._aw_state))
            steps.append((row.clone(), float(opt.stepsize), int(opt.trials)))
        runs.append((steps, {k: v.detach().clone() for k, v in params.items()}))
    (got, got_params), (ref, ref_params) = runs
    for k, ((row_g, lr_g, n_g), (row_r, lr_r, n_r)) in enumerate(zip(got, ref)):
        assert (n_g, lr_g) == (n_r, lr_r) and torch.equal(row_g, row_r), k
    for name, v in got_params.items():
        assert torch.equal(v, ref_params[name]), name


# --------------------------------------------------------------------------- #
# (c) the fixed two-loop
# --------------------------------------------------------------------------- #


class _Ops(TorchDispatchMode):
    """The ATen operations dispatched, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("memory,iters", [(1, 3), (5, 3), (5, 12), (50, 20), (50, 57)])
def test_fixed_two_loop_matches_optax(memory, iters):
    """Every slot at every count, in optax's order: the direction at each
    iteration against ``optax.scale_by_lbfgs``, and the same operations
    dispatched at every count (a replayed graph's launch sequence)."""
    rng = np.random.default_rng(memory * 100 + iters)
    n = 40
    ws = np.cumsum(rng.standard_normal((iters, n)), axis=0)
    A = rng.standard_normal((n, n))
    gs = ws @ (A @ A.T / n + np.eye(n)).T + 0.1 * rng.standard_normal((iters, n))
    with jax.enable_x64(True):
        tx = optax.scale_by_lbfgs(memory_size=memory)
        state = tx.init(jnp.zeros(n))
        update = jax.jit(tx.update)
        ref = []
        for w, g in zip(ws, gs):
            d, state = update(jnp.asarray(g), state, jnp.asarray(w))
            ref.append(np.asarray(d))
    opt = LBFGS([torch.zeros(n, dtype=torch.float64)], memory)
    sequences = set()
    for k, (w, g, r) in enumerate(zip(ws, gs, ref)):
        opt._w0.copy_(torch.from_numpy(w))
        opt._g0.copy_(torch.from_numpy(g))
        with _Ops() as ops:
            d = opt._direction()
        sequences.add(tuple(ops.ops))
        opt._w_prev.copy_(opt._w0)
        opt._g_prev.copy_(opt._g0)
        opt._count.add_(1)
        assert rel_to_max(d, r) < DIR_TOL, k
    assert len(sequences) == 1
    assert iters <= memory or opt.count > memory  # the ring wrapped where it should


# --------------------------------------------------------------------------- #
# (d) evaluations counted on the device, settled at the chunk read
# --------------------------------------------------------------------------- #


def _lbfgs_trainer(hidden=(16, 16), mapping=8, n=64, agent=False):
    pair = burgers_pair(hidden=hidden, mapping=mapping)
    t = pair.tcfg.training
    t.optimizer, t.num_collocation_points, t.validation_frequency = "lbfgs", n, 2
    t.num_boundary_points = t.num_initial_points = 16
    t.early_stopping.enabled = False
    rl = RLAgent(hidden_dim=8, batch_size=2 * n, device="cpu") if agent else None
    return PDETrainer(pair.tmodel, pair.tpde, pair.tcfg, rl_agent=rl), pair


def test_device_evaluations_settle_at_the_chunk_read(monkeypatch):
    """Inside a (simulated) capture every evaluation and kernel-1 launch
    adds to the program's tally; the chunk read settles both, equal."""
    tr, pair = _lbfgs_trainer()
    _twin_kernel1(monkeypatch, pair.tpde, pair.tmodel)
    k1 = fused_step.fused_residual_loss
    params = pair.tmodel.params
    leaves = tr._leaves(params)
    opt = tr._make_lbfgs(leaves)
    batch = tr._lbfgs_batch(0, 0, 64)
    gen = torch.Generator().manual_seed(0)
    program = tr._start_program(params, opt, [gen], 64, batch, 0, 2, 1)
    program.tally = counts.tally(torch.device("cpu"))
    monkeypatch.setattr(counts, "_capturing", lambda: True)
    e0, l0 = LBFGS.evaluations, k1.launches
    program.start_chunk()
    with counts.tallying(program.tally):
        for e in range(2):
            program.run()
            program.unsettled += 1
            program.end_epoch(e, 1, lambda row: row)
    monkeypatch.setattr(counts, "_capturing", lambda: False)
    tallied = program.tally.clone()
    assert (LBFGS.evaluations, k1.launches) == (e0, l0)  # nothing counted on the host
    tr._read_chunk(program, 2, opt)
    evals = LBFGS.evaluations - e0
    slot = counts.COUNTERS.index((LBFGS, "evaluations"))
    assert evals == k1.launches - l0 == int(tallied[slot]) >= 4
    assert int(program.tally.sum()) == 0 and program.unsettled == 0
    program.release()


# --------------------------------------------------------------------------- #
# (e) the capture rule
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("device,mesh,want", [("cuda", None, "graph"), ("cuda", object(), "eager"),
                                              ("cpu", None, "eager"), ("cpu", object(), "eager")])
def test_capture_rule_for_lbfgs(device, mesh, want):
    path, why = step_path(torch.device(device), True, mesh)
    assert path == want and why


# --------------------------------------------------------------------------- #
# (f) the graph path's piece order, with a recorder for the capture
# --------------------------------------------------------------------------- #


class _Recorded:
    """A captured piece that replays by calling it (under an IF node's
    predicate: only where it holds)."""

    def __init__(self, fn, pred, log):
        self.fn, self.pred, self.log = fn, pred, log

    def replay(self):
        if self.pred is None or bool(self.pred):
            self.log.append("replay")
            self.fn()
        else:
            self.log.append("skip")


@pytest.mark.parametrize("agent", [False, True])
def test_graph_path_piece_order_equals_the_eager_program(monkeypatch, agent):
    """The L-BFGS program on its graph path (capture and replay recorded,
    the eager pieces called on the current stream): the run's history and
    parameters (and the agent's networks) equal the eager program's bit for
    bit; the first iteration warms up start, trial 0 and finish eagerly and
    captures the trial; the second captures start, and finish once the
    agent's buffer holds a batch (``ready``: the third iteration here);
    every later iteration replays start, 25 trials (the IF node skipping
    what the search does not need) and finish; the evaluations equal the
    eager run's."""
    runs = []
    for graph in (False, True):
        tr, pair = _lbfgs_trainer(agent=agent)
        log, captured = [], []
        if graph:
            monkeypatch.setattr(trainer_mod, "step_path",
                                lambda device, lbfgs, mesh: ("graph", "recorded"))

            def capture(self, fn, generators, pred=None):
                captured.append((fn, pred is not None))
                return step_program._Captured(_Recorded(fn, pred, log), [], [])

            monkeypatch.setattr(step_program.StepProgram, "_capture", capture)
            monkeypatch.setattr(step_program.StepProgram, "_eager",
                                lambda self, fn: (log.append("eager"), fn()))
        e0 = LBFGS.evaluations
        res = tr.train(num_epochs=4, seed=0)
        params = dict(tr.model.params)
        if agent:
            params.update({f"agent.{k}": v for k, v in tr._rl_state.policy_params.items()})
        runs.append((res["history"], {k: v.detach().clone() for k, v in params.items()},
                     LBFGS.evaluations - e0, tr.programs, log, captured))
        monkeypatch.undo()
    (eh, ep, ee, eprogs, _, _), (gh, gp, ge, gprogs, log, captured) = runs
    assert gh["train_loss"] == eh["train_loss"] and gh["val_loss"] == eh["val_loss"]
    for k, v in gp.items():
        assert torch.equal(v, ep[k]), k
    assert ge == ee
    (program,) = gprogs
    assert program.path == "graph" and program.replays == 4 and program.eager_steps == 0
    assert [has_pred for _, has_pred in captured] == [True, False, False]
    first = log[:log.index("eager", 2) + 1]
    assert first[:2] == ["eager", "eager"] and len(first) == 2 + 24 + 1  # start, trial 0, 24, finish
    eager_finishes = 2 if agent else 1  # until the agent's buffer holds a batch
    assert log.count("eager") == 2 + eager_finishes
    pieces = 3 + 4 - eager_finishes  # start replays, finish replays
    assert log.count("replay") + log.count("skip") == 4 * 25 - 1 + pieces
    assert log.count("replay") - pieces == ee - 4 - 1  # every trial but the eager one, replayed
