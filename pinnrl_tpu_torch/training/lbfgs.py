"""L-BFGS with optax's zoom line search, on one flat parameter vector.

The JAX package's L-BFGS phase runs the optax chain
``optax.lbfgs(memory_size=history_size, linesearch=optax.scale_by_zoom_linesearch(25))``:
``scale_by_lbfgs(scale_init_precond=True)``, ``scale(-1)``, then the zoom
line search with its defaults (slope_rtol 1e-4, curv_rtol 0.9,
approx_dec_rtol 1e-6, increase_factor 2, stepsize_precision 1e-5,
initial_guess_strategy "keep"). ``LBFGS`` does what that chain does, one
iteration per ``step``:

- the memory is a ring of the last ``memory_size`` differences
  s = w_k - w_{k-1}, y = g_k - g_{k-1} with weights rho = 1 / (y.s), 0 where
  y.s == 0 (there is no curvature test); the first iteration writes zeros;
- the initial inverse Hessian is gamma I: gamma = min(1, 1 / ||g||) on the
  first iteration, y.s / y.y (1 where y.y == 0) after it;
- the direction is the two-loop recursion over every slot of the ring,
  newest to oldest and back, in optax's index order (a slot never written
  has weight 0 and changes nothing);
- the zoom search (Nocedal and Wright, algorithms 3.5 and 3.6) expands the
  step by 2 until it brackets a point, then zooms by cubic, quadratic or
  bisection steps; a point is accepted on the Armijo or Hager-Zhang
  approximate decrease test together with the curvature test, and when the
  search runs out of steps it takes the best point that met the decrease
  test (the "safe" step), if any;
- the accepted stepsize is the next search's first guess ("keep").

Everything lives on the parameters' device, in their dtype, in buffers
updated in place: the memory (two ``(memory_size, P)`` tensors, the weights,
the count and the last iterate and gradient), the iteration's start point,
gradient and direction, and the search's state (0-d tensors: the first
guess, the trial count, low/high/cubic reference with their values and
slopes, the safe step and its value, the decrease error, the flags
``interval_found``/``done``/``failed`` and ``active``, whether the search
takes another trial). An iteration is three pieces with no host read:

- ``start``: one evaluation at w0, the two-loop, the initial value and
  slope, the search's initial state;
- ``trial``: one evaluation at w0 + s u, its slope, and the search's
  decision, written once on 0-d tensors with ``torch.where``,
  ``torch.maximum`` and ``torch.minimum`` (separate binary operations, which
  round as numpy and XLA round them), which updates the state and
  ``active``;
- ``finish``: the accepted point (the safe step where the search failed),
  the ring's newest entry, the count and the next first guess.

``step`` runs them eagerly: ``start``, then trials while ``active`` holds
(``search``: one host read per trial after the first, the only reads of
an iteration), then ``finish``. The trainer's step program on the card
replays a captured ``trial`` under an IF node on ``active``
``max_linesearch_steps`` times instead, and reads nothing
(``training/step_program.py``). ``LBFGS.evaluations`` counts the
objective's evaluations (a registered counter of ``ops.kernels.counts``:
a captured evaluation counts on the device, where its trial runs) and
``LBFGS.host_reads`` the eager search's reads, over every instance.

This is not ``torch.optim.LBFGS``: its strong-Wolfe search, inner
``max_iter`` loop and tolerance exits are another algorithm.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from pinnrl_tpu_torch.ops.kernels import counts

# optax.scale_by_zoom_linesearch's defaults, as the JAX package runs it.
_INCREASE_FACTOR = 2.0
_SLOPE_RTOL = 1e-4
_CURV_RTOL = 0.9
_APPROX_DEC_RTOL = 1e-6
_APPROX_SLOPE = 2 * _SLOPE_RTOL - 1.0
_STEPSIZE_PRECISION = 1e-5

# The search's scalar state, in the parameters' dtype, and its flags.
_VALUES = ("value_init", "slope_init", "stepsize", "value", "slope", "low", "value_low",
           "slope_low", "high", "value_high", "slope_high", "cubic_ref", "value_cubic_ref",
           "safe_stepsize", "safe_value", "dec_err")
_FLAGS = ("interval_found", "done", "failed")


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """A critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a; NaN where it has none (optax's ``_cubicmin``; powers as
    XLA's ``integer_pow`` forms them)."""
    C = fpa
    db = b - a
    dc = c - a
    dbc = db * dc
    denom = dbc * dbc * (db - dc)
    r_b = fb - fa - C * db
    r_c = fc - fa - C * dc
    db2, dc2 = db * db, dc * dc
    A = (dc2 * r_b + -db2 * r_c) / denom
    B = (-(dc2 * dc) * r_b + db2 * db * r_c) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """The critical point of the quadratic through (a, fa), (b, fb) with
    slope fpa at a (optax's ``_quadmin``)."""
    db = b - a
    B = (fb - fa - fpa * db) / (db * db)
    return a - fpa / (2.0 * B)


def _nan_to_inf(err: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isnan(err), torch.full_like(err, float("inf")), err)


class LBFGS:
    """``optax.lbfgs`` with ``scale_by_zoom_linesearch`` over ``params``.

    ``step(closure)`` takes one iteration. ``closure()`` evaluates the
    objective at the parameters' current contents and returns
    ``(value, grads, ...)``: a 0-d tensor, one gradient per parameter, and
    anything else. The parameters are left at the accepted point; ``step``
    returns what the closure returned at the starting point.
    """

    host_reads = 0

    def __init__(self, params: Sequence[torch.Tensor], memory_size: int,
                 max_linesearch_steps: int = 25) -> None:
        if memory_size < 1:
            raise ValueError("memory_size must be >= 1")
        self.params: List[torch.Tensor] = list(params)
        dtype = self.params[0].dtype
        if dtype not in (torch.float32, torch.float64) or any(p.dtype != dtype
                                                              for p in self.params):
            raise ValueError(f"LBFGS needs float32 or float64 parameters of one dtype, got {dtype}")
        self._sizes = [p.numel() for p in self.params]
        n = sum(self._sizes)
        self.memory_size = memory_size
        self.max_linesearch_steps = max_linesearch_steps
        device = self.params[0].device
        kw = dict(dtype=dtype, device=device)
        self.s_memory = torch.zeros((memory_size, n), **kw)
        self.y_memory = torch.zeros((memory_size, n), **kw)
        self.rho = torch.zeros(memory_size, **kw)
        self._count = torch.zeros((), dtype=torch.int64, device=device)
        self._slots = torch.arange(memory_size, device=device)
        self._w_prev = torch.zeros(n, **kw)
        self._g_prev = torch.zeros(n, **kw)
        # The iteration's start point, its gradient and the search direction.
        self._w0 = torch.zeros(n, **kw)
        self._g0 = torch.zeros(n, **kw)
        self._u = torch.zeros(n, **kw)
        self._guess = torch.ones((), **kw)  # the next search's first guess
        self._zero = torch.zeros((), **kw)
        self._inf = torch.full((), float("inf"), **kw)
        self._state = {k: torch.zeros((), **kw) for k in _VALUES}
        self._flags = {k: torch.zeros((), dtype=torch.bool, device=device) for k in _FLAGS}
        self.active = torch.zeros((), dtype=torch.bool, device=device)
        self._trials = torch.zeros((), dtype=torch.int64, device=device)

    # ------------------------------------------------------------------ #
    # What the host reads (outside an iteration)
    # ------------------------------------------------------------------ #

    @property
    def count(self) -> int:
        """Iterations taken."""
        return int(self._count)

    @count.setter
    def count(self, value: int) -> None:
        self._count.fill_(value)

    @property
    def stepsize(self) -> float:
        """The last accepted stepsize: the next search's first guess."""
        return float(self._guess)

    @property
    def trials(self) -> int:
        """The line-search evaluations of the last iteration."""
        return int(self._trials)

    # ------------------------------------------------------------------ #
    # Device side
    # ------------------------------------------------------------------ #

    @staticmethod
    def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.cat([t.detach().reshape(-1) for t in tensors])

    @torch.no_grad()
    def _assign(self, stepsize: torch.Tensor) -> None:
        """The parameters <- w0 + stepsize u (a product, then a sum)."""
        w = torch.add(self._w0, torch.mul(self._u, stepsize))
        views = [v.view_as(p) for v, p in zip(w.split(self._sizes), self.params)]
        torch._foreach_copy_(self.params, views)

    def _evaluate(self, closure: Callable[[], Tuple]):
        """(closure's output, its value in the parameters' dtype, flat
        gradient)."""
        out = closure()
        counts.add(LBFGS, "evaluations")
        return out, out[0].detach().reshape(()).to(self._w0.dtype), self._flat(out[1])

    @torch.no_grad()
    def _direction(self) -> torch.Tensor:
        """Write (w0 - w_prev, g0 - g_prev) into the ring's slot count - 1
        (zeros on the first iteration, as optax), then the two-loop
        recursion over every slot: H g0."""
        m, k = self.memory_size, self._count
        first = k == 0
        s = torch.where(first, self._zero, self._w0 - self._w_prev)
        y = torch.where(first, self._zero, self._g0 - self._g_prev)
        ys = torch.dot(y, s)
        i = torch.remainder(k - 1, m).reshape(1)
        self.s_memory.index_copy_(0, i, s.unsqueeze(0))
        self.y_memory.index_copy_(0, i, y.unsqueeze(0))
        self.rho.index_copy_(0, i, torch.where(ys == 0.0, self._zero, 1.0 / ys).reshape(1))
        yy = torch.dot(y, y)
        gamma = torch.where(first, torch.clamp(1.0 / torch.linalg.vector_norm(self._g0), max=1.0),
                            torch.where(yy > 0.0, ys / yy, torch.ones_like(yy)))
        order = torch.remainder(k - 1 - self._slots, m)  # newest first
        S, Y, rho = (t.index_select(0, order) for t in (self.s_memory, self.y_memory, self.rho))
        q = self._g0.clone()
        alphas = []
        for j in range(m):
            alpha = rho[j] * torch.dot(S[j], q)
            q.addcmul_(Y[j], alpha, value=-1.0)
            alphas.append(alpha)
        q.mul_(gamma)
        for j in reversed(range(m)):
            beta = rho[j] * torch.dot(Y[j], q)
            q.addcmul_(S[j], alphas[j] - beta)
        return q

    def start(self, closure: Callable[[], Tuple]) -> Tuple:
        """One evaluation at the parameters (w0), the direction, the
        search's initial state. Returns the closure's output."""
        with torch.no_grad():
            torch.cat([p.detach().reshape(-1) for p in self.params], out=self._w0)
        out, value, g = self._evaluate(closure)
        with torch.no_grad():
            self._g0.copy_(g)
            torch.neg(self._direction(), out=self._u)
            slope = torch.dot(self._u, self._g0)
            st, zero = self._state, self._zero
            init = {"value_init": value, "slope_init": slope, "stepsize": zero, "value": value,
                    "slope": slope, "low": zero, "value_low": value, "slope_low": slope,
                    "high": zero, "value_high": value, "slope_high": slope, "cubic_ref": zero,
                    "value_cubic_ref": value, "safe_stepsize": zero, "safe_value": value,
                    "dec_err": self._inf}
            torch._foreach_copy_([st[k] for k in _VALUES], [init[k] for k in _VALUES])
            torch._foreach_zero_(list(self._flags.values()) + [self._trials])
            self.active.fill_(True)
        return out

    def _decrease_error(self, stepsize, value, slope):
        """How far the Armijo test, or failing it the approximate decrease
        test, is from holding (0 where one holds; inf for NaN)."""
        st = self._state
        value_init, slope_init = st["value_init"], st["slope_init"]
        err = value - value_init - _SLOPE_RTOL * stepsize * slope_init
        approx = slope - _APPROX_SLOPE * slope_init
        approx = torch.maximum(approx, value - value_init - _APPROX_DEC_RTOL * torch.abs(value_init))
        return _nan_to_inf(torch.clamp_min(torch.minimum(approx, err), 0.0))

    def _curvature_error(self, slope):
        err = torch.abs(slope) - _CURV_RTOL * torch.abs(self._state["slope_init"])
        return _nan_to_inf(torch.clamp_min(err, 0.0))

    def trial(self, closure: Callable[[], Tuple]) -> None:
        """One trial of the search: its stepsize (the expansion's next, or
        the zoom's middle), one evaluation there, its slope, and the
        decision, written into the state in place."""
        st, fl = self._state, self._flags
        found = fl["interval_found"]
        with torch.no_grad():
            stepsize, low, high = st["stepsize"], st["low"], st["high"]
            value_low, slope_low = st["value_low"], st["slope_low"]
            value_high, slope_high = st["value_high"], st["slope_high"]
            expand = torch.where(self._trials == 0, self._guess, _INCREASE_FACTOR * stepsize)
            # Zoom into [low, high] by a cubic, quadratic or bisection step.
            delta = torch.abs(high - low)
            left, right = torch.minimum(high, low), torch.maximum(high, low)
            cubic_chk, quad_chk = 0.2 * delta, 0.1 * delta
            cubic = _cubicmin(low, value_low, slope_low, high, value_high, st["cubic_ref"],
                              st["value_cubic_ref"])
            use_cubic = (cubic > left + cubic_chk) & (cubic < right - cubic_chk)
            quad = _quadmin(low, value_low, slope_low, high, value_high)
            use_quad = ~use_cubic & (quad > left + quad_chk) & (quad < right - quad_chk)
            middle = torch.where(use_cubic, cubic, torch.where(use_quad, quad, (low + high) / 2.0))
            new = torch.where(found, middle, expand)
            self._assign(new)
        _, v, g = self._evaluate(closure)
        with torch.no_grad():
            s = torch.dot(g, self._u)
            dec = self._decrease_error(new, v, s)
            done = torch.maximum(dec, self._curvature_error(s)) <= 0.0
            last = self._trials + 1 >= self.max_linesearch_steps
            # Expansion (no interval yet): bracket from the previous trial.
            safe_e = dec <= 0.0
            set_high = (dec > 0.0) | ((v >= st["value"]) & (self._trials > 0))
            set_low = (s >= 0.0) & ~set_high
            low_e = torch.where(set_low, new, stepsize)
            value_low_e = torch.where(set_low, v, st["value"])
            slope_low_e = torch.where(set_low, s, st["slope"])
            # Zoom: shrink the interval around the middle.
            safe_z = (dec <= 0.0) & (v < st["safe_value"])
            to_middle = (dec > 0.0) | (v >= value_low)
            to_low = (s * (high - low) >= 0.0) & ~to_middle
            take_safe = torch.where(found, safe_z, safe_e)
            safe_stepsize = torch.where(take_safe, new, st["safe_stepsize"])
            failed_z = (last | ((delta <= _STEPSIZE_PRECISION) & (safe_stepsize > 0.0))) & ~done
            ref_high = to_middle | to_low

            def pick(zoom, expansion):
                return torch.where(found, zoom, expansion)

            new_state = {
                "stepsize": new, "value": v, "slope": s, "dec_err": dec,
                "low": pick(torch.where(to_middle, low, new), low_e),
                "value_low": pick(torch.where(to_middle, value_low, v), value_low_e),
                "slope_low": pick(torch.where(to_middle, slope_low, s), slope_low_e),
                "high": pick(torch.where(to_middle, new, torch.where(to_low, low, high)),
                             torch.where(set_low, stepsize, new)),
                "value_high": pick(torch.where(to_middle, v, torch.where(to_low, value_low,
                                                                         value_high)),
                                   torch.where(set_low, st["value"], v)),
                "slope_high": pick(torch.where(to_middle, s, torch.where(to_low, slope_low,
                                                                         slope_high)),
                                   torch.where(set_low, st["slope"], s)),
                "cubic_ref": pick(torch.where(ref_high, high, low), low_e),
                "value_cubic_ref": pick(torch.where(ref_high, value_high, value_low), value_low_e),
                "safe_stepsize": safe_stepsize,
                "safe_value": torch.where(take_safe, v, st["safe_value"]),
            }
            failed = pick(failed_z, last & ~done)
            new_flags = {"interval_found": found | set_high | set_low | done, "done": done,
                         "failed": failed}
            keys = [k for k in _VALUES if k in new_state]
            torch._foreach_copy_([st[k] for k in keys], [new_state[k] for k in keys])
            torch._foreach_copy_([fl[k] for k in _FLAGS], [new_flags[k] for k in _FLAGS])
            self.active.copy_(~(done | failed))
            self._trials.add_(1)

    @torch.no_grad()
    def finish(self) -> None:
        """Take the accepted stepsize (the safe one where the search failed
        and has one, or left the domain), keep this iteration's point and
        gradient for the next ring entry, and keep the stepsize as the next
        first guess."""
        st = self._state
        use_safe = self._flags["failed"] & ((st["safe_stepsize"] > 0.0)
                                            | torch.isinf(st["dec_err"]))
        stepsize = torch.where(use_safe, st["safe_stepsize"], st["stepsize"])
        self._assign(stepsize)
        torch._foreach_copy_([self._w_prev, self._g_prev, self._guess],
                             [self._w0, self._g0, stepsize])
        self._count.add_(1)

    def more(self) -> bool:
        """Whether the search takes another trial: one host read."""
        LBFGS.host_reads += 1
        return bool(self.active)

    def search(self, trial: Callable[[], None]) -> None:
        """The eager line search: ``trial()`` while ``more()`` (the first
        trial always runs)."""
        for k in range(self.max_linesearch_steps):
            if k and not self.more():
                break
            trial()

    def step(self, closure: Callable[[], Tuple]) -> Tuple:
        out = self.start(closure)
        self.search(lambda: self.trial(closure))
        self.finish()
        return out

    # ------------------------------------------------------------------ #
    # State
    # ------------------------------------------------------------------ #

    def state_dict(self) -> dict:
        count = self.count
        return {"count": count, "stepsize": self.stepsize, "s_memory": self.s_memory,
                "y_memory": self.y_memory, "rho": self.rho,
                "params": self._w_prev if count else None,
                "grads": self._g_prev if count else None}

    def arrays(self, names: Sequence[str]) -> dict:
        """The state as numpy arrays (a checkpoint's): the memory, the
        step count and first guess, and the last iterate and gradient."""
        count = self.count
        out = {"lbfgs/count": np.asarray(count), "lbfgs/stepsize": self._guess.cpu().numpy(),
               "lbfgs/names": np.asarray(list(names))}
        for key in ("s_memory", "y_memory", "rho"):
            out[f"lbfgs/{key}"] = getattr(self, key).cpu().numpy()
        if count:
            out["lbfgs/w_prev"] = self._w_prev.cpu().numpy()
            out["lbfgs/g_prev"] = self._g_prev.cpu().numpy()
        return out

    @torch.no_grad()
    def load_arrays(self, arrays: dict, names: Sequence[str]) -> None:
        """Restore what ``arrays`` wrote, in place; raises KeyError on the
        state of another problem."""
        if list(arrays["lbfgs/names"]) != list(names) or \
                arrays["lbfgs/s_memory"].shape != tuple(self.s_memory.shape):
            raise KeyError("the L-BFGS memory does not match these parameters")
        targets = {"s_memory": self.s_memory, "y_memory": self.y_memory, "rho": self.rho,
                   "count": self._count, "stepsize": self._guess, "w_prev": self._w_prev,
                   "g_prev": self._g_prev}
        for key, target in targets.items():
            if f"lbfgs/{key}" in arrays:
                target.copy_(torch.as_tensor(arrays[f"lbfgs/{key}"]).reshape(target.shape))


counts.register(LBFGS, "evaluations")
