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
  y.s == 0 (there is no curvature test);
- the initial inverse Hessian is gamma I: gamma = min(1, 1 / ||g||) on the
  first iteration, y.s / y.y (1 where y.y == 0) after it;
- the direction is the two-loop recursion, newest entry to oldest and back,
  in optax's index order; entries never written are skipped (their weight
  is 0, so optax's pass over them changes nothing);
- the zoom search (Nocedal and Wright, algorithms 3.5 and 3.6) expands the
  step by 2 until it brackets a point, then zooms by cubic, quadratic or
  bisection steps; a point is accepted on the Armijo or Hager-Zhang
  approximate decrease test together with the curvature test, and when the
  search runs out of steps it takes the best point that met the decrease
  test (the "safe" step), if any;
- the accepted stepsize is the next search's first guess ("keep").

Vectors stay on the parameters' device: the memory is two
``(memory_size, P)`` tensors and the two-loop runs on device scalars. The
search decides on the host, in the parameters' dtype (numpy scalars, whose
IEEE rules match XLA's): each evaluation's value and slope come back in one
transfer. ``LBFGS.evaluations`` counts the objective's evaluations and
``LBFGS.host_reads`` those transfers, over every instance.

This is not ``torch.optim.LBFGS``: its strong-Wolfe search, inner
``max_iter`` loop and tolerance exits are another algorithm.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

_HOST_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}
# optax.scale_by_zoom_linesearch's defaults, as the JAX package runs it.
_INCREASE_FACTOR = 2.0
_SLOPE_RTOL = 1e-4
_CURV_RTOL = 0.9
_APPROX_DEC_RTOL = 1e-6
_STEPSIZE_PRECISION = 1e-5


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """A critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a; NaN where it has none (optax's ``_cubicmin``)."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    r_b = fb - fa - C * db
    r_c = fc - fa - C * dc
    A = (dc**2 * r_b + -(db**2) * r_c) / denom
    B = (-(dc**3) * r_b + db**3 * r_c) / denom
    radical = B * B - type(a)(3.0) * A * C
    return a + (-B + np.sqrt(radical)) / (type(a)(3.0) * A)


def _quadmin(a, fa, fpa, b, fb):
    """The critical point of the quadratic through (a, fa), (b, fb) with
    slope fpa at a (optax's ``_quadmin``)."""
    db = b - a
    B = (fb - fa - fpa * db) / (db**2)
    return a - fpa / (type(a)(2.0) * B)


class LBFGS:
    """``optax.lbfgs`` with ``scale_by_zoom_linesearch`` over ``params``.

    ``step(closure)`` takes one iteration. ``closure()`` evaluates the
    objective at the parameters' current contents and returns
    ``(value, grads, ...)``: a 0-d tensor, one gradient per parameter, and
    anything else. The parameters are left at the accepted point; ``step``
    returns what the closure returned at the starting point.
    """

    evaluations = 0
    host_reads = 0

    def __init__(self, params: Sequence[torch.Tensor], memory_size: int,
                 max_linesearch_steps: int = 25) -> None:
        if memory_size < 1:
            raise ValueError("memory_size must be >= 1")
        self.params: List[torch.Tensor] = list(params)
        dtype = self.params[0].dtype
        if dtype not in _HOST_DTYPES or any(p.dtype != dtype for p in self.params):
            raise ValueError(f"LBFGS needs float32 or float64 parameters of one dtype, got {dtype}")
        self.F = F = _HOST_DTYPES[dtype]
        self._sizes = [p.numel() for p in self.params]
        n = sum(self._sizes)
        self.memory_size = memory_size
        self.max_linesearch_steps = max_linesearch_steps
        # The search's constants in the parameters' dtype, as optax's weak types.
        self.increase_factor = F(_INCREASE_FACTOR)
        self.slope_rtol = F(_SLOPE_RTOL)
        self.curv_rtol = F(_CURV_RTOL)
        self.approx_dec_rtol = F(_APPROX_DEC_RTOL)
        self.approx_slope = F(2 * _SLOPE_RTOL - 1.0)
        self.stepsize_precision = F(_STEPSIZE_PRECISION)
        kw = dict(dtype=dtype, device=self.params[0].device)
        self.s_memory = torch.zeros((memory_size, n), **kw)
        self.y_memory = torch.zeros((memory_size, n), **kw)
        self.rho = torch.zeros(memory_size, **kw)
        self.count = 0
        self.stepsize = F(1.0)  # the next search's first guess
        self._w_prev: Optional[torch.Tensor] = None
        self._g_prev: Optional[torch.Tensor] = None
        self.trials = 0  # line-search evaluations of the last step

    # ------------------------------------------------------------------ #
    # Device side
    # ------------------------------------------------------------------ #

    def _flat(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.cat([t.detach().reshape(-1) for t in tensors])

    @torch.no_grad()
    def _assign(self, w: torch.Tensor) -> None:
        views = [v.view_as(p) for v, p in zip(w.split(self._sizes), self.params)]
        torch._foreach_copy_(self.params, views)

    def _evaluate(self, closure: Callable[[], Tuple], w: Optional[torch.Tensor] = None):
        """(closure's output, flat gradient), at ``w`` if given."""
        if w is not None:
            self._assign(w)
        out = closure()
        LBFGS.evaluations += 1
        return out, self._flat(out[1])

    def _read(self, *scalars: torch.Tensor):
        """0-d device tensors -> host scalars, in one transfer."""
        LBFGS.host_reads += 1
        vals = torch.stack([s.detach().reshape(()).to(self.s_memory.dtype) for s in scalars]).cpu()
        return [self.F(v) for v in vals.numpy()]

    @torch.no_grad()
    def _direction(self, w: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        """Write (w - w_prev, g - g_prev) into the ring, then the two-loop
        recursion: H g."""
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
        order = [(k - 1 - j) % m for j in range(min(k, m))]  # newest first
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

    def _trial(self, closure, w0: torch.Tensor, u: torch.Tensor, stepsize):
        """(value, slope) at w0 + stepsize u."""
        out, g = self._evaluate(closure, torch.add(w0, u, alpha=float(stepsize)))
        return self._read(out[0], torch.dot(g, u))

    # ------------------------------------------------------------------ #
    # Host side: the zoom line search
    # ------------------------------------------------------------------ #

    def _decrease_error(self, stepsize, value, slope, value_init, slope_init):
        """How far the Armijo test, or failing it the approximate decrease
        test, is from holding (0 where one holds; inf for NaN)."""
        err = value - value_init - self.slope_rtol * stepsize * slope_init
        approx = slope - self.approx_slope * slope_init
        approx = np.maximum(approx, value - value_init - self.approx_dec_rtol * np.abs(value_init))
        err = np.maximum(np.minimum(approx, err), self.F(0.0))
        return self.F(np.inf) if np.isnan(err) else err

    def _curvature_error(self, slope, slope_init):
        err = np.maximum(np.abs(slope) - self.curv_rtol * np.abs(slope_init), self.F(0.0))
        return self.F(np.inf) if np.isnan(err) else err

    def _line_search(self, closure, w0, u, value_init, slope_init):
        """The accepted stepsize along ``u`` and the number of trials."""
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
                # Expand until an interval holds a point that meets both tests.
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
                # Zoom into [low, high] by cubic, quadratic or bisection steps.
                delta = np.abs(high - low)
                left, right = np.minimum(high, low), np.maximum(high, low)
                cubic_chk, quad_chk = F(0.2) * delta, F(0.1) * delta
                too_small = bool(delta <= self.stepsize_precision)
                middle = _cubicmin(low, value_low, slope_low, high, value_high, cubic_ref,
                                   value_cubic_ref)
                if not (middle > left + cubic_chk and middle < right - cubic_chk):
                    middle = _quadmin(low, value_low, slope_low, high, value_high)
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

    # ------------------------------------------------------------------ #
    # One iteration
    # ------------------------------------------------------------------ #

    def step(self, closure: Callable[[], Tuple]) -> Tuple:
        w0 = self._flat(self.params)
        out, g0 = self._evaluate(closure)
        u = self._direction(w0, g0).neg_()
        value_init, slope_init = self._read(out[0], torch.dot(u, g0))
        with np.errstate(all="ignore"):
            stepsize, self.trials = self._line_search(closure, w0, u, value_init, slope_init)
        self._assign(torch.add(w0, u, alpha=float(stepsize)))
        self._w_prev, self._g_prev = w0, g0
        self.count += 1
        self.stepsize = stepsize
        return out

    def state_dict(self) -> dict:
        return {"count": self.count, "stepsize": float(self.stepsize), "s_memory": self.s_memory,
                "y_memory": self.y_memory, "rho": self.rho, "params": self._w_prev,
                "grads": self._g_prev}

    def arrays(self, names: Sequence[str]) -> dict:
        """The state as numpy arrays (a checkpoint's): the memory, the
        step count and first guess, and the last iterate and gradient."""
        out = {"lbfgs/count": np.asarray(self.count), "lbfgs/stepsize": np.asarray(self.stepsize),
               "lbfgs/names": np.asarray(list(names))}
        for key in ("s_memory", "y_memory", "rho"):
            out[f"lbfgs/{key}"] = getattr(self, key).cpu().numpy()
        if self._w_prev is not None:
            out["lbfgs/w_prev"] = self._w_prev.cpu().numpy()
            out["lbfgs/g_prev"] = self._g_prev.cpu().numpy()
        return out

    def load_arrays(self, arrays: dict, names: Sequence[str]) -> None:
        """Restore what ``arrays`` wrote; raises KeyError on the state of
        another problem."""
        if list(arrays["lbfgs/names"]) != list(names) or \
                arrays["lbfgs/s_memory"].shape != tuple(self.s_memory.shape):
            raise KeyError("the L-BFGS memory does not match these parameters")
        dev = self.s_memory.device

        def load(key):
            return torch.as_tensor(arrays[key]).to(dev)

        for key in ("s_memory", "y_memory", "rho"):
            setattr(self, key, load(f"lbfgs/{key}"))
        self.count = int(arrays["lbfgs/count"])
        self.stepsize = self.F(arrays["lbfgs/stepsize"])
        if "lbfgs/w_prev" in arrays:
            self._w_prev, self._g_prev = load("lbfgs/w_prev"), load("lbfgs/g_prev")
