"""The trainer's step program: one optimizer step over persistent state,
captured once per phase as CUDA graphs and replayed once per step.

The JAX package runs a whole validation interval as one device call (a
``lax.scan`` over fused steps inside ``jax.jit``) and reads its metrics once
at the chunk's end. The port keeps the per-step structure and removes the
host from it: every phase on the card captures its step into
``torch.cuda.CUDAGraph`` objects and replays them at each step, so a step
issues no Python, no dispatcher work and no kernel launches of its own. The
graphs' size and capture time do not grow with ``validation_frequency``.

An Adam step is one graph. An L-BFGS iteration (``Search``) is three graphs
in one memory pool: ``start`` (one evaluation, the two-loop, the search's
initial state), ``trial`` (one trial of the zoom line search, its whole body
under an IF node on the search's ``active`` flag, ``if_node``) and
``finish`` (the accepted point, the ring, the agent's update and the row). A
step replays ``start``, then ``trial`` ``steps`` times, then ``finish``: a
trial the search does not need runs only the kernel that sets the node's
condition, so the card runs exactly the evaluations of the JAX package's
``lax.while_loop``, and the host reads nothing until the chunk's end.

A replay runs the kernels on the addresses the capture recorded and runs no
host code, so the step keeps its state where the capture saw it:

- every tensor it reads at its start is a buffer that it updates in place:
  the parameters and the gradients, Adam's moments and step counts, the
  learning rate (a device tensor that ``AdamStep.prepare`` writes before each
  replay), the plateau state, the adaptive-weight state, the EMA shadow,
  L-BFGS's memory, point, direction and search state, the agent's networks,
  replay buffer, counters and epsilon, and the last points; its row goes
  into slot ``slot`` of ``rows`` and advances ``slot``. What one graph of an
  L-BFGS step hands to the next lives in such buffers too, so the graphs may
  be captured in any order;
- what the host keeps as Python numbers is advanced per replay: each
  optimizer that stepped in the capture is prepared before and advanced
  after every replay (``AdamStep.count``), and each of the trainer's host
  counts (``counters``: the EMA's count) takes the increment that the
  capture made;
- the kernels' launch counters (and ``LBFGS.evaluations``) are counted on
  the device: the captures run inside ``ops.kernels.counts.tallying(tally)``,
  so each wrapper records an add into ``tally`` beside its launch, and every
  replay makes it where its kernel runs (a skipped trial adds nothing); the
  trainer reads the tally with the chunk's rows and ``settle`` moves it
  into the counters, so a kernel's ``launches`` counts what ran;
- the generators the step draws from are registered with the graph
  (``CUDAGraph.register_generator_state``): a replay draws what an eager
  step at the same offset would. The L-BFGS objective draws its BC/IC
  points from a generator reseeded at every evaluation; ``Search.reseed``
  reseeds it on the host before each replay of ``start`` and ``trial``.

An Adam phase's first steps run eagerly on a side stream (as torch
documents whole-step capture); they are real steps of the run. The capture
follows once ``ready()`` holds (the agent's buffer holds a batch, so its
train branch is fixed from then on). An L-BFGS program warms each piece up
inside its first iteration instead, with no host read: ``start`` and the
first trial (which always runs) eagerly, then the trial's capture and
replays, then ``finish`` eagerly; the next iteration captures ``start`` and
``finish``. A capture or replay that fails raises: nothing falls back to
the eager step. On the CPU and under a device mesh (``step_path``) the
program calls the step eagerly, one call per step, and an eager L-BFGS
step reads the search's ``active`` once per trial; a program whose warm-up
never ends (``WARMUP_STEPS`` patched past the run) takes every step
eagerly, the comparisons' eager run.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import logging
import time
from typing import Any, Callable, Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import torch

from pinnrl_tpu_torch.ops.kernels import counts

logger = logging.getLogger(__name__)

# Eager steps before the capture: Adam creates its state at its first step,
# and the kernels are built, traced and cached at their first call.
WARMUP_STEPS = 1


def step_path(device: torch.device, lbfgs: bool, mesh: Any) -> Tuple[str, str]:
    """How a phase's steps run, and why: ``"graph"`` (captured once, replayed
    per step) for every phase on the card, Adam and L-BFGS; ``"eager"``
    otherwise."""
    if device.type != "cuda":
        return "eager", "not on a card"
    if mesh is not None:
        return "eager", "device mesh: the collectives are not captured"
    if lbfgs:
        return "graph", "an L-BFGS phase on the card: the line search on the device"
    return "graph", "an Adam phase on the card"


def _graph_cond() -> ctypes.CDLL:
    """``csrc/graph_cond.cu``, built and loaded (its module too)."""
    from pinnrl_tpu_torch.ops.kernels._build import check, load_library

    lib = load_library("graph_cond")
    if not getattr(lib, "ready", False):
        lib.gc_load.restype = lib.gc_begin_if.restype = lib.gc_end.restype = ctypes.c_int
        lib.gc_load.argtypes = []
        lib.gc_begin_if.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.gc_end.argtypes = [ctypes.c_void_p]
        check(lib.gc_load(), "gc_load")
        lib.ready = True
    return lib


@contextlib.contextmanager
def if_node(pred: torch.Tensor, pool: Tuple[int, int]) -> Iterator[None]:
    """Inside a capture on the current stream: capture the block into the
    body of an IF node that runs at each replay where ``pred`` (a 0-d bool
    tensor on the card) holds. The block runs on a stream of its own, and
    its allocations go to memory pool ``pool`` (not the capture's: the
    allocator routes one capture at a time to a pool); the caller releases
    the block's hold on it after the graph (``torch._C._cuda_releasePool``).
    torch 2.11 has no binding of CUDA's conditional nodes, so
    ``csrc/graph_cond.cu`` makes the node."""
    from pinnrl_tpu_torch.ops.kernels._build import check

    if pred.dtype != torch.bool or pred.numel() != 1 or pred.device.type != "cuda":
        raise ValueError("if_node: the predicate must be one bool on the card")
    lib = _graph_cond()
    device = pred.device
    index = torch.cuda.current_device() if device.index is None else device.index
    outer = torch.cuda.current_stream(device)
    body = torch.cuda.Stream(device)
    check(lib.gc_begin_if(outer.cuda_stream, pred.data_ptr(), body.cuda_stream), "gc_begin_if")
    # A synchronizing call inside the body would invalidate its capture, and
    # CUDA then leaves the outer graph unusable (its end crashes the
    # process): torch raises at such a call instead, before it reaches CUDA.
    sync_mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.cuda.stream(body):
            torch._C._cuda_beginAllocateCurrentStreamToPool(index, pool)
            try:
                yield
            finally:
                torch._C._cuda_endAllocateToPool(index, pool)
    finally:
        torch.cuda.set_sync_debug_mode(sync_mode)
        check(lib.gc_end(body.cuda_stream), "gc_end")


class Search(NamedTuple):
    """An L-BFGS step in pieces: ``start()``, then ``trial()`` while
    ``active`` holds, at most ``steps`` times, then ``finish()``, which
    returns the row; ``reseed()`` resets the objective's generators
    (``generators``, which ``start`` and ``trial`` draw from), before each
    replay of a piece that evaluates it."""
    start: Callable[[], None]
    trial: Callable[[], None]
    finish: Callable[[], torch.Tensor]
    active: torch.Tensor
    steps: int
    reseed: Callable[[], None]
    generators: Sequence[torch.Generator]


class _Captured(NamedTuple):
    graph: torch.cuda.CUDAGraph
    stepped: List[Any]  # optimizers that stepped in the capture
    deltas: List[Tuple[Any, str, Any]]  # what the capture added to host counters


class StepProgram:
    """``body()`` runs one step and returns its row; ``run()`` takes one
    step on ``path`` and writes the row into ``rows[slot]``. With
    ``search`` the step is an L-BFGS iteration: ``body`` runs it eagerly,
    and the graph path captures its pieces."""

    def __init__(self, body: Callable[[], torch.Tensor], path: str, device: torch.device,
                 capacity: int, epochs: int, generators: Sequence[torch.Generator] = (),
                 optimizers: Sequence[Any] = (), counters: Sequence[Tuple[Any, str]] = (),
                 ready: Callable[[], bool] = lambda: True, name: str = "adam",
                 search: Optional[Search] = None) -> None:
        self.body = body
        self.path = path
        self.device = device
        self.capacity = int(capacity)
        self.n_epochs = int(epochs)
        self.generators = list(generators)
        self.optimizers = list(optimizers)
        self.counters = list(counters)
        self.ready = ready
        self.name = name
        self.search = search
        self.rows: Optional[torch.Tensor] = None  # (capacity, columns): the chunk's step rows
        self.slot: Optional[torch.Tensor] = None  # (1,) int64: the next row
        self.epochs: Optional[torch.Tensor] = None  # (epochs, columns): the chunk's epoch rows
        self.graphs: Dict[str, _Captured] = {}  # "step", or "start" / "trial" / "finish"
        self.tally: Optional[torch.Tensor] = None  # the replays' kernel launches (``counts``)
        self.unsettled = 0  # replays since the tally was last settled
        self.eager_steps = 0
        self.replays = 0
        self.capture_s: Optional[float] = None
        self.pool_bytes: Optional[int] = None
        # The graphs' memory pool (and their IF bodies'); ``_body_holds``: the
        # bodies' holds on it, released with the graphs.
        self._pool: Optional[Tuple[int, int]] = None
        self._body_holds = 0
        self._warm: set = set()  # pieces that ran eagerly (an L-BFGS step's warm-up)
        self._side: Optional[torch.cuda.Stream] = None  # the warm-up's stream

    @property
    def graph(self) -> Optional[torch.cuda.CUDAGraph]:
        """The first captured graph, or None before the capture (and after
        ``release``)."""
        return next(iter(self.graphs.values())).graph if self.graphs else None

    # ------------------------------------------------------------------ #

    def start_chunk(self) -> None:
        """The chunk's first step writes row 0."""
        if self.slot is not None:
            self.slot.zero_()

    def run(self) -> None:
        """One step: eager, or a replay of the captured step (captured first
        once the warm-up is done)."""
        if self.search is not None and self.path == "graph" \
                and self.eager_steps >= WARMUP_STEPS - 1:
            self._search_step()
            return
        if self.search is None and self.path == "graph" and not self.graphs \
                and self.eager_steps >= WARMUP_STEPS and self.ready():
            self.graphs["step"] = self._capture(self._call, self.generators)
        if "step" in self.graphs:
            self._replay(self.graphs["step"])
            self.replays += 1
            self.unsettled += 1
            return
        if self.path == "graph":
            self._eager(self._call)
        else:
            self._call()
        self.eager_steps += 1

    def _eager(self, fn: Callable[[], Any]) -> None:
        """``fn()`` on the warm-up's side stream, ordered after and before
        the current stream's work."""
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        side, main = self._side, torch.cuda.current_stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            fn()
        main.wait_stream(side)

    def _call(self) -> None:
        self._write_row(self.body())

    def _write_row(self, row: torch.Tensor) -> None:
        row = row.detach().reshape(1, -1)
        if self.rows is None:
            self.rows = torch.zeros((self.capacity, row.shape[1]), dtype=row.dtype,
                                    device=row.device)
            self.slot = torch.zeros(1, dtype=torch.int64, device=row.device)
        self.rows.index_copy_(0, self.slot, row.to(self.rows.dtype))
        self.slot.add_(1)

    # ------------------------------------------------------------------ #
    # An L-BFGS iteration on the graph path
    # ------------------------------------------------------------------ #

    def _search_step(self) -> None:
        """``start``, ``steps`` trials and ``finish``, each replayed where it
        is captured, warmed up eagerly (then captured) where it is not."""
        search = self.search
        self._piece("start", search.start, search.generators)
        done = 0
        if "trial" not in self.graphs:
            if "trial" not in self._warm:
                self._eager(search.trial)  # a search's first trial always runs
                self._warm.add("trial")
                done = 1
            self.graphs["trial"] = self._capture(search.trial, search.generators,
                                                 pred=search.active)
        for _ in range(done, search.steps):
            search.reseed()
            self._replay(self.graphs["trial"])
        self._piece("finish", lambda: self._write_row(search.finish()), self.generators)
        self.replays += 1
        self.unsettled += 1

    def _piece(self, key: str, fn: Callable[[], Any], generators) -> None:
        captured = self.graphs.get(key)
        if captured is None and key in self._warm and (key != "finish" or self.ready()):
            captured = self.graphs[key] = self._capture(fn, generators)
        if captured is None:
            self._eager(fn)
            self._warm.add(key)
            return
        if key == "start":
            self.search.reseed()
        self._replay(captured)

    # ------------------------------------------------------------------ #

    def _capture(self, fn: Callable[[], Any], generators: Sequence[torch.Generator],
                 pred: Optional[torch.Tensor] = None) -> _Captured:
        """Capture ``fn()`` into a new graph of the program's pool (under an
        IF node on ``pred`` if given)."""
        before = [getattr(owner, attr) for owner, attr in self.counters]
        for opt in self.optimizers:
            opt.captured = False
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            graph.register_generator_state(gen)
        # As torch.cuda.graph does on entry, so the bytes below are the capture's.
        torch.cuda.synchronize(self.device)
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        if self.tally is None:
            self.tally = counts.tally(self.device)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        if pred is not None:
            _graph_cond()  # built and loaded outside the capture's time
        t0 = time.perf_counter()
        # An IF node's graph allocates nothing outside its body, and its body
        # allocates from the program's pool (a pool takes one capture at a
        # time): what the body frees serves the other pieces' captures, as
        # the graphs share no live block (what one hands the next is in
        # persistent buffers).
        with counts.tallying(self.tally), \
                torch.cuda.graph(graph, pool=self._pool if pred is None else None):
            if pred is None:
                fn()
            else:
                with if_node(pred, self._pool):
                    self._body_holds += 1  # the body's hold on the pool
                    fn()
        torch.cuda.synchronize(self.device)
        seconds = time.perf_counter() - t0
        grown = torch.cuda.memory_reserved(self.device) - reserved
        self.capture_s = (self.capture_s or 0.0) + seconds
        self.pool_bytes = (self.pool_bytes or 0) + grown
        # The capture ran no step: put the host counts back, and add its
        # increments at each replay instead.
        deltas = []
        for (owner, attr), value in zip(self.counters, before):
            delta = getattr(owner, attr) - value
            setattr(owner, attr, value)
            if delta:
                deltas.append((owner, attr, delta))
        logger.info("%s step captured in %.3f s (%d bytes reserved)", self.name, seconds, grown)
        return _Captured(graph, [opt for opt in self.optimizers if opt.captured], deltas)

    @staticmethod
    def _replay(captured: _Captured) -> None:
        for opt in captured.stepped:
            opt.prepare()
        captured.graph.replay()
        for opt in captured.stepped:
            opt.advance()
        for owner, attr, delta in captured.deltas:
            setattr(owner, attr, getattr(owner, attr) + delta)

    # ------------------------------------------------------------------ #

    def end_epoch(self, e: int, steps: int, reduce: Callable[[torch.Tensor], torch.Tensor],
                  extra: Optional[torch.Tensor] = None) -> None:
        """Epoch ``e`` of the chunk: the mean of its ``steps`` rows (through
        ``reduce``, the mesh's mean), then ``extra``, into ``epochs[e]``."""
        row = reduce(self.rows[e * steps:(e + 1) * steps].mean(dim=0))
        if extra is not None:
            row = torch.cat([row, extra])
        if self.epochs is None or self.epochs.shape[1] != row.shape[0]:
            self.epochs = torch.zeros((self.n_epochs, row.shape[0]), dtype=row.dtype,
                                      device=row.device)
        self.epochs[e].copy_(row)

    def settle(self, values: Optional[Sequence[float]] = None) -> None:
        """Move the tally (``values``, as read with the chunk's rows; read
        here if None) into the kernels' launch counters."""
        if self.tally is None or not self.unsettled:
            return
        counts.settle(self.tally, self.tally.tolist() if values is None else values)
        self.unsettled = 0

    def release(self) -> None:
        """Free the graphs and the buffers (the phase is over)."""
        self.settle()
        self.graphs = {}
        self.tally = None
        self.rows = self.slot = self.epochs = None
        if self._body_holds:
            gc.collect()  # the graphs first
            index = self.device.index if self.device.index is not None \
                else torch.cuda.current_device()
            for _ in range(self._body_holds):
                torch._C._cuda_releasePool(index, self._pool)
            self._body_holds = 0

    def stats(self) -> dict:
        """How the phase ran: its path, eager steps, replays, capture
        seconds and the bytes the captures reserved."""
        return {"name": self.name, "path": self.path, "eager_steps": self.eager_steps,
                "replays": self.replays, "capture_s": self.capture_s,
                "pool_bytes": self.pool_bytes}
