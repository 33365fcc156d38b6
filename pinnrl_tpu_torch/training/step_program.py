"""The trainer's step program: one optimizer step over persistent state,
captured once per phase as a CUDA graph and replayed once per step.

The JAX package runs a whole validation interval as one device call (a
``lax.scan`` over fused steps inside ``jax.jit``) and reads its metrics once
at the chunk's end. The port keeps the per-step structure and removes the
host from it: every Adam phase on the card captures one step into a
``torch.cuda.CUDAGraph`` and replays it at each step, so a step issues no
Python, no dispatcher work and no kernel launches of its own. The graph's
size and capture time do not grow with ``validation_frequency``.

A replay runs the kernels on the addresses the capture recorded and runs no
host code, so the step keeps its state where the capture saw it:

- every tensor it reads at its start is a buffer that it updates in place:
  the parameters and the gradients, Adam's moments and step counts, the
  learning rate (a device tensor that ``AdamStep.prepare`` writes before each
  replay), the plateau state, the adaptive-weight state, the EMA shadow, the
  agent's networks, replay buffer, counters and epsilon, and the last
  points; its row goes into slot ``slot`` of ``rows`` and advances ``slot``;
- what the host keeps as Python numbers is advanced per replay: each
  optimizer that stepped in the capture is prepared before and advanced
  after every replay (``AdamStep.count``), and each of the trainer's host
  counts (``counters``: the EMA's count) takes the increment that the
  capture made;
- the kernels' launch counters are counted on the device: the capture runs
  inside ``ops.kernels.counts.tallying(tally)``, so each wrapper records an
  add into ``tally`` beside its launch, and every replay makes it; the
  trainer reads the tally with the chunk's rows and ``settle`` moves it
  into the counters, so a kernel's ``launches`` counts what ran;
- the generators the step draws from are registered with the graph
  (``CUDAGraph.register_generator_state``): a replay draws what an eager
  step at the same offset would.

The phase's first steps run eagerly on a side stream (as torch documents
whole-step capture); they are real steps of the run. The capture follows
once ``ready()`` holds (the agent's buffer holds a batch, so its train
branch is fixed from then on). A capture or replay that fails raises:
nothing falls back to the eager step. On the CPU, under L-BFGS and under a
device mesh (``step_path``) the program calls the step eagerly, one call per
step; a program whose warm-up never ends (``WARMUP_STEPS`` patched past the
run) takes every step eagerly, the comparisons' eager run.
"""

from __future__ import annotations

import gc
import logging
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from pinnrl_tpu_torch.ops.kernels import counts

logger = logging.getLogger(__name__)

# Eager steps before the capture: Adam creates its state at its first step,
# and the kernels are built, traced and cached at their first call.
WARMUP_STEPS = 1


def step_path(device: torch.device, lbfgs: bool, mesh: Any) -> Tuple[str, str]:
    """How a phase's steps run, and why: ``"graph"`` (captured once, replayed
    per step) for every Adam phase on the card; ``"eager"`` otherwise."""
    if device.type != "cuda":
        return "eager", "not on a card"
    if lbfgs:
        return "eager", "L-BFGS: the line search reads its step size on the host"
    if mesh is not None:
        return "eager", "device mesh: the collectives are not captured"
    return "graph", "an Adam phase on the card"


class StepProgram:
    """``body()`` runs one step and returns its row; ``run()`` takes one
    step on ``path`` and writes the row into ``rows[slot]``."""

    def __init__(self, body: Callable[[], torch.Tensor], path: str, device: torch.device,
                 capacity: int, epochs: int, generators: Sequence[torch.Generator] = (),
                 optimizers: Sequence[Any] = (), counters: Sequence[Tuple[Any, str]] = (),
                 ready: Callable[[], bool] = lambda: True, name: str = "adam") -> None:
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
        self.rows: Optional[torch.Tensor] = None  # (capacity, columns): the chunk's step rows
        self.slot: Optional[torch.Tensor] = None  # (1,) int64: the next row
        self.epochs: Optional[torch.Tensor] = None  # (epochs, columns): the chunk's epoch rows
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.tally: Optional[torch.Tensor] = None  # the replays' kernel launches (``counts``)
        self.unsettled = 0  # replays since the tally was last settled
        self.eager_steps = 0
        self.replays = 0
        self.capture_s: Optional[float] = None
        self.pool_bytes: Optional[int] = None
        self._side: Optional[torch.cuda.Stream] = None  # the warm-up's stream
        self._stepped: List[Any] = []  # optimizers that stepped in the capture
        self._deltas: List[Tuple[Any, str, Any]] = []  # what the capture added to host counters

    # ------------------------------------------------------------------ #

    def start_chunk(self) -> None:
        """The chunk's first step writes row 0."""
        if self.slot is not None:
            self.slot.zero_()

    def run(self) -> None:
        """One step: eager, or a replay of the captured step (captured first
        once the warm-up is done)."""
        if self.path == "graph" and self.graph is None and self.eager_steps >= WARMUP_STEPS \
                and self.ready():
            self._capture()
        if self.graph is not None:
            for opt in self._stepped:
                opt.prepare()
            self.graph.replay()
            for opt in self._stepped:
                opt.advance()
            for owner, attr, delta in self._deltas:
                setattr(owner, attr, getattr(owner, attr) + delta)
            self.replays += 1
            self.unsettled += 1
            return
        if self.path == "graph":
            if self._side is None:
                self._side = torch.cuda.Stream(self.device)
            side = self._side
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                self._call()
            torch.cuda.current_stream(self.device).wait_stream(side)
        else:
            self._call()
        self.eager_steps += 1

    def _call(self) -> None:
        row = self.body().detach().reshape(1, -1)
        if self.rows is None:
            self.rows = torch.zeros((self.capacity, row.shape[1]), dtype=row.dtype,
                                    device=row.device)
            self.slot = torch.zeros(1, dtype=torch.int64, device=row.device)
        self.rows.index_copy_(0, self.slot, row.to(self.rows.dtype))
        self.slot.add_(1)

    def _capture(self) -> None:
        before = [getattr(owner, attr) for owner, attr in self.counters]
        for opt in self.optimizers:
            opt.captured = False
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        # As torch.cuda.graph does on entry, so the bytes below are the capture's.
        torch.cuda.synchronize(self.device)
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        self.tally = counts.tally(self.device)
        t0 = time.perf_counter()
        with counts.tallying(self.tally), torch.cuda.graph(graph):
            self._call()
        torch.cuda.synchronize(self.device)
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        # The capture ran no step: put the host counts back, and add its
        # increments at each replay instead.
        self._deltas = []
        for (owner, attr), value in zip(self.counters, before):
            delta = getattr(owner, attr) - value
            setattr(owner, attr, value)
            if delta:
                self._deltas.append((owner, attr, delta))
        self._stepped = [opt for opt in self.optimizers if opt.captured]
        self.graph = graph
        logger.info("%s step captured in %.3f s (%d bytes reserved)", self.name, self.capture_s,
                    self.pool_bytes)

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
        """Free the graph and the buffers (the phase is over)."""
        self.settle()
        self.graph = self.tally = None
        self.rows = self.slot = self.epochs = None
        self._stepped, self._deltas = [], []

    def stats(self) -> dict:
        """How the phase ran: its path, eager steps, replays, capture
        seconds and the bytes the capture reserved."""
        return {"name": self.name, "path": self.path, "eager_steps": self.eager_steps,
                "replays": self.replays, "capture_s": self.capture_s,
                "pool_bytes": self.pool_bytes}
