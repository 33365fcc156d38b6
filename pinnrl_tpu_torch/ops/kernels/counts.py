"""The kernel wrappers' launch counters.

Each wrapper counts in plain integer attributes of its own function
(``fused_residual_loss.launches``, ``fourier_features.jvps``, ...), which
it registers here at import (``register``) and adds to with ``add`` where it
launches its kernel. A replayed CUDA graph launches the kernels it recorded
without running the wrapper, so while the trainer's step program captures a
step (``tallying``) ``add`` records a device add into the program's tally
instead, beside the launch: each replay then adds to the tally where it runs
the kernel, and ``settle`` moves what the tally holds into the attributes
(the step program reads it with its chunk's rows). A launch captured
without a tally counts once, at the capture.
"""

from __future__ import annotations

import contextlib
from typing import Any, Iterator, List, Optional, Sequence, Tuple

import torch

# (owner, attribute) of every registered counter; a tally has a slot for each.
COUNTERS: List[Tuple[Any, str]] = []
_tally: Optional[torch.Tensor] = None


def register(owner: Any, *attrs: str) -> None:
    """Set counters ``attrs`` of ``owner`` to 0 and register them."""
    for attr in attrs:
        setattr(owner, attr, 0)
        COUNTERS.append((owner, attr))


def add(owner: Any, attr: str, n: int = 1) -> None:
    """Add ``n`` to ``owner.attr``; while a step is captured into a tally,
    record the add on the device instead, so that each replay makes it."""
    if _tally is not None and _capturing():
        slot = COUNTERS.index((owner, attr))
        if slot >= _tally.numel():
            raise RuntimeError(f"counter {attr} was registered after the tally was made")
        # Below any torch.func transform (a jvp rule, a launch under vmap):
        # the tally is no input of the transformed function.
        with torch._C._DisableFuncTorch():
            _tally[slot].add_(n)
    else:
        setattr(owner, attr, getattr(owner, attr) + n)


def _capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph."""
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def tally(device: torch.device) -> torch.Tensor:
    """A zero tally: one int64 slot per registered counter."""
    return torch.zeros(len(COUNTERS), dtype=torch.int64, device=device)


@contextlib.contextmanager
def tallying(into: torch.Tensor) -> Iterator[None]:
    """Count what is captured in this block into ``into``."""
    global _tally
    previous, _tally = _tally, into
    try:
        yield
    finally:
        _tally = previous


def settle(into: torch.Tensor, values: Sequence[float]) -> None:
    """Add ``values`` (the tally ``into`` as read) to the counters, and set
    the tally to 0."""
    for (owner, attr), v in zip(COUNTERS, values):
        if v:
            setattr(owner, attr, getattr(owner, attr) + int(v))
    into.zero_()
