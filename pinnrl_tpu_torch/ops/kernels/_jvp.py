"""What the kernels' ``jvp`` rules need to nest under ``torch.func.jvp``.

torch runs an ``autograd.Function``'s ``jvp`` staticmethod with forward-mode
AD switched off, on tensors wrapped at the level being differentiated. A
rule written in plain ops would then be invisible to an enclosing ``jvp``,
and every derivative above the first would come out zero. ``lower`` unwraps
the rule's tensors by that one level, to the level its tangent lives at, and
``forward_mode`` switches forward AD back on there, so each enclosing level
differentiates the rule's ops as it would any others: nested ``jvp`` and
reverse-over-forward then hold at every order. This is what JAX's
``custom_jvp`` gives for free.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
from torch._C._functorch import _unwrap_for_grad, maybe_get_level
from torch.autograd.forward_ad import _set_fwd_grad_enabled


def lower(*tensors: Optional[torch.Tensor]) -> Tuple[int, Tuple[Optional[torch.Tensor], ...]]:
    """(level, tensors unwrapped by one level): the level is the highest
    ``torch.func`` level among them (-1 outside any transform)."""
    level = max((maybe_get_level(t) for t in tensors if t is not None), default=-1)
    if level <= 0:
        return level, tensors
    return level, tuple(None if t is None else _unwrap_for_grad(t, level) for t in tensors)


def forward_mode(level: int):
    """Forward AD on for a rule lowered from ``level`` (inside a
    ``torch.func`` transform); left as torch set it otherwise."""
    return _set_fwd_grad_enabled(True) if level > 0 else contextlib.nullcontext()
