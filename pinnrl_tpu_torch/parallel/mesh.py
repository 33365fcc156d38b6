"""Device-mesh data parallelism for PINN training.

The JAX package shards the collocation batch over a 1-D ``data`` mesh of
devices and replicates the parameters; XLA inserts the gradient ``psum``.
The port does the same the torch way: one process per device, joined by a
``torch.distributed`` process group (NCCL on the card, gloo on the CPU).

Every rank draws the same global batch from the same seeded generator and
keeps its own contiguous block of rows (``shard_batch``), which is what one
JAX key and a sharding constraint give. The parameters start from rank 0's
(``replicate``) and stay equal on every rank because every rank applies the
mean of the ranks' gradients (``Mesh.all_reduce_mean``). With equal shards
the mean of the ranks' mean losses is the mean over the global batch, so
the gradient is the unsharded one. Everything else (BC/IC points,
validation, the RL agent, the RAR pool) is computed whole on every rank.

Usage (``torchrun --nproc_per_node N script.py`` on the card; the process
group may also be initialised by the caller before ``make_mesh``)::

    mesh = make_mesh()                        # every rank on axis "data"
    trainer = PDETrainer(model, pde, cfg, mesh=mesh)
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist


@dataclass
class Mesh:
    """This rank's view of a 1-D mesh: ``size`` ranks on ``axis_name``, this
    one ``rank`` on ``device``, its collectives on ``group``."""

    size: int
    rank: int
    device: torch.device
    group: Any
    axis_name: str = "data"

    def _reduce(self, flat: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(flat, group=self.group)
        return flat.div_(self.size)

    def mean(self, tensor: torch.Tensor) -> torch.Tensor:
        """The mean of ``tensor`` over the ranks (a new tensor)."""
        return self._reduce(tensor.detach().clone())

    @torch.no_grad()
    def all_reduce_mean(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Replace each tensor by its mean over the ranks, in place, in one
        collective (the tensors flattened into one buffer)."""
        tensors = list(tensors)
        if self.size == 1 or not tensors:
            return tensors
        flat = self._reduce(torch.cat([t.reshape(-1) for t in tensors]))
        start = 0
        for t in tensors:
            t.copy_(flat[start:start + t.numel()].view_as(t))
            start += t.numel()
        return tensors

    def all_gather(self, tensor: torch.Tensor) -> torch.Tensor:
        """The ranks' ``tensor`` (equal shapes), concatenated along dim 0 in
        rank order: the global batch a shard came from."""
        if self.size == 1:
            return tensor
        parts = [torch.empty_like(tensor) for _ in range(self.size)]
        dist.all_gather(parts, tensor.contiguous(), group=self.group)
        return torch.cat(parts, dim=0)

    def causal_loss(self, r2: torch.Tensor, t: torch.Tensor, eps: float) -> torch.Tensor:
        """This rank's share of the causal residual loss of the global batch
        (``PDEBase._residual_loss``: w_i = exp(-eps sum_{t_j < t_i} r_j^2 /
        N) over the batch sorted by time). The weights need every point's
        r^2, so the detached (t, r^2) are gathered and the weights computed
        on the whole batch; the share is ``size * sum_local(w r^2) /
        sum(w)``, whose mean over the ranks is the loss and whose gradients'
        mean is its gradient."""
        t_all = self.all_gather(t.reshape(-1).detach())
        r2_all = self.all_gather(r2.detach())
        order = torch.argsort(t_all, stable=True)
        r2_sorted = r2_all[order]
        n = r2_sorted.shape[0]
        cum_prev = torch.cumsum(r2_sorted, dim=0) - r2_sorted
        w_sorted = torch.exp(-eps * cum_prev / n)
        w = torch.empty_like(w_sorted).index_put_((order,), w_sorted)
        n_local = r2.shape[0]
        w_local = w[self.rank * n_local:(self.rank + 1) * n_local]
        return self.size * torch.sum(w_local * r2) / torch.clamp(torch.sum(w_sorted), min=1e-12)


def _rank_device(devices, rank: int) -> torch.device:
    """This rank's device: ``devices[rank]`` from a sequence, the CPU for
    "cpu", else the card of the local rank (``LOCAL_RANK`` as torchrun sets
    it)."""
    from pinnrl_tpu_torch.config import resolve_device

    if devices is not None and not isinstance(devices, str):
        return torch.device(resolve_device(str(devices[rank])))
    name = resolve_device(devices or "cuda")
    if name == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        return torch.device("cuda", local % torch.cuda.device_count())
    return torch.device(name)


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "data",
              devices: Optional[str | Sequence[str]] = None) -> Optional[Mesh]:
    """A 1-D mesh over (up to) ``n_devices`` ranks of the process group.

    Uses the process group already initialised, or initialises one from
    torchrun's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``): NCCL for the card, gloo for ``devices="cpu"``.
    ``devices`` names the device: "cuda" (the default: the card of the
    local rank), "cpu", or one device name per rank. Raises ValueError when
    more devices are asked for than the group has ranks; with fewer, the
    first ``n_devices`` ranks form the mesh (every rank must call) and the
    others get None."""
    if not dist.is_initialized():
        cpu = isinstance(devices, str) and devices == "cpu"
        dist.init_process_group("gloo" if cpu else "nccl")
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if n_devices is None else int(n_devices)
    if n > world:
        raise ValueError(f"Requested {n} devices but only {world} available")
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    if rank >= n:
        return None
    return Mesh(size=n, rank=rank, device=_rank_device(devices, rank), group=group,
                axis_name=axis_name)


def batch_sharding(mesh: Mesh, n: int) -> slice:
    """The rows of a (n, ...) batch that this rank holds: its contiguous
    block of n / size rows (n a multiple of the mesh size)."""
    if n % mesh.size:
        raise ValueError(f"a batch of {n} does not split over {mesh.size} ranks; "
                         "pad it with pad_to_multiple")
    per = n // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


@torch.no_grad()
def replicate(mesh: Mesh, tensors: Sequence[torch.Tensor], src: int = 0) -> List[torch.Tensor]:
    """Make ``tensors`` (parameters, coefficients) equal on every rank:
    rank ``src``'s values, broadcast in place."""
    tensors = list(tensors)
    if mesh.size > 1:
        for t in tensors:
            dist.broadcast(t.data, src=src, group=mesh.group)
    return tensors


def shard_batch(mesh: Mesh, *arrays: torch.Tensor):
    """This rank's rows of each batch array (``batch_sharding``)."""
    out = tuple(a[batch_sharding(mesh, a.shape[0])] for a in arrays)
    return out if len(out) > 1 else out[0]


def pad_to_multiple(n: int, k: int) -> int:
    """Smallest multiple of k >= n (the batch must divide across ranks)."""
    return ((n + k - 1) // k) * k
