"""Data parallelism over a 1-D device mesh: one process per device, over a
``torch.distributed`` process group (``mesh.py``)."""

from pinnrl_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    batch_sharding,
    make_mesh,
    pad_to_multiple,
    replicate,
    shard_batch,
)
