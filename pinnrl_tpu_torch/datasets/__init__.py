"""'The Well' dataset integration, as ``pinnrl_tpu.datasets``: the registry,
the loader (lazy ``the_well`` import, ``.npz`` cache) and the offline
synthetic stand-in. Plain numpy throughout; nothing here imports torch."""

from pinnrl_tpu_torch.datasets.registry import (  # noqa: F401
    WELL_REGISTRY,
    WellEntry,
    get_entry,
    list_dataset_names,
)
from pinnrl_tpu_torch.datasets.well_loader import (  # noqa: F401
    TheWellNotInstalledError,
    load_well_slice,
    resolve_path,
)
