"""Load "The Well" trajectories and flatten them into observation point
clouds, as ``pinnrl_tpu.datasets.well_loader``.

``the_well`` is imported only on a cache miss (``TheWellNotInstalledError``
without it). The ``.npz`` cache lives under ``$PINNRL_WELL_CACHE`` (default
``~/.cache/pinnrl_tpu/well``) and is keyed by (name, split, n_traj,
n_points, seed, sha1(base)) with the JAX package's file names, so a cache
written by either package serves the other. Sub-sampling draws from
``numpy.random.default_rng(seed)``, so both packages pick the same points.
Returns plain numpy arrays.
"""

from __future__ import annotations

import hashlib
import logging
import os
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

from pinnrl_tpu_torch.datasets.registry import get_entry

logger = logging.getLogger(__name__)
DEFAULT_HF_BASE = "hf://datasets/polymathic-ai/"


class TheWellNotInstalledError(ImportError):
    def __init__(self) -> None:
        super().__init__(
            "The Well datasets need the optional dependency:\n"
            "    pip install the_well h5py huggingface-hub"
        )


def resolve_path(base: Optional[str] = None) -> str:
    """The Hugging Face streaming mirror unless a local directory is given."""
    if base is None or not str(base).strip():
        return DEFAULT_HF_BASE
    return str(base)


def _cache_dir() -> Path:
    root = os.environ.get("PINNRL_WELL_CACHE")
    return Path(root) if root else Path.home() / ".cache" / "pinnrl_tpu" / "well"


def _cache_file(name, split, n_traj, n_points, seed, base) -> Path:
    tag = hashlib.sha1(resolve_path(base).encode()).hexdigest()[:10]
    return _cache_dir() / f"{name}__{split}__t{n_traj}_p{n_points}_s{seed}__{tag}.npz"


def _import_well_dataset(name: str, split: str, base: Optional[str]):
    try:
        from the_well.data import WellDataset  # type: ignore
    except ImportError as exc:
        raise TheWellNotInstalledError() from exc
    return WellDataset(
        well_base_path=resolve_path(base),
        well_dataset_name=name,
        well_split_name=split,
    )


def _extract_arrays(sample: Any) -> Dict[str, np.ndarray]:
    """A WellDataset sample (dict or array-like) -> {"fields": ndarray}."""

    def to_np(v):
        if hasattr(v, "numpy"):
            v = v.numpy()
        return np.asarray(v)

    if isinstance(sample, dict):
        fields = sample.get("input_fields", sample.get("fields"))
        if fields is None:
            # Concatenate every array-valued entry along the channel axis.
            arrays = [to_np(v) for k, v in sample.items() if hasattr(v, "shape")]
            fields = np.concatenate([a[..., None] if a.ndim == 3 else a for a in arrays], -1)
        else:
            fields = to_np(fields)
    else:
        fields = to_np(sample)
    return {"fields": fields}


def _flatten_trajectory(fields: np.ndarray, entry) -> Dict[str, np.ndarray]:
    """(n_steps, *spatial, n_fields) grid -> flat (N, x/t/u) point cloud."""
    if fields.ndim == entry.n_spatial_dims + 1:  # missing channel axis
        fields = fields[..., None]
    n_steps = fields.shape[0]
    spatial_shape = fields.shape[1 : 1 + entry.n_spatial_dims]
    n_fields = fields.shape[-1]

    axes = [
        np.linspace(lo, hi, s)
        for (lo, hi), s in zip(entry.domain, spatial_shape)
    ]
    t_axis = np.linspace(entry.time_domain[0], entry.time_domain[1], n_steps)
    mesh = np.meshgrid(t_axis, *axes, indexing="ij")
    t_flat = mesh[0].reshape(-1, 1).astype(np.float32)
    x_flat = np.stack([m.reshape(-1) for m in mesh[1:]], axis=-1).astype(np.float32)
    u_flat = fields.reshape(-1, n_fields).astype(np.float32)
    return {"x": x_flat, "t": t_flat, "u": u_flat}


def load_well_slice(
    name: str,
    split: str = "train",
    n_traj: int = 1,
    n_points: int = 4096,
    seed: int = 0,
    base: Optional[str] = None,
    use_cache: bool = True,
) -> Dict[str, np.ndarray]:
    """Load ``n_traj`` trajectories, flatten them and sub-sample ``n_points``
    (without replacement); returns {"x", "t", "u"} numpy arrays."""
    entry = get_entry(name)
    cache = _cache_file(name, split, n_traj, n_points, seed, base)
    if use_cache and cache.exists():
        logger.info("Well cache hit: %s", cache)
        with np.load(cache) as data:
            return {k: data[k] for k in ("x", "t", "u")}

    ds = _import_well_dataset(name, split, base)
    clouds = []
    for i in range(min(n_traj, len(ds))):
        arrs = _extract_arrays(ds[i])
        clouds.append(_flatten_trajectory(arrs["fields"], entry))
    x = np.concatenate([c["x"] for c in clouds], axis=0)
    t = np.concatenate([c["t"] for c in clouds], axis=0)
    u = np.concatenate([c["u"] for c in clouds], axis=0)

    if n_points and n_points < x.shape[0]:
        rng = np.random.default_rng(seed)
        idx = rng.choice(x.shape[0], size=n_points, replace=False)
        x, t, u = x[idx], t[idx], u[idx]

    out = {"x": x, "t": t, "u": u}
    if use_cache:
        cache.parent.mkdir(parents=True, exist_ok=True)
        np.savez(cache, **out)
        logger.info("Well cache write: %s", cache)
    return out
