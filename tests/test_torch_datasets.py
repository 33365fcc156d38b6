"""The port's The Well integration (``pinnrl_tpu_torch.datasets``) against
``pinnrl_tpu.datasets``, without ``the_well`` installed: a fake module is
spliced into ``sys.modules`` (the pattern of tests/test_well_loader.py), and
the offline ``synthetic_heat_2d`` entry writes the loader's cache.

Everything here is numpy on both sides, so every comparison is exact: the
registry entry by entry, the cache file names, the flattened point clouds,
the sub-sampled slices, the synthetic trajectories and the cache files'
arrays; a cache written by either package serves the other.
"""

import sys
import types

import numpy as np
import pytest
import torch
import torch_parity_helpers  # noqa: F401  (pins torch's CPU threads per worker)

import pinnrl_tpu.datasets as jax_datasets
import pinnrl_tpu.datasets.synthetic as jax_synthetic
import pinnrl_tpu.datasets.well_loader as jax_loader
import pinnrl_tpu_torch.datasets as datasets
import pinnrl_tpu_torch.datasets.synthetic as synthetic
import pinnrl_tpu_torch.datasets.well_loader as loader


class _FakeWellDataset:
    """Synthetic trajectories shaped like the_well.data.WellDataset samples."""

    def __init__(self, well_base_path, well_dataset_name, well_split_name):
        entry = datasets.get_entry(well_dataset_name)
        shape = (4,) + (8,) * entry.n_spatial_dims + (len(entry.fields),)
        self._fields = np.random.default_rng(0).normal(size=shape).astype(np.float32)

    def __len__(self):
        return 3

    def __getitem__(self, i):
        return {"input_fields": self._fields + i}


@pytest.fixture
def cache(monkeypatch, tmp_path):
    monkeypatch.setenv("PINNRL_WELL_CACHE", str(tmp_path / "cache"))
    return tmp_path / "cache"


@pytest.fixture
def fake_well(monkeypatch, cache):
    mod = types.ModuleType("the_well")
    data_mod = types.ModuleType("the_well.data")
    data_mod.WellDataset = _FakeWellDataset
    mod.data = data_mod
    monkeypatch.setitem(sys.modules, "the_well", mod)
    monkeypatch.setitem(sys.modules, "the_well.data", data_mod)
    return cache


def _equal_arrays(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert np.array_equal(a[k], b[k]), k


def test_registry_equals_jax_entry_by_entry():
    assert datasets.list_dataset_names() == jax_datasets.list_dataset_names()
    assert len(datasets.WELL_REGISTRY) == 13
    for name, ref in jax_datasets.WELL_REGISTRY.items():
        got = datasets.get_entry(name)
        assert type(got).__name__ == "WellEntry"
        assert got.__dict__ == ref.__dict__, name
    with pytest.raises(KeyError, match="Unknown Well dataset"):
        datasets.get_entry("nonexistent")
    with pytest.raises(ValueError, match="n_spatial_dims"):
        datasets.WellEntry("x", "", 1, ("u",), ((0.0, 1.0),), (0.0, 1.0), None, "fno", 2, 1,
                           "data_only")


@pytest.mark.parametrize("base", [None, "", "  ", "/data/well", "hf://datasets/polymathic-ai/"])
def test_cache_file_names_equal_jax(cache, base):
    assert loader.resolve_path(base) == jax_loader.resolve_path(base)
    for args in (("active_matter", "train", 1, 4096, 0), ("MHD_64", "test", 3, 0, 7)):
        assert loader._cache_file(*args, base) == jax_loader._cache_file(*args, base)
        assert loader._cache_file(*args, base).parent == cache


def test_default_cache_dir_equals_jax(monkeypatch):
    monkeypatch.delenv("PINNRL_WELL_CACHE", raising=False)
    assert loader._cache_dir() == jax_loader._cache_dir()
    assert loader._cache_dir().parts[-3:] == (".cache", "pinnrl_tpu", "well")


@pytest.mark.parametrize("name", ["active_matter", "MHD_64", "synthetic_heat_2d"])
def test_flatten_trajectory_equals_jax(name):
    entry = datasets.get_entry(name)
    shape = (3,) + (5,) * entry.n_spatial_dims + (len(entry.fields),)
    fields = np.random.default_rng(1).normal(size=shape)
    _equal_arrays(loader._flatten_trajectory(fields, entry),
                  jax_loader._flatten_trajectory(fields, jax_datasets.get_entry(name)))
    # A field without its channel axis gets one.
    _equal_arrays(loader._flatten_trajectory(fields[..., 0], entry),
                  jax_loader._flatten_trajectory(fields[..., 0], jax_datasets.get_entry(name)))


def test_extract_arrays_equals_jax():
    rng = np.random.default_rng(2)
    a, b = rng.normal(size=(2, 4, 4)), rng.normal(size=(2, 4, 4, 2))
    for sample in ({"input_fields": a}, {"fields": torch.from_numpy(b)}, {"p": a, "v": b},
                   torch.from_numpy(b)):
        _equal_arrays(loader._extract_arrays(sample), jax_loader._extract_arrays(sample))


@pytest.mark.parametrize("name,n_traj,n_points", [("active_matter", 2, 100),
                                                  ("MHD_64", 1, 0), ("shear_flow", 5, 50)])
def test_load_well_slice_equals_jax(fake_well, name, n_traj, n_points):
    """Through the fake the_well: the same points (default_rng sub-sampling
    without replacement), and the cache each writes."""
    got = datasets.load_well_slice(name, n_traj=n_traj, n_points=n_points, seed=3,
                                   use_cache=False)
    ref = jax_datasets.load_well_slice(name, n_traj=n_traj, n_points=n_points, seed=3,
                                       use_cache=False)
    _equal_arrays(got, ref)
    path = loader._cache_file(name, "train", n_traj, n_points, 3, None)
    first = datasets.load_well_slice(name, n_traj=n_traj, n_points=n_points, seed=3)
    assert path.exists()
    _equal_arrays(first, ref)
    with np.load(path) as data:
        _equal_arrays({k: data[k] for k in data.files}, ref)


def test_missing_the_well_raises_as_jax(cache, monkeypatch):
    monkeypatch.setitem(sys.modules, "the_well", None)
    monkeypatch.setitem(sys.modules, "the_well.data", None)
    with pytest.raises(datasets.TheWellNotInstalledError) as got:
        datasets.load_well_slice("active_matter")
    with pytest.raises(jax_datasets.TheWellNotInstalledError) as want:
        jax_datasets.load_well_slice("active_matter")
    assert str(got.value) == str(want.value) and isinstance(got.value, ImportError)


@pytest.mark.parametrize("kw", [{}, {"traj_index": 5, "n_steps": 7, "nx": 12, "ny": 9},
                                {"traj_index": 2, "alpha": 0.1}])
def test_synthetic_trajectory_equals_jax(kw):
    got, ref = synthetic.generate_heat_2d_trajectory(**kw), jax_synthetic.generate_heat_2d_trajectory(**kw)
    assert got.dtype == ref.dtype == np.float32 and np.array_equal(got, ref)


@pytest.mark.parametrize("split", ["train", "test"])
def test_synthetic_cache_equals_jax_and_serves_both(cache, split):
    """The port writes, JAX reads (and the files are equal); JAX writes the
    other key, the port reads."""
    kw = dict(split=split, n_traj=2, n_points=300, seed=4)
    path = synthetic.ensure_synthetic_well_cache(**kw)
    with np.load(path) as data:
        ours = {k: data[k] for k in data.files}
    _equal_arrays(jax_datasets.load_well_slice("synthetic_heat_2d", **kw), ours)
    path.unlink()
    assert jax_synthetic.ensure_synthetic_well_cache(**kw) == path
    with np.load(path) as data:
        _equal_arrays({k: data[k] for k in data.files}, ours)

    kw2 = dict(kw, seed=5)
    jax_synthetic.ensure_synthetic_well_cache(**kw2)
    got = datasets.load_well_slice("synthetic_heat_2d", **kw2)
    ref = jax_datasets.load_well_slice("synthetic_heat_2d", **kw2)
    _equal_arrays(got, ref)
    assert got["x"].shape == (300, 2) and got["t"].shape == (300, 1)


def test_synthetic_refuses_real_names_and_keeps_existing(cache):
    with pytest.raises(ValueError, match="refusing"):
        synthetic.ensure_synthetic_well_cache(name="active_matter")
    path = synthetic.ensure_synthetic_well_cache(n_traj=1, n_points=64, seed=0)
    np.savez(path, x=np.zeros((1, 2)), t=np.zeros((1, 1)), u=np.zeros((1, 1)))
    assert synthetic.ensure_synthetic_well_cache(n_traj=1, n_points=64, seed=0) == path
    assert datasets.load_well_slice("synthetic_heat_2d", n_traj=1, n_points=64)["x"].shape == (1, 2)
    synthetic.ensure_synthetic_well_cache(n_traj=1, n_points=64, seed=0, overwrite=True)
    assert datasets.load_well_slice("synthetic_heat_2d", n_traj=1, n_points=64)["x"].shape == (64, 2)


def test_trajectory_is_an_exact_heat_solution():
    """u_t = alpha lap(u) by finite differences on the grid."""
    f = synthetic.generate_heat_2d_trajectory(0, n_steps=48, nx=96, ny=96)[..., 0]
    e = datasets.get_entry("synthetic_heat_2d")
    dt = (e.time_domain[1] - e.time_domain[0]) / 47
    dx = (e.domain[0][1] - e.domain[0][0]) / 95
    u_t = (f[2:, 1:-1, 1:-1] - f[:-2, 1:-1, 1:-1]) / (2 * dt)
    lap = (f[1:-1, 2:, 1:-1] + f[1:-1, :-2, 1:-1] + f[1:-1, 1:-1, 2:] + f[1:-1, 1:-1, :-2]
           - 4 * f[1:-1, 1:-1, 1:-1]) / dx**2
    assert float(np.abs(u_t - synthetic.ALPHA * lap).max()) < 5e-3
