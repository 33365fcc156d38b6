"""Build and load the hand-written CUDA kernels (``pinnrl_tpu_torch/csrc``).

Each ``csrc/<name>.cu`` exports a plain C interface. At first use it is
compiled by ``nvcc`` into ``build/torch_kernels/lib<name>-<hash>.so`` at the
repository root and loaded with ``ctypes``; the hash covers the sources and
the flags, so a stale build is never loaded. Emitted sources (kernel 1's
generated residuals, ``residual_codegen.py``) take the same way through
``load_generated``, their ``.cu`` kept beside the library. Nothing is
compiled or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Union

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
# No --use_fast_math: Fourier phases reach tens of radians, where the fast
# sin/cos intrinsics lose digits.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v",
)

_LOADED: Dict[str, ctypes.CDLL] = {}
# Seconds each library took to build (or find cached) in this process, and
# the compiler's report (registers, shared memory, spills per kernel), kept
# beside the library as lib<name>-<hash>.log so a cached build has it too.
BUILD_SECONDS: Dict[str, float] = {}
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built at first use on a CUDA machine")


def _digest(text: bytes) -> str:
    """Hash of a source's text, every ``csrc/*.cuh`` and the flags."""
    h = hashlib.sha256(text)
    for path in sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _compile(name: str, source: Path, target: Path) -> ctypes.CDLL:
    """Build ``source`` into ``target`` unless it exists, then load it; the
    compiler's report goes to ``BUILD_LOG[name]``. A failed build raises with
    nvcc's output."""
    t0 = time.perf_counter()
    if not target.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, str(source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed for {source.name} (rc {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
            )
        target.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, target)  # atomic: a concurrent loader never sees half a file
    log = target.with_suffix(".log")
    BUILD_LOG[name] = log.read_text() if log.exists() else ""
    BUILD_SECONDS[name] = time.perf_counter() - t0
    lib = ctypes.CDLL(str(target))
    _LOADED[name] = lib
    return lib


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if needed and return the loaded library."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    source = CSRC / f"{name}.cu"
    return _compile(name, source, BUILD_DIR / f"lib{name}-{_digest(source.read_bytes())}.so")


def load_generated(name: str, text: str) -> ctypes.CDLL:
    """Compile the emitted CUDA source ``text`` (it includes ``csrc``
    headers) as ``build/torch_kernels/<name>-<hash>.cu`` beside its
    ``lib<name>-<hash>.so`` and ``.log``, and return the loaded library.
    Libraries are keyed by ``name``: one name, one text."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    stem = f"{name}-{_digest(text.encode())}"
    source = BUILD_DIR / f"{stem}.cu"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    if not source.exists() or source.read_text() != text:
        fd, tmp = tempfile.mkstemp(suffix=".cu", dir=BUILD_DIR)
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, source)  # atomic: a concurrent nvcc never reads half a file
    return _compile(name, source, BUILD_DIR / f"lib{stem}.so")


def stream_handle(device: Union[torch.device, int]) -> int:
    """The raw ``cudaStream_t`` of torch's current stream on ``device`` (a
    device or its index), read without building a ``torch.cuda.Stream``."""
    index = device if isinstance(device, int) else device.index
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device() if index is None else index)


def check(status: int, what: str) -> None:
    """Raise if a C launcher returned a non-zero ``cudaError_t``."""
    if status != 0:
        raise RuntimeError(f"CUDA launch of {what} failed with cudaError_t {status}")


def require_cuda_f32(name: str, t: torch.Tensor) -> None:
    """The checks every kernel wrapper makes before it hands a pointer over."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got device {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
