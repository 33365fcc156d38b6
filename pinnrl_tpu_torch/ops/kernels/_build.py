"""Build and load the hand-written CUDA kernels (``pinnrl_tpu_torch/csrc``).

Each ``csrc/<name>.cu`` exports a plain C interface. At first use it is
compiled by ``nvcc`` into ``build/torch_kernels/lib<name>-<hash>.so`` at the
repository root and loaded with ``ctypes``; the hash covers the sources and
the flags, so a stale build is never loaded. Nothing is compiled or loaded
when this module is imported.
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
from typing import Dict

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
# the compiler's report (registers, shared memory, spills per kernel).
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


def _digest(source: Path) -> str:
    h = hashlib.sha256()
    for path in sorted([source, *CSRC.glob("*.cuh")]):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if needed and return the loaded library."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    source = CSRC / f"{name}.cu"
    target = BUILD_DIR / f"lib{name}-{_digest(source)}.so"
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
        os.replace(tmp, target)  # atomic: a concurrent loader never sees half a file
        BUILD_LOG[name] = proc.stdout + proc.stderr
    BUILD_SECONDS[name] = time.perf_counter() - t0
    lib = ctypes.CDLL(str(target))
    _LOADED[name] = lib
    return lib


def stream_handle(device: torch.device) -> int:
    """The raw ``cudaStream_t`` of torch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream


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
