"""Build and load the port's hand-written CUDA kernels.

Each kernel is one source ``repro_torch/csrc/<name>.cu`` with a plain C
entry point. It is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library under ``repro_torch/build/`` (ignored by git) at first use,
and loaded with ``ctypes``. The library's file name carries a hash of the
source and the flags, so an edited source is rebuilt and a built one is
reused. Nothing here runs at import time: the CPU tests import every
module, and there is no ``nvcc`` there.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Tuple

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}


def _paths(name: str) -> Tuple[Path, Path]:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return src, BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build(name: str) -> str:
    """Compile the named kernel unless it is built already. Returns nvcc's
    output (its ptxas register and shared-memory report), or "" when the
    library was built before. Raises if the compile fails."""
    src, so = _paths(name)
    if so.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or none
    return proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def n_sm(device) -> int:
    """The card's SM count, which the wrappers size their grids by."""
    import torch
    return torch.cuda.get_device_properties(device).multi_processor_count


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build(name)
        lib = _libs[name] = ctypes.CDLL(str(_paths(name)[1]))
    return lib
