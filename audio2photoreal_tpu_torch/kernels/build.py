"""Build the CUDA kernels from the package's sources and load them with ctypes.

Each library is compiled by ``nvcc`` into a shared object with a plain C
interface, at its first use, under ``build/torch_kernels/`` at the root of
the checkout.  The file name carries a hash of the sources, the shared
headers (``csrc/*.cuh``) and the compiler flags, so an edit to any of them
builds a new library and a stale one is never loaded.  Nothing here runs
when the package is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): nvcc is needed to build the kernels")
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return nvcc


def library_path(name: str, sources: Sequence[str]) -> Path:
    """Where the library for these sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (*sources, *sorted(p.name for p in CSRC.glob("*.cuh"))):
        h.update(src.encode())
        h.update((CSRC / src).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def load_library(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """Compile (if needed) and load ``csrc/<sources>`` as ``lib<name>``."""
    path = library_path(name, sources)
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *(str(CSRC / s) for s in sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {name} (exit {proc.returncode}):\n{proc.stderr[-4000:]}"
            )
        os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
    return ctypes.CDLL(str(path))
