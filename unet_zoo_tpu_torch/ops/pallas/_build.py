"""Build the package's CUDA sources into one shared library and load it.

The sources under ``unet_zoo_tpu_torch/csrc/`` are compiled with ``nvcc`` for
``sm_90a`` (Hopper) into ``unet_zoo_tpu_torch/_build/`` at first CUDA use, and
loaded with ``ctypes``: each kernel has a plain C entry point that takes raw
device pointers and a stream, so the build needs no PyTorch headers and takes
seconds. The library's name carries a hash of the sources and flags, so an
edited kernel is rebuilt. Importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills of each kernel, kept in the build log
    "-ldl",  # dlopen of libcuda.so.1, for cuTensorMapEncodeTiled
)


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"libunet_zoo_kernels_{digest.hexdigest()[:16]}.so"


def _find_nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for nvcc in candidates:
        if nvcc and os.access(nvcc, os.X_OK):
            return nvcc
    raise RuntimeError(
        "nvcc not found (not on PATH, and no CUDA_HOME with bin/nvcc): "
        "the CUDA kernels cannot be built"
    )


def _compile(lib_path: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", str(tmp)]
    cmd += [str(p) for p in _sources() if p.suffix == ".cu"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n{' '.join(cmd)}\n{proc.stderr}"
        )
    lib_path.with_suffix(".log").write_text(proc.stderr)
    os.replace(tmp, lib_path)  # atomic: a concurrent process sees a whole library or none


@functools.cache
def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library. Raises if nvcc fails."""
    lib_path = library_path()
    if not lib_path.exists():
        _compile(lib_path)
    return ctypes.CDLL(str(lib_path))
