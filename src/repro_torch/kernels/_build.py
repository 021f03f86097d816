"""Build the port's CUDA sources with `nvcc` and load them with `ctypes`.

Each `csrc/<name>.cu` exposes a plain C interface (no PyTorch headers, so
a build takes seconds).  It is compiled for `sm_90a` into
`build/kernels/lib<name>-<hash>.so` under the repository root at first
use; the hash of the source and of the shared headers (`csrc/*.cuh`)
names the library, so an edited source is rebuilt and a stale library is
never loaded.  Every C entry point
returns its `cudaGetLastError()`; `check` raises on a nonzero code.
`sm_count` is the card's SM count, from which the wrappers size grids.

A library is built under a file lock of its own (`build/kernels/
lib<name>-<hash>.so.lock`), so that two processes (the ranks of a
`torchrun` launch) never build the same kernel at once: the second waits
and loads the first's library.

Nothing here runs at import time: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, Iterable

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> pathlib.Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):     # shared by some sources
        digest.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source that has no current library, one `nvcc`
    per source, all started together.  Returns {name: ptxas report} for
    the sources compiled by this call."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    locks = []
    try:
        for name in sorted(set(names)):       # locks taken in one order
            out = _lib_path(name)
            if out.exists():
                continue
            lock = open(out.with_name(out.name + ".lock"), "w")
            locks.append(lock)
            fcntl.flock(lock, fcntl.LOCK_EX)  # another build of it ends
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp, out)
        reports = {}
        failed = []
        for name, (proc, tmp, out) in procs.items():
            text, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}:\n{text}")
                continue
            os.replace(tmp, out)
            reports[name] = text
    finally:
        for lock in locks:
            lock.close()                      # releases the lock
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            _LIBS[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The card's SM count, which the wrappers size their grids from."""
    return torch.cuda.get_device_properties(device).multi_processor_count
