"""Build and load the port's hand-written CUDA kernels.

Every kernel source is one ``memotr_tpu_torch/csrc/<name>.cu`` with a plain
C interface.  ``build`` compiles sources with ``nvcc`` for ``sm_90a`` into
``memotr_tpu_torch/_build/<hash of source and flags>/lib<name>.so`` under a
file lock (several processes may ask at once), starting one ``nvcc`` per
source so that several kernels build in parallel; ``load`` opens the
library with ``ctypes``.  No PyTorch header is included, so a build takes
seconds.  Nothing here runs at import time: the CPU tests import the kernel
modules on machines without ``nvcc`` or a GPU.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, List

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit "
                           "to build the port's kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def source(name: str) -> Path:
    return CSRC / f"{name}.cu"


def lib_path(name: str) -> Path:
    src = source(name).read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / key / f"lib{name}.so"


def build(*names: str) -> Dict[str, Path]:
    """Compile every named kernel that has not been built from its current
    source yet, one ``nvcc`` per source, all started together.  Returns the
    path of each shared library; ``build.log`` beside it holds the command
    and ptxas's report (registers, spills)."""
    paths = {n: lib_path(n) for n in names}
    pending = {}
    try:
        for name, path in paths.items():
            if path.exists():
                continue
            path.parent.mkdir(parents=True, exist_ok=True)
            lock = open(path.parent / "lock", "w")
            fcntl.flock(lock, fcntl.LOCK_EX)
            if path.exists():                  # built by another process
                fcntl.flock(lock, fcntl.LOCK_UN)
                lock.close()
                continue
            tmp = path.with_name(f"{path.stem}.{os.getpid()}.so")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source(name))]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            pending[name] = (proc, cmd, tmp, lock)
        failed = []
        for name, (proc, cmd, tmp, _) in pending.items():
            log = proc.communicate()[0]
            (paths[name].parent / "build.log").write_text(
                " ".join(cmd) + "\n" + log)
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}) building "
                              f"{source(name)}:\n{log}")
            else:
                os.replace(tmp, paths[name])
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for proc, _, _, lock in pending.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            fcntl.flock(lock, fcntl.LOCK_UN)
            lock.close()
    return paths


def load(name: str, argtypes: Dict[str, List]) -> ctypes.CDLL:
    """The kernel library ``name``, built at first use and opened once.
    ``argtypes`` maps each C entry point to its argument types; every entry
    returns a CUDA error code (``int``)."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)[name]))
        for fn, types in argtypes.items():
            getattr(lib, fn).argtypes = types
            getattr(lib, fn).restype = ctypes.c_int
        _libs[name] = lib
    return lib
