"""CUDA MSDA forward kernel: build at first use, ctypes binding, wrapper.

Replaces the TPU kernel ``ms_deform_attn_pallas``
(``memotr_tpu/ops/msda_pallas.py:220``; its ``pallas_call`` is at :187).
The kernel source is ``memotr_tpu_torch/csrc/msda_fwd.cu``; its header says
what bounds it on an H100 and how its design answers that.

The shared library is compiled with ``nvcc`` on first use into
``memotr_tpu_torch/_build/<source hash>/``, under a file lock, and loaded
with ``ctypes`` (a plain C interface: no PyTorch headers, so the build takes
seconds).  Nothing here runs at import time: the CPU tests import this
module on machines without ``nvcc`` or a GPU.

``launches`` counts kernel launches (and nothing else), so a run can show
that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Sequence, Tuple

import torch

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "msda_fwd.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

launches = 0
_lib = None
_shape_tables: Dict[Tuple, torch.Tensor] = {}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA "
                           "toolkit to build the MSDA kernel")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build() -> Path:
    """Compile the kernel library if this source has not been built yet.
    Returns the path of the shared library."""
    src = SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = BUILD_DIR / key
    lib_path = out_dir / "libmsda_fwd.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if lib_path.exists():          # built by another process meanwhile
                return lib_path
            tmp = out_dir / f"libmsda_fwd.{os.getpid()}.so"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            (out_dir / "build.log").write_text(
                " ".join(cmd) + "\n" + res.stdout + res.stderr)
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({res.returncode}) building {SOURCE}:\n"
                    f"{res.stderr}")
            os.replace(tmp, lib_path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return lib_path


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.msda_fwd.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                                 + [ctypes.c_void_p])
        lib.msda_fwd.restype = ctypes.c_int
        _lib = lib
    return _lib


def _shape_table(spatial_shapes: Sequence[Tuple[int, int]],
                 device: torch.device) -> torch.Tensor:
    """(L, 3) int32 [H, W, start row] on the device, made once per shapes."""
    key = (tuple(map(tuple, spatial_shapes)), device)
    tab = _shape_tables.get(key)
    if tab is None:
        rows, start = [], 0
        for h, w in spatial_shapes:
            rows.append((h, w, start))
            start += h * w
        tab = torch.tensor(rows, dtype=torch.int32, device=device)
        _shape_tables[key] = tab
    return tab


def ms_deform_attn_cuda(value: torch.Tensor,
                        spatial_shapes: Sequence[Tuple[int, int]],
                        sampling_locations: torch.Tensor,
                        attention_weights: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernel; same contract as ``ms_deform_attn_torch``.

    Raises on what the kernel does not take (device, dtype, shape,
    contiguity) and when a gradient is asked for: the backward kernel comes
    with the training slice."""
    global launches
    loc, aw = sampling_locations, attention_weights
    if torch.is_grad_enabled() and (value.requires_grad or loc.requires_grad
                                    or aw.requires_grad):
        raise NotImplementedError(
            "MSDA CUDA kernel is forward-only; its backward kernel comes with "
            "the training slice (run inference under torch.inference_mode())")
    for name, t in (("value", value), ("sampling_locations", loc),
                    ("attention_weights", aw)):
        if not t.is_cuda or t.device != value.device:
            raise ValueError(f"{name} must be on {value.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if value.dtype not in _DTYPES:
        raise TypeError(f"value dtype {value.dtype} not supported "
                        "(float32 or bfloat16)")
    if loc.dtype != torch.float32 or aw.dtype != torch.float32:
        raise TypeError("sampling_locations and attention_weights must be "
                        "float32")
    if value.dim() != 4 or loc.dim() != 6 or aw.dim() != 5:
        raise ValueError("expected value (B,S,M,D), loc (B,Lq,M,L,P,2), "
                         "aw (B,Lq,M,L,P)")
    b, s, m, d = value.shape
    lq, nl, p = loc.shape[1], loc.shape[3], loc.shape[4]
    if tuple(loc.shape) != (b, lq, m, nl, p, 2) or \
            tuple(aw.shape) != (b, lq, m, nl, p):
        raise ValueError(f"shape mismatch: value {tuple(value.shape)}, loc "
                         f"{tuple(loc.shape)}, aw {tuple(aw.shape)}")
    if not 1 <= nl <= 4 or nl != len(spatial_shapes):
        raise ValueError(f"{nl} levels in loc, {len(spatial_shapes)} shapes; "
                         "the kernel takes 1-4 levels")
    if s != sum(h * w for h, w in spatial_shapes):
        raise ValueError(f"value has {s} rows, shapes give "
                         f"{sum(h * w for h, w in spatial_shapes)}")
    if d not in (4, 8, 16) and (d < 32 or d % 32):
        raise ValueError(f"head dim {d} not supported (4, 8, 16 or a "
                         "multiple of 32)")
    lib = _load()
    table = _shape_table(spatial_shapes, value.device)
    out = torch.empty((b, lq, m * d), dtype=value.dtype, device=value.device)
    stream = torch.cuda.current_stream(value.device).cuda_stream
    rc = lib.msda_fwd(value.data_ptr(), table.data_ptr(), loc.data_ptr(),
                      aw.data_ptr(), out.data_ptr(), _DTYPES[value.dtype],
                      b, s, lq, m, d, nl, p, stream)
    if rc != 0:
        raise RuntimeError(f"msda_fwd launch failed: CUDA error {rc}")
    launches += 1
    return out
