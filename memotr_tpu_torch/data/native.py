"""ctypes binding of the native data plane, ``native/dataplane.cpp``
(counterpart of ``memotr_tpu/data/native.py``): fused JPEG decode, resize,
normalize and pad in C++ with OpenCV, synchronous or on a worker pool.

The library is built on first use with ``g++`` (the flags of
``native/Makefile``, OpenCV's from ``pkg-config opencv4``) into
``memotr_tpu_torch/_build/<hash of source and flags>/libdataplane.so``
under a file lock; ``native/`` itself is only read.  Where it cannot be
built (no compiler, no OpenCV headers), ``available()`` is false,
``unavailable_reason()`` says why, and callers take the Python path.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .transforms import IMAGENET_MEAN, IMAGENET_STD

SOURCE = Path(__file__).resolve().parents[2] / "native" / "dataplane.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17"]
LIBS = ["-lopencv_core", "-lopencv_imgcodecs", "-lopencv_imgproc"]

_lib: Optional[ctypes.CDLL] = None
_reason = "not built yet"
_lib_lock = threading.Lock()


def _opencv_cflags() -> list:
    out = subprocess.run(["pkg-config", "--cflags", "opencv4"],
                         capture_output=True, text=True, timeout=30)
    if out.returncode != 0:
        raise RuntimeError("pkg-config finds no opencv4: "
                           + out.stderr.strip().splitlines()[0])
    return out.stdout.split()


def build() -> Path:
    """Compiles ``native/dataplane.cpp`` unless built from this source
    already; returns the library's path.  Raises with the compiler's
    output when it fails."""
    flags = CXX_FLAGS + _opencv_cflags()
    key = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(flags + LIBS).encode()).hexdigest()[:16]
    path = BUILD_DIR / key / "libdataplane.so"
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path.parent / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not path.exists():              # or built by another process
                tmp = path.with_name(f"libdataplane.{os.getpid()}.so")
                cmd = ["g++", *flags, "-o", str(tmp), str(SOURCE), *LIBS]
                out = subprocess.run(cmd, capture_output=True, text=True,
                                     timeout=300)
                (path.parent / "build.log").write_text(
                    " ".join(cmd) + "\n" + out.stdout + out.stderr)
                if out.returncode != 0:
                    raise RuntimeError(f"g++ failed ({out.returncode}) "
                                       f"building {SOURCE}:\n{out.stderr}")
                os.replace(tmp, path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return path


def load_library() -> Optional[ctypes.CDLL]:
    """The data plane, built and opened once; None where it cannot be."""
    global _lib, _reason
    with _lib_lock:
        if _lib is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _reason = f"{type(e).__name__}: {e}".strip()
            return None
        fp = ctypes.POINTER(ctypes.c_float)
        u8 = ctypes.POINTER(ctypes.c_ubyte)
        lib.dp_create.restype = ctypes.c_void_p
        lib.dp_create.argtypes = [ctypes.c_int]
        lib.dp_destroy.restype = None
        lib.dp_destroy.argtypes = [ctypes.c_void_p]
        lib.dp_decode_sync.restype = ctypes.c_int
        lib.dp_decode_sync.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, fp, fp, fp, u8, ctypes.POINTER(ctypes.c_int)]
        lib.dp_decode_sync_u8.restype = ctypes.c_int
        lib.dp_decode_sync_u8.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, u8, u8, ctypes.POINTER(ctypes.c_int)]
        lib.dp_submit.restype = ctypes.c_int
        lib.dp_submit.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, fp, fp, fp, u8]
        lib.dp_wait.restype = ctypes.c_int
        lib.dp_wait.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                ctypes.POINTER(ctypes.c_int)]
        _lib = lib
        return _lib


def available() -> bool:
    return load_library() is not None


def unavailable_reason() -> str:
    """Why the data plane could not be loaded (after a failed load)."""
    return _reason


_MEAN = (ctypes.c_float * 3)(*IMAGENET_MEAN.tolist())
_STD = (ctypes.c_float * 3)(*IMAGENET_STD.tolist())


def _dims(dims) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    return (dims[0], dims[1]), (dims[2], dims[3])


def decode_sync(path: str, short_side: int, max_side: int,
                canvas_hw: Tuple[int, int]):
    """Decode, resize, normalize and pad one frame: (canvas float32 HWC,
    mask bool HW, (ori_h, ori_w), (new_h, new_w)), or None on failure."""
    lib = load_library()
    if lib is None:
        return None
    h, w = canvas_hw
    canvas = np.empty((h, w, 3), np.float32)
    mask = np.empty((h, w), np.uint8)
    dims = (ctypes.c_int * 4)()
    rc = lib.dp_decode_sync(
        path.encode(), short_side, max_side, h, w, _MEAN, _STD,
        canvas.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), dims)
    if rc != 0:
        return None
    return (canvas, mask.astype(bool), *_dims(dims))


def decode_sync_u8(path: str, short_side: int, max_side: int,
                   canvas_hw: Tuple[int, int]):
    """Decode, resize and pad one frame, raw RGB uint8 (normalized on the
    device): (canvas uint8 HWC, mask bool HW, (ori_h, ori_w),
    (new_h, new_w)), or None on failure."""
    lib = load_library()
    if lib is None:
        return None
    h, w = canvas_hw
    canvas = np.empty((h, w, 3), np.uint8)
    mask = np.empty((h, w), np.uint8)
    dims = (ctypes.c_int * 4)()
    rc = lib.dp_decode_sync_u8(
        path.encode(), short_side, max_side, h, w,
        canvas.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), dims)
    if rc != 0:
        return None
    return (canvas, mask.astype(bool), *_dims(dims))


class AsyncDecoder:
    """Worker-pool decoder: submit paths ahead, collect them in order with
    ``wait``; ``close`` ends the pool."""

    def __init__(self, num_threads: int = 4):
        self.lib = load_library()
        if self.lib is None:
            raise RuntimeError(f"native data plane unavailable: {_reason}")
        self.handle = self.lib.dp_create(num_threads)
        self._next_id = 0
        self._bufs = {}

    def submit(self, path: str, short_side: int, max_side: int,
               canvas_hw: Tuple[int, int]) -> int:
        h, w = canvas_hw
        canvas = np.empty((h, w, 3), np.float32)
        mask = np.empty((h, w), np.uint8)
        job = self._next_id
        self._next_id += 1
        rc = self.lib.dp_submit(
            self.handle, job, path.encode(), short_side, max_side, h, w,
            _MEAN, _STD,
            canvas.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
        if rc != 0:
            raise RuntimeError("dp_submit failed")
        self._bufs[job] = (canvas, mask)      # alive until the job is waited
        return job

    def wait(self, job: int):
        dims = (ctypes.c_int * 4)()
        rc = self.lib.dp_wait(self.handle, job, dims)
        canvas, mask = self._bufs.pop(job)
        if rc != 0:
            return None
        return (canvas, mask.astype(bool), *_dims(dims))

    def close(self):
        if self.handle:
            self.lib.dp_destroy(self.handle)
            self.handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
