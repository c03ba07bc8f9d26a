"""ctypes binding for the native batch assembler (port of
``distkeras_tpu/data/native.py``), over the port's own copy of its C++
source, ``native_src/batcher.cc``.

The library is compiled with ``g++`` on first use into ``_build/`` beside
this module (listed in ``.gitignore``), written under a temporary name
and renamed, so processes that build at once never load a half-written
file. Every entry point falls back to NumPy when the toolchain or the
library is unavailable, as in the JAX package: the native path is a
throughput optimization of the host side of the input pipeline, and both
paths give the same rows. :func:`available` says which path runs.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "native_src", "batcher.cc")
_SO = os.path.join(_HERE, "_build", "libdkbatch.so")


def _build() -> Optional[str]:
    if not os.path.exists(_SRC):
        return None
    if os.path.exists(_SO) and \
            os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return _SO
    try:
        os.makedirs(os.path.dirname(_SO), exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(_SO))
        os.close(fd)
        try:
            subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp,
                            _SRC, "-lpthread"],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, _SO)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return _SO
    except (OSError, subprocess.SubprocessError):
        return None


def _lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        so = _build()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
            lib.dk_gather_rows.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int32]
            lib.dk_gather_rows.restype = None
            lib.dk_permutation.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64]
            lib.dk_permutation.restype = None
            _LIB = lib
        except OSError:
            _LIB = None
        return _LIB


def available() -> bool:
    """Whether the native library built and loaded (the path the entry
    points below take); False means the NumPy fallback runs."""
    return _lib() is not None


def gather_rows(src: np.ndarray, idx: np.ndarray,
                num_threads: int = 0) -> np.ndarray:
    """out[i] = src[idx[i]]: native threaded memcpy gather with NumPy
    fallback. ``src`` may have any row shape; ``idx`` is int64 [n]."""
    lib = _lib()
    idx = np.ascontiguousarray(idx, np.int64)
    src = np.asarray(src)
    if lib is None or src.dtype.hasobject:
        # object rows are PyObject pointers: a memcpy without incref
        # corrupts the interpreter, so those columns stay on NumPy
        return src[idx]
    if idx.size and (idx.min() < 0 or idx.max() >= len(src)):
        raise IndexError(  # match the NumPy fallback, don't memcpy OOB
            f"gather indices out of range [0, {len(src)}): "
            f"[{idx.min()}, {idx.max()}]")
    src = np.ascontiguousarray(src)
    n = len(idx)
    row_bytes = src.dtype.itemsize * int(np.prod(src.shape[1:],
                                                 dtype=np.int64))
    out = np.empty((n,) + src.shape[1:], src.dtype)
    if num_threads <= 0:
        num_threads = min(8, os.cpu_count() or 1)
    lib.dk_gather_rows(
        src.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p),
        idx.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(n), ctypes.c_int64(row_bytes),
        ctypes.c_int32(num_threads))
    return out


def permutation(n: int, seed: int) -> np.ndarray:
    """Deterministic Fisher-Yates permutation of [0, n): native
    xoshiro256** with NumPy fallback (the two paths draw different
    sequences, each deterministic by seed)."""
    lib = _lib()
    if lib is None:
        return np.random.default_rng(seed).permutation(n).astype(np.int64)
    out = np.empty(n, np.int64)
    lib.dk_permutation(out.ctypes.data_as(ctypes.c_void_p),
                       ctypes.c_int64(n), ctypes.c_uint64(seed & (2**64 - 1)))
    return out
