"""Build the port's CUDA sources into shared libraries and load them.

Each kernel source under ``csrc/`` exposes a plain C interface; it is
compiled by ``nvcc`` for Hopper (``sm_90a``) into ``_build/`` beside this
file (git-ignored) and loaded with :mod:`ctypes`. A library is named by
the hash of its sources, the shared headers (``csrc/*.cuh``) and the
flags, so a changed source is rebuilt and an unchanged one is reused
within a checkout. Nothing is built at import time: :func:`load` runs on
a kernel's first launch. Different libraries build in parallel when
loaded from several threads (one ``nvcc`` each).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

#: dynamic shared memory one block may opt into on Hopper (H100 and H200:
#: 227 KiB of the SM's 256 KiB)
SMEM_OPTIN_BYTES = 232448

NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_name_locks: dict = {}
_libs: dict = {}
#: name -> {"seconds": build time (0.0 when reused), "log": nvcc's
#: output (registers, shared memory and spills per kernel), "path": ...}
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda); "
                       "the port's CUDA kernels are built on first use")


def load(name: str, sources) -> ctypes.CDLL:
    """Build (or reuse) ``lib<name>-<hash>.so`` from ``sources`` (file
    names under ``csrc/``) and return it loaded. Raises RuntimeError with
    the compiler's output when the build fails."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        if name in _libs:
            return _libs[name]
        paths = [CSRC / s for s in sources]
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for p in paths + sorted(CSRC.glob("*.cuh")):
            digest.update(p.read_bytes())
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        out = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
        seconds, log = 0.0, ""
        if not out.exists():
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, paths)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(
                    f"nvcc failed building {name} (exit {proc.returncode}):\n"
                    f"{' '.join(cmd)}\n{log}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        _libs[name] = lib
        build_info[name] = {"seconds": seconds, "log": log, "path": str(out)}
        return lib
