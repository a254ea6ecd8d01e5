"""Build a CUDA source of the port into a shared library, at first use.

The port's CUDA kernels live in ``chainermn_tpu_torch/csrc/*.cu``, each
with a plain ``extern "C"`` entry point.  :func:`load_library` compiles one
with ``nvcc`` for Hopper (``sm_90a``) into ``build/cuda/`` of the checkout
and loads it with ``ctypes``; the caller declares the entry point's
``argtypes``.  No PyTorch headers are compiled, so a build takes seconds.

The library's file name carries a hash of the source and the flags, so an
edited source is rebuilt and a stale library is never loaded.  Several
processes (the ranks of one ``torchrun``) may ask at the same moment: the
build runs under a file lock, into a temporary name that is then renamed
into place.  ``nvcc`` is ``$CUDA_HOME/bin/nvcc`` (default ``/usr/local/cuda``)
or the first ``nvcc`` on ``PATH``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD = Path(__file__).resolve().parents[2] / "build" / "cuda"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
_LIBS: dict = {}


def nvcc() -> str:
    """Path of the CUDA compiler; raises if there is none."""
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
            "CUDA kernels are built from source on first use")
    return found


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/{name}.cu`` goes."""
    key = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD / f"lib{name}-{key}.so"


def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/{name}.cu`` if its library is missing, then load it
    (once per process)."""
    if name in _LIBS:
        return _LIBS[name]
    out = library_path(name)
    if not out.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        with open(BUILD / f"{name}.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not out.exists():  # another process may have built it
                tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
                cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                       str(CSRC / f"{name}.cu")]
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=900)
                if proc.returncode:
                    raise RuntimeError(
                        f"building {name}.cu failed ({' '.join(cmd)}):\n"
                        f"{proc.stdout}{proc.stderr}")
                os.replace(tmp, out)
    _LIBS[name] = ctypes.CDLL(str(out))
    return _LIBS[name]
