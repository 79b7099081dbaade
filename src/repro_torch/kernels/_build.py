"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on first use into its own shared library
``build/kernels/lib<name>_<hash>.so`` at the root of the checkout (the
hash covers the source and the flags, so an edited source rebuilds), with
a plain C interface that the wrappers call through :mod:`ctypes`.  The
flags are fixed: ``sm_90a``, ``-O3``, ``-fmad=false`` (no FMA
contraction, so the kernels round like their plain PyTorch versions) and
no fast math.  A failed build raises; there is no fallback.

:func:`build_all` compiles every source, one after another; :func:`load`
returns one source's library, building it if needed.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

__all__ = ["BUILD_DIR", "CSRC", "NVCC_FLAGS", "build_all", "error_string",
           "load"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    """Path of the CUDA compiler (``PATH`` first, then the toolkit's)."""
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    """Library path of ``csrc/<name>.cu`` for its current contents."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _build(name: str, verbose: bool = False) -> float:
    """Compile ``csrc/<name>.cu`` unless its library is up to date.

    Returns the seconds the build took (0.0 if it was up to date).  Raises
    ``RuntimeError`` with the compiler's output if the build fails.  With
    ``verbose`` the compiler runs with ``-Xptxas -v`` and its report is
    printed.
    """
    out = _target(name)
    if out.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (exit "
                           f"{proc.returncode}):\n{proc.stdout}")
    if verbose and proc.stdout:
        print(proc.stdout)
    os.replace(tmp, out)
    return time.perf_counter() - t0


def build_all(verbose: bool = False) -> Dict[str, float]:
    """Compile every ``csrc/*.cu``; the seconds each build took."""
    return {p.stem: _build(p.stem, verbose) for p in sorted(CSRC.glob("*.cu"))}


def load(name: str = "psp_tick") -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    _build(name)
    lib = ctypes.CDLL(str(_target(name)))
    lib.psp_tick_launch.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                    ctypes.POINTER(ctypes.c_int),
                                    ctypes.POINTER(ctypes.c_float),
                                    ctypes.c_void_p]
    lib.psp_tick_launch.restype = ctypes.c_int
    lib.psp_tick_error_string.argtypes = [ctypes.c_int]
    lib.psp_tick_error_string.restype = ctypes.c_char_p
    _LIBS[name] = lib
    return lib


def error_string(err: int, name: str = "psp_tick") -> str:
    """The CUDA runtime's message for error code ``err``."""
    return f"{err}: {load(name).psp_tick_error_string(err).decode()}"
