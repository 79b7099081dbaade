"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on first use into its own shared library
``build/kernels/lib<name>_<hash>.so`` at the root of the checkout (the
hash covers that source alone and the flags, so an edited source
rebuilds only itself), with a plain C interface that the wrappers call
through :mod:`ctypes`.  The flags are fixed: ``sm_90a``, ``-O3``,
``-fmad=false`` (no FMA contraction, so the kernels round like their
plain PyTorch versions; a kernel that wants a fused multiply-add writes
``fmaf``) and no fast math.  A failed build raises; there is no fallback.

Every source exports ``const char* cuda_error_string(int)``, which
:func:`error_string` calls to decode that library's error codes; each
wrapper module declares the signatures of its own entry points.

:func:`build_all` compiles every source, one ``nvcc`` per source, all
started together; :func:`load` returns one source's library, building
it if needed.  A verbose build keeps each compiler's report (``ptxas``'s
registers, spills and warnings per kernel) in :data:`LOGS`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

__all__ = ["BUILD_DIR", "CSRC", "LOGS", "NVCC_FLAGS", "build_all",
           "error_string", "load"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
#: the compiler's output of each source's last verbose build, by name
LOGS: Dict[str, str] = {}


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


def _start(name: str, verbose: bool):
    """Start ``nvcc`` on ``csrc/<name>.cu`` unless its library is up to
    date; returns ``(process, temporary output)`` or ``None``."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), tmp


def _finish(name: str, started, verbose: bool) -> None:
    """Wait for one build; install its library or raise with the
    compiler's output."""
    if started is None:
        return
    proc, tmp = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (exit "
                           f"{proc.returncode}):\n{log}")
    if verbose and log:
        LOGS[name] = log
        print(f"--- {name}.cu\n{log}")
    os.replace(tmp, _target(name))


def build_all(verbose: bool = False) -> Dict[str, float]:
    """Compile every ``csrc/*.cu`` in parallel (one ``nvcc`` each).

    Returns the seconds until each build finished, counted from the
    common start (0.0 for a library that was up to date).  With
    ``verbose`` the compiler runs with ``-Xptxas -v`` and its report is
    printed.  Every started compiler is waited for, even when one fails.
    """
    names: List[str] = [p.stem for p in sorted(CSRC.glob("*.cu"))]
    t0 = time.perf_counter()
    started = {n: _start(n, verbose) for n in names}
    secs, errors = {}, []
    for n in names:
        try:
            _finish(n, started[n], verbose)
        except RuntimeError as e:
            errors.append(str(e))
        secs[n] = (time.perf_counter() - t0) if started[n] else 0.0
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use.

    Only ``cuda_error_string`` is declared here; the caller declares the
    argument and result types of its own entry points.
    """
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    _finish(name, _start(name, False), False)
    lib = ctypes.CDLL(str(_target(name)))
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    _LIBS[name] = lib
    return lib


def error_string(lib: ctypes.CDLL, err: int) -> str:
    """The CUDA runtime's message for error code ``err``, as decoded by
    the library ``lib`` that returned it."""
    return f"{err}: {lib.cuda_error_string(err).decode()}"
