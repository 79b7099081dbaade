"""RMSNorm over the trailing axis: plain PyTorch version and CUDA kernel.

The port's counterpart of :mod:`repro.kernels.rmsnorm` (``rmsnorm_tpu``)
and of ``repro.kernels.ref.rmsnorm_ref``.  With ``m = rsqrt(mean(f32(x)²)
+ eps)`` in float32, it has two forms:

* ``round_scale=False`` (the default), the TPU kernel's:
  ``y = cast(f32(x) · m · f32(w))``, one rounding to x's dtype;
* ``round_scale=True``, the reference model's norm
  (``repro.models.layers._rms_fwd``): in bfloat16
  ``y = cast(x · cast(m · f32(w)))``, the scale rounded to x's dtype
  before the product (two roundings).  In float32 it is the first form.

:func:`repro_torch.models.layers.rmsnorm` takes the second, so the
port's model norm rounds as the reference model's does.

* :func:`rmsnorm_ref` — plain PyTorch; what CPU tensors get.
* :func:`rmsnorm_cuda` — the hand-written kernel
  (``kernels/csrc/rmsnorm.cu``): 16-byte loads, each row held in
  registers between its sum of squares and its scaling, one to eight
  warps per row, a scalar path for a D that is not a multiple of the
  vector width or an unaligned pointer; any row count, float32 or
  bfloat16.
"""
from __future__ import annotations

import ctypes
import functools

import torch

__all__ = ["launch_count", "reset_launch_count", "rmsnorm_cuda",
           "rmsnorm_ref"]

_LAUNCHES = 0
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
                round_scale: bool = False) -> torch.Tensor:
    """Plain RMSNorm over the trailing axis (float32 statistics); see the
    module docstring for ``round_scale``."""
    xf = x.float()
    m = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    if round_scale and x.dtype != torch.float32:
        return (xf * (m * w.float()).to(x.dtype).float()).to(x.dtype)
    return (xf * m * w.float()).to(x.dtype)


def launch_count() -> int:
    """Kernel launches through :func:`rmsnorm_cuda` since the last reset."""
    return _LAUNCHES


def reset_launch_count() -> None:
    """Set the launch count of :func:`rmsnorm_cuda` to 0."""
    global _LAUNCHES
    _LAUNCHES = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """``csrc/rmsnorm.cu``'s library, its entry point declared
    (once)."""
    from repro_torch.kernels import _build
    lib = _build.load("rmsnorm")
    lib.rmsnorm_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.rmsnorm_launch.restype = ctypes.c_int
    return lib


def rmsnorm_cuda(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
                 round_scale: bool = False) -> torch.Tensor:
    """The CUDA kernel: same contract as :func:`rmsnorm_ref`, both forms.

    ``x`` is a contiguous CUDA tensor ``(..., D)`` of float32 or
    bfloat16; ``w`` is ``(D,)`` on the same device (cast to float32 here
    if it is not already).  Raises on any other input and if the launch
    fails; there is no fallback.
    """
    global _LAUNCHES
    from repro_torch.kernels import _build
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        raise ValueError("rmsnorm_cuda: x must be a CUDA tensor")
    if x.dtype not in _DTYPES:
        raise ValueError(f"rmsnorm_cuda: x has dtype {x.dtype}, expected "
                         "float32 or bfloat16")
    if x.dim() < 1 or not x.is_contiguous():
        raise ValueError("rmsnorm_cuda: x must be contiguous with a "
                         "trailing axis")
    D = x.shape[-1]
    if tuple(w.shape) != (D,) or w.device != x.device:
        raise ValueError(f"rmsnorm_cuda: w must be ({D},) on {x.device}, "
                         f"got {tuple(w.shape)} on {w.device}")
    if not w.is_floating_point():
        raise ValueError(f"rmsnorm_cuda: w has dtype {w.dtype}")
    w32 = w.float().contiguous()
    y = torch.empty_like(x)
    rows = x.numel() // D if D else 0
    if rows == 0:
        return y
    lib = _lib()
    err = lib.rmsnorm_launch(
        x.data_ptr(), w32.data_ptr(), y.data_ptr(), rows, D,
        _DTYPES[x.dtype], float(eps), int(round_scale),
        x.device.index or 0, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError("rmsnorm_cuda: launch failed: "
                           + _build.error_string(lib, err))
    _LAUNCHES += 1
    return y
