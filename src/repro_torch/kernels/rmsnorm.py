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

Both forwards take ``return_m=True`` (the training forward): they then
also return each row's ``m`` (float32, x's leading shape), the residual
the reference's ``_rms_fwd`` saves.  The backward of the
``round_scale=True`` form (the reference model's custom VJP
``repro.models.layers._rms_bwd``), given that ``m`` and the cotangent
``g`` of y: with ``gs = f32(g)·w``,

    dx = cast(m·gs) − cast(cast(coeff)·x),  coeff = (m³/D)·Σ cast(gs)·x
    dw = Σ_rows f32(cast(f32(g)·m))·f32(x)

with every rounding of ``_rms_bwd`` (in float32 the casts are the
identity), dx in x's dtype, dw float32.

* :func:`rmsnorm_bwd_ref` — plain PyTorch; what CPU tensors get.
* :func:`rmsnorm_bwd_cuda` — the hand-written kernel beside the forward
  in ``kernels/csrc/rmsnorm.cu``.  Its bound is bytes (x and g read
  once, dx written once), so it takes the forward's layout: each thread
  holds 16-byte vectors of x and g of its row in registers, the row's
  inner sum goes by shuffles, and dx is written from the registers, so
  each row is read from device memory once; each thread also sums dw in
  f32 for the columns it owns over the rows its warp visits, the block
  adds its warps' sums in a fixed order into one partial row, and a
  second, column pass adds the blocks' rows in a fixed order (no
  atomics: two runs give the same bits).  A D that is not a multiple of
  the vector width or an unaligned pointer takes a scalar path of the
  same shape.  Its roundings are the plain version's; only the order of
  the float32 sums (the inner sum, dw) differs.
"""
from __future__ import annotations

import ctypes
import functools

import torch

__all__ = ["bwd_launch_count", "launch_count", "reset_launch_count",
           "rmsnorm_bwd_cuda", "rmsnorm_bwd_ref", "rmsnorm_cuda",
           "rmsnorm_ref"]

_LAUNCHES = 0
_BWD_LAUNCHES = 0
#: the most blocks the backward's row pass runs (two per SM of an H100):
#: the rows of its per-block dw partials
_BWD_BLOCKS = 264
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
                round_scale: bool = False, return_m: bool = False):
    """Plain RMSNorm over the trailing axis (float32 statistics); see the
    module docstring for ``round_scale`` and ``return_m``."""
    xf = x.float()
    m = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    if round_scale and x.dtype != torch.float32:
        y = (xf * (m * w.float()).to(x.dtype).float()).to(x.dtype)
    else:
        y = (xf * m * w.float()).to(x.dtype)
    return (y, m[..., 0]) if return_m else y


def rmsnorm_bwd_ref(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                    m: torch.Tensor):
    """Plain backward of the ``round_scale=True`` form from the forward's
    ``m``: (dx in x's dtype, dw float32); see the module docstring."""
    T, D = x.dtype, x.shape[-1]
    xf = x.float()
    m = m[..., None]
    gs = g.float() * w.float()
    inner = (gs.to(T).float() * xf).sum(dim=-1, keepdim=True)
    coeff = (m * m * m / D) * inner
    dx = (m * gs).to(T) - coeff.to(T) * x
    t = (g.float() * m).to(T)
    dw = (t.float() * xf).reshape(-1, D).sum(dim=0)
    return dx, dw


def launch_count() -> int:
    """Kernel launches through :func:`rmsnorm_cuda` since the last reset."""
    return _LAUNCHES


def bwd_launch_count() -> int:
    """Calls of :func:`rmsnorm_bwd_cuda` (each launches its row and column
    passes) since the last reset."""
    return _BWD_LAUNCHES


def reset_launch_count() -> None:
    """Set the launch counts of :func:`rmsnorm_cuda` and
    :func:`rmsnorm_bwd_cuda` to 0."""
    global _LAUNCHES, _BWD_LAUNCHES
    _LAUNCHES = _BWD_LAUNCHES = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """``csrc/rmsnorm.cu``'s library, its entry point declared
    (once)."""
    from repro_torch.kernels import _build
    lib = _build.load("rmsnorm")
    lib.rmsnorm_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.rmsnorm_launch.restype = ctypes.c_int
    lib.rmsnorm_bwd_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.rmsnorm_bwd_launch.restype = ctypes.c_int
    return lib


def rmsnorm_cuda(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
                 round_scale: bool = False, return_m: bool = False):
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
    m = (torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
         if return_m else None)
    rows = x.numel() // D if D else 0
    if rows == 0:
        return (y, m) if return_m else y
    lib = _lib()
    err = lib.rmsnorm_launch(
        x.data_ptr(), w32.data_ptr(), y.data_ptr(),
        m.data_ptr() if return_m else None, rows, D,
        _DTYPES[x.dtype], float(eps), int(round_scale),
        x.device.index or 0, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError("rmsnorm_cuda: launch failed: "
                           + _build.error_string(lib, err))
    _LAUNCHES += 1
    return (y, m) if return_m else y


def rmsnorm_bwd_cuda(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                     m: torch.Tensor):
    """The backward kernel: same contract as :func:`rmsnorm_bwd_ref`.

    ``x`` and ``g`` are CUDA tensors ``(..., D)`` of one dtype (float32
    or bfloat16; made contiguous here), ``w`` is ``(D,)``, ``m`` float32
    of x's leading shape; D is at most 12288 (the row pass holds a row in
    the registers of at most 8 warps).  Raises on any other input and if
    a launch fails; there is no fallback.
    """
    global _BWD_LAUNCHES
    from repro_torch.kernels import _build
    for name, t in (("x", x), ("g", g)):
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"rmsnorm_bwd_cuda: {name} must be a CUDA "
                             "tensor")
    if x.dtype not in _DTYPES or g.dtype != x.dtype or g.shape != x.shape:
        raise ValueError(f"rmsnorm_bwd_cuda: x {x.dtype}{tuple(x.shape)} "
                         f"and g {g.dtype}{tuple(g.shape)} must match, "
                         "float32 or bfloat16")
    D = x.shape[-1]
    if tuple(w.shape) != (D,) or w.device != x.device:
        raise ValueError(f"rmsnorm_bwd_cuda: w must be ({D},) on {x.device}")
    if not 1 <= D <= 12288:
        raise ValueError(f"rmsnorm_bwd_cuda: D {D} outside 1..12288")
    if (m.shape != x.shape[:-1] or m.dtype != torch.float32
            or m.device != x.device):
        raise ValueError("rmsnorm_bwd_cuda: m must be float32 "
                         f"{tuple(x.shape[:-1])} on {x.device}")
    x, g, m = x.contiguous(), g.contiguous(), m.contiguous()
    w32 = w.float().contiguous()
    dx = torch.empty_like(x)
    dw = torch.empty(D, dtype=torch.float32, device=x.device)
    rows = x.numel() // D
    if rows == 0:
        return dx, dw.zero_()
    partial = torch.empty(min(rows, _BWD_BLOCKS), D, dtype=torch.float32,
                          device=x.device)
    lib = _lib()
    err = lib.rmsnorm_bwd_launch(
        x.data_ptr(), w32.data_ptr(), g.data_ptr(), m.data_ptr(),
        dx.data_ptr(), partial.data_ptr(), dw.data_ptr(), rows, D,
        partial.shape[0],
        _DTYPES[x.dtype], x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError("rmsnorm_bwd_cuda: launch failed: "
                           + _build.error_string(lib, err))
    _BWD_LAUNCHES += 1
    return dx, dw
