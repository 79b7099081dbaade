"""The RG-LRU recurrence (Griffin): plain PyTorch version and CUDA kernel.

The port's counterpart of the scan in :func:`repro.models.rglru.rglru_apply`
(``src/repro/models/rglru.py:91–111``; the reference runs it by
``jax.lax.associative_scan`` and has no Pallas kernel for it).  From the
gate pre-activations on, per channel ``w`` of width ``W``::

    r = σ(r_pre), i = σ(i_pre), log a = −8·softplus(Λ)·r, a = exp(log a)
    mult = sqrt(clip(1 − exp(2·log a), 0, 1)),  b = mult·i·x
    h_t = a_t·h_{t−1} + b_t                    (h_{−1} = h0, or 0)

all in float32 (the reference's expressions, ``exp(2·log a)`` and not
``a²``), for ``x``, ``r_pre``, ``i_pre`` ``(B, S, W)`` in the compute
dtype, ``Λ`` ``(W,)`` float32 and an optional ``h0`` ``(B, W)``
float32.  Outputs: ``y = cast(h)`` in the compute dtype (the rounding
the reference applies right after the scan), or ``cast(h)·gate`` when a
``gate`` ``(B, S, W)`` in the compute dtype is given (one rounding of
the product of two compute-dtype values, the reference's multiply), and
``h_last`` = h at the last position, float32 ``(B, W)``.

* :func:`rglru_scan_ref` — plain PyTorch, differentiable through
  autograd; what CPU tensors get, and the source of the CPU gradients.
  It scans in ⌈log₂ S⌉ tensor steps (Hillis–Steele doubling of the
  affine maps ``h ↦ a·h + b``), not one Python step per token, so a
  4096-token prefill's plain pass is a dozen tensor ops a layer.
* :func:`rglru_scan_cuda` — the hand-written kernel
  (``kernels/csrc/rglru_scan.cu``): one launch per call, prefill or a
  decode step alike; float32 or bfloat16.  The sequence is cut into
  tiles of 64 steps × one 128-byte row of channels, which persistent
  blocks (three an SM) take in order from an atomic ticket and bring
  into a ring of shared-memory slots by TMA: each thread forms its 2
  steps × 16 bytes of channels and composes their map, a warp-shuffle
  scan composes the warp's, one thread a channel carries h across the
  warps, and the h leaving each tile passes to the next segment's tile
  through a scratch buffer kept per device and stream (one tagged word a
  channel, in a fixed order).  Every input is read once; a decode step
  (S ≤ 16) runs one warp a block.  Its sums run in another order than
  the plain version's doubling (and the reference's tree), so the two
  agree to float32 rounding, not bit for bit; two calls agree bit for
  bit.

softplus has the reference's value and gradient (:func:`softplus`,
shared with the Mamba-2 block).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

__all__ = ["launch_count", "reset_launch_count", "rglru_scan_cuda",
           "rglru_scan_ref", "scan_bytes", "softplus"]

#: Griffin's fixed gate sharpness constant
C = 8.0

_LAUNCHES = 0
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel's scratch buffer (ticket, counts, tag, the tiles' h) per
#: (device index, stream): a call on one stream never shares it with a
#: call that may run beside it on another
_SCRATCH: Dict[Tuple[int, int], torch.Tensor] = {}


class _Softplus(torch.autograd.Function):
    """softplus as the reference's ``jax.nn.softplus`` (``logaddexp(x,
    0)``) evaluates it, max(x, 0) + log1p(exp(−|x|)), with its gradient
    exp(x − softplus(x)) (= sigmoid(x); 0.5 at 0, where autograd of the
    expression above would give 1)."""

    @staticmethod
    def forward(ctx, x):
        y = torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return g * torch.exp(x - y)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """softplus with the reference's value and gradient (``_Softplus``)."""
    return _Softplus.apply(x)


def _doubling_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t·h_{t−1} + b_t from h_{−1} = 0 along dim 1: after the
    round of offset d, entry t holds the map of steps (t − 2d, t]
    composed (out of place, so autograd follows)."""
    d, S = 1, a.shape[1]
    while d < S:
        b = torch.cat([b[:, :d], b[:, d:] + a[:, d:] * b[:, :-d]], 1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], 1)
        d *= 2
    return b


def rglru_scan_ref(x: torch.Tensor, r_pre: torch.Tensor,
                   i_pre: torch.Tensor, lam: torch.Tensor,
                   h0: Optional[torch.Tensor] = None,
                   gate: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain RG-LRU scan (see the module docstring): (y in x's dtype,
    h_last float32)."""
    r = torch.sigmoid(r_pre.float())
    i = torch.sigmoid(i_pre.float())
    log_a = -C * softplus(lam.float()) * r
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), 0.0, 1.0))
    b = mult * i * x.float()
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], 1)
    h = _doubling_scan(a, b)
    y = h.to(x.dtype)
    if gate is not None:
        y = y * gate
    return y, h[:, -1]


def scan_bytes(B: int, S: int, W: int, itemsize: int,
               gated: bool = True, h0: bool = False) -> int:
    """Bytes the scan must move: x, r_pre, i_pre (and the gate) read
    once, y written once, Λ, and h0 and h_last (float32)."""
    return (B * S * W * itemsize * (5 if gated else 4) + 4 * W
            + 4 * B * W * (2 if h0 else 1))


def launch_count() -> int:
    """Kernel launches through :func:`rglru_scan_cuda` since the last
    reset."""
    return _LAUNCHES


def reset_launch_count() -> None:
    """Set the launch count of :func:`rglru_scan_cuda` to 0."""
    global _LAUNCHES
    _LAUNCHES = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """``csrc/rglru_scan.cu``'s library, its entry point declared
    (once)."""
    from repro_torch.kernels import _build
    lib = _build.load("rglru_scan")
    lib.rglru_scan_launch.argtypes = [ctypes.c_void_p] * 9 + [
        ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.rglru_scan_launch.restype = ctypes.c_int
    lib.rglru_scan_scratch_bytes.argtypes = [ctypes.c_int] * 4
    lib.rglru_scan_scratch_bytes.restype = ctypes.c_longlong
    return lib


def _scratch(lib: ctypes.CDLL, B: int, S: int, W: int, dtype: int,
             device: torch.device, stream: int) -> Optional[torch.Tensor]:
    """The scratch buffer of ``device`` and ``stream`` with room for a
    call of this shape (``None`` if the call needs none).  A new buffer
    is made zeroed (its one fill, when it first grows); the kernel leaves
    it ready for the next call on the same stream."""
    need = lib.rglru_scan_scratch_bytes(B, S, W, dtype)
    if need <= 0:
        return None
    key = (device.index or 0, stream)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < need:
        buf = torch.zeros(need, dtype=torch.uint8, device=device)
        _SCRATCH[key] = buf
    return buf


def rglru_scan_cuda(x: torch.Tensor, r_pre: torch.Tensor,
                    i_pre: torch.Tensor, lam: torch.Tensor,
                    h0: Optional[torch.Tensor] = None,
                    gate: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel: same contract as :func:`rglru_scan_ref`.

    ``x``, ``r_pre``, ``i_pre`` (and ``gate``) are contiguous CUDA
    tensors ``(B, S, W)`` of one dtype, float32 or bfloat16; ``lam``
    float32 ``(W,)`` and ``h0`` float32 ``(B, W)`` on the same device.
    Returns new (y, h_last).  Raises on any other input and if the
    launch fails; there is no fallback.
    """
    global _LAUNCHES
    from repro_torch.kernels import _build
    named = [("x", x), ("r_pre", r_pre), ("i_pre", i_pre)]
    if gate is not None:
        named.append(("gate", gate))
    for name, t in named:
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"rglru_scan_cuda: {name} must be a CUDA "
                             "tensor")
        if t.dim() != 3 or t.shape != x.shape or t.dtype != x.dtype \
                or t.device != x.device:
            raise ValueError(f"rglru_scan_cuda: {name} is {t.dtype}"
                             f"{tuple(t.shape)}, x is {x.dtype}"
                             f"{tuple(x.shape)} on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"rglru_scan_cuda: {name} must be contiguous")
    if x.dtype not in _DTYPES:
        raise ValueError(f"rglru_scan_cuda: dtype {x.dtype}, expected "
                         "float32 or bfloat16")
    B, S, W = x.shape
    if B < 1 or S < 1 or W < 1 or B > 65535:
        raise ValueError(f"rglru_scan_cuda: shape {tuple(x.shape)}")
    for name, t, shape in (("lam", lam, (W,)), ("h0", h0, (B, W))):
        if t is None:
            continue
        if (tuple(t.shape) != shape or t.dtype != torch.float32
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"rglru_scan_cuda: {name} must be contiguous "
                             f"float32 {shape} on {x.device}")
    y = torch.empty_like(x)
    h_last = torch.empty(B, W, dtype=torch.float32, device=x.device)
    ptr = lambda t: t.data_ptr() if t is not None else None
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    scratch = _scratch(lib, B, S, W, _DTYPES[x.dtype], x.device, stream)
    err = lib.rglru_scan_launch(
        x.data_ptr(), r_pre.data_ptr(), i_pre.data_ptr(), lam.data_ptr(),
        ptr(h0), ptr(gate), y.data_ptr(), h_last.data_ptr(), ptr(scratch),
        B, S, W, _DTYPES[x.dtype], x.device.index or 0, stream)
    if err != 0:
        raise RuntimeError("rglru_scan_cuda: launch failed: "
                           + _build.error_string(lib, err))
    _LAUNCHES += 1
    return y, h_last
