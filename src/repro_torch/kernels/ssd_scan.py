"""Mamba-2 chunked SSD scan: plain PyTorch version and CUDA kernel.

The port's counterpart of :mod:`repro.kernels.ssd_scan` (``ssd_scan_tpu``)
and of ``repro.models.ssm.ssd_chunked``.  Both compute, for inputs
``x`` ``(B, S, nh, hd)``, post-softplus steps ``dt`` ``(B, S, nh)``,
negative decay rates ``A`` ``(nh,)`` and input / output projections
``Bm``, ``Cm`` ``(B, S, ng, N)`` shared by the ``nh / ng`` heads of a
group, the recurrence

    h_t = exp(dt_t·A) h_{t−1} + dt_t B_t ⊗ x_t,   y_t = C_t · h_t

in the chunked dual form (chunk length Q = min(chunk, S), S % Q == 0),
in float32: per chunk ``((C Bᵀ) ⊙ L)(x·dt)`` with
``L = exp(cum_i − cum_j)·[i ≥ j]`` and ``cum`` the prefix sum of
``dt·A``, plus the state carried from the chunks before.  They return
``y`` in x's dtype and the final state ``h`` ``(B, nh, hd, N)`` float32.

* :func:`ssd_ref` — plain PyTorch, written as ``ssd_chunked`` writes it;
  what CPU tensors get.
* :func:`ssd_cuda` — the hand-written kernels (``kernels/csrc/ssd_scan.cu``),
  groups read through strides, hd 16 or 64 (the reduced and the published
  mamba2-780m), N ≤ 128, Q ≤ 128.  The route is fixed by the dtype:
  every bfloat16 call runs two launches on the tensor cores — a scan over
  the chunks in order per (``scan_rows`` state rows, head, batch), the
  state in the MMA accumulators, writing each chunk's entering state;
  then the output per (batch, chunk, three heads of a group sharing
  the block's B, C and C·Bᵀ; a constant of the CUDA source, chosen on
  the H100 at mamba2-780m's serving prefill), the chunk axis spread across
  the card — and every float32 call one launch on the CUDA cores (a block
  per (head, batch) walking the chunks in order), products in float32.
  There is no other route and no fallback.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

__all__ = ["HEAD_DIMS", "chunk_len", "launch_count",
           "reset_launch_count", "scan_rows", "ssd_cuda", "ssd_ref"]

#: head dims the kernel is built for
HEAD_DIMS = (16, 64)
#: largest chunk length and state size the kernel takes
MAX_CHUNK = 128
MAX_STATE = 128

_LAUNCHES = 0
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def chunk_len(S: int, chunk: int) -> int:
    """The chunk length Q = min(chunk, S); raises unless it divides S."""
    Q = min(chunk, S)
    if Q < 1 or S % Q:
        raise ValueError(f"ssd: sequence length {S} is not a multiple of "
                         f"the chunk length {Q}")
    return Q


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            Bm: torch.Tensor, Cm: torch.Tensor, chunk: int = 128
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain chunked SSD (see the module docstring); returns
    (y (B, S, nh, hd) in x's dtype, h_final (B, nh, hd, N) float32)."""
    B, S, nh, hd = x.shape
    ng, N = Bm.shape[2], Bm.shape[3]
    rep = nh // ng
    Q = chunk_len(S, chunk)
    nc = S // Q

    f32 = torch.float32
    xdt = x.to(f32) * dt.to(f32)[..., None]                 # (B,S,nh,hd)
    dA = dt.to(f32) * A.to(f32)                              # (B,S,nh) ≤ 0

    def ch(a, *extra):
        return a.reshape(B, nc, Q, *extra)
    xdt_c = ch(xdt, nh, hd)
    dA_c = ch(dA, nh)
    B_h = ch(Bm.to(f32), ng, N).repeat_interleave(rep, dim=3)  # (B,nc,Q,nh,N)
    C_h = ch(Cm.to(f32), ng, N).repeat_interleave(rep, dim=3)

    cum = torch.cumsum(dA_c, dim=2)                          # (B,nc,Q,nh)
    seg_total = cum[:, :, -1]                                # (B,nc,nh)

    # intra-chunk (quadratic dual form); exp overflows above the
    # diagonal, so the mask selects and never multiplies
    li = cum[:, :, :, None, :]
    lj = cum[:, :, None, :, :]
    causal = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    L = torch.where(causal[None, None, :, :, None], torch.exp(li - lj),
                    torch.zeros((), dtype=f32, device=x.device))
    scores = torch.einsum("bcqhn,bcshn->bcqsh", C_h, B_h) * L
    y_intra = torch.einsum("bcqsh,bcshd->bcqhd", scores, xdt_c)

    # per-chunk input states
    decay_to_end = torch.exp(seg_total[:, :, None, :] - cum)
    chunk_state = torch.einsum("bcqhn,bcqhd,bcqh->bchdn",
                               B_h, xdt_c, decay_to_end)     # (B,nc,nh,hd,N)

    # inter-chunk recurrence over states, each chunk reading the previous
    h = torch.zeros(B, nh, hd, N, dtype=f32, device=x.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = (h * torch.exp(seg_total[:, c])[:, :, None, None]
             + chunk_state[:, c])
    y_inter = torch.einsum("bcqhn,bchdn,bcqh->bcqhd", C_h,
                           torch.stack(h_prev, dim=1), torch.exp(cum))
    y = (y_intra + y_inter).reshape(B, S, nh, hd)
    return y.to(x.dtype), h


def launch_count() -> int:
    """Kernel launches through :func:`ssd_cuda` since the last reset."""
    return _LAUNCHES


def reset_launch_count() -> None:
    """Set the launch count of :func:`ssd_cuda` to 0."""
    global _LAUNCHES
    _LAUNCHES = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """``csrc/ssd_scan.cu``'s library, its entry point declared (once)."""
    from repro_torch.kernels import _build
    lib = _build.load("ssd_scan")
    lib.ssd_scan_launch.argtypes = [ctypes.c_void_p] * 9 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int),
        ctypes.c_void_p]
    lib.ssd_scan_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def scan_rows(B: int, nh: int, hd: int, sms: int) -> int:
    """State rows per bfloat16 scan block: the whole head (hd ≤ 64) when
    the (batch, head) pairs fill the SMs, else 32 (hd when it is 16)."""
    return hd if B * nh >= sms or hd < 32 else 32


def _aligned(t: torch.Tensor, elems: int) -> torch.Tensor:
    """``t``, or a contiguous copy of it where its data or its strides
    are not multiples of ``elems`` elements (the bfloat16 kernels copy
    rows in 16- or 8-byte pieces)."""
    if (t.data_ptr() % (elems * t.element_size()) == 0
            and all(st % elems == 0 for st in t.stride()[:-1])):
        return t
    return torch.empty_like(t, memory_format=torch.contiguous_format).copy_(t)


def _check(x, dt, A, Bm, Cm, chunk: int) -> int:
    """Raise unless the inputs fit the kernel; returns the chunk length."""
    for name, t in (("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)):
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"ssd_cuda: {name} must be a CUDA tensor")
        if t.device != x.device:
            raise ValueError(f"ssd_cuda: {name} is on {t.device}, x on "
                             f"{x.device}")
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError(f"ssd_cuda: x, Bm, Cm are {x.dtype}, {Bm.dtype}, "
                         f"{Cm.dtype}; expected one of float32, bfloat16")
    if x.dim() != 4 or dt.dim() != 3 or Bm.dim() != 4 or Cm.shape != Bm.shape:
        raise ValueError("ssd_cuda: expected x (B, S, nh, hd), dt (B, S, nh) "
                         "and Bm, Cm (B, S, ng, N)")
    B, S, nh, hd = x.shape
    ng, N = Bm.shape[2], Bm.shape[3]
    if (tuple(dt.shape) != (B, S, nh) or tuple(A.shape) != (nh,)
            or tuple(Bm.shape[:2]) != (B, S)):
        raise ValueError(f"ssd_cuda: dt {tuple(dt.shape)}, A "
                         f"{tuple(A.shape)}, Bm {tuple(Bm.shape)} do not fit "
                         f"x {tuple(x.shape)}")
    if ng < 1 or nh % ng:
        raise ValueError(f"ssd_cuda: {nh} heads are not a multiple of {ng} "
                         "groups")
    if hd not in HEAD_DIMS:
        raise ValueError(f"ssd_cuda: head dim {hd} not in {HEAD_DIMS}")
    if N % 4 or not 4 <= N <= MAX_STATE:
        raise ValueError(f"ssd_cuda: state size {N} is not a multiple of 4 "
                         f"up to {MAX_STATE}")
    if x.stride(-1) != 1 or Bm.stride(-1) != 1 or Cm.stride(-1) != 1:
        raise ValueError("ssd_cuda: the trailing dims of x, Bm, Cm must be "
                         "contiguous")
    if B > 65535:
        raise ValueError(f"ssd_cuda: batch {B} > 65535")
    Q = chunk_len(S, chunk)
    if Q > MAX_CHUNK:
        raise ValueError(f"ssd_cuda: chunk length {Q} > {MAX_CHUNK}")
    return Q


def ssd_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, chunk: int = 128
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernels: same contract as :func:`ssd_ref`.

    ``x``, ``Bm``, ``Cm`` are CUDA tensors of one dtype with contiguous
    trailing dims, read through their other strides; ``dt`` and ``A`` are
    cast to float32 here if they are not already.  bfloat16 runs on the
    tensor cores (a bfloat16 operand whose data or strides are not
    16-byte aligned — 8 for Bm, Cm when N is not a multiple of 8 — is
    copied to contiguous storage first), with scratch allocated here: cum
    (B, S/Q, nh, Q) float32 and each chunk's entering state (B, S/Q, nh,
    hd, N rounded up to 8), 4 bytes an element (its bf16 hi and lo, in
    the kernels' fragment order).  float32 runs on the CUDA cores.
    Returns new contiguous ``y`` and ``h_final``.  Raises on any other
    input and if a launch fails; there is no fallback.
    """
    global _LAUNCHES
    from repro_torch.kernels import _build
    Q = _check(x, dt, A, Bm, Cm, chunk)
    B, S, nh, hd = x.shape
    ng, N = Bm.shape[2], Bm.shape[3]
    R = scan_rows(B, nh, hd, _sm_count(x.device.index or 0))
    dt32 = dt.to(torch.float32)
    A32 = A.to(torch.float32).contiguous()
    f32 = dict(dtype=torch.float32, device=x.device)
    cum = st = None
    if x.dtype == torch.bfloat16:
        x = _aligned(x, 8)
        Bm, Cm = (_aligned(t, 8 if N % 8 == 0 else 4) for t in (Bm, Cm))
        cum = torch.empty(B, S // Q, nh, Q, **f32)
        st = torch.empty(B, S // Q, nh, hd, -(-N // 8) * 8, **f32)
    y = torch.empty(B, S, nh, hd, dtype=x.dtype, device=x.device)
    h = torch.empty(B, nh, hd, N, **f32)
    strides = (ctypes.c_longlong * 12)(
        *x.stride()[:3], *dt32.stride(), *Bm.stride()[:3], *Cm.stride()[:3])
    ints = (ctypes.c_int * 10)(B, S, nh, ng, hd, N, Q, _DTYPES[x.dtype],
                               x.device.index or 0, R)
    lib = _lib()
    ptr = lambda t: None if t is None else t.data_ptr()
    err = lib.ssd_scan_launch(
        x.data_ptr(), dt32.data_ptr(), A32.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), y.data_ptr(), h.data_ptr(), ptr(cum), ptr(st),
        strides, ints, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError("ssd_cuda: launch failed: "
                           + _build.error_string(lib, err))
    _LAUNCHES += 1
    return y, h
