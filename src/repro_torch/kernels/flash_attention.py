"""Forward attention: plain PyTorch version and the CUDA flash kernel.

The port's counterpart of :mod:`repro.kernels.flash_attention`
(``flash_attention_tpu``) and of ``repro.kernels.ref.attention_ref``.
Both compute, for queries ``q`` ``(B, Sq, H, hd)`` and keys / values
``k``, ``v`` ``(B, Sk, KV, hd)`` with ``H`` a multiple of ``KV``,

    o[b, i, h] = softmax_j(mask(cap·tanh(s / cap)))  · v[b, j, h // (H / KV)]
    s = (q[b, i, h] · k[b, j, h // (H / KV)]) / sqrt(hd)

in float32, with masked scores at -1e30 (causal: ``i >= j``; window:
``i - j < window``; positions count from 0 in both sequences) and the
output in q's dtype.  Grouped-query attention is native: no K/V head is
repeated, and the layout is the model's (sequence before heads).

* :func:`attention_ref` — plain PyTorch (O(Sq·Sk) scores); what CPU
  tensors get.
* :func:`flash_attention_cuda` — the hand-written kernel
  (``kernels/csrc/flash_attention.cu``): online softmax over the key
  tiles of the causal / window band, any sequence lengths (tails are
  masked), ``hd`` 64 or 128, float32 or bfloat16.  In bfloat16 it runs
  on the tensor cores (``wgmma``, tiles brought by TMA) and rounds the
  softmax weights P to bfloat16 before P·V, where the plain version and
  the TPU kernel keep them in float32 (a relative error of about 2⁻⁹
  per weight); in float32 it runs on the CUDA cores in float32.

Both take ``return_lse=True`` (the training forward): they then also
return the row log-sum-exp ``lse`` (float32 ``(B, H, Sq)``) that the
backward reads.  Serving passes no ``lse`` buffer and runs the kernel it
always ran.

The backward (the reference's custom VJP ``repro.models.flash._bwd`` /
``_bwd_triangular``), given o, lse and the cotangent ``do``: with
``Δ = rowsum(do ⊙ o)``, ``p = exp(s − lse)``, ``ds = p ⊙ (do·vᵀ − Δ)``
(times ``1 − tanh²(s_raw/cap)`` under a softcap, 0 where masked),
``dq = scale·ds·k``, ``dk = scale·dsᵀ·q`` and ``dv = pᵀ·do``, dk and dv
summed over each group's query heads, all in float32 and returned in
q's dtype:

* :func:`attention_bwd_ref` — plain PyTorch; what CPU tensors get.
* :func:`flash_attention_bwd_cuda` — the hand-written kernel (second
  half of ``kernels/csrc/flash_attention.cu``): Δ; dk/dv per (64-key
  tile, head) over the query tiles of the band into per-head float32
  partials; dq per (64-query tile, head) over the key tiles, recomputing
  S and dP; then dk/dv summed over the group's heads in order, by the
  dq launch's blocks with the fewest keys in bfloat16 (three launches)
  and by a fourth launch in float32 (no atomics: two runs give the same
  bits).  Its bound is
  operations (five S×S×hd products), so in bfloat16 every product runs
  on the tensor cores (``wgmma``, tiles brought by TMA, as the forward):
  S and dP (Sᵀ and dPᵀ in the dk/dv kernel) from shared memory, P and
  dS formed in registers and fed back as register operands of dV, dK
  and dQ.  It rounds P and dS to bfloat16 as operands, where the plain
  version keeps them in float32, and takes exp as 2^x.  float32 runs on
  the CUDA cores in float32.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

__all__ = ["HEAD_DIMS", "attention_bwd_ref", "attention_ref",
           "bwd_launch_count", "flash_attention_bwd_cuda",
           "flash_attention_cuda", "launch_count", "reset_launch_count",
           "tma_strides"]

#: head dims the kernel is built for
HEAD_DIMS = (64, 128)

_LAUNCHES = 0
_BWD_LAUNCHES = 0
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_NEG = -1e30


def _mask(Sq: int, Sk: int, causal: bool, window: Optional[int],
          device) -> torch.Tensor:
    """bool (Sq, Sk): which keys each query sees."""
    qa = torch.arange(Sq, device=device)[:, None]
    ka = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones(Sq, Sk, dtype=torch.bool, device=device)
    if causal:
        mask &= qa >= ka
    if window is not None:
        mask &= (qa - ka) < window
    return mask


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  softcap: Optional[float] = None,
                  return_lse: bool = False):
    """Plain attention, grouped-query layout (see the module docstring);
    with ``return_lse`` also the row log-sum-exp (f32 ``(B, H, Sq)``)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.float().reshape(B, Sq, KV, G, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * hd ** -0.5
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    s = s.masked_fill(~_mask(Sq, Sk, causal, window, q.device), _NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    o = o.reshape(B, Sq, H, hd).to(q.dtype)
    if return_lse:
        return o, torch.logsumexp(s, dim=-1).reshape(B, H, Sq)
    return o


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                      *, causal: bool = True, window: Optional[int] = None,
                      softcap: Optional[float] = None):
    """Plain backward (see the module docstring): (dq, dk, dv) in q's
    dtype, from the forward's output ``o`` and ``lse`` (f32
    ``(B, H, Sq)``) and the cotangent ``do`` of o."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    qg = q.float().reshape(B, Sq, KV, G, hd)
    dog = do.float().reshape(B, Sq, KV, G, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    t = None
    if softcap is not None:
        t = torch.tanh(s / softcap)
        s = softcap * t
    mask = _mask(Sq, Sk, causal, window, q.device)
    s = s.masked_fill(~mask, _NEG)
    p = torch.exp(s - lse.reshape(B, KV, G, Sq)[..., None])
    delta = (dog * o.float().reshape(B, Sq, KV, G, hd)).sum(-1)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog, v.float())
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    if t is not None:
        ds = ds * (1.0 - t * t)
    ds = ds.masked_fill(~mask, 0.0)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float()) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qg) * scale
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dog)
    return (dq.reshape(B, Sq, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def launch_count() -> int:
    """Kernel launches through :func:`flash_attention_cuda` since the last
    reset."""
    return _LAUNCHES


def bwd_launch_count() -> int:
    """Calls of :func:`flash_attention_bwd_cuda` (three launches each in
    bfloat16, four in float32) since the last reset."""
    return _BWD_LAUNCHES


def reset_launch_count() -> None:
    """Set the launch counts of :func:`flash_attention_cuda` and
    :func:`flash_attention_bwd_cuda` to 0."""
    global _LAUNCHES, _BWD_LAUNCHES
    _LAUNCHES = _BWD_LAUNCHES = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """``csrc/flash_attention.cu``'s library, its entry point declared
    (once)."""
    from repro_torch.kernels import _build
    lib = _build.load("flash_attention")
    lib.flash_attention_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_int), ctypes.c_float, ctypes.c_float,
        ctypes.c_void_p]
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_bwd_launch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    lib.flash_attention_bwd_launch.restype = ctypes.c_int
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless q, k, v fit the kernel (see :func:`flash_attention_cuda`)."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
            raise ValueError(f"flash_attention_cuda: {name} must be a CUDA "
                             "tensor")
        if x.dim() != 4:
            raise ValueError(f"flash_attention_cuda: {name} must be 4-D, "
                             f"got shape {tuple(x.shape)}")
        if x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"flash_attention_cuda: {name} is {x.dtype} on "
                             f"{x.device}, q is {q.dtype} on {q.device}")
        if x.stride(-1) != 1:
            raise ValueError(f"flash_attention_cuda: {name}'s head dim must "
                             "be contiguous")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention_cuda: dtype {q.dtype}, expected "
                         "float32 or bfloat16")
    B, Sq, H, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head dim {hd} not in "
                         f"{HEAD_DIMS}")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"flash_attention_cuda: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    KV = k.shape[2]
    if KV < 1 or H % KV:
        raise ValueError(f"flash_attention_cuda: {H} query heads are not a "
                         f"multiple of {KV} KV heads")
    if Sq < 1 or k.shape[1] < 1 or B > 65535 or H > 65535:
        raise ValueError("flash_attention_cuda: empty sequence or too many "
                         "batch rows / heads")


def tma_strides(name: str, x: torch.Tensor):
    """The element strides (batch, seq, head) under which the bfloat16
    kernel's TMA copies read ``x`` ``(B, S, heads, hd)``.

    TMA needs a 16-byte aligned base and strides that are multiples of 16
    bytes (8 elements); the stride of a dim of size 1 is never used, so
    it is replaced by its contiguous value.  Raises ``ValueError`` on any
    other layout: the kernel takes no other path.
    """
    if x.data_ptr() % 16:
        raise ValueError(f"flash_attention_cuda: bf16 {name} must start on "
                         "a 16-byte boundary (TMA)")
    out = []
    for d in range(3):
        st = x.stride(d)
        if x.shape[d] == 1:
            st = math.prod(x.shape[d + 1:])
        if st % 8 or not 0 < st < 2 ** 39:
            raise ValueError(
                f"flash_attention_cuda: bf16 {name} has strides "
                f"{tuple(x.stride())}; TMA needs batch, seq and head "
                "strides that are positive multiples of 8 elements")
        out.append(st)
    return tuple(out)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, *, causal: bool = True,
                         window: Optional[int] = None,
                         softcap: Optional[float] = None,
                         return_lse: bool = False):
    """The CUDA kernel: same contract as :func:`attention_ref`.

    ``q``, ``k``, ``v`` are CUDA tensors of one dtype (float32 or
    bfloat16) with a contiguous head dim of 64 or 128.  In float32 the
    other strides are read as they are.  In bfloat16 (the tensor-core
    kernel, fed by TMA) each tensor must start on a 16-byte boundary and
    its batch, seq and head strides must be multiples of 8 elements, as
    the model's contiguous q, k and v are (see :func:`tma_strides`);
    other strides raise instead of taking a slower path.  Returns a new
    contiguous ``(B, Sq, H, hd)`` tensor, and with ``return_lse`` the
    row log-sum-exp (float32 ``(B, H, Sq)``) too.  Raises on any other
    input and if the launch fails; there is no fallback.
    """
    global _LAUNCHES
    from repro_torch.kernels import _build
    _check(q, k, v)
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if window is not None and window < 1:
        raise ValueError(f"flash_attention_cuda: window {window} < 1")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"flash_attention_cuda: softcap {softcap} <= 0")
    if q.dtype == torch.bfloat16:
        st = [s for name, x in (("q", q), ("k", k), ("v", v))
              for s in tma_strides(name, x)]
    else:
        st = [s for x in (q, k, v) for s in x.stride()[:3]]
    o = torch.empty(B, Sq, H, hd, dtype=q.dtype, device=q.device)
    lse = (torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
           if return_lse else None)
    strides = (ctypes.c_longlong * 9)(*st)
    ints = (ctypes.c_int * 10)(B, Sq, Sk, H, KV, hd, _DTYPES[q.dtype],
                               int(causal), window or 0,
                               q.device.index or 0)
    lib = _lib()
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr() if return_lse else None, strides,
        ints, float(softcap or 0.0), float(hd ** -0.5),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError("flash_attention_cuda: launch failed: "
                           + _build.error_string(lib, err))
    _LAUNCHES += 1
    return (o, lse) if return_lse else o


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor, *,
                             causal: bool = True,
                             window: Optional[int] = None,
                             softcap: Optional[float] = None):
    """The backward kernel: same contract as :func:`attention_bwd_ref`.

    q, k, v, o, do are CUDA tensors of one dtype (float32 or bfloat16,
    made contiguous here) with a head dim of 64 or 128, each starting on
    a 16-byte boundary (the TMA copies and 16-byte loads need it);
    ``lse`` float32 ``(B, H, Sq)``.  Returns new (dq, dk, dv).  Raises on
    any other input and if a launch fails; there is no fallback.
    """
    global _BWD_LAUNCHES
    from repro_torch.kernels import _build
    _check(q, k, v)
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    for name, x in (("o", o), ("do", do)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"flash_attention_bwd_cuda: {name} "
                             f"{x.dtype}{tuple(x.shape)} does not fit q")
    if (lse.shape != (B, H, Sq) or lse.dtype != torch.float32
            or lse.device != q.device):
        raise ValueError("flash_attention_bwd_cuda: lse must be float32 "
                         f"{(B, H, Sq)} on {q.device}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention_bwd_cuda: window {window} < 1")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"flash_attention_bwd_cuda: softcap {softcap} <= 0")
    q, k, v, o, do = (x.contiguous() for x in (q, k, v, o, do))
    for name, x in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        if x.data_ptr() % 16:
            raise ValueError(f"flash_attention_bwd_cuda: {name} must start "
                             "on a 16-byte boundary")
    lse = lse.contiguous()
    f32 = dict(dtype=torch.float32, device=q.device)
    # Δ and lse·log2(e) per query row, rows padded to whole 64-row tiles
    stats = torch.empty(2, B, H, -(-Sq // 64) * 64, **f32)
    dkp = torch.empty(B, Sk, H, hd, **f32)
    dvp = torch.empty(B, Sk, H, hd, **f32)
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    ptrs = (ctypes.c_void_p * 13)(*(x.data_ptr() for x in (
        q, k, v, o, do, lse, stats[0], stats[1], dq, dkp, dvp, dk, dv)))
    ints = (ctypes.c_int * 10)(B, Sq, Sk, H, KV, hd, _DTYPES[q.dtype],
                               int(causal), window or 0, q.device.index or 0)
    lib = _lib()
    err = lib.flash_attention_bwd_launch(
        ptrs, ints, float(softcap or 0.0), float(hd ** -0.5),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError("flash_attention_bwd_cuda: launch failed: "
                           + _build.error_string(lib, err))
    _BWD_LAUNCHES += 1
    return dq, dk, dv
