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

Both forwards take ``return_states=True`` (the training forward): they
then also return cum (B, S/Q, nh, Q) and each chunk's entering state,
which the backward reuses.  The backward is the VJP of the chunked form
(the reference's comes from XLA's autodiff of ``ssd_chunked``).  Given
dy and the cotangent G of h_final, with H_c the state entering chunk c,
G_c = dL/dH_{c+1} and, per chunk, S = (C·Bᵀ) ⊙ L, dsc = dy·xdtᵀ:

    G_{c−1} = exp(seg_c)·G_c + Σ_i exp(cum_i) dy_i ⊗ C_i   (G_{nc−1} = G)
    D = dsc ⊙ L,  M = dsc ⊙ S
    dC_i = Σ_j D_ij B_j + exp(cum_i)·H_cᵀ dy_i
    dB_j = Σ_i D_ij C_i + exp(seg − cum_j)·G_cᵀ xdt_j
    dxdt_j = Σ_i S_ij dy_i + exp(seg − cum_j)·G_c B_j
    dcum = Σ_j M_ij − Σ_i M_ij + C·dC_state − B·dB_state,
    plus dseg = Σ_j B_j·dB_state_j + exp(seg)·<H_c, G_c> at the last step
    ddA = dcum's reverse cumulative sum within the chunk
    ddt = ddA·A + Σ_d dxdt·x,  dA = Σ ddA·dt,  dx = dxdt·dt

(dC_state, dB_state: the exp-weighted state terms above), dB and dC
summed over a group's heads.  It returns dx in x's dtype, ddt and dA
float32, dB and dC in B's and C's dtypes.

* :func:`ssd_bwd_ref` — plain PyTorch, those steps one by one; what CPU
  tensors get.
* :func:`ssd_bwd_cuda` — the hand-written kernels beside the forward in
  ``kernels/csrc/ssd_scan.cu``, three launches and no atomics in either
  dtype (two calls give the same bits).  bfloat16 runs on the tensor
  cores (``mma.sync``, each float32 operand but D split into bf16
  hi + lo): the state gradient G scanned over the chunks in reverse per
  (head, batch) in MMA accumulators, written as hi + lo
  in the forward states' fragment order; then per (tile of three heads
  of a group, chunk, batch) C·Bᵀ once, and per head each 16 × 16 tile
  of the chunk's duals formed once for its columns (dB, dxdt → dx) and
  its rows (dC), the state terms, dcum and its scan into ddt and the
  chunk's share of dA, dB and dC summed over the tile's heads; then dA
  and dB, dC summed over the tiles in order.  float32 runs the first
  design on the CUDA cores: the state gradient per (16 state rows,
  head, batch); per (chunk, head, batch) strips of 32 steps, each
  walking 32-step tiles of the other side of the chunk's duals (row
  strips: dC and the rows' dcum; column strips: dB, dxdt → dx, Σ_d
  dxdt·x and the columns' dcum), dB and dC per head; then per head the
  dcum scan, ddt and dA in a fixed order, and dB, dC summed over each
  group's heads in head order.  The bfloat16 route reads the forward's
  states as their hi + lo (16 bits) in place.

:func:`bwd_bytes` and :func:`bwd_flops` give the backward's bound.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

__all__ = ["HEAD_DIMS", "bwd_bytes", "bwd_flops", "bwd_launch_count",
           "chunk_len", "launch_count", "reset_launch_count", "scan_rows",
           "ssd_bwd_cuda", "ssd_bwd_ref", "ssd_cuda", "ssd_ref"]

#: head dims the kernel is built for
HEAD_DIMS = (16, 64)
#: largest chunk length and state size the kernel takes
MAX_CHUNK = 128
MAX_STATE = 128

_LAUNCHES = 0
_BWD_LAUNCHES = 0
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def chunk_len(S: int, chunk: int) -> int:
    """The chunk length Q = min(chunk, S); raises unless it divides S."""
    Q = min(chunk, S)
    if Q < 1 or S % Q:
        raise ValueError(f"ssd: sequence length {S} is not a multiple of "
                         f"the chunk length {Q}")
    return Q


def bwd_bytes(B: int, S: int, nh: int, ng: int, hd: int, N: int,
              itemsize: int, split: bool, chunk: int = 128,
              dh: bool = False) -> int:
    """Bytes one backward call must move: x, dy, B, C, dt, A, cum, the
    saved states (their stored width: N rounded up to 8 when ``split``)
    and ``dh`` read once; dx, dB, dC, ddt, dA written once (x, B, C and
    their gradients ``itemsize`` bytes an element, the rest float32)."""
    Q = chunk_len(S, chunk)
    width = -(-N // 8) * 8 if split else N
    return (3 * B * S * nh * hd * itemsize + 4 * B * S * ng * N * itemsize
            + 3 * B * S * nh * 4 + 2 * nh * 4
            + B * (S // Q) * nh * hd * width * 4
            + (B * nh * hd * N * 4 if dh else 0))


def bwd_flops(B: int, S: int, nh: int, ng: int, hd: int, N: int,
              chunk: int = 128) -> int:
    """FLOPs of the backward's products over the causal pairs i ≥ j of a
    chunk (P = Q(Q+1)/2): per (batch, chunk, group) C·Bᵀ (2PN); per
    (batch, chunk, head) dy·xdtᵀ and S·dy (2P·hd each), D·B and Dᵀ·C
    (2PN each), and four state products of 2Q·hd·N (dC and dB from the
    states, dxdt from the state gradient, and that gradient's scan)."""
    Q = chunk_len(S, chunk)
    P = Q * (Q + 1) // 2
    return B * (S // Q) * (ng * 2 * P * N
                           + nh * (4 * P * hd + 4 * P * N + 8 * Q * hd * N))


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            Bm: torch.Tensor, Cm: torch.Tensor, chunk: int = 128,
            return_states: bool = False):
    """Plain chunked SSD (see the module docstring); returns
    (y (B, S, nh, hd) in x's dtype, h_final (B, nh, hd, N) float32), and
    with ``return_states`` also cum (B, S/Q, nh, Q) and each chunk's
    entering state (B, S/Q, nh, hd, N), both float32."""
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

    # intra-chunk (quadratic dual form)
    L = _decay_matrix(cum)
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
    y = (y_intra + y_inter).reshape(B, S, nh, hd).to(x.dtype)
    if return_states:
        return (y, h, cum.permute(0, 1, 3, 2).contiguous(),
                torch.stack(h_prev, dim=1))
    return y, h


def _decay_matrix(cum: torch.Tensor) -> torch.Tensor:
    """L[b, c, i, j, h] = exp(cum_i − cum_j) for i ≥ j, else 0, of cum
    (B, nc, Q, nh).  Above the diagonal the exponent is positive and
    overflows, so it is replaced by 0 before the exp, not only after:
    the mask selects and never multiplies, and autograd through it
    stays finite (a masked inf would give 0·inf = NaN)."""
    Q = cum.shape[2]
    causal = torch.ones(Q, Q, dtype=torch.bool,
                        device=cum.device).tril()[None, None, :, :, None]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    zero = torch.zeros((), dtype=cum.dtype, device=cum.device)
    return torch.where(causal, torch.exp(torch.where(causal, diff, zero)),
                       zero)


def ssd_bwd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, dy: torch.Tensor,
                cum: torch.Tensor, states: torch.Tensor,
                dh: Optional[torch.Tensor] = None, chunk: int = 128):
    """Plain backward of :func:`ssd_ref` (the module docstring's steps),
    given the cotangent ``dy`` of y (x's dtype), the forward's ``cum``
    and entering ``states`` (``ssd_ref(..., return_states=True)``) and
    the cotangent ``dh`` of h_final (None: zeros).  Returns (dx in x's
    dtype, ddt float32, dA (nh,) float32, dB in Bm's dtype, dC in Cm's
    dtype); every sum in float32."""
    B, S, nh, hd = x.shape
    ng, N = Bm.shape[2], Bm.shape[3]
    rep = nh // ng
    Q = chunk_len(S, chunk)
    nc = S // Q
    f32 = torch.float32

    xc = x.to(f32).reshape(B, nc, Q, nh, hd)
    dtc = dt.to(f32).reshape(B, nc, Q, nh)
    xdt = xc * dtc[..., None]
    dyc = dy.to(f32).reshape(B, nc, Q, nh, hd)
    B_h, C_h = (t.to(f32).reshape(B, nc, Q, ng, N).repeat_interleave(rep, 3)
                for t in (Bm, Cm))                           # (B,nc,Q,nh,N)
    cq = cum.permute(0, 1, 3, 2)                             # (B,nc,Q,nh)
    seg = cq[:, :, -1]                                       # (B,nc,nh)

    # 1. the state gradient, chunks in reverse: gout[:, c] is dL/dH_{c+1},
    # the gradient of the state chunk c leaves
    g = (torch.zeros(B, nh, hd, N, dtype=f32, device=x.device)
         if dh is None else dh.to(f32))
    gout = [None] * nc
    for c in range(nc - 1, -1, -1):
        gout[c] = g
        g = (g * torch.exp(seg[:, c])[:, :, None, None]
             + torch.einsum("bqhd,bqhn,bqh->bhdn", dyc[:, c], C_h[:, c],
                            torch.exp(cq[:, c])))
    gout = torch.stack(gout, dim=1)                          # (B,nc,nh,hd,N)

    # 2. within each chunk: the transposed duals, masked by L
    L = _decay_matrix(cq)                                    # (B,nc,Qi,Qj,nh)
    Sm = torch.einsum("bcihn,bcjhn->bcijh", C_h, B_h) * L     # scores
    dsc = torch.einsum("bcihd,bcjhd->bcijh", dyc, xdt)       # dy_i · xdt_j
    D = dsc * L                                              # dG
    M = dsc * Sm                                             # dL ⊙ L
    e_in = torch.exp(cq)                                     # exp(cum_i)
    e_out = torch.exp(seg[:, :, None] - cq)                  # exp(seg−cum_j)
    dC_state = e_in[..., None] * torch.einsum("bcihd,bchdn->bcihn", dyc,
                                              states)
    dB_state = e_out[..., None] * torch.einsum("bcjhd,bchdn->bcjhn", xdt,
                                               gout)
    dxdt_state = e_out[..., None] * torch.einsum("bcjhn,bchdn->bcjhd", B_h,
                                                 gout)
    dC_h = torch.einsum("bcijh,bcjhn->bcihn", D, B_h) + dC_state
    dB_h = torch.einsum("bcijh,bcihn->bcjhn", D, C_h) + dB_state
    dxdt = torch.einsum("bcijh,bcihd->bcjhd", Sm, dyc) + dxdt_state

    # 3. dcum: L's rows and columns, the inter-chunk output (through
    # exp(cum_i)) and the chunk's state (through exp(seg − cum_j)); seg is
    # cum's last step, so dseg lands there; ddA = dcum's reverse
    # cumulative sum within the chunk
    st_term = (B_h * dB_state).sum(-1)                       # (B,nc,Q,nh)
    dcum = (M.sum(3) - M.sum(2) + (C_h * dC_state).sum(-1) - st_term)
    dseg = (st_term.sum(2) + torch.exp(seg)
            * (states * gout).sum((-2, -1)))                 # (B,nc,nh)
    dcum[:, :, -1] += dseg
    ddA = dcum.flip(2).cumsum(2).flip(2)

    # 4. through xdt = x·dt and dA = dt·A
    ddt = ddA * A.to(f32) + (dxdt * xc).sum(-1)
    dA = (ddA * dtc).sum((0, 1, 2))
    dx = dxdt * dtc[..., None]
    dB, dC = (t.reshape(B, S, ng, rep, N).sum(3) for t in (dB_h, dC_h))
    return (dx.reshape(B, S, nh, hd).to(x.dtype), ddt.reshape(B, S, nh), dA,
            dB.to(Bm.dtype), dC.to(Cm.dtype))


def launch_count() -> int:
    """Kernel launches through :func:`ssd_cuda` since the last reset."""
    return _LAUNCHES


def reset_launch_count() -> None:
    """Set the launch counts of :func:`ssd_cuda` and :func:`ssd_bwd_cuda`
    to 0."""
    global _LAUNCHES, _BWD_LAUNCHES
    _LAUNCHES = _BWD_LAUNCHES = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """``csrc/ssd_scan.cu``'s library, its entry point declared (once)."""
    from repro_torch.kernels import _build
    lib = _build.load("ssd_scan")
    lib.ssd_scan_launch.argtypes = [ctypes.c_void_p] * 9 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int),
        ctypes.c_void_p]
    lib.ssd_scan_launch.restype = ctypes.c_int
    lib.ssd_bwd_scratch_floats.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.ssd_bwd_scratch_floats.restype = ctypes.c_longlong
    lib.ssd_bwd_launch.argtypes = [ctypes.c_void_p] * 15 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int),
        ctypes.c_void_p]
    lib.ssd_bwd_launch.restype = ctypes.c_int
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
             Bm: torch.Tensor, Cm: torch.Tensor, chunk: int = 128,
             return_states: bool = False):
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
    Returns new contiguous ``y`` and ``h_final``; with ``return_states``
    also cum and the entering states, which :func:`ssd_bwd_cuda` takes:
    in bfloat16 the scratch above (the states as a bfloat16 tensor
    (B, S/Q, nh, hd, 2·N rounded up to 8) holding hi and lo), in float32
    plain float32 (B, S/Q, nh, hd, N), which the one launch then also
    writes.  Raises on any other input and if a launch fails; there is
    no fallback.
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
        st = torch.empty(B, S // Q, nh, hd, -(-N // 8) * 16,
                         dtype=torch.bfloat16, device=x.device)
    elif return_states:
        cum = torch.empty(B, S // Q, nh, Q, **f32)
        st = torch.empty(B, S // Q, nh, hd, N, **f32)
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
    return (y, h, cum, st) if return_states else (y, h)


def bwd_launch_count() -> int:
    """Calls of :func:`ssd_bwd_cuda` (each launches its three kernels)
    since the last reset."""
    return _BWD_LAUNCHES


def ssd_bwd_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, dy: torch.Tensor,
                 cum: torch.Tensor, states: torch.Tensor,
                 dh: Optional[torch.Tensor] = None, chunk: int = 128):
    """The backward kernels: same contract as :func:`ssd_bwd_ref`, on the
    ``cum`` and ``states`` that ``ssd_cuda(..., return_states=True)``
    returned for inputs of this dtype (bfloat16's are read as their
    hi + lo).

    The inputs are :func:`ssd_cuda`'s (read through their strides; a
    bfloat16 x, dy, Bm or Cm that is not 16-byte aligned is copied, as
    :func:`ssd_cuda` copies); ``dy`` has x's shape and dtype and a
    contiguous trailing dim.  Returns new contiguous dx, ddt, dA, dB, dC.
    Raises on any other input and if a launch fails; there is no
    fallback.
    """
    global _BWD_LAUNCHES
    from repro_torch.kernels import _build
    Q = _check(x, dt, A, Bm, Cm, chunk)
    B, S, nh, hd = x.shape
    ng, N = Bm.shape[2], Bm.shape[3]
    nc = S // Q
    split = states.dtype == torch.bfloat16
    want = ((B, nc, nh, hd, -(-N // 8) * 16) if split
            else (B, nc, nh, hd, N))
    if (not isinstance(dy, torch.Tensor) or dy.shape != x.shape
            or dy.dtype != x.dtype or dy.device != x.device):
        raise ValueError(f"ssd_bwd_cuda: dy must be {x.dtype}"
                         f"{tuple(x.shape)} on {x.device}")
    if (tuple(cum.shape) != (B, nc, nh, Q) or cum.dtype != torch.float32
            or tuple(states.shape) != want
            or states.dtype not in (torch.float32, torch.bfloat16)
            or cum.device != x.device or states.device != x.device):
        raise ValueError("ssd_bwd_cuda: cum and states must be the ones "
                         "ssd_cuda(..., return_states=True) returned")
    if dh is not None and (tuple(dh.shape) != (B, nh, hd, N)
                           or dh.device != x.device):
        raise ValueError(f"ssd_bwd_cuda: dh must be {(B, nh, hd, N)} on "
                         f"{x.device}")
    if split != (x.dtype == torch.bfloat16):
        raise ValueError("ssd_bwd_cuda: the states must be the ones "
                         "ssd_cuda(..., return_states=True) returned for "
                         f"{x.dtype} inputs")
    if dy.stride(-1) != 1:
        dy = dy.contiguous()
    if x.dtype == torch.bfloat16:
        x, dy = _aligned(x, 8), _aligned(dy, 8)
        Bm, Cm = (_aligned(t, 8 if N % 8 == 0 else 4) for t in (Bm, Cm))
    dt32 = dt.to(torch.float32)
    A32 = A.to(torch.float32).contiguous()
    cum, states = cum.contiguous(), states.contiguous()
    dh32 = None if dh is None else dh.to(torch.float32).contiguous()
    dx = torch.empty(B, S, nh, hd, dtype=x.dtype, device=x.device)
    ddt = torch.empty(B, S, nh, dtype=torch.float32, device=x.device)
    dA = torch.empty(nh, dtype=torch.float32, device=x.device)
    dB = torch.empty(B, S, ng, N, dtype=Bm.dtype, device=x.device)
    dC = torch.empty(B, S, ng, N, dtype=Cm.dtype, device=x.device)
    strides = (ctypes.c_longlong * 15)(
        *x.stride()[:3], *dt32.stride(), *Bm.stride()[:3], *Cm.stride()[:3],
        *dy.stride()[:3])
    ints = (ctypes.c_int * 10)(B, S, nh, ng, hd, N, Q, _DTYPES[x.dtype],
                               x.device.index or 0, int(split))
    lib = _lib()
    scratch = torch.empty(lib.ssd_bwd_scratch_floats(ints),
                          dtype=torch.float32, device=x.device)
    err = lib.ssd_bwd_launch(
        x.data_ptr(), dt32.data_ptr(), A32.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), dy.data_ptr(), cum.data_ptr(), states.data_ptr(),
        None if dh32 is None else dh32.data_ptr(), dx.data_ptr(),
        ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
        scratch.data_ptr(), strides, ints,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError("ssd_bwd_cuda: launch failed: "
                           + _build.error_string(lib, err))
    _BWD_LAUNCHES += 1
    return dx, ddt, dA, dB, dC
