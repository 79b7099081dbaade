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

The backward, given the cotangent ``dy`` of y (and ``dh`` of h_last,
or none): with ``g_t = f32(cast(dy_t·gate_t))`` (or f32(dy_t)) and
``dgate_t = cast(dy_t·cast(h_t))``, the reverse recurrence ``dh_t = g_t
+ a_{t+1}·dh_{t+1}`` (``dh_{S−1} = g_{S−1} + dh``), ``da_t =
dh_t·h_{t−1}``, ``db_t = dh_t``, then back through b, mult, a and log a
to dx, dr_pre, di_pre (compute dtype), dΛ (float32) and dh0 = a_0·dh_0,
each product and rounding as autograd takes them through
:func:`rglru_scan_ref`:

* :func:`rglru_scan_bwd_ref` — plain PyTorch, the explicit formulas,
  the reverse recurrence as a doubling scan; what CPU tensors get;
* :func:`rglru_scan_bwd_cuda` — the hand-written kernel (the second
  half of ``kernels/csrc/rglru_scan.cu``): one persistent launch over
  the forward's 64-step tiles taken by ticket from the last segment to
  the first, each input read once by TMA and each element's a and b
  formed once; h composed over each tile from the h entering it, which
  the training forward (``return_states=True``) writes, ``(B, ⌈S/64⌉,
  W)`` float32; the carried ``a·dh`` chained from tile to tile through a
  tagged word a channel in a scratch buffer of its own, kept per device
  and stream; then dΛ summed over the tiles' partials in order by a
  small second launch.  No atomics touch a value: two calls agree bit
  for bit.

softplus has the reference's value and gradient (:func:`softplus`,
shared with the Mamba-2 block).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

__all__ = ["SEG", "bwd_launch_count", "launch_count", "reset_launch_count",
           "rglru_scan_bwd_cuda", "rglru_scan_bwd_ref", "rglru_scan_cuda",
           "rglru_scan_ref", "scan_bwd_bytes", "scan_bytes", "softplus"]

#: Griffin's fixed gate sharpness constant
C = 8.0

#: steps a tile of the kernels (the forward's and the backward's)
SEG = 64

_LAUNCHES = 0
_BWD_LAUNCHES = 0
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernels' scratch buffers (ticket, counts, tag, the words chained
#: between tiles; the backward's also its dΛ partials) per (kernel,
#: device index, stream): a call on one stream never shares one with a
#: call that may run beside it on another, and the forward's counters
#: never meet the backward's
_SCRATCH: Dict[Tuple[str, int, int], torch.Tensor] = {}


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


def _tile_states(h: torch.Tensor, h0: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """The h entering each ``SEG``-step tile of h ``(B, S, W)``: h0 (or
    0) for the first, then h at each tile's step before: ``(B, ⌈S/SEG⌉,
    W)``."""
    first = (h0 if h0 is not None else torch.zeros_like(h[:, 0]))[:, None]
    return torch.cat([first, h[:, SEG - 1:-1:SEG]], 1)


def _terms(x: torch.Tensor, r_pre: torch.Tensor, i_pre: torch.Tensor,
           lam: torch.Tensor, h0: Optional[torch.Tensor]) -> Dict:
    """The forward's float32 terms in the reference's expressions: r, i,
    softplus(Λ), coef = −C·softplus(Λ), a, e2 = exp(2·log a), u = 1 − e2,
    mult, mi = mult·i and b = mi·x (h0's term folded into the first
    step's)."""
    r = torch.sigmoid(r_pre.float())
    i = torch.sigmoid(i_pre.float())
    sp = softplus(lam.float())
    coef = -C * sp
    log_a = coef * r
    a = torch.exp(log_a)
    e2 = torch.exp(2.0 * log_a)
    u = 1.0 - e2
    mult = torch.sqrt(torch.clamp(u, 0.0, 1.0))
    mi = mult * i
    b = mi * x.float()
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], 1)
    return dict(r=r, i=i, sp=sp, coef=coef, a=a, e2=e2, u=u, mult=mult,
                mi=mi, b=b)


def rglru_scan_ref(x: torch.Tensor, r_pre: torch.Tensor,
                   i_pre: torch.Tensor, lam: torch.Tensor,
                   h0: Optional[torch.Tensor] = None,
                   gate: Optional[torch.Tensor] = None,
                   return_states: bool = False):
    """Plain RG-LRU scan (see the module docstring): (y in x's dtype,
    h_last float32); with ``return_states`` also the h entering each
    ``SEG``-step tile, float32 ``(B, ⌈S/SEG⌉, W)`` (what
    :func:`rglru_scan_bwd_cuda` reads)."""
    t = _terms(x, r_pre, i_pre, lam, h0)
    h = _doubling_scan(t["a"], t["b"])
    y = h.to(x.dtype)
    if gate is not None:
        y = y * gate
    if return_states:
        return y, h[:, -1], _tile_states(h, h0)
    return y, h[:, -1]


def rglru_scan_bwd_ref(x: torch.Tensor, r_pre: torch.Tensor,
                       i_pre: torch.Tensor, lam: torch.Tensor,
                       dy: torch.Tensor, h0: Optional[torch.Tensor] = None,
                       gate: Optional[torch.Tensor] = None,
                       dh: Optional[torch.Tensor] = None):
    """Plain backward of :func:`rglru_scan_ref`: the cotangents of its
    inputs given ``dy`` (y's, x's dtype) and ``dh`` (h_last's, float32
    ``(B, W)``, or None for zeros), by the explicit formulas of autograd
    through it, in its roundings: (dx, dr_pre, di_pre in x's dtype, dΛ
    float32 ``(W,)``, dh0 float32 ``(B, W)`` or None without h0, dgate
    in x's dtype or None without a gate).  The reverse recurrence
    ``dh_t = g_t + a_{t+1}·dh_{t+1}`` runs as a doubling scan over the
    reversed sequence; h is recomputed by the forward's."""
    dt = x.dtype
    t = _terms(x, r_pre, i_pre, lam, h0)
    r, i, a, e2, u, mult = (t[k] for k in ("r", "i", "a", "e2", "u", "mult"))
    h = _doubling_scan(a, t["b"])
    dgate = None
    if gate is not None:
        g = (dy * gate).float()
        dgate = dy * h.to(dt)
    else:
        g = dy.float()
    # reversed time: dh'_τ = g'_τ + a'_τ·dh'_{τ−1}, a'_τ = a_{S−τ} (1 at
    # τ = 0, where h_last's cotangent enters)
    gr = g.flip(1)
    if dh is not None:
        gr = torch.cat([gr[:, :1] + dh.float()[:, None], gr[:, 1:]], 1)
    ar = torch.cat([torch.ones_like(a[:, :1]), a.flip(1)[:, :-1]], 1)
    dhs = _doubling_scan(ar, gr).flip(1)
    first = h0[:, None] if h0 is not None else torch.zeros_like(h[:, :1])
    h_prev = torch.cat([first, h[:, :-1]], 1)
    dmi = dhs * x.float()
    dx = (dhs * t["mi"]).to(dt)
    di = (((dmi * mult) * (1.0 - i)) * i).to(dt)
    dsq = (dmi * i) / (2.0 * mult)
    du = torch.where((u >= 0.0) & (u <= 1.0), dsq, torch.zeros_like(dsq))
    dlog_a = (dhs * h_prev) * a + 2.0 * (-du * e2)
    dr = (((dlog_a * t["coef"]) * (1.0 - r)) * r).to(dt)
    dlam = ((dlog_a * r).sum((0, 1)) * -C) * torch.exp(lam.float() - t["sp"])
    dh0 = a[:, 0] * dhs[:, 0] if h0 is not None else None
    return dx, dr, di, dlam, dh0, dgate


def scan_bytes(B: int, S: int, W: int, itemsize: int,
               gated: bool = True, h0: bool = False) -> int:
    """Bytes the scan must move: x, r_pre, i_pre (and the gate) read
    once, y written once, Λ, and h0 and h_last (float32)."""
    return (B * S * W * itemsize * (5 if gated else 4) + 4 * W
            + 4 * B * W * (2 if h0 else 1))


def scan_bwd_bytes(B: int, S: int, W: int, itemsize: int,
                   gated: bool = True, h0: bool = False) -> int:
    """Bytes the backward must move: x, r_pre, i_pre, dy (and the gate)
    read once and dx, dr_pre, di_pre (and dgate) written once, the h
    entering each tile, Λ and dΛ, and h0 and dh0 (float32)."""
    return (B * S * W * itemsize * (9 if gated else 7)
            + 4 * B * -(-S // SEG) * W + 8 * W
            + (8 * B * W if h0 else 0))


def launch_count() -> int:
    """Kernel launches through :func:`rglru_scan_cuda` since the last
    reset."""
    return _LAUNCHES


def bwd_launch_count() -> int:
    """Calls of :func:`rglru_scan_bwd_cuda` (each launches its kernel
    and dΛ's sum) since the last reset."""
    return _BWD_LAUNCHES


def reset_launch_count() -> None:
    """Set the launch counts of :func:`rglru_scan_cuda` and
    :func:`rglru_scan_bwd_cuda` to 0."""
    global _LAUNCHES, _BWD_LAUNCHES
    _LAUNCHES = _BWD_LAUNCHES = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """``csrc/rglru_scan.cu``'s library, its entry point declared
    (once)."""
    from repro_torch.kernels import _build
    lib = _build.load("rglru_scan")
    lib.rglru_scan_launch.argtypes = [ctypes.c_void_p] * 10 + [
        ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.rglru_scan_launch.restype = ctypes.c_int
    lib.rglru_scan_bwd_launch.argtypes = [ctypes.c_void_p] * 15 + [
        ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.rglru_scan_bwd_launch.restype = ctypes.c_int
    for fn in (lib.rglru_scan_scratch_bytes,
               lib.rglru_scan_bwd_scratch_bytes):
        fn.argtypes = [ctypes.c_int] * 4
        fn.restype = ctypes.c_longlong
    return lib


def _scratch(kind: str, need: int, device: torch.device,
             stream: int) -> Optional[torch.Tensor]:
    """The scratch buffer of kernel ``kind`` ("fwd" or "bwd"), ``device``
    and ``stream`` with room for ``need`` bytes (``None`` if the call
    needs none).  A new buffer is made zeroed (its one fill, when it first
    grows); the kernel leaves it ready for its next call on the same
    stream."""
    if need <= 0:
        return None
    key = (kind, device.index or 0, stream)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < need:
        buf = torch.zeros(need, dtype=torch.uint8, device=device)
        _SCRATCH[key] = buf
    return buf


def _check(x: torch.Tensor, named, lam: torch.Tensor, floats,
           what: str) -> None:
    """The wrappers' checks: ``named`` (name, tensor) pairs contiguous
    CUDA tensors of x's shape (B, S, W) and dtype, float32 or bfloat16;
    ``lam`` and ``floats`` ((name, tensor or None, shape) triples)
    contiguous float32 on x's device."""
    for name, t in named:
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"{what}: {name} must be a CUDA tensor")
        if t.dim() != 3 or t.shape != x.shape or t.dtype != x.dtype \
                or t.device != x.device:
            raise ValueError(f"{what}: {name} is {t.dtype}"
                             f"{tuple(t.shape)}, x is {x.dtype}"
                             f"{tuple(x.shape)} on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if x.dtype not in _DTYPES:
        raise ValueError(f"{what}: dtype {x.dtype}, expected float32 or "
                         "bfloat16")
    B, S, W = x.shape
    if B < 1 or S < 1 or W < 1 or B > 65535:
        raise ValueError(f"{what}: shape {tuple(x.shape)}")
    for name, t, shape in (("lam", lam, (W,)), *floats):
        if t is None:
            continue
        if (tuple(t.shape) != shape or t.dtype != torch.float32
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"{what}: {name} must be contiguous float32 "
                             f"{shape} on {x.device}")


def _shape(x) -> Tuple[int, int, int]:
    """x's (B, S, W), or zeros when it is not a 3-d tensor (the checks
    then say what is wrong)."""
    if isinstance(x, torch.Tensor) and x.dim() == 3:
        return tuple(x.shape)
    return 0, 0, 0


def rglru_scan_cuda(x: torch.Tensor, r_pre: torch.Tensor,
                    i_pre: torch.Tensor, lam: torch.Tensor,
                    h0: Optional[torch.Tensor] = None,
                    gate: Optional[torch.Tensor] = None,
                    return_states: bool = False):
    """The CUDA kernel: same contract as :func:`rglru_scan_ref`.

    ``x``, ``r_pre``, ``i_pre`` (and ``gate``) are contiguous CUDA
    tensors ``(B, S, W)`` of one dtype, float32 or bfloat16; ``lam``
    float32 ``(W,)`` and ``h0`` float32 ``(B, W)`` on the same device.
    Returns new (y, h_last), and with ``return_states`` the h entering
    each tile as the kernel carried it.  Raises on any other input and
    if the launch fails; there is no fallback.
    """
    global _LAUNCHES
    from repro_torch.kernels import _build
    named = [("x", x), ("r_pre", r_pre), ("i_pre", i_pre)]
    if gate is not None:
        named.append(("gate", gate))
    B, S, W = _shape(x)
    _check(x, named, lam, [("h0", h0, (B, W))], "rglru_scan_cuda")
    y = torch.empty_like(x)
    h_last = torch.empty(B, W, dtype=torch.float32, device=x.device)
    states = (torch.empty(B, -(-S // SEG), W, dtype=torch.float32,
                          device=x.device) if return_states else None)
    ptr = lambda t: t.data_ptr() if t is not None else None
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    scratch = _scratch("fwd", lib.rglru_scan_scratch_bytes(
        B, S, W, _DTYPES[x.dtype]), x.device, stream)
    err = lib.rglru_scan_launch(
        x.data_ptr(), r_pre.data_ptr(), i_pre.data_ptr(), lam.data_ptr(),
        ptr(h0), ptr(gate), y.data_ptr(), h_last.data_ptr(), ptr(states),
        ptr(scratch), B, S, W, _DTYPES[x.dtype], x.device.index or 0, stream)
    if err != 0:
        raise RuntimeError("rglru_scan_cuda: launch failed: "
                           + _build.error_string(lib, err))
    _LAUNCHES += 1
    return (y, h_last, states) if return_states else (y, h_last)


def rglru_scan_bwd_cuda(x: torch.Tensor, r_pre: torch.Tensor,
                        i_pre: torch.Tensor, lam: torch.Tensor,
                        dy: torch.Tensor, states: torch.Tensor,
                        h0: Optional[torch.Tensor] = None,
                        gate: Optional[torch.Tensor] = None,
                        dh: Optional[torch.Tensor] = None):
    """The backward kernel (``kernels/csrc/rglru_scan.cu``: one persistent
    launch over the tiles, the carried cotangent chained between them,
    then dΛ's sum): same contract as :func:`rglru_scan_bwd_ref`, given the
    ``states`` that ``rglru_scan_cuda(..., return_states=True)`` returned
    for these inputs.

    x, r_pre, i_pre, dy (and gate) are contiguous CUDA tensors ``(B, S,
    W)`` of one dtype, float32 or bfloat16; lam ``(W,)``, h0 and dh
    ``(B, W)`` and states ``(B, ⌈S/64⌉, W)`` contiguous float32.
    Returns new (dx, dr_pre, di_pre, dΛ, dh0 or None, dgate or None).
    Raises on any other input and if a launch fails; there is no
    fallback.
    """
    global _BWD_LAUNCHES
    from repro_torch.kernels import _build
    named = [("x", x), ("r_pre", r_pre), ("i_pre", i_pre), ("dy", dy)]
    if gate is not None:
        named.append(("gate", gate))
    B, S, W = _shape(x)
    nseg = -(-S // SEG)
    _check(x, named, lam, [("h0", h0, (B, W)), ("dh", dh, (B, W)),
                           ("states", states, (B, nseg, W))],
           "rglru_scan_bwd_cuda")
    dx, dr, di = (torch.empty_like(x) for _ in range(3))
    dgate = torch.empty_like(x) if gate is not None else None
    dlam = torch.empty(W, dtype=torch.float32, device=x.device)
    dh0 = (torch.empty(B, W, dtype=torch.float32, device=x.device)
           if h0 is not None else None)
    ptr = lambda t: t.data_ptr() if t is not None else None
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    scratch = _scratch("bwd", lib.rglru_scan_bwd_scratch_bytes(
        B, S, W, _DTYPES[x.dtype]), x.device, stream)
    err = lib.rglru_scan_bwd_launch(
        x.data_ptr(), r_pre.data_ptr(), i_pre.data_ptr(), ptr(gate),
        dy.data_ptr(), lam.data_ptr(), ptr(dh), states.data_ptr(),
        dx.data_ptr(), dr.data_ptr(), di.data_ptr(), ptr(dgate),
        dlam.data_ptr(), ptr(dh0), scratch.data_ptr(), B, S, W,
        _DTYPES[x.dtype], x.device.index or 0, stream)
    if err != 0:
        raise RuntimeError("rglru_scan_bwd_cuda: launch failed: "
                           + _build.error_string(lib, err))
    _BWD_LAUNCHES += 1
    return dx, dr, di, dlam, dh0, dgate
