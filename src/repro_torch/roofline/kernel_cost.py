"""The work of each hand-written kernel, by formula: the FLOPs of its
products and the bytes it must move (each input read once, each output
written once).

One definition serves ``chip_smoke.py``'s bounds and the dry run's
count (:mod:`repro_torch.roofline.dispatch_cost`): the kernel wrappers
of :mod:`repro_torch.kernels.ops` charge these at the kernel boundary,
so a kernel's count is the same whatever implements it, the kernel or
its plain version.  The plain attention forms all S² scores, and the
plain SSD and RG-LRU versions repeat their arithmetic step by step;
counted op by op they would charge work the kernels never do.

FLOPs count products only (2·|out|·|contracted|), as the dispatch
count does; the RMSNorm and RG-LRU kernels and the tick's decisions do
none at the tensor-core rate and are bound by their bytes.  Formulas
that live beside their kernel are re-exported here:
``ssd_bwd_flops``/``ssd_bwd_bytes`` (:mod:`repro_torch.kernels.ssd_scan`)
and ``rglru_bytes``/``rglru_bwd_bytes``
(:mod:`repro_torch.kernels.rglru_scan`); the tick's bytes depend on its
data and stay in :func:`repro_torch.kernels.psp_tick.tick_bytes`.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels.rglru_scan import scan_bwd_bytes as rglru_bwd_bytes
from repro_torch.kernels.rglru_scan import scan_bytes as rglru_bytes
from repro_torch.kernels.ssd_scan import bwd_bytes as ssd_bwd_bytes
from repro_torch.kernels.ssd_scan import bwd_flops as ssd_bwd_flops
from repro_torch.kernels.ssd_scan import chunk_len

__all__ = ["attention_bytes", "attention_flops", "band_pairs",
           "rglru_bwd_bytes", "rglru_bytes", "rmsnorm_bytes",
           "ssd_bwd_bytes", "ssd_bwd_flops", "ssd_bytes", "ssd_flops",
           "tick_flops"]


def band_pairs(S: int, window: int) -> int:
    """The (query, key) pairs a causal window of ``window`` keys sees in
    a sequence of S: sum over queries i of min(i + 1, window)."""
    w = min(S, window)
    return w * (w + 1) // 2 + (S - w) * window


def attention_flops(B: int, S: int, H: int, hd: int, *,
                    causal: bool = True, window: Optional[int] = None,
                    backward: bool = False) -> int:
    """FLOPs of attention's products over the pairs its mask keeps: two
    (S·Kᵀ, P·V) forward, five backward, each 2·hd a pair and head.  A
    causal mask without a window keeps S²/2 pairs, a window
    :func:`band_pairs`, no mask S²."""
    products = 5 if backward else 2
    if window is not None:
        return 2 * products * B * H * hd * band_pairs(S, window)
    if causal:
        return products * B * H * hd * S * S
    return 2 * products * B * H * hd * S * S


def attention_bytes(B: int, S: int, H: int, KV: int, hd: int,
                    itemsize: int, *, lse: bool = False,
                    backward: bool = False) -> int:
    """Bytes attention must move: forward q, k, v read and o written
    (and the float32 row log-sum-exp written with ``lse``); backward q,
    k, v, o, do and lse read, dq, dk, dv written."""
    q, kv = B * S * H * hd * itemsize, B * S * KV * hd * itemsize
    lse_bytes = 4 * B * S * H
    if backward:
        return 4 * q + 4 * kv + lse_bytes
    return 2 * q + 2 * kv + (lse_bytes if lse else 0)


def rmsnorm_bytes(rows: int, D: int, itemsize: int, w_itemsize: int = 4,
                  *, m: bool = False, backward: bool = False) -> int:
    """Bytes RMSNorm must move: forward x read, y written, the gain read
    (and each row's float32 m written with ``m``); backward x, g and m
    read, dx written, the gain read and its float32 gradient written."""
    if backward:
        return 3 * rows * D * itemsize + 4 * rows + 2 * D * 4
    return 2 * rows * D * itemsize + D * w_itemsize + (4 * rows if m else 0)


def ssd_flops(B: int, S: int, nh: int, ng: int, hd: int, N: int,
              chunk: int = 128) -> int:
    """FLOPs the chunked dual form needs: per (batch, group, chunk) C·Bᵀ
    (2Q²N, shared by the group's heads); per (batch, head, chunk)
    scores·(x·dt) (2Q²hd), C·Hᵀ and the state update (2QN·hd each)."""
    Q = min(chunk, S)
    return B * (S // Q) * (ng * 2 * Q * Q * N
                           + nh * (2 * Q * Q * hd + 4 * Q * N * hd))


def ssd_bytes(B: int, S: int, nh: int, ng: int, hd: int, N: int,
              itemsize: int, *, states: bool = False,
              chunk: int = 128) -> int:
    """Bytes the SSD scan must move: x, B and C (``itemsize``), dt and A
    (float32) read once, y and the float32 final state written once;
    with ``states`` (training) also the float32 cum and each chunk's
    entering state."""
    n = (2 * B * S * nh * hd * itemsize + 4 * B * S * nh + 4 * nh
         + 2 * B * S * ng * N * itemsize + 4 * B * nh * hd * N)
    if states:
        Q = chunk_len(S, chunk)
        n += 4 * B * (S // Q) * nh * (Q + hd * N)
    return n


def tick_flops(n_fin: int, n_cand: int, m: int, d: int, P: int, *,
               k_max: int, masked: bool) -> int:
    """A tick's arithmetic on its data: each finisher's gradient over m
    samples of d (4·m·d), and each candidate of a sampled row's β-sample
    (a rank form scans the peer axis twice; β = 1 on an unmasked row is
    one gather and one compare)."""
    scan = 1 if k_max == 1 and not masked else 2 * P
    return 4 * n_fin * m * d + 2 * n_cand * scan
