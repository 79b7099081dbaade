"""Execution planner for the port's chunked sweep loop (one device).

The port's copy of :mod:`repro.core.sweep_plan` on the degenerate 1×1
mesh: the stride and chunk schedule equal the reference's for the same
inputs.  The two free parameters:

``stride`` — ticks per trace record / noise-draw block
    Traces are only consumed on the measurement grid, and drawing each
    tick's noise separately wastes generator launches, so the stride is
    the largest divisor of the measurement cadence whose per-supertick
    noise block still fits :data:`_NOISE_BUDGET`.

``chunks`` — binary decomposition of the supertick count
    Greedy pow2 blocks, largest first (40 records → 32 + 8); remainder
    ticks below one stride are dead padding that every row ignores, and
    the runner stops once every row is past its horizon.

Rows pad up to a multiple of
:data:`~repro_torch.kernels.psp_tick.DATA_PLANE_BLOCK`; padded rows carry
a negative horizon and never tick.  The multi-device mesh
(``parse_mesh``, ``_node_axis_size`` and ``resolve_mesh`` in the
reference) belongs to the mesh slice, ROADMAP queue 1, item 15b.

Env overrides: ``PSP_TRACE_STRIDE`` forces the record stride (snapped to
an admissible divisor), ``PSP_SWEEP_CHUNK`` a uniform chunk length.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import numpy as np

from repro_torch.core import env
from repro_torch.kernels.psp_tick import DATA_PLANE_BLOCK

__all__ = ["SweepPlan", "plan_sweep"]

#: per-supertick noise-block budget (bytes); caps the stride for batches
#: whose per-row score matrices scale with B·P²
_NOISE_BUDGET = 64 << 20

#: chunks smaller than this are not worth their set-up (records)
_MIN_CHUNK = 1


@dataclasses.dataclass(frozen=True)
class SweepPlan:
    """One sweep's execution schedule (see module docstring)."""

    stride: int                 #: grid ticks per trace record
    n_rec: int                  #: scheduled records (covers the padded grid)
    n_rec_live: int             #: records containing at least one live tick
    chunks: Tuple[int, ...]     #: record-block lengths, in execution order
    n_devices: int              #: devices used (always 1 in the port)
    b_pad: int                  #: scenario rows after padding
    node_pad: int               #: node-keyed draw slots after padding
    mesh: Tuple[int, int] = (1, 1)   #: (rows, nodes) device factorization
    p_loc: int = 0              #: node slots per nodes-axis shard

    @property
    def n_ticks(self) -> int:
        """Padded tick-grid length (``n_rec × stride``)."""
        return self.n_rec * self.stride


def _record_stride(n_ticks: int, measure_idx: np.ndarray,
                   noise_bytes_per_tick: int) -> int:
    """Largest stride aligning every measurement index on a record.

    A stride ``s`` records states after global ticks ``s−1, 2s−1, …``, so
    the admissible strides are the divisors of ``gcd{m + 1, n_ticks}``;
    take the largest whose supertick noise block stays under the budget.
    """
    vals = np.concatenate([measure_idx + 1, [n_ticks]])
    q = int(np.gcd.reduce(vals.astype(np.int64)))
    cap = max(1, _NOISE_BUDGET // max(noise_bytes_per_tick, 1))
    forced = env.get_int("PSP_TRACE_STRIDE")
    if forced:
        cap = min(cap, max(1, forced))
    best = 1
    for s in range(1, int(math.isqrt(q)) + 1):
        if q % s == 0:
            for cand in (s, q // s):
                if cand <= cap:
                    best = max(best, cand)
    return best


def _binary_chunks(n_rec: int) -> Tuple[int, ...]:
    """Greedy pow2 decomposition of the record count, largest first.

    ``PSP_SWEEP_CHUNK`` forces a uniform length instead; the tail chunk is
    then scheduled past the live records and the runner skips it.
    """
    forced = env.get_int("PSP_SWEEP_CHUNK")
    if forced:
        c = max(1, forced)
        return tuple([c] * math.ceil(n_rec / c))
    out, left = [], n_rec
    while left > 0:
        block = 1 << (left.bit_length() - 1)
        block = max(block, _MIN_CHUNK) if left >= _MIN_CHUNK else left
        block = min(block, left)
        out.append(block)
        left -= block
    return tuple(out)


def plan_sweep(n_ticks: int, measure_idx: Sequence[int], B: int, P: int, *,
               batch: int, d: int, k_max: int, masked: bool,
               has_churn: bool) -> SweepPlan:
    """Choose stride and chunk schedule for one single-device sweep.

    Args:
      n_ticks: live tick-grid length (before stride padding).
      measure_idx: global tick index of each measurement point.
      B: scenario rows in the batch (before padding).
      P: padded node-slot count of the batch.
      batch / d: data-plane minibatch size and model dimension.
      k_max: static β-sample slot count (0 = no sampled rows).
      masked: per-row alive-masked sampling (churn or ragged padding).
      has_churn: whether churn uniforms are drawn.
    """
    b_pad = math.ceil(B / DATA_PLANE_BLOCK) * DATA_PLANE_BLOCK
    noise = P * batch * (d + 1)                     # minibatch blob
    noise += b_pad * P                              # step-duration jitter
    if k_max > 0:
        noise += b_pad * P * P if masked else (P if k_max == 1 else P * P)
    if has_churn:
        noise += 2 * b_pad * P
    stride = _record_stride(n_ticks, np.asarray(measure_idx, np.int64),
                            4 * noise)
    n_rec_live = math.ceil(n_ticks / stride)
    chunks = _binary_chunks(n_rec_live)
    return SweepPlan(stride=stride, n_rec=sum(chunks), n_rec_live=n_rec_live,
                     chunks=chunks, n_devices=1, b_pad=b_pad, node_pad=P,
                     mesh=(1, 1), p_loc=P)
