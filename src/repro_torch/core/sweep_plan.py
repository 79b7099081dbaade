"""Execution planner for the port's chunked, sharded sweep loop.

The port's copy of :mod:`repro.core.sweep_plan`: for the same inputs
and device count every field of :class:`SweepPlan` equals the
reference's.  The three free parameters:

``stride`` — ticks per trace record / noise-draw block
    Traces are only consumed on the measurement grid, and drawing each
    tick's noise separately wastes generator launches, so the stride is
    the largest divisor of the measurement cadence whose per-supertick
    noise block still fits :data:`_NOISE_BUDGET`.

``chunks`` — binary decomposition of the supertick count
    Greedy pow2 blocks, largest first (40 records → 32 + 8); remainder
    ticks below one stride are dead padding that every row ignores, and
    the runner stops once every row is past its horizon.

``mesh`` / padding — 2-D ``(rows, nodes)`` placement over ranks
    The ranks of the initialised process group (one per device) factor
    into a ``rows × nodes`` mesh.  Scenario rows split over ``rows``,
    each rank's block padded to a multiple of
    :data:`~repro_torch.kernels.psp_tick.DATA_PLANE_BLOCK` (padded rows
    carry a negative horizon and never tick); the P node slots split
    over ``nodes``, whose size is clamped to the largest divisor of P
    within the request, because a padded node slot would widen the
    full-view reductions and break the bit identity across meshes.  The
    default is ``(devices, 1)``: node sharding is asked for with
    ``mesh=`` or ``PSP_SWEEP_MESH``.  Without a process group there is
    one device and the mesh is ``(1, 1)``.  The stride's noise budget
    counts the block every rank draws (:func:`draw_rows`), so the stride
    — and the noise stream — is the same on every mesh.

Env overrides:

=====================  ==================================================
``PSP_SWEEP_MESH``     ``RxN`` rows × nodes factorization (e.g. ``4x2``)
``PSP_SWEEP_DEVICES``  rows-axis size (default: every rank of the
                       group); ignored when a mesh is given
``PSP_TRACE_STRIDE``   force the record stride (still snapped to a
                       divisor of the measurement cadence)
``PSP_SWEEP_CHUNK``    force a uniform chunk length in records
=====================  ==================================================
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import env
from repro_torch.kernels.psp_tick import DATA_PLANE_BLOCK

__all__ = ["SweepPlan", "available_devices", "draw_rows", "parse_mesh",
           "plan_sweep", "resolve_mesh"]

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
    n_devices: int              #: total devices used (= rows · nodes)
    b_pad: int                  #: scenario rows after mesh padding
    node_pad: int               #: node-keyed draw slots after mesh padding
    mesh: Tuple[int, int] = (1, 1)   #: (rows, nodes) device factorization
    p_loc: int = 0              #: node slots per nodes-axis shard (P / nodes)

    @property
    def n_ticks(self) -> int:
        """Padded tick-grid length (``n_rec × stride``)."""
        return self.n_rec * self.stride

    @property
    def rows(self) -> int:
        """Rows-axis size of the device mesh."""
        return self.mesh[0]

    @property
    def nodes(self) -> int:
        """Nodes-axis size of the device mesh."""
        return self.mesh[1]


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


def draw_rows(B: int) -> int:
    """Rows of a supertick's noise block: B padded to the data-plane
    block width, as on one rank (every mesh draws this block)."""
    return math.ceil(B / DATA_PLANE_BLOCK) * DATA_PLANE_BLOCK


def parse_mesh(spec: str) -> Tuple[int, int]:
    """Parse a ``RxN`` mesh spec (``PSP_SWEEP_MESH`` / ``--mesh``).

    Exactly two positive decimal integers joined by a single ``x`` (case
    insensitive): ``"4x2" → (4, 2)``.  Anything else raises
    ``ValueError`` rather than running an unintended placement.
    """
    parts = spec.strip().lower().split("x")
    if len(parts) != 2 or not all(p.isdigit() and p for p in parts):
        raise ValueError(
            f"mesh spec {spec!r} is not of the form RxN (two positive "
            "integers, e.g. '4x2')")
    rows, nodes = int(parts[0]), int(parts[1])
    if rows < 1 or nodes < 1:
        raise ValueError(f"mesh spec {spec!r}: sizes must be >= 1")
    return rows, nodes


def _node_axis_size(n: int, P: int, budget: int) -> int:
    """Largest divisor of ``P`` that is ≤ min(n, budget): the nodes-axis
    shard width must be exact, so a request that does not divide P
    degrades to the nearest feasible size (``nodes=8`` on P = 100 runs
    5-way)."""
    cap = max(1, min(n, P, budget))
    return max(d for d in range(1, cap + 1) if P % d == 0)


def available_devices() -> int:
    """The devices a sweep may use: the initialised process group's
    world size (one rank a device), or 1 without a group."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def resolve_mesh(B: int, P: int, mesh: Optional[Tuple[int, int]] = None,
                 n_devices: Optional[int] = None, *,
                 available: Optional[int] = None) -> Tuple[int, int]:
    """The ``(rows, nodes)`` factorization a sweep of this shape uses.

    Resolution order: explicit ``mesh`` > ``PSP_SWEEP_MESH`` > 1-D
    ``(n_devices, 1)`` (``PSP_SWEEP_DEVICES``, default every available
    device).  Rows clamp to B and the available devices, nodes to the
    largest divisor of P within the devices left, so a request beyond
    the host degrades instead of failing.  ``available`` defaults to
    :func:`available_devices`.
    """
    avail = available_devices() if available is None else int(available)
    if mesh is None:
        env_mesh = env.get_str("PSP_SWEEP_MESH")
        if env_mesh:
            mesh = parse_mesh(env_mesh)
    if mesh is None:
        if n_devices is None:
            n_devices = env.get_int("PSP_SWEEP_DEVICES") or None
        mesh = (avail if n_devices is None else int(n_devices), 1)
    rows = max(1, min(int(mesh[0]), B, avail))
    nodes = _node_axis_size(int(mesh[1]), P, avail // rows)
    return rows, nodes


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
               has_churn: bool, n_devices: Optional[int] = None,
               mesh: Optional[Tuple[int, int]] = None,
               available: Optional[int] = None) -> SweepPlan:
    """Choose stride, chunk schedule and mesh placement for one sweep.

    Args:
      n_ticks: live tick-grid length (before stride padding).
      measure_idx: global tick index of each measurement point.
      B: scenario rows in the batch (before mesh padding).
      P: padded node-slot count of the batch.
      batch / d: data-plane minibatch size and model dimension.
      k_max: static β-sample slot count (0 = no sampled rows).
      masked: per-row alive-masked sampling (churn or ragged padding).
      has_churn: whether churn uniforms are drawn.
      n_devices / mesh: the placement asked for (see
        :func:`resolve_mesh`).
      available: the devices there are (default
        :func:`available_devices`).
    """
    rows, nodes = resolve_mesh(B, P, mesh=mesh, n_devices=n_devices,
                               available=available)
    # each rank's row block pads to the data-plane block width; padded
    # rows are inert (negative horizon)
    b_loc = math.ceil(math.ceil(B / rows) / DATA_PLANE_BLOCK) \
        * DATA_PLANE_BLOCK
    b_pad = b_loc * rows
    # node-keyed draw slots as the reference counts them: each node
    # column's exact P/nodes block, padded to the rows axis
    p_loc = P // nodes
    node_pad = nodes * math.ceil(p_loc / rows) * rows
    # every rank draws the supertick's full-width noise block at the
    # one-rank row padding (the generator's stream must not depend on
    # the mesh), so that is the block the budget counts; the reference
    # counts b_pad, which is the same on one rank
    b_draw = draw_rows(B)
    noise = P * batch * (d + 1)                     # minibatch blob
    noise += b_draw * P                             # step-duration jitter
    if k_max > 0:
        noise += b_draw * P * P if masked else (P if k_max == 1 else P * P)
    if has_churn:
        noise += 2 * b_draw * P
    stride = _record_stride(n_ticks, np.asarray(measure_idx, np.int64),
                            4 * noise)
    n_rec_live = math.ceil(n_ticks / stride)
    chunks = _binary_chunks(n_rec_live)
    return SweepPlan(stride=stride, n_rec=sum(chunks), n_rec_live=n_rec_live,
                     chunks=chunks, n_devices=rows * nodes, b_pad=b_pad,
                     node_pad=node_pad, mesh=(rows, nodes), p_loc=p_loc)
