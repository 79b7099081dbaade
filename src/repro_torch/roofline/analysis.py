"""Three-term roofline against one H100.

The port's counterpart of :mod:`repro.roofline.analysis`::

    compute term    = FLOPs / peak FLOP/s
    memory term     = bytes / HBM bytes/s
    collective term = collective bytes / link bytes/s

:class:`HW` holds the data-sheet figures of the NVIDIA H100 SXM (80 GB
HBM3), the card "NVIDIA H100 80GB HBM3, 700.00 W" on which every number
of the port's ``PERF.md`` was taken.  They are the published peaks at
the full 700 W power limit, not measurements: 989 TFLOP/s dense bf16 on
the tensor cores, 67 TFLOP/s float32 outside them, 3.35 TB/s of HBM,
80 GB.  The link figure is NVLink 4's 900 GB/s per GPU in both
directions together (the same data sheet), 450 GB/s one way.  A card
set below 700 W runs slower under load, so a roofline share is stated
beside the card's power limit.

The port runs on one card, so the collective term is 0: the
reference's ``collective_bytes`` parses partitioned HLO text, which the
port does not have.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

__all__ = ["HW", "RooflineReport", "model_flops", "roofline_report",
           "times_ms"]


@dataclasses.dataclass(frozen=True)
class HW:
    """NVIDIA H100 SXM data-sheet figures (dense, no sparsity, 700 W)."""

    peak_flops: float = 989e12      # bf16 FLOP/s on the tensor cores
    f32_flops: float = 67e12        # float32 FLOP/s outside them
    hbm_bw: float = 3.35e12         # HBM bytes/s
    link_bw: float = 450e9          # NVLink 4 bytes/s, one direction
    hbm_bytes: float = 80e9         # HBM capacity


def times_ms(flops: float, nbytes: float, *, f32: bool = False,
             hw: HW = HW()) -> Tuple[float, float]:
    """(operations, bytes) times in ms: ``flops`` at the bf16
    tensor-core rate (``f32``: the float32 rate) and ``nbytes`` at the
    HBM rate.  A kernel's bound is the larger of the two."""
    rate = hw.f32_flops if f32 else hw.peak_flops
    return 1e3 * flops / rate, 1e3 * nbytes / hw.hbm_bw


@dataclasses.dataclass
class RooflineReport:
    """One step's roofline (the reference's fields)."""

    flops: float                    # per-device FLOPs
    hbm_bytes: float                # per-device bytes accessed
    coll_bytes: float               # per-device collective bytes
    coll_detail: Dict[str, float]
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops_total: float        # 6·N·D (global)
    useful_ratio: float             # model_flops / (flops × chips)
    chips: int

    def to_dict(self) -> dict:
        """The report as a plain dict."""
        return dataclasses.asdict(self)


def roofline_report(cost: dict, *, chips: int = 1,
                    model_flops_total: float, coll_bytes: float = 0.0,
                    hw: HW = HW()) -> RooflineReport:
    """The three terms of ``cost`` (``{"flops", "bytes accessed"}``, the
    reference's keys) against ``hw``; the bottleneck is the largest
    term."""
    flops = float(cost.get("flops", 0.0))
    hbm = float(cost.get("bytes accessed", 0.0))
    compute_s = flops / hw.peak_flops
    memory_s = hbm / hw.hbm_bw
    collective_s = coll_bytes / hw.link_bw
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    useful = (model_flops_total / (flops * chips)) if flops else 0.0
    return RooflineReport(
        flops=flops, hbm_bytes=hbm, coll_bytes=coll_bytes,
        coll_detail={"total": coll_bytes}, compute_s=compute_s,
        memory_s=memory_s, collective_s=collective_s,
        bottleneck=max(terms, key=terms.get),
        model_flops_total=model_flops_total, useful_ratio=useful,
        chips=chips)


def model_flops(cfg, shape) -> float:
    """6·N·D (training) or 2·N·D (inference), N = the config's active
    parameter count ``cfg.param_count(active_only=True)``: the
    reference's formula, which leaves an ``rglru`` layer's MLP and gates
    out (recurrentgemma-2b: 1,596,912,640 against its tree's
    2,682,237,440)."""
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        return 6.0 * n_active * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch
