"""The port's roofline: the H100's figures and the three-term roofline
(:mod:`~repro_torch.roofline.analysis`), the hand-written kernels' work
by formula (:mod:`~repro_torch.roofline.kernel_cost`), and a step's work
counted at dispatch (:mod:`~repro_torch.roofline.dispatch_cost`)."""
from repro_torch.roofline.analysis import (HW, RooflineReport, model_flops,
                                           roofline_report, times_ms)

__all__ = ["HW", "RooflineReport", "model_flops", "roofline_report",
           "times_ms"]
