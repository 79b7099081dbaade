"""The port's reproductions of the paper's figures and its sweep benchmark.

* :mod:`repro_torch.bench.figures` — Figs 1a–1e, 1c's β sweep, 2a–2c
  and 3 through :func:`repro_torch.core.run_sweep`
* :mod:`repro_torch.bench.fig45_bounds` — Figs 4–5: the Theorem 2 bounds
  beside an empirical mean lag
* :mod:`repro_torch.bench.sweep_bench` — the Fig 2 matrix through the
  event engine, the numpy grid engine, the plain tick and the kernel,
  plus a 100,000-node pair
* :mod:`repro_torch.bench.churn_bench` — the elastic trainer under
  Poisson churn and a heavy straggler tail, all nine barrier policies
  (Fig 6: :func:`repro_torch.bench.figures.fig6_adaptive_churn`)
* :mod:`repro_torch.bench.serve_bench` — open-loop serving with two
  mid-stream snapshot swaps
* :mod:`repro_torch.bench.chaos_bench` — recovery and goodput of the
  cluster under a fault plan, and serving under publish faults and a
  decode-worker death
* :mod:`repro_torch.bench.roofline_bench` — the dry run's roofline
  table and the sweep tick's roofline row
* :mod:`repro_torch.bench.run` — the ``name,us_per_call,derived`` CSV
  harness over the figures, the sweep and churn benchmarks and the
  roofline step
"""
from __future__ import annotations

__all__ = ["resolve_device"]


def resolve_device(device=None):
    """``device`` as a ``torch.device``; ``None`` means the GPU.  Raises
    when it names CUDA and no GPU is visible: nothing falls back to the
    CPU unless asked."""
    import torch
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass --device cpu "
                           "(device='cpu') to run on the CPU")
    return dev
