"""PSP core of the port: barrier controls, sampling, the overlay, the
theory, the barrier model, the event engine, the sweep engine, the three
engines and the PSP trainer.

* :mod:`repro_torch.core.barriers` — BSP/SSP/ASP/pBSP/pSSP and the
  adaptive policies (declarations)
* :mod:`repro_torch.core.sampling` — the β-sample primitive: the host
  samplers and the index core on tensors
* :mod:`repro_torch.core.overlay` — the structured overlay behind
  distributed sampling
* :mod:`repro_torch.core.bounds` — Theorems 1–3 bounds (Figs 4–5)
* :mod:`repro_torch.core.barrier_kernel` — straggler and barrier model
* :mod:`repro_torch.core.simulator` — ``SimConfig``, ``SimResult``, the
  per-seed static draws and the discrete-event engine (Figs 1–3)
* :mod:`repro_torch.core.sweep_plan` — stride and chunk schedule
* :mod:`repro_torch.core.vector_sim` — batching, static state, the numpy
  grid engine, ``run_sweep``
* :mod:`repro_torch.core.vector_sim_torch` — the tick loop on the device
* :mod:`repro_torch.core.engines` — map-reduce / parameter-server / p2p
* :mod:`repro_torch.core.spmd_psp` — PSP as a training feature: the
  trainer's tick over W worker views
"""
from repro_torch.core.barriers import (ASP, BSP, PBSP, PSSP, SSP,
                                       BarrierControl, make_barrier)
from repro_torch.core.bounds import (mean_lag_bound, psp_lag_pmf,
                                     regret_tail_bound, variance_lag_bound)
from repro_torch.core.sampling import CentralSampler, OverlaySampler
from repro_torch.core.simulator import SimConfig, SimResult, run_simulation
from repro_torch.core.vector_sim import VectorSimulator, run_sweep

__all__ = ["ASP", "BSP", "PBSP", "PSSP", "SSP", "BarrierControl",
           "make_barrier", "mean_lag_bound", "psp_lag_pmf",
           "regret_tail_bound", "variance_lag_bound", "CentralSampler",
           "OverlaySampler", "SimConfig", "SimResult", "run_simulation",
           "VectorSimulator", "run_sweep"]
