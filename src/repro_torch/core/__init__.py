"""PSP core of the port: barrier controls, sampling, the barrier model,
scenario configs, the tensor sweep engine and the PSP trainer.

* :mod:`repro_torch.core.barriers` — BSP/SSP/ASP/pBSP/pSSP and the
  adaptive policies (declarations)
* :mod:`repro_torch.core.sampling` — the β-sample primitive on tensors
* :mod:`repro_torch.core.barrier_kernel` — straggler and barrier model
* :mod:`repro_torch.core.simulator` — ``SimConfig``, ``SimResult`` and the
  per-seed static draws
* :mod:`repro_torch.core.sweep_plan` — stride and chunk schedule
* :mod:`repro_torch.core.vector_sim` — batching, static state, ``run_sweep``
* :mod:`repro_torch.core.vector_sim_torch` — the tick loop on the device
* :mod:`repro_torch.core.spmd_psp` — PSP as a training feature: the
  trainer's tick over W worker views
"""
from repro_torch.core.barriers import (ASP, BSP, PBSP, PSSP, SSP,
                                       BarrierControl, make_barrier)
from repro_torch.core.simulator import SimConfig, SimResult
from repro_torch.core.vector_sim import VectorSimulator, run_sweep

__all__ = ["ASP", "BSP", "PBSP", "PSSP", "SSP", "BarrierControl",
           "make_barrier", "SimConfig", "SimResult", "VectorSimulator",
           "run_sweep"]
