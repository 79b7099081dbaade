"""PyTorch / CUDA port of the PSP reproduction (the ``repro`` package).

The structure and module names follow ``repro`` so each module's
counterpart is easy to find: ``repro_torch.core.vector_sim_torch`` is the
twin of ``repro.core.vector_sim_jax``, ``repro_torch.kernels.psp_tick``
of ``repro.kernels.psp_tick`` and so on.  The port imports ``torch``,
numpy and the standard library only; it keeps its own copy of every
numpy-only helper it needs rather than importing ``repro``.

Entry point::

    from repro_torch.core import run_sweep
    results = run_sweep(configs)                 # on the GPU
    results = run_sweep(configs, device="cpu")   # plain PyTorch tick

The fused sweep tick runs as a hand-written CUDA kernel
(``kernels/csrc/psp_tick.cu``) on CUDA tensors and as its plain PyTorch
version (:func:`repro_torch.kernels.psp_tick.psp_tick_ref`) on CPU
tensors.  The LM tier serves (``python -m repro_torch.launch.serve``)
and trains under the PSP barrier (``python -m
repro_torch.launch.train``; :mod:`repro_torch.core.spmd_psp`).
"""
