"""Kernels of the port, each a hand-written CUDA source under ``csrc/``
beside its plain PyTorch version: the fused sweep tick
(:mod:`~repro_torch.kernels.psp_tick`), flash attention
(:mod:`~repro_torch.kernels.flash_attention`), RMSNorm
(:mod:`~repro_torch.kernels.rmsnorm`) and the Mamba-2 SSD scan
(:mod:`~repro_torch.kernels.ssd_scan`); the ``nvcc`` build
(:mod:`~repro_torch.kernels._build`) and the dispatch
(:mod:`~repro_torch.kernels.ops`)."""
