"""Kernels of the port: the fused sweep tick (CUDA, ``csrc/psp_tick.cu``)
with its plain PyTorch version, the ``nvcc`` build and the dispatch."""
