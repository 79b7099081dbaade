"""Workload configurations of the port (the paper's PSP linear task)."""
from repro_torch.configs.psp_linear import CONFIG, PSPLinearConfig

__all__ = ["CONFIG", "PSPLinearConfig"]
