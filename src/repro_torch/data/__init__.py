"""Data pipelines of the port (the counterpart of :mod:`repro.data`)."""
from repro_torch.data.synthetic import SyntheticLM

__all__ = ["SyntheticLM"]
