"""Dispatch of the fused sweep tick between the CUDA kernel and its plain
version.

``impl="auto"`` sends CUDA tensors to the kernel and CPU tensors to the
plain PyTorch version; ``"cuda"`` and ``"ref"`` force a path (``ref`` is
how a run holds the kernel against the plain version on the card).  A
CUDA tensor never reaches the plain version unless ``ref`` asks for it,
and ``cuda`` on CPU tensors raises in the wrapper's checks.
"""
from __future__ import annotations

from repro_torch.kernels.psp_tick import psp_tick_cuda, psp_tick_ref

__all__ = ["IMPLS", "psp_tick", "use_kernel"]

IMPLS = ("auto", "cuda", "ref")


def use_kernel(impl: str, device) -> bool:
    """Whether ``impl`` on tensors of ``device`` runs the CUDA kernel.

    An unknown ``impl`` (e.g. a mistyped ``PSP_TICK_IMPL``) raises
    instead of silently running the plain version.
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; choose from "
                         + "|".join(IMPLS))
    if impl == "auto":
        return getattr(device, "type", str(device)) == "cuda"
    return impl == "cuda"


def psp_tick(state, rand, params, t, leave_n, join_n, *, k_max: int,
             has_churn: bool, masked: bool, adaptive: bool = False,
             impl: str = "auto"):
    """One fused PSP sweep-grid tick (see :mod:`repro_torch.kernels.psp_tick`).

    Both paths consume the same pre-drawn noise in ``rand``, so a sweep's
    noise stream is independent of ``impl``.
    """
    fn = (psp_tick_cuda if use_kernel(impl, state["steps"].device)
          else psp_tick_ref)
    return fn(state, rand, params, t, leave_n, join_n, k_max=k_max,
              has_churn=has_churn, masked=masked, adaptive=adaptive)
