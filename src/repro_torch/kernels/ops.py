"""Dispatch of the port's kernels between CUDA and their plain versions.

``impl="auto"`` sends CUDA tensors to the kernel and CPU tensors to the
plain PyTorch version; ``"cuda"`` and ``"ref"`` force a path (``ref`` is
how a run holds a kernel against its plain version on the card).  A
CUDA tensor never reaches the plain version unless ``ref`` asks for it,
and ``cuda`` on CPU tensors raises in the wrapper's checks.

* :func:`psp_tick` — the fused PSP sweep tick
  (:mod:`repro_torch.kernels.psp_tick`);
* :func:`attention` — forward attention, grouped-query layout
  (:mod:`repro_torch.kernels.flash_attention`);
* :func:`rmsnorm` — RMSNorm over the trailing axis in either of its two
  forms: ``round_scale=False`` the TPU kernel's (one rounding),
  ``round_scale=True`` the reference model's (in bfloat16 the scale is
  rounded before the product) (:mod:`repro_torch.kernels.rmsnorm`);
* :func:`ssd` — the Mamba-2 chunked SSD scan, with its final state
  (:mod:`repro_torch.kernels.ssd_scan`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import (attention_ref,
                                                 flash_attention_cuda)
from repro_torch.kernels.psp_tick import psp_tick_cuda, psp_tick_ref
from repro_torch.kernels.rmsnorm import rmsnorm_cuda, rmsnorm_ref
from repro_torch.kernels.ssd_scan import ssd_cuda, ssd_ref

__all__ = ["IMPLS", "attention", "psp_tick", "rmsnorm", "ssd", "use_kernel"]

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
    noise stream is independent of ``impl``.  The kernel updates
    ``state["w"]`` and ``state["pulled"]`` in place; the plain version
    never writes its inputs.
    """
    fn = (psp_tick_cuda if use_kernel(impl, state["steps"].device)
          else psp_tick_ref)
    return fn(state, rand, params, t, leave_n, join_n, k_max=k_max,
              has_churn=has_churn, masked=masked, adaptive=adaptive)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              softcap: Optional[float] = None,
              impl: str = "auto") -> torch.Tensor:
    """Forward attention: q ``(B, Sq, H, hd)``, k/v ``(B, Sk, KV, hd)`` →
    ``(B, Sq, H, hd)`` in q's dtype (see
    :mod:`repro_torch.kernels.flash_attention`)."""
    fn = flash_attention_cuda if use_kernel(impl, q.device) else attention_ref
    return fn(q, k, v, causal=causal, window=window, softcap=softcap)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
            round_scale: bool = False, impl: str = "auto") -> torch.Tensor:
    """RMS-normalise the trailing axis of ``x`` with gain ``w``;
    ``round_scale`` picks the form (see
    :mod:`repro_torch.kernels.rmsnorm`)."""
    fn = rmsnorm_cuda if use_kernel(impl, x.device) else rmsnorm_ref
    return fn(x, w, eps, round_scale)


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
        Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128,
        impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD: x ``(B, S, nh, hd)``, dt ``(B, S, nh)`` f32, A
    ``(nh,)`` f32, Bm/Cm ``(B, S, ng, N)`` → (y ``(B, S, nh, hd)`` in x's
    dtype, h_final ``(B, nh, hd, N)`` f32); raises unless
    ``S % min(chunk, S) == 0`` (see :mod:`repro_torch.kernels.ssd_scan`)."""
    fn = ssd_cuda if use_kernel(impl, x.device) else ssd_ref
    return fn(x, dt, A, Bm, Cm, chunk)
