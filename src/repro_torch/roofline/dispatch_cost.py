"""A step's work, counted as PyTorch dispatches it.

The port's counterpart of :mod:`repro.roofline.hlo_cost`.  The
reference compiles a step and parses its HLO; the port runs the step
under :class:`DispatchCost`, a ``TorchDispatchMode``, on ``meta``
tensors with ``impl="ref"``, so nothing is allocated.  Every iteration
of every loop dispatches, so trip counts come for free, and with
``cfg.remat`` the recomputed blocks dispatch again in the backward, as
the reference's HLO count includes them.

* **FLOPs** count products only (2·|out|·|contracted|), with
  ``torch.utils.flop_counter``'s formulas (matmuls, batched matmuls,
  convolutions), the same rule as ``hlo_cost``'s.
* **bytes** charges every op that is not a view its operands and
  outputs: the naive count.
* **bytes_min** charges the same for the ops that must touch HBM
  (``HEAVY``: products, reductions, sorts and top-k, concatenation),
  the gathers their output and indices, the scatters their updates,
  read and written (the reference's ``_HEAVY_MIN``).  It is the memory
  term.

**The kernel boundary.**  :mod:`repro_torch.kernels.ops` wraps each
hand-written kernel (and its backward) in :func:`kernel_region`: when a
:class:`DispatchCost` is active it charges the kernel's formula
(:mod:`repro_torch.roofline.kernel_cost`) to all three counts and counts
nothing dispatched inside, so the plain version's S² scores or
step-by-step scans are never charged.  A kernel's count is then the
same whatever implements it.

Count once, outside any timing: the mode's own overhead would land in
a measured time.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Any, Dict, Iterator, Optional

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils.flop_counter import flop_registry

__all__ = ["DispatchCost", "GATHERS", "HEAVY", "SCATTERS", "kernel_region"]

aten = torch.ops.aten

#: ops that must touch HBM even under a perfect fuser: products,
#: reductions, sorts and selections, concatenation
HEAVY = frozenset((
    aten.mm, aten.addmm, aten.bmm, aten.baddbmm, aten.convolution,
    aten.convolution_backward, aten.sum, aten.mean, aten.amax, aten.amin,
    aten.max, aten.min, aten.argmax, aten.argmin, aten.prod, aten.var,
    aten.std, aten.var_mean, aten.linalg_vector_norm, aten.norm,
    aten.logsumexp, aten._softmax, aten._log_softmax,
    aten._softmax_backward_data, aten._log_softmax_backward_data,
    aten.cumsum, aten.cumprod, aten.any, aten.all, aten.sort, aten.topk,
    aten.searchsorted, aten.cat, aten.embedding_dense_backward))
#: gathers: charged their output and their indices (a table is read
#: only where indexed)
GATHERS = frozenset((
    aten.index_select, aten.gather, aten.embedding, aten.index,
    aten.take_along_dim))
#: scatters: charged their updates read and written, and their indices
#: (the destination is touched only where indexed)
SCATTERS = frozenset((
    aten.index_put, aten.index_put_, aten.scatter, aten.scatter_,
    aten.scatter_add, aten.scatter_add_, aten.index_add, aten.index_add_,
    aten.index_copy, aten.index_copy_, aten.scatter_reduce,
    aten.scatter_reduce_))


def _tensors(tree: Any) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def _nbytes(tree: Any) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


class DispatchCost(TorchDispatchMode):
    """Counts FLOPs, ``bytes`` and ``bytes_min`` of what runs inside
    ``with DispatchCost() as cost:`` (see the module docstring).

    ``kernels`` maps each hand-written kernel's name to its ``calls``,
    ``flops`` and ``bytes`` charged at the boundary; ``ops`` counts the
    other dispatched ops by name.
    """

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.bytes_min = 0.0
        self.kernels: Dict[str, Dict[str, float]] = defaultdict(
            lambda: {"calls": 0, "flops": 0.0, "bytes": 0.0})
        self.ops: Dict[str, int] = defaultdict(int)
        self._inside = 0

    def charge(self, name: str, flops: float, nbytes: float) -> None:
        """Add one call of kernel ``name``: ``flops`` and ``nbytes`` to
        every count."""
        k = self.kernels[name]
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        self.flops += flops
        self.bytes += nbytes
        self.bytes_min += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._inside or func.is_view:
            return out
        packet = func._overloadpacket
        self.ops[packet.__name__] += 1
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out)
        full = _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
        self.bytes += full
        if packet in GATHERS:
            self.bytes_min += _nbytes(out) + _nbytes(args[1:])
        elif packet in SCATTERS:
            self.bytes_min += 2 * _nbytes(args[1:]) + _nbytes(kwargs)
        elif packet in HEAVY:
            self.bytes_min += full
        return out


def _active() -> Optional[DispatchCost]:
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, DispatchCost):
            return mode
    return None


@contextlib.contextmanager
def kernel_region(name: str, flops: Optional[float] = None,
                  nbytes: float = 0.0):
    """Charge kernel ``name``'s formula to the active :class:`DispatchCost`
    (none: nothing happens) and count nothing dispatched inside.  Yields
    the counter, or None; a caller whose count depends on the kernel's
    outputs passes ``flops=None`` and calls
    :meth:`~DispatchCost.charge` after the kernel."""
    cost = _active()
    if cost is None:
        yield None
        return
    if flops is not None:
        cost.charge(name, flops, nbytes)
    cost._inside += 1
    try:
        yield cost
    finally:
        cost._inside -= 1
