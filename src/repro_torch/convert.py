"""Carry tick inputs across from the reference's numpy dicts and back.

The reference package passes the sweep tick numpy (or jax) arrays; the
port passes tensors.  :func:`tick_inputs_to_torch` maps the reference's
``state`` / ``rand`` / ``params`` dicts onto the port's, dtype for dtype
(bool, int32, float32; 0-d scalars become host floats, as the port keeps
``eps`` and ``poll``), and :func:`to_numpy` maps results back, so both
packages can compute on the same inputs.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

__all__ = ["tick_inputs_to_torch", "to_numpy", "to_torch"]

_DTYPES = {np.dtype(bool): torch.bool, np.dtype(np.int32): torch.int32,
           np.dtype(np.float32): torch.float32}


def to_torch(x: Any, device: Any = "cpu") -> Any:
    """One array → tensor of the same dtype (bool, int32 or float32) on
    ``device``; a 0-d array becomes a host float."""
    a = np.asarray(x)
    if a.ndim == 0:
        return float(a)
    if a.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {a.dtype} (bool, int32 or "
                        "float32 expected)")
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def tick_inputs_to_torch(state: Dict, rand: Dict, params: Dict,
                         device: Any = "cpu") -> Tuple[Dict, Dict, Dict]:
    """The reference's tick dicts as the port's: (state, rand, params)."""
    conv = lambda d: {k: to_torch(v, device) for k, v in d.items()}
    return conv(state), conv(rand), conv(params)


def to_numpy(tree: Dict) -> Dict[str, np.ndarray]:
    """A dict of tensors (or host numbers) → a dict of numpy arrays."""
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in tree.items()}
