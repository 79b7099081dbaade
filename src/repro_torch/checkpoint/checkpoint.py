"""Tree checkpointing in the reference's dependency-free .npz format.

The port's counterpart of :mod:`repro.checkpoint.checkpoint`, file for
file: ``<dir>/step_<n>.npz`` holds the flattened leaves keyed by their
``/``-joined tree path (dict keys, list indices), beside a small JSON
sidecar with the step's metadata.  Writes are crash-atomic: both files
are staged under ``.tmp`` names, the sidecar is renamed into place first
and the ``.npz`` last, so a discoverable checkpoint always has its
sidecar (``latest_step`` also refuses entries whose sidecar is missing
or unparseable — a torn write is never selected for restore).  bfloat16
leaves are stored as float32.

A tree is nested dicts, lists and tuples (:mod:`repro_torch.tree`) whose
leaves are tensors or numpy arrays.  Restore is structural: the arrays
land in the structure of a template tree, each leaf in its template
leaf's dtype, and on its device where the template leaf is a tensor.
Model trees are written in the reference's layout (stacked ``groups``,
:func:`repro_torch.convert.to_reference_layout`) by the callers, so an
archive of either package restores in the other.

The async writer / save-policy layer lives in
:mod:`repro_torch.checkpoint.manager`; this module is the storage format
only.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_map

__all__ = ["archive_keys", "latest_step", "read_metadata",
           "restore_checkpoint", "save_checkpoint"]

Tree = Any

_SEP = "/"


def _paths(tree: Tree, prefix: Tuple[str, ...] = ()):
    """``(path, leaf)`` pairs of ``tree`` in :func:`tree_map`'s order;
    ``None`` holds no leaf."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (str(i),))
    else:
        yield _SEP.join(prefix), tree


def _host(leaf) -> np.ndarray:
    """One leaf as a host numpy array (bfloat16 and other dtypes numpy
    lacks as float32)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()
        return t.numpy()
    arr = np.asarray(leaf)
    if arr.dtype.kind not in "fiub":     # not a number: cast (or raise)
        arr = arr.astype(np.float32)
    return arr


def _flatten(tree: Tree) -> Dict[str, np.ndarray]:
    return {key: _host(leaf) for key, leaf in _paths(tree)}


def _npz_name(step: int) -> str:
    return f"step_{step:08d}.npz"


def save_checkpoint(ckpt_dir: str, step: int, tree: Tree,
                    metadata: Optional[dict] = None) -> str:
    """Atomically write ``tree`` (+ JSON sidecar) as step ``step``.

    Publication order matters for crash safety: the sidecar is renamed
    into place *first* and the ``.npz`` *last*, so the moment a
    checkpoint becomes discoverable its metadata exists too.  A crash
    between the two renames leaves an orphan sidecar, which restore
    ignores and :class:`~repro_torch.checkpoint.manager.CheckpointManager`
    removes.
    """
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays = _flatten(tree)
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    os.close(fd)
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    final = os.path.join(ckpt_dir, _npz_name(step))
    meta = {"step": step, **(metadata or {})}
    fd, mtmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    os.close(fd)
    with open(mtmp, "w") as f:
        json.dump(meta, f)
    os.replace(mtmp, final + ".json")
    os.replace(tmp, final)            # npz rename last: publishes atomically
    return final


def _sidecar_ok(ckpt_dir: str, fn: str) -> bool:
    """Whether ``fn``'s JSON sidecar exists and parses."""
    try:
        with open(os.path.join(ckpt_dir, fn + ".json")) as f:
            json.load(f)
    except (OSError, ValueError):
        return False
    return True


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Largest step with a complete (npz + parseable sidecar) checkpoint;
    entries whose sidecar is missing or corrupt are torn writes and are
    skipped."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for fn in os.listdir(ckpt_dir)
             if (m := re.match(r"step_(\d+)\.npz$", fn))
             and _sidecar_ok(ckpt_dir, fn)]
    return max(steps) if steps else None


def read_metadata(ckpt_dir: str, step: int) -> dict:
    """Load the JSON sidecar of checkpoint ``step`` (raises if absent)."""
    with open(os.path.join(ckpt_dir, _npz_name(step)) + ".json") as f:
        return json.load(f)


def archive_keys(ckpt_dir: str, step: int) -> List[str]:
    """The leaf keys stored in checkpoint ``step``."""
    with np.load(os.path.join(ckpt_dir, _npz_name(step))) as data:
        return list(data.files)


def _cast(arr: np.ndarray, leaf):
    """``arr`` in the template leaf's kind, dtype (and device)."""
    if isinstance(leaf, torch.Tensor):
        return torch.from_numpy(arr).to(device=leaf.device, dtype=leaf.dtype)
    return arr.astype(np.asarray(leaf).dtype, copy=False)


def restore_checkpoint(ckpt_dir: str, template: Tree,
                       step: Optional[int] = None) -> Tuple[Tree, int]:
    """Restore into the structure of ``template`` (shapes must match);
    returns ``(tree, step)``, the newest step unless ``step`` is given.

    Archive entries the template does not name are ignored.  Raises
    :class:`ValueError` — never a bare ``assert`` or a ``KeyError`` —
    when a template leaf is absent from the archive or stored with
    another shape, naming the key and both shapes.
    """
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, _npz_name(step))
    leaves = []
    with np.load(path) as data:
        for key, leaf in _paths(template):
            if key not in data.files:
                raise ValueError(
                    f"checkpoint {path} has no entry for template leaf "
                    f"'{key}' (archive holds {sorted(data.files)[:8]}...); "
                    "was it written by a different config?")
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(
                    f"checkpoint {path} leaf '{key}': stored shape "
                    f"{tuple(arr.shape)} != template shape "
                    f"{tuple(leaf.shape)}")
            leaves.append(_cast(arr, leaf))
    it = iter(leaves)
    return tree_map(lambda _: next(it), template), step
