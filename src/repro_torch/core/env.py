"""Typed registry of the ``PSP_*`` environment overrides the port reads.

The port's own copy of :mod:`repro.core.env`'s registry: every override
is declared once in :data:`REGISTRY` with its type, default and a
one-line description, and every read goes through the typed accessors
below, so a mistyped name raises ``KeyError`` at the read site instead
of silently reading the default.  Only the variables the port reads are
registered.

Accessors return the registered default when the variable is unset; the
empty string counts as unset.  *Flag* variables follow one rule:
set-and-nonempty is true.  ``python -m repro_torch.core.env`` prints the
registry as a markdown table (:func:`markdown_table`).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

__all__ = ["EnvVar", "REGISTRY", "flag", "get_float", "get_int", "get_str",
           "markdown_table"]


@dataclasses.dataclass(frozen=True)
class EnvVar:
    """One registered environment override."""

    name: str           #: full variable name (``PSP_...``)
    kind: str           #: "str" | "int" | "float" | "flag"
    default: Any        #: value returned when unset (flags: False)
    help: str           #: one-line description


def _reg(*vs: EnvVar) -> Dict[str, EnvVar]:
    return {v.name: v for v in vs}


REGISTRY: Dict[str, EnvVar] = _reg(
    EnvVar("PSP_TICK_IMPL", "str", "auto",
           "PSP tick dispatch in the port: `auto` (CUDA kernel on CUDA "
           "tensors, plain PyTorch on CPU tensors) | `cuda` | `ref`"),
    EnvVar("PSP_SWEEP_MESH", "str", None,
           "`RxN` rows×nodes mesh factorization for torch sweeps "
           "(beats `PSP_SWEEP_DEVICES`; e.g. `4x2`)"),
    EnvVar("PSP_SWEEP_DEVICES", "int", None,
           "rows-axis device count for 1-D sweep placement "
           "(default: every rank of the process group; `0` = default)"),
    # registered as the reference has it; the port's sweep bench reads
    # no variable for its ranks: `--mesh RxN` spawns them
    EnvVar("PSP_BENCH_HOST_DEVICES", "int", None,
           "forced host-device count for CPU benchmark runs "
           "(`0` disables the forced mesh; default: one per core, "
           "capped at 8)"),
    EnvVar("PSP_TRACE_STRIDE", "int", None,
           "force the sweep trace record stride (snapped down to an "
           "admissible divisor of the measurement cadence)"),
    EnvVar("PSP_SWEEP_CHUNK", "int", None,
           "force a uniform sweep chunk length in records "
           "(default: greedy pow2 schedule)"),
    EnvVar("PSP_FAULT_PLAN", "str", None,
           "default fault plan for the cluster harness: a registry spec "
           "(`standard:seed=7`) or a plan-JSON path"),
    EnvVar("PSP_BUS_BACKOFF_BASE", "float", 0.25,
           "snapshot-watcher retry backoff base seconds for a bad "
           "step (doubles per failure, jittered)"),
    EnvVar("PSP_BUS_BACKOFF_MAX", "float", 8.0,
           "snapshot-watcher retry backoff ceiling in seconds"),
    EnvVar("PSP_BUS_BLACKLIST_MAX", "int", 64,
           "max bad-step entries the snapshot watcher remembers "
           "(oldest evicted beyond the cap)"),
    EnvVar("PSP_BUS_BLACKLIST_TTL", "float", 300.0,
           "seconds a bad-step entry stays blacklisted before eviction "
           "(the retention window)"),
    EnvVar("PSP_HB_INTERVAL", "float", 0.25,
           "cluster worker heartbeat-sidecar write cadence in seconds"),
    EnvVar("PSP_HB_TIMEOUT", "float", 10.0,
           "heartbeat staleness after which the cluster coordinator "
           "SIGKILLs a hung worker and treats it as departed"),
)


def _raw(name: str) -> Optional[str]:
    """Registered lookup: the raw string, or None when unset/empty."""
    if name not in REGISTRY:
        raise KeyError(f"{name} is not a registered env override "
                       f"(known: {sorted(REGISTRY)})")
    val = os.environ.get(name)
    return val if val else None


def get_str(name: str) -> Optional[str]:
    """String-typed read of a registered override (default when unset)."""
    raw = _raw(name)
    return REGISTRY[name].default if raw is None else raw


def get_int(name: str) -> Optional[int]:
    """Int-typed read; garbage raises ``ValueError`` naming the variable."""
    raw = _raw(name)
    if raw is None:
        return REGISTRY[name].default
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r} is not an integer") from None


def get_float(name: str) -> Optional[float]:
    """Float-typed read; garbage raises ``ValueError`` naming the variable."""
    raw = _raw(name)
    if raw is None:
        return REGISTRY[name].default
    try:
        return float(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r} is not a number") from None


def flag(name: str) -> bool:
    """Flag-typed read: set to any non-empty value = True."""
    return _raw(name) is not None


def markdown_table() -> str:
    """The registry as a markdown table, one row per variable."""
    rows = ["| variable | type | default | meaning |",
            "|---|---|---|---|"]
    for v in REGISTRY.values():
        default = "unset" if v.default in (None, False) else str(v.default)
        help_ = v.help.replace("|", "\\|")   # keep cell pipes out of the grid
        rows.append(f"| `{v.name}` | {v.kind} | {default} | {help_} |")
    return "\n".join(rows)


if __name__ == "__main__":
    print(markdown_table())
