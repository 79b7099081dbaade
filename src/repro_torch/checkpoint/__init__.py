"""Checkpoints of the port: the reference's npz + JSON-sidecar format
(:mod:`~repro_torch.checkpoint.checkpoint`) and its async manager
(:mod:`~repro_torch.checkpoint.manager`)."""
from repro_torch.checkpoint.checkpoint import (archive_keys, latest_step,
                                               read_metadata,
                                               restore_checkpoint,
                                               save_checkpoint)
from repro_torch.checkpoint.manager import (CheckpointManager,
                                            CheckpointPolicy, host_snapshot)

__all__ = ["CheckpointManager", "CheckpointPolicy", "archive_keys",
           "host_snapshot", "latest_step", "read_metadata",
           "restore_checkpoint", "save_checkpoint"]
