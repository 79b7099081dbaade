"""Serving tier of the port: the request-lifecycle engine, the threaded
inference server and the trainer → server snapshot bus."""
from repro_torch.serving.engine import (Completion, Request, ServeConfig,
                                        ServingEngine, StepResult,
                                        sample_token)
from repro_torch.serving.server import InferenceServer, ServerStats
from repro_torch.serving.snapshot_bus import (ChaosPublisher,
                                              SnapshotPublisher,
                                              SnapshotWatcher)

__all__ = ["ChaosPublisher", "Completion", "InferenceServer", "Request",
           "ServeConfig", "ServerStats", "ServingEngine", "SnapshotPublisher",
           "SnapshotWatcher", "StepResult", "sample_token"]
