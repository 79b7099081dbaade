"""Serving tier of the port: the request-lifecycle engine.  The server
and the snapshot bus follow with the checkpoint slice (ROADMAP queue 1,
item 12)."""
from repro_torch.serving.engine import (Completion, Request, ServeConfig,
                                        ServingEngine, StepResult,
                                        sample_token)

__all__ = ["Completion", "Request", "ServeConfig", "ServingEngine",
           "StepResult", "sample_token"]
