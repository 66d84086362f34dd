"""Fault-tolerance runtime of the port."""
from repro_torch.runtime.ft import (HeartbeatMonitor, StragglerDetector,
                                    TrainingRuntime)

__all__ = ["StragglerDetector", "HeartbeatMonitor", "TrainingRuntime"]
