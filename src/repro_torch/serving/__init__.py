"""Serving of the port: the baseline continuous-batching engine."""
from repro_torch.serving.engine import Request, ServingEngine

__all__ = ["ServingEngine", "Request"]
