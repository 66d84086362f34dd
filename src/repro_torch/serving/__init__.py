"""Serving of the port: the continuous-batching engine and its ST decode
router."""
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.st_decode import STDecodeRouter

__all__ = ["ServingEngine", "Request", "STDecodeRouter"]
