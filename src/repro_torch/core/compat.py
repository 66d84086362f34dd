"""Device selection.

Entry points run on CUDA unless the caller asks for the CPU: a stream
built for ``"cuda"`` on a machine without a card raises here instead of
carrying on quietly on the CPU. (Kernel wrappers take their route from
the device of the tensor they are given: the hand-written kernel for a
CUDA tensor, the plain PyTorch version for a CPU tensor, with no
fallback between the two.)
"""
from __future__ import annotations

from typing import Optional

import torch


def resolve_device(device) -> Optional[torch.device]:
    """``None`` stays None (a device-free stream); ``"cpu"`` is the CPU;
    anything CUDA must name an available card, else RuntimeError."""
    if device is None:
        return None
    device = torch.device(device)
    if device.type == "cpu":
        return device
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}; use 'cuda' or "
                         "'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but CUDA is not available; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def block(device: Optional[torch.device]) -> None:
    """Host block until every kernel queued on ``device`` has finished
    (nothing to wait for on the CPU, where PyTorch runs synchronously)."""
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
