"""State carried across packages: the JAX package's window state as
numpy arrays in, the port's tensors out, and back.

Faces has no weights; its window state (``{key: array}`` as ``np.asarray``
of the JAX package's state gives it) is what the two packages share, so
a run of either can start from the other's state and be compared key by
key.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def state_from_numpy(stream, arrays: Dict[str, np.ndarray]
                     ) -> Dict[str, torch.Tensor]:
    """The stream's allocated state with every key filled from
    ``arrays``; keys, shapes and dtypes must match what
    ``stream.allocate()`` makes exactly."""
    specs = stream.state_specs()
    if set(arrays) != set(specs):
        raise ValueError("state keys differ: missing "
                         f"{sorted(set(specs) - set(arrays))[:6]}, extra "
                         f"{sorted(set(arrays) - set(specs))[:6]}")
    for k, (shape, dtype) in specs.items():
        a = np.asarray(arrays[k])
        if a.shape != shape or a.dtype.name != dtype:
            raise ValueError(f"{k}: {a.dtype.name}{list(a.shape)}, "
                             f"expected {dtype}{list(shape)}")
    state = stream.allocate()
    for k, t in state.items():
        t.copy_(torch.from_numpy(np.ascontiguousarray(arrays[k])))
    return state


def state_to_numpy(state: Dict[str, torch.Tensor]
                   ) -> Dict[str, np.ndarray]:
    """{key: host numpy copy} of a state dict."""
    return {k: v.detach().cpu().numpy() for k, v in state.items()}
