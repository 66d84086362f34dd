"""Random values for the rwkv leaves the reference's init leaves constant.

The init sets the token-shift mixes to 1, the decay base ``w0`` and the
bonus to 0 and ``ln_x`` to 1, which leaves the token shift and the bonus
inert and every decay at one value. The rwkv tests redraw them from one
set of ranges (``chip_smoke.py``'s ``rwkv_redraw`` draws the first three
from the same ranges):

- ``mix_*``: U(0, 1);
- ``w0``: U(-6, 1), a decay of w = exp(-exp(w0 - 0.5)) in [0.07, 1);
- ``bonus``: U(0, 0.5);
- ``ln_x``: U(0.5, 1.5), away from 1 so that a test against the
  reference sees whether the gate scale is cast to the compute dtype.
"""
import numpy as np

RANGES = {"mix_": (0.0, 1.0), "w0": (-6.0, 1.0), "bonus": (0.0, 0.5),
          "ln_x": (0.5, 1.5)}


def _range(name):
    for prefix, lo_hi in RANGES.items():
        if name == prefix or (prefix.endswith("_")
                              and name.startswith(prefix)):
            return lo_hi
    return None


def redraw_rwkv(tree, rng):
    """A copy of a numpy params tree (the reference's layout) with the
    leaves of RANGES drawn from ``rng`` (a ``np.random.RandomState``)."""
    if isinstance(tree, list):
        return [redraw_rwkv(t, rng) for t in tree]
    out = {}
    for name, a in tree.items():
        lo_hi = None if isinstance(a, (dict, list)) else _range(name)
        if isinstance(a, (dict, list)):
            out[name] = redraw_rwkv(a, rng)
        elif lo_hi is not None:
            out[name] = rng.uniform(*lo_hi, np.shape(a)).astype(np.float32)
        else:
            out[name] = np.asarray(a)
    return out


def redraw_rwkv_torch(params, gen):
    """The same draws in place on the port's params (one dict per
    layer), from ``gen`` (a ``torch.Generator``)."""
    for layer in params["layers"]:
        for part in ("mixer", "ffn"):
            for name, t in layer[part].items():
                lo_hi = _range(name)
                if lo_hi is not None:
                    t.uniform_(*lo_hi, generator=gen)
