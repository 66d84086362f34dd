"""Random values for the mamba leaves the reference's init leaves
constant or degenerate.

The init sets ``a_log`` to 0 (every A = -1: every state channel decays
alike, so a scan that indexes A wrongly still agrees), ``dt_bias`` to 0
(dt ~ softplus(0) = 0.69: the state forgets within about two steps),
``d_skip`` to 1 and ``conv_b`` to 0. The mamba tests redraw them from
Mamba's own init ranges (arXiv:2312.00752), as ``chip_smoke.py``'s
``mamba_redraw`` does:

- ``a_log``: log U(1, 16), the range of the S4D-real init A_n = -(n+1);
- ``dt_bias``: softplus^-1(dt), dt log-uniform in [1e-3, 1e-1]
  (``dt_min``, ``dt_max``);
- ``d_skip``: U(0.5, 1.5);
- ``conv_b``: U(-0.1, 0.1).
"""
import numpy as np

DT_MIN, DT_MAX = 1e-3, 1e-1


def _draw(name, shape, uniform):
    """The redrawn value of leaf ``name`` from ``uniform(lo, hi, shape)``,
    or None for a leaf that keeps its init."""
    if name == "a_log":
        return np.log(uniform(1.0, 16.0, shape))
    if name == "dt_bias":
        dt = np.exp(uniform(np.log(DT_MIN), np.log(DT_MAX), shape))
        return dt + np.log(-np.expm1(-dt))          # softplus^-1
    if name == "d_skip":
        return uniform(0.5, 1.5, shape)
    if name == "conv_b":
        return uniform(-0.1, 0.1, shape)
    return None


def redraw_mamba(tree, rng):
    """A copy of a numpy params tree (the reference's layout) with the
    mamba leaves drawn from ``rng`` (a ``np.random.RandomState``)."""
    if isinstance(tree, list):
        return [redraw_mamba(t, rng) for t in tree]
    out = {}
    for name, a in tree.items():
        if isinstance(a, (dict, list)):
            out[name] = redraw_mamba(a, rng)
            continue
        v = _draw(name, np.shape(a), rng.uniform)
        out[name] = np.asarray(a) if v is None else v.astype(np.float32)
    return out


def redraw_mamba_torch(params, gen):
    """The same draws in place on the port's params (one dict per
    layer), from ``gen`` (a ``torch.Generator``)."""
    import torch

    def uniform(lo, hi, shape):
        u = torch.empty(shape, dtype=torch.float64)
        return u.uniform_(lo, hi, generator=gen).numpy()
    for layer in params["layers"]:
        for name, t in layer["mixer"].items():
            v = _draw(name, tuple(t.shape), uniform)
            if v is not None:
                t.copy_(torch.from_numpy(v))
