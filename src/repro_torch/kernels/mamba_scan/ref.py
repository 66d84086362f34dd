"""Plain PyTorch version of the selective-scan kernel: the JAX package's
``kernels/mamba_scan/ref.py`` term for term, as a loop over time in
float32 (any S >= 1)."""
from __future__ import annotations

import torch


def mamba_scan_ref(a_log, dt, b, c, xc, h0):
    """a_log: (di,ds); dt,xc: (B,S,di); b,c: (B,S,ds); h0: (B,di,ds).
    With A = -exp(a_log), per step
        h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t^T,   y_t = h_t C_t.
    Returns (y (B,S,di) in xc's dtype, hT (B,di,ds) float32); h0 is not
    written."""
    A = -torch.exp(a_log.float())
    dt, b, c, x = (a.float() for a in (dt, b, c, xc))
    h = h0.float()
    ys = []
    for t in range(dt.shape[1]):
        dA = torch.exp(dt[:, t, :, None] * A[None])
        dBx = (dt[:, t] * x[:, t])[:, :, None] * b[:, t, None, :]
        h = dA * h + dBx
        ys.append(torch.einsum("bds,bs->bd", h, c[:, t]))
    return torch.stack(ys, dim=1).to(xc.dtype), h
