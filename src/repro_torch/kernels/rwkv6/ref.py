"""Plain PyTorch versions of the WKV6 recurrence: the JAX package's
``kernels/rwkv6/ref.py`` term for term, as a loop over time in float32
(any S >= 1; the CUDA kernel's oracle), and its chunked decomposition."""
from __future__ import annotations

import torch

CHUNK = 16      # steps per chunk of the chunked decomposition


def wkv6_ref(r, k, v, logw, u, s0):
    """r,k,v,logw: (B,S,H,hd); u: (H,hd); s0: (B,H,hd,hd).
    y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T);  S_t = diag(w_t) S_{t-1} + k_t v_t^T
    with w_t = exp(logw_t). Returns (y (B,S,H,hd) f32, sT (B,H,hd,hd) f32);
    s0 is not written."""
    r, k, v, logw = (a.float() for a in (r, k, v, logw))
    w = torch.exp(logw)
    u = u.float()[None, :, :, None]
    s = s0.float()
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhc,bhcv->bhv", r[:, t], s + u * kv))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(ys, dim=1), s


def wkv6_chunked(r, k, v, logw, u, s0, chunk=CHUNK):
    """The function of :func:`wkv6_ref` in the chunked form, which turns
    the recurrence inside a chunk into products (float32, any S >= 1; s0
    is not written). A CUDA kernel of this form matched the plain version
    to 1e-5 but sums in another order, and the served model's bf16
    replay check in ``chip_smoke.py`` did not pass it; the CUDA kernel
    keeps the plain order.

    The steps go in chunks of ``chunk``; the state S is carried from one
    chunk to the next. Within a chunk that starts from S, with the
    decays as products of w = exp(logw) (every factor <= 1, so nothing
    overflows, and no long prefix sum of logw is ever differenced):
      P_t = prod_{s<t} w_s,  Q_t = prod_{s>t} w_s,  D = prod_s w_s,
      A[t, tau] = sum_i r_t k_tau prod_{tau<s<t} w_s   (tau < t),
      A[t, t]   = sum_i r_t u k_t                      (the bonus),
      y_t   = (r_t P_t) S + sum_{tau<=t} A[t, tau] v_tau,
      S_end = diag(D) S + sum_tau (k_tau Q_tau)^T v_tau.
    The inter-chunk term and the state update are (C x hd)(hd x hd) and
    (hd x C)(C x hd) products; A is a masked C x C product whose
    per-channel decays are built one step at a time (the kernel's
    running products). A ragged last chunk is padded with r = k = v = 0
    and w = 1, which leaves y and S unchanged."""
    r, k, v = (a.float() for a in (r, k, v))
    w = torch.exp(logw.float())
    B, S, H, hd = r.shape
    n = -(-S // chunk)
    pad = n * chunk - S
    if pad:
        def padded(a, value):
            return torch.cat([a, a.new_full((B, pad, H, hd), value)], 1)
        r, k, v, w = padded(r, 0.0), padded(k, 0.0), padded(v, 0.0), \
            padded(w, 1.0)

    def fold(a):                # (B, n C, H, hd) -> (B, H, n, C, hd)
        return a.reshape(B, n, chunk, H, hd).permute(0, 3, 1, 2, 4)
    r, k, v, w = map(fold, (r, k, v, w))

    prefix = [torch.ones_like(w[..., 0, :])]
    for t in range(chunk - 1):
        prefix.append(prefix[-1] * w[..., t, :])
    decay = prefix[-1] * w[..., chunk - 1, :]
    suffix = [torch.ones_like(w[..., 0, :])]
    for t in range(chunk - 1, 0, -1):
        suffix.append(suffix[-1] * w[..., t, :])
    rt = r * torch.stack(prefix, -2)
    kt = k * torch.stack(suffix[::-1], -2)

    A = r.new_zeros(r.shape[:-1] + (chunk,))
    A.diagonal(0, -2, -1).copy_((r * u.float()[None, :, None, None] * k)
                                .sum(-1))
    kd = k[..., :chunk - 1, :]  # k_tau prod_{tau<s<tau+d} w_s at offset d
    for d in range(1, chunk):
        A.diagonal(-d, -2, -1).copy_((r[..., d:, :] * kd).sum(-1))
        kd = kd[..., :chunk - d - 1, :] * w[..., d:chunk - 1, :]

    s, ys = s0.float(), []
    for c in range(n):
        ys.append(rt[:, :, c] @ s + A[:, :, c] @ v[:, :, c])
        s = decay[:, :, c, :, None] * s + kt[:, :, c].transpose(-1, -2) \
            @ v[:, :, c]
    y = torch.stack(ys, 2).permute(0, 2, 3, 1, 4).reshape(B, n * chunk, H,
                                                          hd)
    return y[:, :S], s

