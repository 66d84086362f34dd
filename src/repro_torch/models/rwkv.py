"""RWKV6 (Finch) mixer, following the JAX package's ``models/rwkv.py``:
time-mix with data-dependent per-channel decay + channel-mix FFN.
Attention-free; the state is O(1) in sequence length.

The WKV recurrence is routed by ``cfg.attn_impl``, as attention is:
``"kernel"`` calls :func:`..kernels.rwkv6.wkv6` (the hand-written CUDA
kernel for CUDA tensors, its plain version for CPU tensors), ``"plain"``
calls :func:`..kernels.rwkv6.wkv6_ref` on any device.

One-dim leaves arrive in float32 (:mod:`.params`). The reference casts
the token-shift mixes (``mix_*``) and ``ln_x`` to the compute dtype
before use, so the port does too (in bf16 the lerps then run in bf16,
as the reference's do); ``w0`` and ``bonus`` stay float32, as there.

With a cache, the layer's ``shift_t``/``shift_c`` rows (the previous
token's input, in the cache dtype) and ``wkv`` state (float32) are
written IN PLACE (the reference returns a new cache); each is read
before it is written.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6 import wkv6, wkv6_ref
from repro_torch.models.params import ParamSpec

DECAY_LORA = 64
GROUP_NORM_EPS = 64e-5


def timemix_specs(cfg) -> dict:
    d = cfg.d_model
    return {
        "mix_r": ParamSpec((d,), (None,), init="ones", scale=None),
        "mix_k": ParamSpec((d,), (None,), init="ones"),
        "mix_v": ParamSpec((d,), (None,), init="ones"),
        "mix_w": ParamSpec((d,), (None,), init="ones"),
        "mix_g": ParamSpec((d,), (None,), init="ones"),
        "wr": ParamSpec((d, d), ("embed", "mlp")),
        "wk": ParamSpec((d, d), ("embed", "mlp")),
        "wv": ParamSpec((d, d), ("embed", "mlp")),
        "wg": ParamSpec((d, d), ("embed", "mlp")),
        "wo": ParamSpec((d, d), ("mlp", "embed")),
        "w0": ParamSpec((d,), (None,), init="zeros"),
        "w_a": ParamSpec((d, DECAY_LORA), ("embed", None), scale=0.02),
        "w_b": ParamSpec((DECAY_LORA, d), (None, "embed"), scale=0.02),
        "bonus": ParamSpec((d,), (None,), init="zeros"),
        "ln_x": ParamSpec((d,), (None,), init="ones"),
    }


def channelmix_specs(cfg) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mix_k": ParamSpec((d,), (None,), init="ones"),
        "mix_r": ParamSpec((d,), (None,), init="ones"),
        "wk": ParamSpec((d, f), ("embed", "mlp")),
        "wv": ParamSpec((f, d), ("mlp", "embed")),
        "wr": ParamSpec((d, d), ("embed", "mlp")),
    }


def rwkv_cache_specs(cfg, batch: int):
    """Returns {name: (shape, logical_axes)}: no sequence axis, the
    state of each sequence."""
    d = cfg.d_model
    hd = cfg.rwkv.head_size
    H = d // hd
    return {
        "shift_t": ((batch, d), ("batch", None)),
        "shift_c": ((batch, d), ("batch", None)),
        "wkv": ((batch, H, hd, hd), ("batch", "rwkv_head", None, None)),
    }


def _token_shift(x, prev):
    """x: (B,S,D); prev: (B,D) last token of the previous segment."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def _lerp(params, name, x, xs):
    m = params[name].to(x.dtype)
    return x * m + xs * (1.0 - m)


def _prev(cache, key, x):
    B, _, D = x.shape
    if cache is None:
        return torch.zeros((B, D), dtype=x.dtype, device=x.device)
    return cache[key].to(x.dtype)


def time_mix(cfg, params, x, *, cache=None):
    """Pre-norm'd x (B,S,D) -> (time-mix output, cache)."""
    if cfg.attn_impl not in ("kernel", "plain"):
        raise ValueError(f"attn_impl {cfg.attn_impl!r}: the port has "
                         "'kernel' and 'plain'")
    dt = x.dtype
    B, S, D = x.shape
    hd = cfg.rwkv.head_size
    H = D // hd
    xs = _token_shift(x, _prev(cache, "shift_t", x))

    def proj(mix, w):
        return torch.matmul(_lerp(params, mix, x, xs), params[w].to(dt))

    r, k, v, g = (proj("mix_r", "wr"), proj("mix_k", "wk"),
                  proj("mix_v", "wv"), proj("mix_g", "wg"))
    # data-dependent decay (the Finch contribution)
    wl = torch.matmul(torch.tanh(_lerp(params, "mix_w", x, xs)),
                      params["w_a"].to(dt))
    w_raw = params["w0"].float() + torch.matmul(
        wl, params["w_b"].to(dt)).float()
    logw = -torch.exp(w_raw - 0.5)                    # log w_t < 0

    def heads(a):
        return a.view(B, S, H, hd)

    u = params["bonus"].float().view(H, hd)
    if cache is None:
        s0 = torch.zeros((B, H, hd, hd), dtype=torch.float32,
                         device=x.device)
    else:
        s0 = cache["wkv"]
    if cfg.attn_impl == "plain":
        y, sT = wkv6_ref(heads(r), heads(k), heads(v), heads(logw), u, s0)
        if cache is not None:
            cache["wkv"].copy_(sT)
    else:
        y, _ = wkv6(heads(r), heads(k), heads(v), heads(logw), u, s0,
                    inplace=cache is not None)

    # per-head group norm, in float32
    var, mean = torch.var_mean(y, dim=-1, keepdim=True, unbiased=False)
    y = (y - mean) * torch.rsqrt(var + GROUP_NORM_EPS)
    y = y.reshape(B, S, D).to(dt) * params["ln_x"].to(dt)
    y = y * F.silu(g)
    out = torch.matmul(y, params["wo"].to(dt))
    if cache is not None:
        cache["shift_t"].copy_(x[:, -1, :])
    return out, cache


def channel_mix(cfg, params, x, *, cache=None):
    """Pre-norm'd x (B,S,D) -> (channel-mix output, cache)."""
    dt = x.dtype
    xs = _token_shift(x, _prev(cache, "shift_c", x))
    k = torch.matmul(_lerp(params, "mix_k", x, xs), params["wk"].to(dt))
    kv = torch.matmul(torch.square(F.relu(k)), params["wv"].to(dt))
    r = torch.matmul(_lerp(params, "mix_r", x, xs), params["wr"].to(dt))
    out = torch.sigmoid(r) * kv
    if cache is not None:
        cache["shift_c"].copy_(x[:, -1, :])
    return out, cache
