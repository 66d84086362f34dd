"""GQA attention with a KV cache and RoPE (none where ``cfg.use_rope``
is off, as in Jamba), and the tanh-gated cross attention of the vlm
archs, following the JAX package's ``models/attention.py`` (qk-norm
included).

The attention core dispatches as the reference's Pallas route does
(``attention.py`` ``attention_core``): one query token goes to the
flash-decode kernel, anything else to the flash attention kernel. Each
kernel wrapper takes its route from the tensors' device — the
hand-written CUDA kernel on the card, its plain PyTorch version on the
CPU — and ``cfg.attn_impl == "plain"`` asks for the plain versions on
any device (the reference a run on the card is held against). The
reference's chunked ``attention_core_xla`` is not ported: it computes
the same function as the plain versions, and the CPU tests compare the
port against it.

A non-causal query (cross attention) sees every key at decode too, as
on the reference's default ``"xla"`` route: the decode kernel gets no
query position, so nothing masks the keys past it. (The reference's
Pallas decode route masks keys past the query position even then.)
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_ref)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ref)
from repro_torch.kernels.norm_rope import rope_cache
from repro_torch.models.layers import (apply_rope, kernel_route, rmsnorm_nl,
                                       rope_table)
from repro_torch.models.params import ParamSpec


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------

def attn_specs(cfg, cross: bool = False) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = {
        "wq": ParamSpec((d, H, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, KV, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, KV, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((H, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qk_norm:
        s["q_norm"] = ParamSpec((hd,), (None,), init="ones")
        s["k_norm"] = ParamSpec((hd,), (None,), init="ones")
    if cross:
        # tanh-gated residual (llama-3.2-vision style)
        s["gate"] = ParamSpec((), (), init="zeros")
    return s


# ---------------------------------------------------------------------------
# Attention core
# ---------------------------------------------------------------------------

def attention_core(cfg, q, k, v, *, q_positions, kv_valid_len=None,
                   causal=True, scale=None):
    """q (B,Sq,H,hd), k/v (B,Skv,KV,hd[v]), q_positions (B,Sq) absolute
    -> (B,Sq,H,hdv). ``causal=False`` masks no key by position, at
    decode as at prefill. ``scale``: the scores' scale (default
    hd^-1/2), taken by the flash attention route only; the decode
    kernels have the default alone."""
    plain = cfg.attn_impl == "plain"
    if cfg.attn_impl not in ("kernel", "plain"):
        raise ValueError(f"attn_impl {cfg.attn_impl!r}: the port has "
                         "'kernel' and 'plain'")
    if q.shape[1] == 1:
        if scale is not None:
            raise ValueError("attention_core: the decode route takes no "
                             "scale")
        pos = q_positions if causal else None
        if plain:
            return decode_attention_ref(q, k, v, q_positions=pos,
                                        kv_valid_len=kv_valid_len)
        return decode_attention(q, k, v, q_positions=pos,
                                kv_valid_len=kv_valid_len)
    if plain:
        return flash_attention_ref(q, k, v, q_offset=q_positions[:, 0],
                                   kv_valid_len=kv_valid_len, causal=causal,
                                   scale=scale)
    return flash_attention(q, k, v, q_positions=q_positions,
                           kv_valid_len=kv_valid_len, causal=causal,
                           scale=scale)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

def attn_cache_specs(cfg, batch: int, max_len: int, cross: bool = False,
                     n_vis: int = 0):
    """Returns {name: (shape, logical_axes)} for this layer's cache: a
    self layer's "k", "v" rows per position, a cross layer's "ck", "cv"
    of the ``n_vis`` vision rows."""
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    if cross:
        return {
            "ck": ((batch, n_vis, KV, hd),
                   ("batch", "vis_tokens", "kv_heads", "head_dim")),
            "cv": ((batch, n_vis, KV, hd),
                   ("batch", "vis_tokens", "kv_heads", "head_dim")),
        }
    return {
        "k": ((batch, max_len, KV, hd),
              ("batch", "kv_seq", "kv_heads", "head_dim")),
        "v": ((batch, max_len, KV, hd),
              ("batch", "kv_seq", "kv_heads", "head_dim")),
    }


def cache_index(positions):
    """(rows, cols) indexing the cache rows a step writes: sequence b's
    rows ``positions[b, 0] .. positions[b, 0] + S - 1``."""
    B, S = positions.shape
    rows = torch.arange(B, device=positions.device)[:, None]
    cols = positions[:, :1].long() + torch.arange(S, device=positions.device)
    return rows, cols


def _update_cache(cache_k, k_new, index):
    """Write ``k_new`` (B, S_new, KV, hd) into ``cache_k`` (B, S, KV, hd)
    at the rows ``index`` (:func:`cache_index` of the step's positions),
    IN PLACE (the reference returns a new cache). A prefill writes its
    prompt's rows, a decode step one row per sequence; nothing else of
    the cache is touched, and no value goes to the host. Returns
    ``cache_k``."""
    cache_k[index] = k_new.to(cache_k.dtype)
    return cache_k


def shared_inputs(cfg, positions, rope_dim=None) -> dict:
    """What every attention layer of one forward pass derives from the
    positions alone — the RoPE table (at ``rope_dim``, default the head
    dim, YaRN's where ``cfg.rope_scaling`` gives it; None where
    ``cfg.use_rope`` is off, but MLA's rope part, whose width
    ``rope_dim`` names, is always rotated), the cache rows written,
    the valid KV length — made once per pass instead of once per
    layer."""
    rope = (rope_table(positions, rope_dim or cfg.head_dim, cfg.rope_theta,
                       cfg.rope_scaling)
            if cfg.use_rope or rope_dim else None)
    return {"rope": rope,
            "cache_index": cache_index(positions),
            "kv_valid_len": positions[:, -1] + 1}


# ---------------------------------------------------------------------------
# Block apply
# ---------------------------------------------------------------------------

def _project(x, w, n, hd):
    """(B,S,D) @ (D,n,hd) -> (B,S,n,hd) in x's dtype."""
    B, S, _ = x.shape
    return torch.matmul(x, w.to(x.dtype).reshape(w.shape[0], -1)).view(
        B, S, n, hd)


def cross_attention(cfg, params, x, *, positions, cache=None, vision=None):
    """Pre-norm'd x -> (tanh(gate) * attention over the vision rows,
    cache), the reference's ``attention(..., cross=True)``.

    vision: (B, T_vis, D) projected patch embeddings; K and V are
    projected from them (no RoPE) and, with a cache, written into its
    {"ck", "cv"} (B, T_vis, KV, hd) IN PLACE. A one-token step with a
    cache (decode) reads "ck"/"cv" instead and needs no vision. Every
    query sees every vision row (``causal=False``, no valid length).
    """
    dt = x.dtype
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _project(x, params["wq"], H, hd)
    if cfg.qk_norm:
        q = rmsnorm_nl(q, cfg.norm_eps) * params["q_norm"].to(dt)
    if cache is not None and S == 1:
        k, v = cache["ck"].to(dt), cache["cv"].to(dt)
    else:
        if vision is None:
            raise ValueError("cross attention: a step without a cached "
                             "vision K/V needs batch['vision']")
        k = _project(vision, params["wk"], KV, hd)
        v = _project(vision, params["wv"], KV, hd)
        if cfg.qk_norm:
            k = rmsnorm_nl(k, cfg.norm_eps) * params["k_norm"].to(dt)
        if cache is not None:
            cache["ck"].copy_(k)
            cache["cv"].copy_(v)
    out = attention_core(cfg, q, k, v, q_positions=positions, causal=False)
    out = torch.matmul(out.reshape(B, S, H * hd),
                       params["wo"].to(dt).reshape(H * hd, -1))
    return out * torch.tanh(params["gate"].float()).to(dt), cache


def attention(cfg, params, x, *, positions, cache=None, shared=None):
    """Pre-norm'd x -> (attention output, cache).

    x: (B, S, D); positions: (B, S) absolute positions. cache: this
    layer's {"k", "v"} (B, max_len, KV, hd) buffers, updated in place
    (the returned cache is the same dict), or None (no cache: attend
    within x only). shared: :func:`shared_inputs` of the positions, if
    the caller made it once for all layers. With a cache, the rotation
    of q and k and the two cache writes are one launch of the rope_cache
    kernel where ``layers.kernel_route`` allows (bit for bit
    :func:`apply_rope` and :func:`_update_cache`).
    """
    if shared is None:
        shared = shared_inputs(cfg, positions)
    dt = x.dtype
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = (_project(x, params["wq"], H, hd),
               _project(x, params["wk"], KV, hd),
               _project(x, params["wv"], KV, hd))
    if cfg.qk_norm:
        q = rmsnorm_nl(q, cfg.norm_eps) * params["q_norm"].to(dt)
        k = rmsnorm_nl(k, cfg.norm_eps) * params["k_norm"].to(dt)
    if cache is not None and kernel_route(cfg, q, k, v, cache["k"],
                                          cache["v"]):
        q = rope_cache(q, k, v, shared["rope"], cache["k"], cache["v"],
                       shared["cache_index"])
    else:
        if shared["rope"] is not None:
            q = apply_rope(q, shared["rope"])
            k = apply_rope(k, shared["rope"])
        if cache is not None:
            _update_cache(cache["k"], k, shared["cache_index"])
            _update_cache(cache["v"], v, shared["cache_index"])

    kv_valid_len = None
    if cache is not None:
        k, v = cache["k"].to(dt), cache["v"].to(dt)
        kv_valid_len = shared["kv_valid_len"]

    out = attention_core(cfg, q, k, v, q_positions=positions,
                         kv_valid_len=kv_valid_len, causal=True)
    out = torch.matmul(out.reshape(B, S, H * hd),
                       params["wo"].to(dt).reshape(H * hd, -1))
    return out, cache
