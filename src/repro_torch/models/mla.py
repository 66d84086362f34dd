"""Multi-head latent attention (DeepSeek-V2), following the JAX package's
``models/mla.py``.

Two execution paths, as there:

  * expand (no cache, and prefill): decompress the latent into per-head
    K/V and run standard attention through :func:`.attention.
    attention_core` — q and k are 128 nope + 64 rope = 192 wide per head
    at full width, v 128, so a prefill runs the flash attention kernel at
    (hd, hdv) = (192, 128). With a cache the whole cache is expanded
    (Skv = max_len, bounded by the valid length), as the reference does;
  * absorbed (decode, one token with a cache): fold W_k^b into the query
    and W_v^b into the output and attend over the compressed latent
    cache directly — the MLA memory saving (the cache holds kv_lora +
    rope_dim values per token instead of 2 H hd). Plain products, as the
    reference's einsums (it has no Pallas kernel there); the mask is made
    on the device from the positions, so the decode step still captures
    as one CUDA graph.

The cache is {"ckv": (B, max_len, kv_lora), "krope": (B, max_len,
rope_dim)}, written in place at the step's rows.

Beyond the JAX package's layer (DeepSeek-V2-Lite, each off by default):
``cfg.mla.q_lora_rank`` 0 makes the query one projection ``wq`` (d, H,
nope + rope) in place of ``wq_a``, ``q_norm`` and ``wq_b``; and
``cfg.rope_scaling`` (YaRN) rotates the rope part at YaRN's frequencies
(:func:`.attention.shared_inputs`) and multiplies the softmax scale of
both paths by its ``softmax_factor`` (:func:`softmax_scale`).
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.attention import (_update_cache, attention_core,
                                          shared_inputs as _shared_inputs)
from repro_torch.models.layers import apply_rope, rmsnorm_nl
from repro_torch.models.params import ParamSpec

NEG_INF = -1e30


def mla_specs(cfg) -> dict:
    m, d, H = cfg.mla, cfg.d_model, cfg.num_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    if m.q_lora_rank:
        q = {"wq_a":   ParamSpec((d, m.q_lora_rank), ("embed", "lora")),
             "q_norm": ParamSpec((m.q_lora_rank,), (None,), init="ones"),
             "wq_b":   ParamSpec((m.q_lora_rank, H, qk),
                                 ("lora", "heads", "head_dim"))}
    else:
        q = {"wq": ParamSpec((d, H, qk), ("embed", "heads", "head_dim"))}
    return {
        **q,
        "wkv_a":  ParamSpec((d, m.kv_lora_rank + m.qk_rope_head_dim),
                            ("embed", "lora")),
        "kv_norm": ParamSpec((m.kv_lora_rank,), (None,), init="ones"),
        "wk_b":   ParamSpec((m.kv_lora_rank, H, m.qk_nope_head_dim),
                            ("lora", "heads", "head_dim")),
        "wv_b":   ParamSpec((m.kv_lora_rank, H, m.v_head_dim),
                            ("lora", "heads", "head_dim")),
        "wo":     ParamSpec((H, m.v_head_dim, d),
                            ("heads", "head_dim", "embed")),
    }


def mla_cache_specs(cfg, batch: int, max_len: int):
    """{name: (shape, logical_axes)} of this layer's latent cache."""
    m = cfg.mla
    return {
        "ckv":   ((batch, max_len, m.kv_lora_rank),
                  ("batch", "kv_seq", "lora")),
        "krope": ((batch, max_len, m.qk_rope_head_dim),
                  ("batch", "kv_seq", None)),
    }


def shared_inputs(cfg, positions) -> dict:
    """:func:`.attention.shared_inputs` with the RoPE table at the rope
    part's width (``qk_rope_head_dim``), made once per forward pass."""
    return _shared_inputs(cfg, positions, rope_dim=cfg.mla.qk_rope_head_dim)


def _proj(x, w, dt):
    """(B, S, K) @ (K, *rest) -> (B, S, *rest)."""
    return torch.matmul(x, w.to(dt).reshape(w.shape[0], -1)).view(
        *x.shape[:-1], *w.shape[1:])


def softmax_scale(cfg) -> float:
    """The scores' scale: (nope + rope)^-1/2, times YaRN's
    ``softmax_factor`` where ``cfg.rope_scaling`` gives it."""
    m = cfg.mla
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    if cfg.rope_scaling is not None:
        scale *= cfg.rope_scaling.softmax_factor
    return scale


def _latents(cfg, params, x, rope, dt):
    m = cfg.mla
    if m.q_lora_rank:
        cq = _proj(x, params["wq_a"], dt)
        cq = rmsnorm_nl(cq, cfg.norm_eps) * params["q_norm"].to(dt)
        q = _proj(cq, params["wq_b"], dt)                # (B, S, H, qk)
    else:
        q = _proj(x, params["wq"], dt)
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], rope)

    kv = _proj(x, params["wkv_a"], dt)
    ckv = rmsnorm_nl(kv[..., :m.kv_lora_rank], cfg.norm_eps) \
        * params["kv_norm"].to(dt)
    # the rope part has no head axis: rotated with one (the table is
    # (B, S, 1, rope/2)), which is dropped after
    krope = apply_rope(kv[:, :, None, m.kv_lora_rank:], rope)[:, :, 0]
    return q_nope, q_rope, ckv, krope


def mla_attention(cfg, params, x, *, positions, cache=None, shared=None):
    """Pre-norm'd x (B, S, D) -> (out, cache). ``cache``: this layer's
    {"ckv", "krope"}, updated in place (the same dict is returned), or
    None. ``shared``: :func:`shared_inputs` of the positions, if the
    caller made it once for all layers."""
    if shared is None:
        shared = shared_inputs(cfg, positions)
    dt = x.dtype
    m, H = cfg.mla, cfg.num_heads
    B, S, _ = x.shape
    q_nope, q_rope, ckv, krope = _latents(cfg, params, x, shared["rope"], dt)

    kv_valid_len = None
    if cache is not None:
        _update_cache(cache["ckv"], ckv, shared["cache_index"])
        _update_cache(cache["krope"], krope, shared["cache_index"])
        ckv, krope = cache["ckv"].to(dt), cache["krope"].to(dt)
        if S == 1:
            return _absorbed_decode(cfg, params, q_nope, q_rope, ckv, krope,
                                    positions, dt), cache
        kv_valid_len = shared["kv_valid_len"]

    # expand path
    Skv = ckv.shape[1]
    k_nope = _proj(ckv, params["wk_b"], dt)              # (B, Skv, H, nope)
    v = _proj(ckv, params["wv_b"], dt)                   # (B, Skv, H, v)
    k_rope = krope[:, :, None, :].expand(B, Skv, H, m.qk_rope_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope], dim=-1)
    # a scale of its own only under YaRN (the kernel's default is the
    # same float otherwise); a lone query without a cache attends to its
    # own key alone, whose weight is 1 at any scale
    scale = (softmax_scale(cfg) if cfg.rope_scaling is not None and S > 1
             else None)
    out = attention_core(cfg, q, k, v, q_positions=positions,
                         kv_valid_len=kv_valid_len, causal=True,
                         scale=scale)
    out = torch.matmul(out.reshape(B, S, H * m.v_head_dim),
                       params["wo"].to(dt).reshape(H * m.v_head_dim, -1))
    return out, cache


def _absorbed_decode(cfg, params, q_nope, q_rope, ckv, krope, positions,
                     dt):
    """Decode without decompressing: score against the latent directly.
    ckv (B, Skv, kv_lora), krope (B, Skv, rope) in the compute dtype;
    keys past positions[:, -1] are masked."""
    scale = softmax_scale(cfg)
    # fold W_k^b into q: (B,1,H,nope) x (lora,H,nope) -> (B,1,H,lora)
    q_abs = torch.einsum("bqhn,lhn->bqhl", q_nope, params["wk_b"].to(dt))
    s_l = torch.einsum("bqhl,bsl->bhqs", q_abs, ckv)
    s_r = torch.einsum("bqhr,bsr->bhqs", q_rope, krope)
    scores = (s_l + s_r).float() * scale
    kv_idx = torch.arange(ckv.shape[1], device=ckv.device)
    mask = kv_idx[None, :] <= positions[:, -1][:, None]       # (B, Skv)
    scores = torch.where(mask[:, None, None, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(dt)
    ctx = torch.einsum("bhqs,bsl->bqhl", w, ckv)              # latent context
    out = torch.einsum("bqhl,lhk->bqhk", ctx, params["wv_b"].to(dt))
    return torch.einsum("bqhk,hkd->bqd", out, params["wo"].to(dt))
