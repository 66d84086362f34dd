"""Block-pattern LM of the port, following the JAX package's
``models/model.py``: per block

    x += mixer(norm(x))     mixer: attn, rwkv time-mix
    x += ffn(norm(x))       ffn:   dense SwiGLU, rwkv channel-mix

The reference stacks its repeated unit on a leading "layers" axis and
runs it with ``lax.scan``; the port keeps one param dict and one cache
dict per layer (``params["layers"][i]``, ``cache["layers"][i]``) and
loops over them. Blocks other than (attn, dense) and (rwkv, rwkv) — MLA,
MoE, mamba and cross attention — raise ``NotImplementedError`` until
their slice is ported.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.params import ParamSpec

_PORTED = (("attn", "dense"), ("rwkv", "rwkv"))


def _check_ported(cfg) -> list:
    specs = cfg.layer_specs()
    for i, spec in enumerate(specs):
        if tuple(spec) not in _PORTED:
            raise NotImplementedError(
                f"{cfg.name}: layer {i} is {tuple(spec)!r}; the port runs "
                f"{_PORTED} blocks only so far (ROADMAP Queue 1 item 7: "
                "MLA, MoE, mamba and cross attention)")
    if cfg.vision is not None or cfg.family == "audio":
        raise NotImplementedError(
            f"{cfg.name}: modality frontends are not ported yet (ROADMAP "
            "Queue 1 item 7)")
    return specs


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

def _block_specs(cfg, spec, ff_width: int) -> dict:
    d = cfg.d_model
    s = {"norm1": L.rmsnorm_specs(d), "norm2": L.rmsnorm_specs(d)}
    if spec[0] == "attn":
        s["mixer"] = attn_mod.attn_specs(cfg)
        s["ffn"] = L.ffn_specs(d, ff_width)
    else:
        s["mixer"] = rwkv_mod.timemix_specs(cfg)
        s["ffn"] = rwkv_mod.channelmix_specs(cfg)
    return s


def model_specs(cfg) -> dict:
    specs = _check_ported(cfg)
    return {"embed": L.embed_specs(cfg.padded_vocab, cfg.d_model,
                                   cfg.tie_embeddings),
            "final_norm": L.rmsnorm_specs(cfg.d_model),
            "layers": [_block_specs(cfg, sp, cfg.dense_ff_for(i))
                       for i, sp in enumerate(specs)]}


def cache_specs(cfg, batch: int, max_len: int,
                cache_dtype=torch.bfloat16) -> dict:
    """{"layers": [per-layer ParamSpecs]}, zero-initialized: an attention
    layer's {"k", "v"} of (batch, max_len, KV, hd) in ``cache_dtype``
    (bf16, as the reference); an rwkv layer's {"shift_t", "shift_c"}
    (batch, D) in ``cache_dtype`` and {"wkv"} (batch, H, hd, hd) float32,
    as the reference's ``_block_cache_specs``. Leaves with a "kv_seq"
    axis hold rows per position; the others hold a sequence's state."""
    specs = _check_ported(cfg)
    out = []
    for mixer, _ in specs:
        raw = (attn_mod.attn_cache_specs(cfg, batch, max_len)
               if mixer == "attn" else rwkv_mod.rwkv_cache_specs(cfg, batch))
        out.append({k: ParamSpec(tuple(shape), tuple(axes), init="zeros",
                                 dtype=torch.float32 if k == "wkv"
                                 else cache_dtype)
                    for k, (shape, axes) in raw.items()})
    return {"layers": out}


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------

def _apply_block(cfg, spec, params, x, *, positions, cache, shared):
    h = L.rmsnorm(params["norm1"], x, cfg.norm_eps)
    if spec[0] == "attn":
        out, cache = attn_mod.attention(cfg, params["mixer"], h,
                                        positions=positions, cache=cache,
                                        shared=shared)
    else:
        out, cache = rwkv_mod.time_mix(cfg, params["mixer"], h, cache=cache)
    x = x + out
    h2 = L.rmsnorm(params["norm2"], x, cfg.norm_eps)
    if spec[1] == "dense":
        return x + L.ffn(params["ffn"], h2), cache
    out2, cache = rwkv_mod.channel_mix(cfg, params["ffn"], h2, cache=cache)
    return x + out2, cache


@torch.no_grad()
def forward(cfg, params, batch, *, cache=None):
    """Forward pass.

    batch: {"tokens": (B,S) int, "positions": (B,S) int absolute}.
    cache: a cache tree (``cache_specs``), written in place, or None.
    Returns (hidden (B,S,D) after the final norm, cache, aux_loss) — the
    reference's triple; aux_loss is 0 (no MoE layer is ported).
    """
    specs = _check_ported(cfg)
    cdt = getattr(torch, cfg.compute_dtype)
    positions = batch["positions"]
    x = L.embed(params["embed"], batch["tokens"], cdt)
    shared = (attn_mod.shared_inputs(cfg, positions)
              if any(sp[0] == "attn" for sp in specs) else None)
    for i, (sp, p) in enumerate(zip(specs, params["layers"])):
        c = cache["layers"][i] if cache is not None else None
        x, _ = _apply_block(cfg, sp, p, x, positions=positions, cache=c,
                            shared=shared)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return x, cache, torch.zeros((), dtype=torch.float32, device=x.device)


def logits_from_hidden(cfg, params, x, last_only: bool = False):
    if last_only:
        x = x[:, -1:, :]
    return L.unembed(params["embed"], x, cfg.tie_embeddings)
