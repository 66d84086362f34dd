"""Block-pattern LM of the port, following the JAX package's
``models/model.py``: per block

    x += mixer(norm(x))     mixer: attn (the only one ported yet)
    x += ffn(norm(x))       ffn:   dense SwiGLU (the only one ported yet)

The reference stacks its repeated unit on a leading "layers" axis and
runs it with ``lax.scan``; the port keeps one param dict and one cache
dict per layer (``params["layers"][i]``, ``cache["layers"][i]``) and
loops over them. Other mixers (mla, cross, mamba, rwkv) and FFNs (moe,
rwkv) raise ``NotImplementedError`` until their slice is ported.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.models.params import ParamSpec

_PORTED = ("attn", "dense")


def _check_ported(cfg) -> list:
    specs = cfg.layer_specs()
    for i, (mixer, ffn_kind) in enumerate(specs):
        if mixer != "attn" or ffn_kind != "dense":
            raise NotImplementedError(
                f"{cfg.name}: layer {i} is ({mixer!r}, {ffn_kind!r}); the "
                f"port runs {_PORTED} blocks only so far (ROADMAP Queue 1 "
                "item 7: MLA, MoE, mamba, rwkv and cross attention)")
    if cfg.vision is not None or cfg.family == "audio":
        raise NotImplementedError(
            f"{cfg.name}: modality frontends are not ported yet (ROADMAP "
            "Queue 1 item 7)")
    return specs


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

def _block_specs(cfg, ff_width: int) -> dict:
    d = cfg.d_model
    return {"norm1": L.rmsnorm_specs(d), "norm2": L.rmsnorm_specs(d),
            "mixer": attn_mod.attn_specs(cfg),
            "ffn": L.ffn_specs(d, ff_width)}


def model_specs(cfg) -> dict:
    specs = _check_ported(cfg)
    return {"embed": L.embed_specs(cfg.padded_vocab, cfg.d_model,
                                   cfg.tie_embeddings),
            "final_norm": L.rmsnorm_specs(cfg.d_model),
            "layers": [_block_specs(cfg, cfg.dense_ff_for(i))
                       for i in range(len(specs))]}


def cache_specs(cfg, batch: int, max_len: int,
                cache_dtype=torch.bfloat16) -> dict:
    """{"layers": [{"k", "v"} ParamSpecs of (batch, max_len, KV, hd)]},
    zero-initialized, in ``cache_dtype`` (bf16, as the reference)."""
    specs = _check_ported(cfg)
    out = []
    for _ in specs:
        raw = attn_mod.attn_cache_specs(cfg, batch, max_len)
        out.append({k: ParamSpec(tuple(shape), tuple(axes), init="zeros",
                                 dtype=cache_dtype)
                    for k, (shape, axes) in raw.items()})
    return {"layers": out}


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------

def _apply_block(cfg, params, x, *, positions, cache, shared):
    h = L.rmsnorm(params["norm1"], x, cfg.norm_eps)
    out, cache = attn_mod.attention(cfg, params["mixer"], h,
                                    positions=positions, cache=cache,
                                    shared=shared)
    x = x + out
    h2 = L.rmsnorm(params["norm2"], x, cfg.norm_eps)
    return x + L.ffn(params["ffn"], h2), cache


@torch.no_grad()
def forward(cfg, params, batch, *, cache=None):
    """Forward pass.

    batch: {"tokens": (B,S) int, "positions": (B,S) int absolute}.
    cache: a cache tree (``cache_specs``), written in place, or None.
    Returns (hidden (B,S,D) after the final norm, cache, aux_loss) — the
    reference's triple; aux_loss is 0 for dense models.
    """
    _check_ported(cfg)
    cdt = getattr(torch, cfg.compute_dtype)
    positions = batch["positions"]
    x = L.embed(params["embed"], batch["tokens"], cdt)
    shared = attn_mod.shared_inputs(cfg, positions)
    for i, p in enumerate(params["layers"]):
        c = cache["layers"][i] if cache is not None else None
        x, _ = _apply_block(cfg, p, x, positions=positions, cache=c,
                            shared=shared)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return x, cache, torch.zeros((), dtype=torch.float32, device=x.device)


def logits_from_hidden(cfg, params, x, last_only: bool = False):
    if last_only:
        x = x[:, -1:, :]
    return L.unembed(params["embed"], x, cfg.tie_embeddings)
