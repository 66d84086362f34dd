"""Block-pattern LM of the port, following the JAX package's
``models/model.py``: per block

    x += mixer(norm(x))     mixer: attn, cross, mla, mamba, rwkv time-mix
    x += ffn(norm(x))       ffn:   dense SwiGLU, MoE, rwkv channel-mix

mixer and FFN dispatched independently, as the reference's
``_block_specs`` and ``_apply_block`` do. The reference stacks its
repeated unit on a leading "layers" axis and runs it with ``lax.scan``;
the port keeps one param dict and one cache dict per layer
(``params["layers"][i]``, ``cache["layers"][i]``) and loops over them.
A config with a ``vision`` stub has the modality frontend
(``params["frontend"]``): a vlm's cross layers attend to its projection
of ``batch["vision"]``, an audio model's input is its projection of
``batch["frames"]``.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.params import ParamSpec

# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

def _block_specs(cfg, spec, ff_width: int) -> dict:
    mixer, ffn_kind = spec
    d = cfg.d_model
    s = {"norm1": L.rmsnorm_specs(d), "norm2": L.rmsnorm_specs(d)}
    if mixer == "attn":
        s["mixer"] = attn_mod.attn_specs(cfg)
    elif mixer == "cross":
        s["mixer"] = attn_mod.attn_specs(cfg, cross=True)
    elif mixer == "mla":
        s["mixer"] = mla_mod.mla_specs(cfg)
    elif mixer == "mamba":
        s["mixer"] = mamba_mod.mamba_specs(cfg)
    else:
        s["mixer"] = rwkv_mod.timemix_specs(cfg)
    if ffn_kind == "dense":
        s["ffn"] = L.ffn_specs(d, ff_width)
    elif ffn_kind == "moe":
        s["ffn"] = moe_mod.moe_specs(cfg)
    elif ffn_kind == "rwkv":
        s["ffn"] = rwkv_mod.channelmix_specs(cfg)
    else:
        raise ValueError(ffn_kind)
    return s


def model_specs(cfg) -> dict:
    specs = {"embed": L.embed_specs(cfg.padded_vocab, cfg.d_model,
                                    cfg.tie_embeddings),
             "final_norm": L.rmsnorm_specs(cfg.d_model)}
    if cfg.vision is not None:
        specs["frontend"] = L.frontend_specs(cfg.vision.raw_dim, cfg.d_model)
    specs["layers"] = [_block_specs(cfg, sp, cfg.dense_ff_for(i))
                       for i, sp in enumerate(cfg.layer_specs())]
    return specs


def cache_specs(cfg, batch: int, max_len: int,
                cache_dtype=torch.bfloat16) -> dict:
    """{"layers": [per-layer ParamSpecs]}, zero-initialized, as the
    reference's ``_block_cache_specs``: an attention layer's {"k", "v"}
    of (batch, max_len, KV, hd) in ``cache_dtype`` (bf16, as the
    reference); an mla layer's {"ckv"} (batch, max_len, kv_lora) and
    {"krope"} (batch, max_len, rope_dim) in ``cache_dtype``; a mamba
    layer's {"conv"} (batch, d_conv - 1, d_inner) in
    ``cache_dtype`` and {"ssm"} (batch, d_inner, d_state) float32; an
    rwkv layer's {"shift_t", "shift_c"} (batch, D) in ``cache_dtype`` and
    {"wkv"} (batch, H, hd, hd) float32; a cross layer's {"ck", "cv"}
    (batch, vision tokens, KV, hd) in ``cache_dtype``. Leaves with a
    "kv_seq" axis hold rows per position; the others hold a sequence's
    state."""
    out = []
    for mixer, _ in cfg.layer_specs():
        if mixer == "attn":
            raw = attn_mod.attn_cache_specs(cfg, batch, max_len)
        elif mixer == "cross":
            raw = attn_mod.attn_cache_specs(
                cfg, batch, max_len, cross=True,
                n_vis=cfg.vision.num_tokens if cfg.vision else 0)
        elif mixer == "mla":
            raw = mla_mod.mla_cache_specs(cfg, batch, max_len)
        elif mixer == "mamba":
            raw = mamba_mod.mamba_cache_specs(cfg, batch)
        else:
            raw = rwkv_mod.rwkv_cache_specs(cfg, batch)
        out.append({k: ParamSpec(tuple(shape), tuple(axes), init="zeros",
                                 dtype=torch.float32 if k in ("ssm", "wkv")
                                 else cache_dtype)
                    for k, (shape, axes) in raw.items()})
    return {"layers": out}


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------

def _apply_block(cfg, spec, params, x, *, positions, cache, shared,
                 vision, moe_impl):
    """One block; returns (x, cache, MoE aux loss or None)."""
    mixer, ffn_kind = spec
    h = L.rmsnorm(params["norm1"], x, cfg.norm_eps)
    if mixer == "attn":
        out, cache = attn_mod.attention(cfg, params["mixer"], h,
                                        positions=positions, cache=cache,
                                        shared=shared[mixer])
    elif mixer == "cross":
        out, cache = attn_mod.cross_attention(cfg, params["mixer"], h,
                                              positions=positions,
                                              cache=cache, vision=vision)
    elif mixer == "mla":
        out, cache = mla_mod.mla_attention(cfg, params["mixer"], h,
                                           positions=positions, cache=cache,
                                           shared=shared[mixer])
    elif mixer == "mamba":
        out, cache = mamba_mod.mamba(cfg, params["mixer"], h, cache=cache)
    else:
        out, cache = rwkv_mod.time_mix(cfg, params["mixer"], h, cache=cache)
    x = x + out
    h2 = L.rmsnorm(params["norm2"], x, cfg.norm_eps)
    aux = None
    if ffn_kind == "dense":
        out2 = L.ffn(params["ffn"], h2)
    elif ffn_kind == "moe":
        out2, aux = moe_mod.moe(cfg, params["ffn"], h2, impl=moe_impl)
    else:
        out2, cache = rwkv_mod.channel_mix(cfg, params["ffn"], h2,
                                           cache=cache)
    return x + out2, cache, aux


@torch.no_grad()
def forward(cfg, params, batch, *, cache=None, moe_impl: str = "gshard"):
    """Forward pass.

    batch: {"tokens": (B,S) int, "positions": (B,S) int absolute}, and
    for a vlm "vision" (B,T_vis,raw_dim) patch embeddings (needed where a
    cross layer has no cached vision K/V: without a cache, and at
    prefill), for an audio model "frames" (B,S,raw_dim) frame embeddings
    (then "tokens" is optional and, if given, its embedding is added).
    cache: a cache tree (``cache_specs``), written in place, or None.
    moe_impl: the MoE layers' implementation (:func:`.moe.moe`), the
    reference's default "gshard".
    Returns (hidden (B,S,D) after the final norm, cache, aux_loss) — the
    reference's triple; aux_loss (float32) sums the MoE layers' load-
    balance losses, 0 without one.
    """
    specs = cfg.layer_specs()
    cdt = getattr(torch, cfg.compute_dtype)
    positions = batch["positions"]
    if "frames" in batch and cfg.family == "audio":
        x = (L.frontend(params["frontend"], batch["frames"], cdt)
             if "frontend" in params else batch["frames"].to(cdt))
        if "tokens" in batch:   # decode continues from generated tokens
            x = x + L.embed(params["embed"], batch["tokens"], cdt)
    else:
        x = L.embed(params["embed"], batch["tokens"], cdt)
    vision = None
    if cfg.vision is not None and "vision" in batch:
        vision = L.frontend(params["frontend"], batch["vision"], cdt)
    # what the attention layers derive from the positions alone, once
    mixers = {sp[0] for sp in specs}
    shared = {}
    if "attn" in mixers:
        shared["attn"] = attn_mod.shared_inputs(cfg, positions)
    if "mla" in mixers:
        shared["mla"] = mla_mod.shared_inputs(cfg, positions)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, (sp, p) in enumerate(zip(specs, params["layers"])):
        c = cache["layers"][i] if cache is not None else None
        x, _, aux = _apply_block(cfg, sp, p, x, positions=positions,
                                 cache=c, shared=shared, vision=vision,
                                 moe_impl=moe_impl)
        if aux is not None:
            aux_total = aux_total + aux
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return x, cache, aux_total


def logits_from_hidden(cfg, params, x, last_only: bool = False):
    if last_only:
        x = x[:, -1:, :]
    return L.unembed(params["embed"], x, cfg.tie_embeddings)
