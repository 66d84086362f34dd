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

Where no gradient is needed and ``layers.kernel_route`` takes the
tensors (the card, ``attn_impl`` "kernel"), each norm and the residual
add before it are one launch of the rmsnorm kernel (``layers.add_norm``):
a block hands its FFN output to the next block's first norm, the last
block to the final norm.

Training: ``forward`` is differentiable, and each block runs under the
config's activation checkpointing (:func:`_maybe_remat`); the loss is
:func:`lm_loss_fused`. The reference's ``cast_big_params`` casts the
large float32 weights to the compute dtype before its FSDP all-gather;
the port's layers cast each weight at its use (``.to(dt)``), which is
the same bf16 product, with the weight's gradient cast back to float32
by autograd. On one device nothing else is left of it, so it is not
copied.
"""
from __future__ import annotations

import functools

import torch
import torch.utils.checkpoint as ckpt

from repro_torch.core.spans import span
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.params import ParamSpec, tree_leaves

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
                 vision, moe_impl, delta=None):
    """One block; returns (x after the mixer's residual, the FFN's output,
    MoE aux loss or None): the block's output is their sum, which the
    caller adds, or hands the next block (or the final norm) as its
    ``delta``, to be added with the norm after it in one launch."""
    mixer, ffn_kind = spec
    x, h = L.add_norm(cfg, params["norm1"], x, delta)
    if mixer == "attn":
        with span("repro_torch.model.attn"):
            out, cache = attn_mod.attention(cfg, params["mixer"], h,
                                            positions=positions,
                                            cache=cache,
                                            shared=shared[mixer])
    elif mixer == "cross":
        out, cache = attn_mod.cross_attention(cfg, params["mixer"], h,
                                              positions=positions,
                                              cache=cache, vision=vision)
    elif mixer == "mla":
        with span("repro_torch.model.mla"):
            out, cache = mla_mod.mla_attention(cfg, params["mixer"], h,
                                               positions=positions,
                                               cache=cache,
                                               shared=shared[mixer])
    elif mixer == "mamba":
        with span("repro_torch.model.mamba"):
            out, cache = mamba_mod.mamba(cfg, params["mixer"], h,
                                         cache=cache)
    else:
        out, cache = rwkv_mod.time_mix(cfg, params["mixer"], h, cache=cache)
    x, h2 = L.add_norm(cfg, params["norm2"], x, out)
    aux = None
    if ffn_kind == "dense":
        out2 = L.ffn(params["ffn"], h2)
    elif ffn_kind == "moe":
        with span("repro_torch.model.moe"):
            out2, aux = moe_mod.moe(cfg, params["ffn"], h2, impl=moe_impl)
    else:
        out2, cache = rwkv_mod.channel_mix(cfg, params["ffn"], h2,
                                           cache=cache)
    return x, out2, aux


def _block(cfg, spec, params, x, **kw):
    """One block's output, x + the FFN's output, and its aux loss."""
    x, out2, aux = _apply_block(cfg, spec, params, x, **kw)
    return x + out2, aux


# the products whose outputs remat "dots" keeps: matrix products with no
# batch dims, as the reference's checkpoint_dots_with_no_batch_dims
# policy (a (B,S,D) @ (D,F) matmul runs as one mm; attention's batched
# einsums run as bmm and are recomputed)
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _maybe_remat(cfg, fn):
    """``fn`` under the config's activation checkpointing, the
    reference's ``_maybe_remat`` per block: "none" as it is; "full"
    recomputes the block's forward in the backward
    (``torch.utils.checkpoint``); "comm" keeps what "full" keeps on one
    device (the reference's saved ``block_out`` is a block's output,
    which "full" keeps as the next block's input); "dots" recomputes all
    but the outputs of the matrix products with no batch dims (selective
    activation checkpointing). The gradients are the same in every mode.
    ``fn(params, x)`` runs as it is where no gradient is needed (grad
    mode off, or neither ``x`` nor a leaf of ``params`` requiring one):
    checkpointing would only intercept every operation."""
    if cfg.remat == "none":
        return fn
    if cfg.remat not in ("dots", "comm", "full"):
        raise ValueError(f"remat {cfg.remat!r}: none, dots, comm or full")

    def run(params, x):
        if not _needs_grad(params, x):
            return fn(params, x)
        if cfg.remat == "dots":
            return ckpt.checkpoint(
                fn, params, x, use_reentrant=False,
                context_fn=functools.partial(
                    ckpt.create_selective_checkpoint_contexts, _dots_policy))
        return ckpt.checkpoint(fn, params, x, use_reentrant=False)
    return run


def _needs_grad(params, *tensors) -> bool:
    """Grad mode on and a tensor of ``tensors`` or a leaf of ``params``
    requiring a gradient."""
    return torch.is_grad_enabled() and (
        any(t.requires_grad for t in tensors)
        or any(t.requires_grad for t in tree_leaves(params)))


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

    Differentiable in the params (a train step marks its masters
    trainable and passes no cache); the serving steps run it under
    ``torch.no_grad()``. Each block runs under :func:`_maybe_remat`.
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
    # on the kernels' route a block's closing residual add rides in the
    # next norm's launch; elsewhere each block adds it, under its remat
    fused = L.kernel_route(cfg, x) and not _needs_grad(params, x)
    delta = None
    for i, (sp, p) in enumerate(zip(specs, params["layers"])):
        c = cache["layers"][i] if cache is not None else None
        kw = dict(positions=positions, cache=c, shared=shared, vision=vision,
                  moe_impl=moe_impl)
        if fused:
            x, delta, aux = _apply_block(cfg, sp, p, x, delta=delta, **kw)
        else:
            x, aux = _maybe_remat(cfg, functools.partial(_block, cfg, sp,
                                                         **kw))(p, x)
        if aux is not None:
            aux_total = aux_total + aux
    _, x = L.add_norm(cfg, params["final_norm"], x, delta)
    return x, cache, aux_total


def logits_from_hidden(cfg, params, x, last_only: bool = False):
    if last_only:
        x = x[:, -1:, :]
    return L.unembed(params["embed"], x, cfg.tie_embeddings)


def lm_loss_fused(cfg, params, x, targets, chunk: int = 512):
    """Fused unembed + cross-entropy, the reference's ``lm_loss_fused``:
    chunked over ``chunk`` positions (the whole sequence where ``chunk``
    does not divide it), each chunk checkpointed, so the (B, S, padded
    vocab) logits are never built; the padded vocab columns masked to
    -1e30; tied or untied unembedding. x: (B,S,D) hidden after the final
    norm; targets (B,S) int. Returns the mean loss, float32."""
    B, S, D = x.shape
    vp = cfg.padded_vocab
    w = (params["embed"]["tok"].t() if cfg.tie_embeddings
         else params["embed"]["unembed"])
    chunk = min(chunk, S)
    if S % chunk != 0:
        chunk = S
    targets = targets.long()

    def body(xc, tc, w):
        lf = torch.matmul(xc, w.to(xc.dtype)).float()
        if vp != cfg.vocab_size:
            keep = torch.arange(vp, device=lf.device) < cfg.vocab_size
            lf = torch.where(keep, lf, -1e30)
        lse = torch.logsumexp(lf, dim=-1)
        tgt = torch.gather(lf, -1, tc[..., None])[..., 0]
        return torch.sum(lse - tgt)

    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = _needs_grad({}, x, w)
    for c in range(S // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        if remat:
            part = ckpt.checkpoint(body, x[:, sl], targets[:, sl], w,
                                   use_reentrant=False)
        else:
            part = body(x[:, sl], targets[:, sl], w)
        tot = tot + part
    return tot / (B * S)


def lm_loss(cfg, logits, targets):
    """Cross-entropy of (B,S,padded vocab) logits, the padded columns
    masked to -1e30, as the reference's ``lm_loss``."""
    lf = logits.float()
    vp = cfg.padded_vocab
    if vp != cfg.vocab_size:
        keep = torch.arange(vp, device=lf.device) < cfg.vocab_size
        lf = torch.where(keep, lf, -1e30)
    lse = torch.logsumexp(lf, dim=-1)
    tgt = torch.gather(lf, -1, targets.long()[..., None])[..., 0]
    return torch.mean(lse - tgt)
