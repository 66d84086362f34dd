"""Common layers: RMSNorm, RoPE, embeddings, SwiGLU FFN and the modality
frontend stub (spec + apply).

Follows the JAX package's ``models/layers.py``. Weights arrive in the
compute dtype (cast at load, :mod:`.params`); ``.to(dt)`` below is then a
no-op, and casts float32 weights per use as the reference does. Plain
large products are ``torch.matmul``/``einsum``, as the reference leaves
them to XLA.

The model's norms (:func:`add_norm`) and its attention layers' RoPE and
cache writes run as the hand-written kernels of ``kernels/norm_rope``
where :func:`kernel_route` says so, and elsewhere as the plain
composition, which lives once, in ``kernels/norm_rope/ref.py``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import norm_rope
from repro_torch.models.params import ParamSpec


def kernel_route(cfg, *tensors) -> bool:
    """Whether the norm and RoPE kernels (``kernels/norm_rope``) take a
    call on ``tensors``: each on CUDA in a dtype they take, no gradient
    needed of any (grad mode off, or none requiring one), and
    ``cfg.attn_impl`` not "plain". Otherwise the plain composition runs:
    on the CPU, in training, and on the card's plain route."""
    if cfg.attn_impl == "plain" or (torch.is_grad_enabled() and any(
            t.requires_grad for t in tensors)):
        return False
    return all(t.is_cuda and t.dtype in norm_rope.DTYPES for t in tensors)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rmsnorm_specs(dim: int) -> dict:
    return {"scale": ParamSpec((dim,), (None,), init="ones")}


def add_norm(cfg, params, x, delta=None):
    """(s, RMSNorm of s with ``cfg.norm_eps``), s = x + delta in x's dtype
    (x itself where delta is None): a block's residual add and the norm
    after it, one launch of the rmsnorm kernel where :func:`kernel_route`
    allows, else ``norm_rope.rmsnorm_ref`` (normalized in float32, scaled
    by the float32 scale, cast back)."""
    scale = params["scale"]
    tensors = (x, scale) if delta is None else (x, delta, scale)
    if kernel_route(cfg, *tensors) and scale.dtype in (torch.float32,
                                                       x.dtype):
        return norm_rope.rmsnorm(x, scale, cfg.norm_eps, delta)
    return norm_rope.rmsnorm_ref(x, scale, cfg.norm_eps, delta)


def rmsnorm_nl(x, eps: float = 1e-5):
    """Un-learned rmsnorm (qk-norm without scale)."""
    dt = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None, scaling=None):
    """The rotary frequencies of the ``head_dim / 2`` pairs; with
    ``scaling`` (a ``configs.YaRNConfig``) YaRN's: the original ones
    below its ramp, divided by its factor above it, blended linearly in
    between, as DeepSeek-V2's ``DeepseekV2YarnRotaryEmbedding``."""
    half = head_dim // 2
    inv = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                        device=device) / half))
    if scaling is None:
        return inv
    low, high = scaling.ramp(head_dim, theta)
    ramp = ((torch.arange(half, dtype=torch.float32, device=device) - low)
            / ((high - low) or 0.001)).clamp(0, 1)
    return inv / scaling.factor * ramp + inv * (1 - ramp)


def rope_table(positions, head_dim: int, theta: float, scaling=None):
    """(cos, sin) of the rotation angles for ``positions`` (B, S), each
    (B, S, 1, hd/2) float32 — the same for every layer of a forward
    pass, which makes it once. ``scaling``: YaRN's (:func:`rope_freqs`),
    whose cos and sin are multiplied by its ``cos_sin_factor`` unless
    that is 1."""
    inv = rope_freqs(head_dim, theta, positions.device, scaling)
    ang = (positions.float()[..., None] * inv)[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    if scaling is not None and scaling.cos_sin_factor != 1.0:
        cos, sin = cos * scaling.cos_sin_factor, sin * scaling.cos_sin_factor
    return cos, sin


# x: (B, S, H, hd) rotated by the angles of a :func:`rope_table`: the two
# halves of the head dim rotated together, in float32, cast back
apply_rope = norm_rope.rope_ref


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed_specs(vocab: int, d_model: int, tie: bool) -> dict:
    s = {"tok": ParamSpec((vocab, d_model), ("vocab", "embed"), scale=0.02)}
    if not tie:
        s["unembed"] = ParamSpec((d_model, vocab), ("embed", "vocab"),
                                 scale=0.02)
    return s


def embed(params, tokens, compute_dtype):
    return params["tok"].to(compute_dtype)[tokens]


def unembed(params, x, tie: bool):
    w = params["tok"].t() if tie else params["unembed"]
    return torch.matmul(x, w.to(x.dtype))


# ---------------------------------------------------------------------------
# SwiGLU dense FFN
# ---------------------------------------------------------------------------

def ffn_specs(d_model: int, d_ff: int) -> dict:
    return {
        "w_gate": ParamSpec((d_model, d_ff), ("embed", "mlp")),
        "w_up":   ParamSpec((d_model, d_ff), ("embed", "mlp")),
        "w_down": ParamSpec((d_ff, d_model), ("mlp", "embed")),
    }


def ffn(params, x):
    """SwiGLU. x: (B, S, D)."""
    dt = x.dtype
    g = torch.matmul(x, params["w_gate"].to(dt))
    u = torch.matmul(x, params["w_up"].to(dt))
    return torch.matmul(F.silu(g) * u, params["w_down"].to(dt))


# ---------------------------------------------------------------------------
# Modality frontend stub (VLM patches / audio frames)
# ---------------------------------------------------------------------------

def frontend_specs(raw_dim: int, d_model: int) -> dict:
    return {"proj": ParamSpec((raw_dim, d_model), ("vis_dim", "embed"),
                              scale=0.02)}


def frontend(params, raw_embeds, compute_dtype):
    """raw (B, T, raw_dim) precomputed patch/frame embeddings -> (B, T, D)."""
    return torch.matmul(raw_embeds.to(compute_dtype),
                        params["proj"].to(compute_dtype))
