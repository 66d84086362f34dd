"""Common layers: RMSNorm, RoPE, embeddings, SwiGLU FFN and the modality
frontend stub (spec + apply).

Follows the JAX package's ``models/layers.py``. Weights arrive in the
compute dtype (cast at load, :mod:`.params`); ``.to(dt)`` below is then a
no-op, and casts float32 weights per use as the reference does. Plain
large products are ``torch.matmul``/``einsum``, as the reference leaves
them to XLA.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.params import ParamSpec


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rmsnorm_specs(dim: int) -> dict:
    return {"scale": ParamSpec((dim,), (None,), init="ones")}


def rmsnorm(params, x, eps: float = 1e-5):
    """Normalized in float32, scaled by the float32 scale, cast back."""
    dt = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(dt)


def rmsnorm_nl(x, eps: float = 1e-5):
    """Un-learned rmsnorm (qk-norm without scale)."""
    dt = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def rope_table(positions, head_dim: int, theta: float):
    """(cos, sin) of the rotation angles for ``positions`` (B, S), each
    (B, S, 1, hd/2) float32 — the same for every layer of a forward
    pass, which makes it once."""
    inv = rope_freqs(head_dim, theta, positions.device)     # (hd/2,)
    ang = (positions.float()[..., None] * inv)[..., None, :]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, table):
    """x: (B, S, H, hd) rotated by the angles of ``table`` (its
    :func:`rope_table`): the two halves of the head dim are rotated
    together (not interleaved pairs), in float32, and cast back."""
    cos, sin = table
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


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
