"""Plain float32 reference of a Granite-3.0 decoder (and any dense
pre-norm GQA decoder with RoPE and a SwiGLU FFN), for judging served
tokens. It imports nothing of the program and computes with the weights
the benchmark made, upcast to float32, TF32 off.

Weights, as ``weights``: {"embed": (vocab rows, d), "final_norm": (d,),
"layers": [{"input_norm", "q" (d, H*hd), "k", "v" (d, KV*hd), "o" (H*hd,
d), "post_norm", "gate", "up" (d, f), "down" (f, d)}]}, products taken
as ``x @ W``. The configuration ``m`` uses the Hugging Face names of
``granite`` configs, the multipliers included:

  x = embed[tokens] * embedding_multiplier
  per layer: x += o(attn(rope(q(n1(x))), rope(k(..)), v(..))) * residual_multiplier
             x += down(silu(gate(n2(x))) * up(n2(x))) * residual_multiplier
  logits = final_norm(x) @ embed[:vocab].T / logits_scaling

with scores scaled by ``attention_multiplier``, causal, query head h
reading KV head h // (H / KV), RoPE on the two halves of the head dim.

A sequence is computed whole (no cache), layer by layer, the attention
in blocks of query rows so that its scores fit beside the weights.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

QUERY_BLOCK = 1024


def linear_f32(x, w):
    return x @ w.float()


def _fp8(t, dim):
    """``t`` rounded to float8 e4m3, scaled by its largest magnitude
    along ``dim`` (per row of activations, per column of weights)."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / 448.0
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def linear_fp8(x, w):
    """The product with both operands rounded to float8 e4m3 first: the
    control's arithmetic, one precision below the configuration's bf16."""
    return _fp8(x, -1) @ _fp8(w.float(), 0)


def _rmsnorm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def _rope(x, cos, sin):
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(q, k, v, scale):
    """Causal attention of (S, H, hd) queries over (S, H, hd) keys and
    values, in blocks of query rows."""
    S = q.shape[0]
    out = torch.empty_like(q)
    for a in range(0, S, QUERY_BLOCK):
        b = min(a + QUERY_BLOCK, S)
        s = torch.einsum("qhd,khd->hqk", q[a:b], k[:b]) * scale
        mask = (torch.arange(b, device=q.device)[None, :]
                > torch.arange(a, b, device=q.device)[:, None])
        s.masked_fill_(mask[None], float("-inf"))
        out[a:b] = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1),
                                v[:b])
    return out


@torch.no_grad()
def logits_at(weights: dict, m: dict, tokens, at, linear=linear_f32):
    """Float32 logits over the real vocabulary at the positions ``at`` of
    the sequence ``tokens`` (1-D int), (len(at), vocab)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emb = weights["embed"]
    dev = emb.device
    tokens = torch.as_tensor(np.asarray(tokens), device=dev).long()
    S = tokens.shape[0]
    H, KV, hd = (m["num_attention_heads"], m["num_key_value_heads"],
                 m["head_dim"])
    eps, resid = m["rms_norm_eps"], m["residual_multiplier"]
    half = hd // 2
    inv = 1.0 / (m["rope_theta"] ** (torch.arange(half, device=dev,
                                                  dtype=torch.float32)
                                     / half))
    ang = torch.arange(S, device=dev, dtype=torch.float32)[:, None] * inv
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    x = emb[tokens].float() * m["embedding_multiplier"]
    for lw in weights["layers"]:
        h = _rmsnorm(x, lw["input_norm"], eps)
        q = _rope(linear(h, lw["q"]).view(S, H, hd), cos, sin)
        k = _rope(linear(h, lw["k"]).view(S, KV, hd), cos, sin)
        v = linear(h, lw["v"]).view(S, KV, hd)
        k = k.repeat_interleave(H // KV, dim=1)
        v = v.repeat_interleave(H // KV, dim=1)
        a = _attention(q, k, v, m["attention_multiplier"])
        x = x + linear(a.reshape(S, H * hd), lw["o"]) * resid
        h = _rmsnorm(x, lw["post_norm"], eps)
        x = x + linear(F.silu(linear(h, lw["gate"])) * linear(h, lw["up"]),
                       lw["down"]) * resid
    x = _rmsnorm(x[torch.as_tensor(at, device=dev)], weights["final_norm"],
                 eps)
    return linear(x, emb[:m["vocab_size"]].t()) / m["logits_scaling"]


def served_positions(prompt_len: int, served: int):
    """The positions whose logits chose each served token: the prompt's
    last, then each served token's but the last."""
    return list(range(prompt_len - 1, prompt_len - 1 + served))


def served_gaps(weights, m, prompt, served) -> np.ndarray:
    """For each served token, by how much its float32 logit lies below
    the float32 best at its position (0 where it is the best)."""
    seq = np.concatenate([np.asarray(prompt), np.asarray(served[:-1])])
    lg = logits_at(weights, m, seq, served_positions(len(prompt),
                                                     len(served)))
    tok = torch.as_tensor(np.asarray(served), device=lg.device).long()
    gap = lg.max(dim=-1).values - lg.gather(1, tok[:, None])[:, 0]
    return gap.cpu().numpy()


def control_gaps(weights, m, prompt, served, linear=linear_fp8):
    """The control's reading at the same positions: the float32 gap of
    the token that ``linear``'s arithmetic puts first."""
    seq = np.concatenate([np.asarray(prompt), np.asarray(served[:-1])])
    at = served_positions(len(prompt), len(served))
    low = logits_at(weights, m, seq, at, linear=linear).argmax(dim=-1)
    lg = logits_at(weights, m, seq, at)
    gap = lg.max(dim=-1).values - lg.gather(1, low[:, None])[:, 0]
    return gap.cpu().numpy()
