"""Plain float32 reference of a DeepSeek-V2 decoder (DeepSeek-V2-Lite's
block: multi-head latent attention, with or without query compression,
YaRN RoPE, a fine-grained MoE beside shared experts), for judging served
tokens. It imports nothing of the program and computes with the weights
the benchmark made, each matrix upcast to float32 only where it is used
(one layer, and within an MoE layer one expert, at a time), TF32 off.

The configuration ``m`` uses the Hugging Face names of ``deepseek_v2``
configs (``q_lora_rank``, ``kv_lora_rank``, ``qk_nope_head_dim``,
``qk_rope_head_dim``, ``v_head_dim``, ``rope_scaling``,
``first_k_dense_replace``, ``n_routed_experts``, ``n_shared_experts``,
``num_experts_per_tok``, ``moe_intermediate_size``, ``norm_topk_prob``,
``routed_scaling_factor``). Pre-norm blocks, as the published
``modeling_deepseek.py``:

  x = embed[tokens]
  per layer: x += mla(rmsnorm(x)),  x += ffn(rmsnorm(x))
  logits = rmsnorm(x) @ lm_head                     (untied head)

  * MLA on the expand path over the whole sequence: q = h Wq (one
    projection where ``q_lora_rank`` is null, else q = rmsnorm(h Wq_a)
    Wq_b), (H, nope + rope) a token; [c_kv | k_rope] = h W_kv_a, c_kv
    RMS-normed with its scale; [k_nope | v] = c_kv W_kv_b, (H, nope + v)
    a token; q's and k's rope parts rotated (k_rope shared by every
    head); causal softmax attention of [q_nope | q_rope] over [k_nope |
    k_rope] scaled by (nope + rope)^-1/2 x mscale^2, mscale = 1 + 0.1 x
    mscale_all_dim x ln(factor); o = attn W_o;
  * RoPE with YaRN (``rope_scaling`` type "yarn") on the rope part of
    width r: extra_i = theta^(-2i/r), inter_i = extra_i / factor, the
    ramp r_i = clamp((i - low) / (high - low), 0, 1) with low =
    floor(c(beta_fast)), high = ceil(c(beta_slow)), c(b) = r ln(orig /
    (2 pi b)) / (2 ln theta), inv_freq_i = inter_i r_i + extra_i (1 -
    r_i); cos and sin times mscale(mscale) / mscale(mscale_all_dim);
  * FFN: SwiGLU (width ``intermediate_size``) on the first
    ``first_k_dense_replace`` layers; elsewhere the MoE: softmax over
    the router's ``n_routed_experts`` logits, the ``num_experts_per_tok``
    largest taken greedily, weighting their experts' SwiGLU outputs (of
    width ``moe_intermediate_size``) as they are, or divided by their
    sum where ``norm_topk_prob``, times ``routed_scaling_factor``; plus
    the ``n_shared_experts`` shared experts as one SwiGLU of their summed
    width, unweighted.

Departures from the published model: none in the function computed. The
rope part's pairs are (i, i + r/2), not the published code's interleaved
(2i, 2i + 1): a fixed permutation of the rope columns of W_q and
W_kv_a, the program's layout, which the benchmark's random weights do
not tell apart. The RMSNorm multiplies by its scale in float32 before
any cast (in float32 the published order is the same). A sequence is
computed whole (no cache), layer by layer, the attention in blocks of
query rows.

Weights, as ``weights``: {"embed": (vocab rows, d), "lm_head": (d,
vocab cols), "final_norm": (d,), "layers": [{"input_norm",
"post_norm", "attn": {"q" (d, H*(nope+rope)) or "q_a" (d, q_lora),
"q_norm", "q_b" (q_lora, H*(nope+rope)); "kv_a" (d, kv_lora + rope),
"kv_norm" (kv_lora,), "kv_b" (kv_lora, H*(nope+v)), "o" (H*v, d)},
"ffn": {"gate", "up" (d, f), "down" (f, d)} or {"router" (d, E), "gate",
"up" (E, d, f), "down" (E, f, d), "shared": {"gate", "up", "down"}}}]};
products taken as ``x @ W``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from stbench.reference.granite import (QUERY_BLOCK, _rope, linear_f32,
                                       linear_fp8, served_positions)


def _rmsnorm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def _yarn_mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def yarn_ramp(m: dict) -> tuple:
    """(low, high) of YaRN's ramp over the rope part's frequencies."""
    y, r = m["rope_scaling"], m["qk_rope_head_dim"]
    theta, orig = m["rope_theta"], y["original_max_position_embeddings"]

    def c(b):
        return r * math.log(orig / (2 * math.pi * b)) / (2 * math.log(theta))
    return (max(math.floor(c(y["beta_fast"])), 0),
            min(math.ceil(c(y["beta_slow"])), r - 1))


def softmax_scale(m: dict) -> float:
    """(nope + rope)^-1/2, times YaRN's mscale(mscale_all_dim)^2."""
    scale = (m["qk_nope_head_dim"] + m["qk_rope_head_dim"]) ** -0.5
    y = m.get("rope_scaling")
    if y and y.get("mscale_all_dim"):
        scale *= _yarn_mscale(y["factor"], y["mscale_all_dim"]) ** 2
    return scale


def rope_cos_sin(m: dict, S: int, dev):
    """cos and sin of the rope part's angles at positions 0 .. S - 1,
    (S, 1, r/2) float32."""
    r, theta = m["qk_rope_head_dim"], m["rope_theta"]
    i = torch.arange(r // 2, device=dev, dtype=torch.float32)
    extra = 1.0 / theta ** (2 * i / r)
    y = m.get("rope_scaling")
    gain = 1.0
    if y:
        inter = extra / y["factor"]
        low, high = yarn_ramp(m)
        ramp = ((i - low) / ((high - low) or 0.001)).clamp(0, 1)
        inv = inter * ramp + extra * (1 - ramp)
        gain = (_yarn_mscale(y["factor"], y.get("mscale", 1))
                / _yarn_mscale(y["factor"], y.get("mscale_all_dim", 0)))
    else:
        inv = extra
    ang = torch.arange(S, device=dev, dtype=torch.float32)[:, None] * inv
    return ang.cos()[:, None, :] * gain, ang.sin()[:, None, :] * gain


def _attention(q, k, v, scale):
    """Causal attention of (S, H, dqk) queries over (S, H, dqk) keys and
    (S, H, dv) values, in blocks of query rows."""
    S = q.shape[0]
    out = q.new_empty((S, q.shape[1], v.shape[-1]))
    for a in range(0, S, QUERY_BLOCK):
        b = min(a + QUERY_BLOCK, S)
        s = torch.einsum("qhd,khd->hqk", q[a:b], k[:b]) * scale
        mask = (torch.arange(b, device=q.device)[None, :]
                > torch.arange(a, b, device=q.device)[:, None])
        s.masked_fill_(mask[None], float("-inf"))
        out[a:b] = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1),
                                v[:b])
    return out


def layer_kinds(m: dict) -> list:
    """"dense" or "moe" of each layer's FFN."""
    k = m["first_k_dense_replace"]
    return ["dense" if i < k or (i - k) % m.get("moe_layer_freq", 1)
            else "moe" for i in range(m["num_hidden_layers"])]


def _mla(w, m, h, cos, sin, linear):
    S = h.shape[0]
    H = m["num_attention_heads"]
    nope, rope, vd = (m["qk_nope_head_dim"], m["qk_rope_head_dim"],
                      m["v_head_dim"])
    kvr, eps = m["kv_lora_rank"], m["rms_norm_eps"]
    if m.get("q_lora_rank"):
        q = linear(_rmsnorm(linear(h, w["q_a"]), w["q_norm"], eps), w["q_b"])
    else:
        q = linear(h, w["q"])
    q = q.view(S, H, nope + rope)
    kv_a = linear(h, w["kv_a"])
    c_kv = _rmsnorm(kv_a[:, :kvr], w["kv_norm"], eps)
    k_rope = _rope(kv_a[:, None, kvr:], cos, sin).expand(S, H, rope)
    kv = linear(c_kv, w["kv_b"]).view(S, H, nope + vd)
    q = torch.cat([q[..., :nope], _rope(q[..., nope:], cos, sin)], dim=-1)
    k = torch.cat([kv[..., :nope], k_rope], dim=-1)
    a = _attention(q, k, kv[..., nope:], softmax_scale(m))
    return linear(a.reshape(S, H * vd), w["o"])


def _swiglu(h, gate, up, down, linear):
    return linear(F.silu(linear(h, gate)) * linear(h, up), down)


def _moe(w, m, h, linear):
    probs = torch.softmax(linear(h, w["router"]), dim=-1)
    top, sel = torch.topk(probs, m["num_experts_per_tok"], dim=-1)
    if m["norm_topk_prob"]:
        top = top / top.sum(-1, keepdim=True)
    top = top * m["routed_scaling_factor"]
    out = torch.zeros_like(h)
    for e in range(m["n_routed_experts"]):
        rows, k = torch.nonzero(sel == e, as_tuple=True)
        if rows.numel():
            y = _swiglu(h[rows], w["gate"][e], w["up"][e], w["down"][e],
                        linear)
            out.index_add_(0, rows, y * top[rows, k, None])
    s = w["shared"]
    return out + _swiglu(h, s["gate"], s["up"], s["down"], linear)


@torch.no_grad()
def logits_at(weights: dict, m: dict, tokens, at, linear=linear_f32):
    """Float32 logits over the real vocabulary at the positions ``at`` of
    the sequence ``tokens`` (1-D int), (len(at), vocab)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emb = weights["embed"]
    dev = emb.device
    tokens = torch.as_tensor(np.asarray(tokens), device=dev).long()
    eps = m["rms_norm_eps"]
    cos, sin = rope_cos_sin(m, tokens.shape[0], dev)
    x = emb[tokens].float()
    for kind, lw in zip(layer_kinds(m), weights["layers"]):
        x = x + _mla(lw["attn"], m, _rmsnorm(x, lw["input_norm"], eps), cos,
                     sin, linear)
        h = _rmsnorm(x, lw["post_norm"], eps)
        f = lw["ffn"]
        x = x + (_moe(f, m, h, linear) if kind == "moe" else
                 _swiglu(h, f["gate"], f["up"], f["down"], linear))
    x = _rmsnorm(x[torch.as_tensor(at, device=dev)], weights["final_norm"],
                 eps)
    return linear(x, weights["lm_head"][:, :m["vocab_size"]])


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
