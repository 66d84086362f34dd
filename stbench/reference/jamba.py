"""Plain float32 reference of a Jamba decoder (AI21-Jamba2-Mini and the
Jamba 1.5 Mini family), for judging served tokens. It imports nothing of
the program and computes with the weights the benchmark made, each
matrix upcast to float32 only where it is used (one layer, and within an
MoE layer one expert, at a time), TF32 off.

The configuration ``m`` uses the Hugging Face names of ``jamba`` configs
(``attn_layer_period``/``_offset``, ``expert_layer_period``/``_offset``,
``mamba_d_state``, ``mamba_d_conv``, ``mamba_expand``, ``mamba_dt_rank``,
``num_experts``, ``num_experts_per_tok``, ``rms_norm_eps``) and
``head_dim``. Pre-norm blocks:

  x = embed[tokens]
  per layer: x += mixer(rmsnorm(x)),  x += ffn(rmsnorm(x))
  logits = rmsnorm(x) @ unembed                     (untied head)

  * attention (layer i with i % attn_layer_period == attn_layer_offset):
    GQA, causal, no positional encoding (the Mamba layers carry
    position), scores scaled by head_dim^-1/2, query head h reading KV
    head h // (H / KV);
  * Mamba-1 mixer (every other layer): x, z = in_proj(h); x = silu(causal
    depthwise conv(x) + conv bias); dt_low, B, C = x_proj(x) split
    (dt_rank, d_state, d_state), each through its RMSNorm (learned scale,
    ``rms_norm_eps``); dt = softplus(dt_low @ dt_proj + dt_bias); A =
    -exp(a_log); per step h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t, y_t =
    h_t C_t + D x_t, sequential in float32; out_proj(y * silu(z));
  * FFN: SwiGLU; on the layers with i % expert_layer_period ==
    expert_layer_offset a sparse MoE: softmax over the router's
    ``num_experts`` logits, the ``num_experts_per_tok`` largest
    probabilities weight their experts' SwiGLU outputs as they are (not
    renormalized to sum 1).

Departures from the published model: none in the function computed. The
RMSNorm multiplies by its scale in float32 before any cast (the
published code casts back to the input dtype first; in float32 the two
are one). The conv weight is kept as (d_conv, d_inner): tap j multiplies
the input j - (d_conv - 1) steps back, the published Conv1d's
``weight[:, 0, j]``. A sequence is computed whole (no cache), layer by
layer, the attention in blocks of query rows, the scan in chunks of
steps, so that both fit beside the weights.

Weights, as ``weights``: {"embed": (vocab rows, d), "unembed": (d, vocab
cols), "final_norm": (d,), "layers": [{"input_norm", "pre_ff_norm",
"mixer": {...}, "ffn": {...}}]}; the attention mixer {"q" (d, H*hd), "k",
"v" (d, KV*hd), "o" (H*hd, d)}; the Mamba mixer {"in_proj" (d, 2 di),
"conv_w" (d_conv, di), "conv_b", "x_proj" (di, dt_rank + 2 ds),
"dt_norm", "b_norm", "c_norm", "dt_proj" (dt_rank, di), "dt_bias",
"a_log" (di, ds), "d_skip", "out_proj" (di, d)}; a dense FFN {"gate",
"up" (d, f), "down" (f, d)}; an MoE {"router" (d, E), "gate", "up" (E,
d, f), "down" (E, f, d)}; products taken as ``x @ W``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from stbench.reference.granite import (_attention, linear_f32, linear_fp8,
                                       served_positions)

SCAN_CHUNK = 256


def _rmsnorm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def layer_kinds(m: dict) -> list:
    """(mixer, ffn) of each layer: "attn" or "mamba", "dense" or "moe"."""
    out = []
    for i in range(m["num_hidden_layers"]):
        attn = i % m["attn_layer_period"] == m["attn_layer_offset"]
        moe = i % m["expert_layer_period"] == m["expert_layer_offset"]
        out.append(("attn" if attn else "mamba", "moe" if moe else "dense"))
    return out


def _attention_mixer(w, m, h, linear):
    S = h.shape[0]
    H, KV, hd = (m["num_attention_heads"], m["num_key_value_heads"],
                 m["head_dim"])
    q = linear(h, w["q"]).view(S, H, hd)
    k = linear(h, w["k"]).view(S, KV, hd).repeat_interleave(H // KV, dim=1)
    v = linear(h, w["v"]).view(S, KV, hd).repeat_interleave(H // KV, dim=1)
    a = _attention(q, k, v, hd ** -0.5)
    return linear(a.reshape(S, H * hd), w["o"])


def _mamba_mixer(w, m, h, linear):
    S = h.shape[0]
    ds, dtr = m["mamba_d_state"], m["mamba_dt_rank"]
    eps = m["rms_norm_eps"]
    xz = linear(h, w["in_proj"])
    di = xz.shape[-1] // 2
    x, z = xz[:, :di], xz[:, di:]
    cw = w["conv_w"].float()
    dc = cw.shape[0]
    xp = torch.cat([x.new_zeros((dc - 1, di)), x])
    x = F.silu(sum(xp[j:j + S] * cw[j] for j in range(dc))
               + w["conv_b"].float())
    xdb = linear(x, w["x_proj"])
    dt_low = _rmsnorm(xdb[:, :dtr], w["dt_norm"], eps)
    B = _rmsnorm(xdb[:, dtr:dtr + ds], w["b_norm"], eps)
    C = _rmsnorm(xdb[:, dtr + ds:], w["c_norm"], eps)
    dt = F.softplus(linear(dt_low, w["dt_proj"]) + w["dt_bias"].float())
    A = -torch.exp(w["a_log"].float())                       # (di, ds)
    state = x.new_zeros((di, ds))
    y = torch.empty_like(x)
    for a in range(0, S, SCAN_CHUNK):
        b = min(a + SCAN_CHUNK, S)
        dA = torch.exp(dt[a:b, :, None] * A)                 # (n, di, ds)
        dBx = (dt[a:b] * x[a:b])[:, :, None] * B[a:b, None, :]
        for t in range(b - a):
            state = dA[t] * state + dBx[t]
            y[a + t] = state @ C[a + t]
    y = (y + x * w["d_skip"].float()) * F.silu(z)
    return linear(y, w["out_proj"])


def _swiglu(h, gate, up, down, linear):
    return linear(F.silu(linear(h, gate)) * linear(h, up), down)


def _moe(w, m, h, linear):
    probs = torch.softmax(linear(h, w["router"]), dim=-1)
    top, sel = torch.topk(probs, m["num_experts_per_tok"], dim=-1)
    out = torch.zeros_like(h)
    for e in range(m["num_experts"]):
        rows, k = torch.nonzero(sel == e, as_tuple=True)
        if rows.numel():
            y = _swiglu(h[rows], w["gate"][e], w["up"][e], w["down"][e],
                        linear)
            out.index_add_(0, rows, y * top[rows, k, None])
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
    eps = m["rms_norm_eps"]
    x = emb[tokens].float()
    for (mixer, ffn), lw in zip(layer_kinds(m), weights["layers"]):
        h = _rmsnorm(x, lw["input_norm"], eps)
        mix = _attention_mixer if mixer == "attn" else _mamba_mixer
        x = x + mix(lw["mixer"], m, h, linear)
        h = _rmsnorm(x, lw["pre_ff_norm"], eps)
        f = lw["ffn"]
        x = x + (_moe(f, m, h, linear) if ffn == "moe" else
                 _swiglu(h, f["gate"], f["up"], f["down"], linear))
    x = _rmsnorm(x[torch.as_tensor(at, device=dev)], weights["final_norm"],
                 eps)
    return linear(x, weights["unembed"][:, :m["vocab_size"]])


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
