"""Closed-form operation and byte counts of a served DeepSeek-V2 decoder
(``stbench/reference/deepseek_v2.py`` names the configuration's keys),
on the rules of ``stbench/counts.py``: operations as the algorithm
defines them.

  * a decode token's FLOPs: multi-head latent attention in its absorbed
    form at the token's own position (the query and latent projections,
    W_k^b folded into the query, scores over the latent and rope rows of
    the ``kv_len`` cached positions, the context over the latent rows,
    W_v^b and W_o), each MoE layer at its ``num_experts_per_tok`` routed
    experts and its shared experts (not every expert a dense
    implementation computes), the dense first layers, the logits;
  * a prefill dispatch's FLOPs: the expand path over the prompt (the
    latent expanded to each head's k_nope and v at every prompt
    position, causal attention over the prompt), the FFNs as above, the
    logits of the last position only;
  * the ST router's ``put_signal`` launches of one decode dispatch:
    ``counts_jamba.router_put_bounds`` with the payload row the latent
    cache's (``kv_lora_rank`` wide) in place of a KV head's.
"""
from __future__ import annotations

from stbench import counts_jamba
from stbench.counts import causal_pairs
from stbench.reference.deepseek_v2 import layer_kinds


def _q_flops(m: dict) -> int:
    """One token's query projection (compressed or not)."""
    d, H = m["hidden_size"], m["num_attention_heads"]
    qk = m["qk_nope_head_dim"] + m["qk_rope_head_dim"]
    r = m["q_lora_rank"]
    return 2 * (d * r + r * H * qk) if r else 2 * d * H * qk


def mla_decode_token_flops(m: dict, kv_len: int) -> int:
    """One query token of one MLA layer, absorbed, over ``kv_len``
    cached positions (its own included)."""
    d, H = m["hidden_size"], m["num_attention_heads"]
    nope, rope, vd = (m["qk_nope_head_dim"], m["qk_rope_head_dim"],
                      m["v_head_dim"])
    c = m["kv_lora_rank"]
    fixed = (_q_flops(m) + 2 * d * (c + rope) + 2 * H * nope * c
             + 2 * H * c * vd + 2 * H * vd * d)
    return fixed + 2 * H * (2 * c + rope) * kv_len


def mla_prefill_flops(m: dict, length: int) -> int:
    """One prompt of ``length`` tokens through one MLA layer, expanded:
    per token the projections and the latent's expansion to k_nope and
    v, per causal (query, key) pair the scores and the weighted sum."""
    d, H = m["hidden_size"], m["num_attention_heads"]
    nope, rope, vd = (m["qk_nope_head_dim"], m["qk_rope_head_dim"],
                      m["v_head_dim"])
    c = m["kv_lora_rank"]
    per_token = (_q_flops(m) + 2 * d * (c + rope) + 2 * c * H * (nope + vd)
                 + 2 * H * vd * d)
    return (length * per_token
            + 2 * H * (nope + rope + vd) * causal_pairs(length))


def ffn_token_flops(m: dict, moe: bool) -> int:
    """One token through a dense SwiGLU FFN, or through an MoE FFN's
    router, its routed experts and its shared experts."""
    d = m["hidden_size"]
    if not moe:
        return 2 * 3 * d * m["intermediate_size"]
    f = m["moe_intermediate_size"]
    return (2 * d * m["n_routed_experts"]
            + 2 * 3 * d * f * (m["num_experts_per_tok"]
                               + m["n_shared_experts"]))


def decode_token_flops(m: dict, kv_len: int) -> int:
    """One decoded token at ``kv_len`` cached positions: every layer's
    MLA and FFN, and the logits."""
    return (2 * m["vocab_size"] * m["hidden_size"]
            + sum(mla_decode_token_flops(m, kv_len)
                  + ffn_token_flops(m, kind == "moe")
                  for kind in layer_kinds(m)))


def decode_flops(m: dict, kv_lens) -> int:
    """The decoded tokens at ``kv_lens`` cached positions each, summed
    (:func:`decode_token_flops` is linear in the length)."""
    per_key = (mla_decode_token_flops(m, 1)
               - mla_decode_token_flops(m, 0))
    return (len(kv_lens) * decode_token_flops(m, 0)
            + m["num_hidden_layers"] * per_key * sum(kv_lens))


def prefill_flops(m: dict, rows: int, length: int) -> int:
    """A prefill dispatch of ``rows`` prompts of ``length`` tokens: every
    layer's expanded MLA and routed FFN, the logits of the last position
    only."""
    per_row = 2 * m["vocab_size"] * m["hidden_size"] + sum(
        mla_prefill_flops(m, length)
        + length * ffn_token_flops(m, kind == "moe")
        for kind in layer_kinds(m))
    return rows * per_row


def router_put_bounds(m: dict, ranks: int, bucket: int,
                      moe: bool) -> list:
    """Bound seconds of each ``put_signal`` launch of one dispatch at
    ``bucket`` staged rows: the latent rows (float32, ``kv_lora_rank``
    wide), the token ids and, with MoE dispatch, the hidden block to each
    of the ``ranks - 1`` peer shifts."""
    row = {"num_key_value_heads": 1, "head_dim": m["kv_lora_rank"],
           "hidden_size": m["hidden_size"]}
    return counts_jamba.router_put_bounds(row, ranks, bucket, moe)
