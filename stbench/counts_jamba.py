"""Closed-form operation and byte counts of a served Jamba decoder
(``stbench/reference/jamba.py`` names the configuration's keys), on the
rules of ``stbench/counts.py``: each input byte the result depends on
read once, each output byte written once, operations as the algorithm
defines them.

  * a decode token's and a prefill dispatch's FLOPs: the work they
    need, with each MoE layer's ``num_experts_per_tok`` routed experts
    (not every expert a dense implementation computes);
  * a ``mamba_scan_step`` launch's bytes: per active slot the float32
    state read and written once, dt, x, B and C read and y written once
    (the compute dtype), and A (``a_log``, float32) read once a launch;
  * the ST router's ``put_signal`` launches of one decode dispatch: each
    payload row read once and written once to its peer, on every rank,
    with the put's completion counter (``counts.put_signal_bytes``).
"""
from __future__ import annotations

from stbench.counts import bound_s, causal_pairs, put_signal_bytes
from stbench.reference.jamba import layer_kinds

F32 = 4


def _dims(m: dict):
    di = m["mamba_expand"] * m["hidden_size"]
    return di, m["mamba_d_state"], m["mamba_dt_rank"], m["mamba_d_conv"]


def mamba_token_flops(m: dict) -> int:
    """One token through one Mamba mixer: its products (in, x, dt and out
    projections), the depthwise conv, and the scan's 7 operations a
    state entry (dt A; dt x B; the state's multiply-add; y's
    multiply-add), the skip and the gate."""
    d = m["hidden_size"]
    di, ds, dtr, dc = _dims(m)
    prods = d * 2 * di + di * (dtr + 2 * ds) + dtr * di + di * d
    return 2 * prods + 2 * dc * di + 7 * di * ds + 3 * di


def attention_token_flops(m: dict, kv_len: int) -> int:
    """One query token of one attention layer over ``kv_len`` keys: q, k,
    v and o products, scores and weighted sum."""
    d, H, KV, hd = (m["hidden_size"], m["num_attention_heads"],
                    m["num_key_value_heads"], m["head_dim"])
    return 2 * (2 * d * H * hd + 2 * d * KV * hd) + 4 * H * hd * kv_len


def ffn_token_flops(m: dict, moe: bool) -> int:
    """One token through a dense SwiGLU FFN, or through an MoE FFN's
    router and its routed experts."""
    d, f = m["hidden_size"], m["intermediate_size"]
    if not moe:
        return 2 * 3 * d * f
    return 2 * m["num_experts_per_tok"] * 3 * d * f \
        + 2 * d * m["num_experts"]


def decode_token_flops(m: dict, kv_len: int) -> int:
    """One decoded token at ``kv_len`` cached positions (its own
    included): every layer's mixer and FFN, and the logits."""
    total = 2 * m["vocab_size"] * m["hidden_size"]
    for mixer, ffn in layer_kinds(m):
        total += (attention_token_flops(m, kv_len) if mixer == "attn"
                  else mamba_token_flops(m))
        total += ffn_token_flops(m, ffn == "moe")
    return total


def decode_flops(m: dict, kv_lens) -> int:
    """The decoded tokens at ``kv_lens`` cached positions each, summed
    (:func:`decode_token_flops` is linear in the length)."""
    n_attn = sum(k == "attn" for k, _ in layer_kinds(m))
    per_key = 4 * m["num_attention_heads"] * m["head_dim"]
    return (len(kv_lens) * decode_token_flops(m, 0)
            + n_attn * per_key * sum(kv_lens))


def prefill_flops(m: dict, rows: int, length: int) -> int:
    """A prefill dispatch of ``rows`` prompts of ``length`` tokens: every
    layer's mixer (causal attention over the prompt) and routed FFN, the
    logits of the last position only."""
    per_row = 2 * m["vocab_size"] * m["hidden_size"]
    for mixer, ffn in layer_kinds(m):
        if mixer == "attn":
            per_row += (length * attention_token_flops(m, 0)
                        + 4 * m["num_attention_heads"] * m["head_dim"]
                        * causal_pairs(length))
        else:
            per_row += length * mamba_token_flops(m)
        per_row += length * ffn_token_flops(m, ffn == "moe")
    return rows * per_row


def mamba_step_bytes(m: dict, slots: int, el: int = 2) -> int:
    """One ``mamba_scan_step`` launch over ``slots`` active slots, one
    step each."""
    di, ds, _, _ = _dims(m)
    per_slot = 2 * di * ds * F32 + 3 * di * el + 2 * ds * el
    return slots * per_slot + di * ds * F32


def mamba_step_bound(m: dict, slots: int, el: int = 2) -> float:
    return bound_s(0, mamba_step_bytes(m, slots, el))


def router_put_bounds(m: dict, ranks: int, bucket: int,
                      moe: bool) -> list:
    """Bound seconds of each ``put_signal`` launch of one dispatch at
    ``bucket`` staged rows: the KV rows (float32, KV heads x head dim),
    the token ids (int32) and, with MoE dispatch, the hidden block
    (float32) to each of the ``ranks - 1`` peer shifts."""
    kv = m["num_key_value_heads"] * m["head_dim"]
    cells = [bucket * kv, bucket]
    if moe:
        cells += [bucket * m["hidden_size"]] * (ranks - 1)
    return [bound_s(0, put_signal_bytes(ranks, c, F32)) for c in cells]
