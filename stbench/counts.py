"""Closed-form operation and byte counts of the kernels the benchmark
holds against their roofline, and the peaks of the card.

Every count is what the inputs need: each input byte the result depends
on read once, each output byte written once, operations as the
algorithm defines them (a causal score matrix counts its lower triangle
only). Tables an implementation reads to find its way (permutations,
increment tables, split workspaces) are not counted, so a share of the
bound cannot pass 100 % by a change of implementation.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates), the
same constants as the program's ``launch/roofline.py``; a card set
below its 700 W limit runs under them, and the harness prints the
limit beside the shares.
"""
from __future__ import annotations

import itertools
from math import prod

PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float,
            peak: float = PEAK_BF16_FLOPS) -> float:
    """Least time of a kernel: the larger of its operations at ``peak``
    and its bytes at the HBM bandwidth."""
    return max(flops / peak, nbytes / HBM_BYTES_PER_S)


# -- Faces (26-neighbour halo exchange) ---------------------------------------

DIRECTIONS = [d for d in itertools.product((-1, 0, 1), repeat=3)
              if d != (0, 0, 0)]


def surface_cells(n, d) -> int:
    """Cells of an (nx, ny, nz) block sent in direction ``d``: a face
    slab, an edge pencil or a corner cell."""
    return prod(1 if dd else nd for nd, dd in zip(n, d))


def surfaces_cells(n) -> int:
    """Cells of all 26 surfaces together (a cell on an edge is in three
    of them)."""
    return sum(surface_cells(n, d) for d in DIRECTIONS)


def shell_cells(n) -> int:
    """Distinct cells on the block's boundary: what a pack must read."""
    return prod(n) - prod(max(k - 2, 0) for k in n)


def halo_pack_bytes(ranks: int, n, el: int = 4) -> int:
    """Merged pack of every rank: the boundary read once, the 26 send
    buffers written."""
    return ranks * el * (shell_cells(n) + surfaces_cells(n))


def halo_unpack_bytes(ranks: int, n, el: int = 4,
                      with_max: bool = True) -> int:
    """Merged unpack of every rank: the 26 receive buffers read, the
    whole accumulator written, and each rank's max (one value)."""
    return ranks * el * (surfaces_cells(n) + prod(n) + (1 if with_max
                                                        else 0))


def put_signal_bytes(ranks: int, cells: int, el: int = 4) -> int:
    """One put of ``cells`` elements a rank with its completion signal:
    the payload read and written, one int32 counter a rank read and
    written."""
    return ranks * (2 * el * cells + 2 * 4)


def counter_bump_bytes(slots: int) -> int:
    """A bump of ``slots`` int32 counters: each read and written."""
    return 2 * 4 * slots


def faces_iteration_bounds(ranks: int, n, el: int = 4) -> dict:
    """Bound seconds of one merged Faces iteration's kernels, by kernel
    group: {"halo": pack + unpack, "put": 26 puts + the post bump}."""
    halo = (bound_s(0, halo_pack_bytes(ranks, n, el))
            + bound_s(0, halo_unpack_bytes(ranks, n, el)))
    put = sum(bound_s(0, put_signal_bytes(ranks, surface_cells(n, d), el))
              for d in DIRECTIONS)
    put += bound_s(0, counter_bump_bytes(ranks * len(DIRECTIONS)))
    return {"halo": halo, "put": put}


# -- decoder LM (granite) -----------------------------------------------------

def layer_matmul_params(m: dict) -> int:
    """Weights of one decoder layer's matrix products: q, k, v, o and the
    SwiGLU gate, up and down. ``m`` is a configuration in the
    Hugging Face names."""
    d, f = m["hidden_size"], m["intermediate_size"]
    H, KV, hd = (m["num_attention_heads"], m["num_key_value_heads"],
                 m["head_dim"])
    return d * H * hd * 2 + d * KV * hd * 2 + 3 * d * f


def attention_flops(m: dict, queries_keys: int) -> int:
    """One layer's scores and weighted sum over ``queries_keys``
    (query, key) pairs: 2 x hd a pair for each, every head."""
    return 4 * m["num_attention_heads"] * m["head_dim"] * queries_keys


def decode_token_flops(m: dict, kv_len: int) -> int:
    """One decoded token attending to ``kv_len`` positions: every
    layer's products, its attention, and the logits over the vocab."""
    L = m["num_hidden_layers"]
    return (2 * L * layer_matmul_params(m)
            + L * attention_flops(m, kv_len)
            + 2 * m["vocab_size"] * m["hidden_size"])


def causal_pairs(length: int) -> int:
    return length * (length + 1) // 2


def prefill_flops(m: dict, rows: int, length: int) -> int:
    """A prefill dispatch of ``rows`` prompts of ``length`` tokens: every
    layer's products and causal attention, the logits of the last
    position only."""
    L = m["num_hidden_layers"]
    per_row = (2 * L * layer_matmul_params(m) * length
               + L * attention_flops(m, causal_pairs(length))
               + 2 * m["vocab_size"] * m["hidden_size"])
    return rows * per_row


def flash_attention_bound(m: dict, rows: int, length: int,
                          el: int = 2) -> float:
    """Bound seconds of one layer's causal flash attention over a
    dispatch: q, k and v read once, the output written once."""
    H, KV, hd = (m["num_attention_heads"], m["num_key_value_heads"],
                 m["head_dim"])
    nbytes = rows * length * (2 * H + 2 * KV) * hd * el
    return bound_s(rows * attention_flops(m, causal_pairs(length)), nbytes)


def decode_attention_bound(m: dict, kv_lens, el: int = 2) -> float:
    """Bound seconds of one layer's decode attention over the active
    slots (``kv_lens``: each slot's valid KV rows): those rows of k and v
    read once, each query read and output written once."""
    H, KV, hd = (m["num_attention_heads"], m["num_key_value_heads"],
                 m["head_dim"])
    rows = sum(kv_lens)
    nbytes = (rows * 2 * KV * hd + len(kv_lens) * 2 * H * hd) * el
    return bound_s(attention_flops(m, rows), nbytes)
