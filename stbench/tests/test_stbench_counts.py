"""The closed-form counts against hand counts at small shapes."""
import pytest

import stbench_tiny  # noqa: F401  (puts the repository on the path)
from stbench import counts

N = (4, 4, 4)
# a decoder small enough to count by hand: d 4, ffn 8, 2 heads of 2, one
# KV head, one layer, vocab 10
M = {"hidden_size": 4, "intermediate_size": 8, "num_attention_heads": 2,
     "num_key_value_heads": 1, "head_dim": 2, "num_hidden_layers": 1,
     "vocab_size": 10}


def test_faces_cells():
    # 6 faces of 16, 12 edges of 4, 8 corners; 64 - 2^3 boundary cells
    assert counts.surfaces_cells(N) == 6 * 16 + 12 * 4 + 8 == 152
    assert counts.shell_cells(N) == 64 - 8
    assert counts.shell_cells((1, 3, 2)) == 6


def test_faces_bytes():
    assert counts.halo_pack_bytes(8, N) == 8 * 4 * (56 + 152)
    assert counts.halo_unpack_bytes(8, N) == 8 * 4 * (152 + 64 + 1)
    assert counts.halo_unpack_bytes(8, N, with_max=False) == \
        8 * 4 * (152 + 64)
    # a 16-cell face for 8 ranks: payload in and out, one counter each
    assert counts.put_signal_bytes(8, 16) == 8 * (2 * 4 * 16 + 8)
    assert counts.counter_bump_bytes(8 * 26) == 2 * 4 * 208


def test_faces_iteration_bounds():
    b = counts.faces_iteration_bounds(8, N)
    bw = counts.HBM_BYTES_PER_S
    assert b["halo"] == pytest.approx((8 * 4 * 208 + 8 * 4 * 217) / bw)
    puts = sum(8 * (8 * counts.surface_cells(N, d) + 8)
               for d in counts.DIRECTIONS)
    assert b["put"] == pytest.approx((puts + 8 * 208) / bw)


def test_decoder_flops():
    # q, o: 4 x 4 each; k, v: 4 x 2 each; gate, up, down: 3 x 4 x 8
    assert counts.layer_matmul_params(M) == 32 + 16 + 96
    # one token at 3 positions: 2 x 144, scores and sum 4 x 2 x 2 x 3,
    # logits 2 x 10 x 4
    assert counts.decode_token_flops(M, 3) == 288 + 48 + 80
    # 2 rows of 3: 6 causal pairs a row
    assert counts.prefill_flops(M, 2, 3) == 2 * (2 * 144 * 3 + 16 * 6 + 80)


def test_attention_bounds():
    # flash, 2 rows of 3: 192 FLOPs; q, k, v, out: 2*3*(2+1+1+2)*2 el * 2 B
    assert counts.flash_attention_bound(M, 2, 3) == pytest.approx(
        max(192 / counts.PEAK_BF16_FLOPS, 144 / counts.HBM_BYTES_PER_S))
    # decode over 3 and 5 valid rows: k, v rows; each slot's q and out
    assert counts.decode_attention_bound(M, [3, 5]) == pytest.approx(
        max(4 * 2 * 2 * 8 / counts.PEAK_BF16_FLOPS,
            (8 * 2 * 2 + 2 * 2 * 4) * 2 / counts.HBM_BYTES_PER_S))
