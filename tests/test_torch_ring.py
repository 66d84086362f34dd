"""The port's ring attention on the CPU against the JAX package's plain
attention.

``ring_attention_train`` (the direct rotation loop on virtual ranks) and
``ring_attention_st`` (the rotation lowered onto the triggered-op DAG,
through the st, host and fused executors) against the JAX
``flash_attention_ref`` (causal), and ``sharded_decode_attention``
against the JAX ``decode_attention_ref``, in float32 within 1e-5, the
tolerance of the reference's own multi-device tests
(``tests/test_ring_a2a.py``). One rank is the unsharded case of
``tests/test_patterns.py``. The three executors give the same bits, and
so do the packed and chunked put schedules of the ST program.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.decode_attention.ref import decode_attention_ref
from repro.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.core import ring

TOL = 1e-5
B, H, hd = 2, 4, 16


def _qkv(S, seed=0, heads=H, kv_heads=H):
    rng = np.random.RandomState(seed)
    q = (rng.randn(B, S, heads, hd) * 0.3).astype(np.float32)
    k = (rng.randn(B, S, kv_heads, hd) * 0.3).astype(np.float32)
    v = (rng.randn(B, S, kv_heads, hd) * 0.3).astype(np.float32)
    return q, k, v


def _flash_ref(q, k, v, causal=True):
    return np.asarray(flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), causal=causal))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("ranks", [1, 2, 4])
def test_ring_attention_train_matches_flash_ref(ranks, causal):
    q, k, v = _qkv(32 * ranks)
    got = ring.ring_attention_train(*map(torch.from_numpy, (q, k, v)),
                                    ranks=ranks, causal=causal)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _flash_ref(q, k, v, causal),
                               atol=TOL)


@pytest.mark.parametrize("ranks", [1, 4])
def test_ring_attention_st_matches_train_in_every_mode(ranks):
    q, k, v = map(torch.from_numpy, _qkv(16 * ranks, seed=1))
    direct = ring.ring_attention_train(q, k, v, ranks=ranks)
    ref = _flash_ref(q.numpy(), k.numpy(), v.numpy())
    outs = {mode: ring.ring_attention_st(q, k, v, ranks=ranks, mode=mode)
            for mode in ("st", "host", "fused")}
    for mode, out in outs.items():
        np.testing.assert_allclose(out.numpy(), ref, atol=TOL,
                                   err_msg=mode)
        # the same closures on the same blocks: the direct loop's bits
        assert torch.equal(out, direct), mode
    # the inputs are not written
    assert torch.equal(q, torch.from_numpy(_qkv(16 * ranks, seed=1)[0]))


@pytest.mark.parametrize("mode", ["st", "host", "fused"])
@pytest.mark.parametrize("sched", [dict(pack=True), dict(chunk_bytes=256)],
                         ids=["pack", "chunk"])
def test_ring_st_transport_schedules_move_the_same_bits(mode, sched):
    """Two nodes of two ranks: each step's K,V pair rides one packed
    descriptor, or each block a chain of chunks."""
    q, k, v = map(torch.from_numpy, _qkv(64, seed=2))
    plain = ring.ring_attention_st(q, k, v, ranks=4, mode="st")
    got = ring.ring_attention_st(q, k, v, ranks=4, mode=mode,
                                 ranks_per_node=2, **sched)
    assert torch.equal(got, plain)
    stream, _ = ring.ring_stream(q, ranks=4, ranks_per_node=2)
    stats = stream.scheduled_programs(
        node_aware="pack" in sched, **sched)[0].stats()
    assert stats["packed_puts" if "pack" in sched else "chunked_puts"] > 0


@pytest.mark.parametrize("ranks,kv_heads", [(1, 2), (4, 2), (4, 4)])
def test_sharded_decode_attention_matches_decode_ref(ranks, kv_heads):
    S = 64
    rng = np.random.RandomState(3)
    q = (rng.randn(B, 1, H, hd) * 0.3).astype(np.float32)
    k = (rng.randn(B, S, kv_heads, hd) * 0.3).astype(np.float32)
    v = (rng.randn(B, S, kv_heads, hd) * 0.3).astype(np.float32)
    pos = np.asarray([37, 63], np.int32)
    want = np.asarray(decode_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_positions=jnp.asarray(pos)[:, None]))
    got = ring.sharded_decode_attention(
        *map(torch.from_numpy, (q, k, v, pos)), ranks=ranks)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)


def test_ring_window_takes_bf16():
    """A bf16 ring lowers with 2-byte payloads (the reference's bf16
    size) and runs; its output stays within bf16 rounding of the float32
    ring."""
    q, k, v = map(torch.from_numpy, _qkv(32, seed=4))
    stream, win = ring.ring_stream(q.bfloat16(), ranks=4)
    prog = stream.scheduled_programs()[0]
    assert {p.nbytes for p in prog.puts()} == {B * 8 * H * hd * 2}
    assert {p.dtype for p in prog.puts()} == {"bfloat16"}
    out = ring.ring_attention_st(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                 ranks=4)
    assert out.dtype == torch.bfloat16
    f32 = ring.ring_attention_train(q, k, v, ranks=4)
    assert (out.float() - f32).abs().max() < 2e-2
