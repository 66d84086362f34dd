"""The port's attention modules on the CPU.

The plain versions (what the kernel wrappers run for a CPU tensor) must
equal the JAX package's Pallas kernels — in interpret mode, as
``tests/test_kernels.py`` runs them, over the same sweeps — and its
pure-jnp oracles, from the same numpy inputs, at that file's tolerances:
2e-5 for float32, 2e-2 for bf16 (the kernels accumulate in float32,
the oracles round scores and weights to bf16). The CUDA kernels are held
against these plain versions on the card (``tests/test_torch_cuda.py``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.decode_attention.ops import decode_attention as j_dec
from repro.kernels.decode_attention.ref import decode_attention_ref as j_dec_ref
from repro.kernels.flash_attention.ops import flash_attention as j_fa
from repro.kernels.flash_attention.ref import flash_attention_ref as j_fa_ref
from repro.models.attention import attention_core_xla
from repro_torch.configs import get_config
from repro_torch.kernels import _attn
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_ref)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ref)
from repro_torch.models.attention import (_update_cache, attention_core,
                                         cache_index)

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(rng, shapes, dtype, scale=0.3):
    """The same numpy draws as jnp and torch arrays of ``dtype``."""
    jdt, tdt, _ = DTYPES[dtype]
    arrs = [(rng.randn(*s) * scale).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a).astype(jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _close(port, jax_out, tol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(jax_out, np.float32), atol=tol)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd", [
    (1, 128, 128, 4, 4, 64),      # MHA
    (2, 256, 256, 8, 2, 64),      # GQA 4x
    (1, 256, 256, 8, 1, 128),     # MQA
    (1, 128, 512, 4, 4, 64),      # cross Skv > Sq (kv cache prefix)
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_sweep(B, Sq, Skv, H, KV, hd, dtype, rng):
    (jq, jk, jv), (q, k, v) = _inputs(
        rng, [(B, Sq, H, hd), (B, Skv, KV, hd), (B, Skv, KV, hd)], dtype)
    pos = (Skv - Sq) + np.broadcast_to(np.arange(Sq, dtype=np.int32),
                                       (B, Sq))
    out = flash_attention(q, k, v, q_positions=torch.from_numpy(pos.copy()),
                          causal=True)
    tol = DTYPES[dtype][2]
    _close(out, j_fa(jq, jk, jv, q_positions=jnp.asarray(pos), causal=True,
                     interpret=True), tol)
    _close(out, j_fa_ref(jq, jk, jv, q_offset=jnp.asarray(pos[:, 0]),
                         causal=True), tol)


def test_flash_attention_kv_valid_len(rng):
    B, S, H, KV, hd = 2, 256, 4, 4, 64
    (jq, jk, jv), (q, k, v) = _inputs(
        rng, [(B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)], "float32")
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    kvl = np.asarray([100, 256], np.int32)
    out = flash_attention(q, k, v, q_positions=torch.from_numpy(pos),
                          kv_valid_len=torch.from_numpy(kvl), causal=True)
    _close(out, j_fa(jq, jk, jv, q_positions=jnp.asarray(pos),
                     kv_valid_len=jnp.asarray(kvl), causal=True,
                     interpret=True), 2e-5)
    _close(out, j_fa_ref(jq, jk, jv, q_offset=jnp.asarray(pos[:, 0]),
                         kv_valid_len=jnp.asarray(kvl), causal=True), 2e-5)


@pytest.mark.parametrize("sq,h,g,seed", [
    (64, 2, 1, 0), (128, 4, 2, 7), (256, 4, 1, 31), (64, 4, 2, 55),
    (128, 2, 2, 100)])
def test_flash_attention_property(sq, h, g, seed):
    """kernel == oracle for GQA shapes and seeds (test_kernels.py's
    property test, as fixed cases)."""
    rng = np.random.RandomState(seed)
    kv = max(1, h // g)
    (jq, jk, jv), (q, k, v) = _inputs(
        rng, [(1, sq, h, 32), (1, sq, kv, 32), (1, sq, kv, 32)], "float32")
    pos = np.broadcast_to(np.arange(sq, dtype=np.int32), (1, sq)).copy()
    out = flash_attention(q, k, v, q_positions=torch.from_numpy(pos))
    _close(out, j_fa(jq, jk, jv, q_positions=jnp.asarray(pos),
                     interpret=True), 2e-5)
    _close(out, j_fa_ref(jq, jk, jv, q_offset=jnp.asarray(pos[:, 0])), 2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_ragged_serving_shape(causal, rng):
    """Serving's prefill: a prompt of any length against the whole cache
    (Skv = max_len) with only the prompt valid. The Pallas kernel needs
    Sq and Skv divisible by its blocks, so this holds the plain version
    against the oracle and the reference's chunked XLA core."""
    B, Sq, Skv, H, KV, hd = 2, 100, 300, 8, 2, 64
    (jq, jk, jv), (q, k, v) = _inputs(
        rng, [(B, Sq, H, hd), (B, Skv, KV, hd), (B, Skv, KV, hd)],
        "float32")
    pos = np.broadcast_to(np.arange(Sq, dtype=np.int32), (B, Sq)).copy()
    kvl = np.full((B,), Sq, np.int32)
    out = flash_attention(q, k, v, q_positions=torch.from_numpy(pos),
                          kv_valid_len=torch.from_numpy(kvl), causal=causal)
    _close(out, j_fa_ref(jq, jk, jv, q_offset=jnp.asarray(pos[:, 0]),
                         kv_valid_len=jnp.asarray(kvl), causal=causal), 2e-5)
    _close(out, attention_core_xla(jq, jk, jv, q_positions=jnp.asarray(pos),
                                   kv_valid_len=jnp.asarray(kvl),
                                   causal=causal), 2e-5)


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,H,KV,hd", [
    (2, 512, 8, 2, 64),
    (1, 1024, 4, 1, 128),
    (4, 512, 8, 8, 64),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_sweep(B, S, H, KV, hd, dtype, rng):
    (jq, jk, jv), (q, k, v) = _inputs(
        rng, [(B, 1, H, hd), (B, S, KV, hd), (B, S, KV, hd)], dtype)
    pos = rng.randint(10, S, size=(B, 1)).astype(np.int32)
    out = decode_attention(q, k, v, q_positions=torch.from_numpy(pos))
    tol = DTYPES[dtype][2]
    _close(out, j_dec(jq, jk, jv, q_positions=jnp.asarray(pos),
                      interpret=True), tol)
    _close(out, j_dec_ref(jq, jk, jv, q_positions=jnp.asarray(pos)), tol)


def test_decode_attention_kv_valid_len_and_xla_core(rng):
    """Serving's decode: valid length = position + 1 < S, the query heads
    of a group together; against the Pallas kernel, the oracle and the
    reference's grouped XLA core."""
    B, S, H, KV, hd = 3, 512, 8, 2, 64
    (jq, jk, jv), (q, k, v) = _inputs(
        rng, [(B, 1, H, hd), (B, S, KV, hd), (B, S, KV, hd)], "float32")
    pos = np.asarray([[0], [77], [300]], np.int32)
    kvl = pos[:, 0] + 1
    out = decode_attention(q, k, v, q_positions=torch.from_numpy(pos),
                           kv_valid_len=torch.from_numpy(kvl))
    for ref in (j_dec(jq, jk, jv, q_positions=jnp.asarray(pos),
                      kv_valid_len=jnp.asarray(kvl), interpret=True),
                j_dec_ref(jq, jk, jv, q_positions=jnp.asarray(pos),
                          kv_valid_len=jnp.asarray(kvl)),
                attention_core_xla(jq, jk, jv, q_positions=jnp.asarray(pos),
                                   kv_valid_len=jnp.asarray(kvl))):
        _close(out, ref, 2e-5)


# ---------------------------------------------------------------------------
# routing, cache update, input checks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sq", [1, 16])
def test_attention_core_routes_and_plain_agree(sq, rng):
    """attention_core sends one query token to flash-decode and more to
    flash attention; on the CPU the "kernel" route runs the plain
    versions, so it equals attn_impl="plain" exactly."""
    cfg = get_config("granite-3-2b").reduced()
    B, S, H, KV, hd = 2, 64, 4, 2, 32
    _, (q, k, v) = _inputs(
        rng, [(B, sq, H, hd), (B, S, KV, hd), (B, S, KV, hd)], "float32")
    pos = torch.arange(20, 20 + sq, dtype=torch.int32).expand(B, sq)
    kvl = pos[:, -1] + 1
    outs = [attention_core(dataclasses.replace(cfg, attn_impl=impl), q, k,
                           v, q_positions=pos, kv_valid_len=kvl)
            for impl in ("kernel", "plain")]
    assert torch.equal(outs[0], outs[1])
    ref = (decode_attention_ref(q, k, v, q_positions=pos, kv_valid_len=kvl)
           if sq == 1 else
           flash_attention_ref(q, k, v, q_offset=pos[:, 0],
                               kv_valid_len=kvl))
    assert torch.equal(outs[0], ref)
    with pytest.raises(ValueError, match="attn_impl"):
        attention_core(dataclasses.replace(cfg, attn_impl="xla"), q, k, v,
                       q_positions=pos)


def test_update_cache_writes_only_the_given_rows():
    cache = torch.zeros((3, 10, 2, 4))
    new = torch.randn((3, 4, 2, 4))
    pos = torch.tensor([0, 3, 6], dtype=torch.int32)
    out = _update_cache(cache, new, cache_index(
        pos[:, None] + torch.arange(4, dtype=torch.int32)))
    assert out is cache
    want = torch.zeros((3, 10, 2, 4))
    for b in range(3):
        want[b, pos[b]:pos[b] + 4] = new[b]
    assert torch.equal(cache, want)
    one = torch.randn((3, 1, 2, 4))
    _update_cache(cache, one, cache_index(
        torch.tensor([[9], [0], [5]], dtype=torch.int32)))
    for b, p in enumerate((9, 0, 5)):
        want[b, p] = one[b, 0]
    assert torch.equal(cache, want)


def _qkv(shape_q, shape_kv, dtype=torch.bfloat16, hdv=None):
    q = torch.zeros(shape_q, dtype=dtype)
    k = torch.zeros(shape_kv, dtype=dtype)
    v = torch.zeros(shape_kv[:3] + (hdv or shape_kv[3],), dtype=dtype)
    return q, k, v


@pytest.mark.parametrize("case,err,match", [
    ("hd96", ValueError, "no kernel for head dims"),
    ("mla", ValueError, "no kernel for head dims"),
    ("heads", ValueError, "do not divide"),
    ("dtype", TypeError, "one dtype"),
    ("f16", TypeError, "one dtype"),
    ("cpu", ValueError, "expected a CUDA tensor"),
])
def test_kernel_input_checks_raise(case, err, match):
    """What the CUDA route refuses, it refuses before launching: the
    checks run on any tensor, so they are exercised here without a
    card."""
    i32 = torch.zeros((2,), dtype=torch.int32)
    args = {
        "hd96": _qkv((2, 8, 4, 96), (2, 16, 2, 96)),
        # the reduced MLA config's pair: no kernel is compiled for it
        "mla": _qkv((2, 8, 4, 48), (2, 16, 2, 48), hdv=32),
        "heads": _qkv((2, 8, 6, 64), (2, 16, 4, 64)),
        "dtype": _qkv((2, 8, 4, 64), (2, 16, 2, 64))[:1]
        + _qkv((2, 8, 4, 64), (2, 16, 2, 64), torch.float32)[1:],
        "f16": _qkv((2, 8, 4, 64), (2, 16, 2, 64), torch.float16),
        "cpu": _qkv((2, 8, 4, 64), (2, 16, 2, 64)),
    }[case]
    with pytest.raises(err, match=match):
        _attn.check_inputs("flash attention", *args, i32, i32)


def test_flash_takes_mla_head_dims_and_flash_decode_refuses_them():
    """(hd, hdv) = (192, 128), DeepSeek-V2's MLA prefill, passes the
    flash attention kernel's head-dim check (the CPU tensors then fail
    the device check); flash-decode is not compiled for it (MLA decodes
    by absorbed products), so its wrapper refuses it before any launch."""
    assert (192, 128) in _attn.HEAD_DIMS
    assert (192, 128) not in _attn.DECODE_HEAD_DIMS
    i32 = torch.zeros((2,), dtype=torch.int32)
    q, k, v = _qkv((2, 8, 4, 192), (2, 16, 2, 192), hdv=128)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        _attn.check_inputs("flash attention", q, k, v, i32, i32)
    with pytest.raises(ValueError, match="no kernel for head dims"):
        _attn.check_inputs("decode attention", q, k, v, i32, i32,
                           head_dims=_attn.DECODE_HEAD_DIMS)
    meta = [t.to("meta") for t in (q, k, v)]
    with pytest.raises(ValueError, match="no kernel for head dims"):
        decode_attention(meta[0][:, :1], *meta[1:])


def test_wrappers_refuse_a_device_without_a_kernel():
    """Not CPU, not CUDA: no plain route and no kernel, so it raises."""
    q = torch.zeros((1, 4, 4, 64), device="meta")
    k = torch.zeros((1, 8, 2, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention(q, k, k)
    with pytest.raises(ValueError, match="CUDA tensor"):
        decode_attention(q[:, :1], k, k)


def _split_ranges(kend, nsplit):
    """The key ranges [lo, hi) flash-decode gives the splits of a sequence
    whose keys [0, kend) are walked: ``split_range`` in
    ``csrc/decode_attention.cu``, ceil(kend / nsplit) keys each, the last
    ones short or empty."""
    width = -(-kend // nsplit)
    los = [min(kend, i * width) for i in range(nsplit)]
    return [(lo, min(kend, lo + width)) for lo in los]


@pytest.mark.parametrize("S,B,KV", [(4096, 8, 8), (4096, 1, 8), (1000, 4, 2),
                                    (200, 2, 2), (129, 64, 8), (1, 1, 1)])
def test_decode_splits_come_from_shapes_and_cover_the_keys(S, B, KV):
    """flash-decode's split count is a function of host integers alone
    (the cache length, B, KV, the SM count: no device value, so no host
    synchronisation), at least 1 and at most one split per
    SPLIT_MIN_KEYS keys, with enough blocks for SPLIT_BLOCKS_PER_SM per
    SM unless that bound binds; and for every number of walked keys
    kend in [1, S] the kernel's ranges cover [0, kend) exactly once, in
    order."""
    cap = -(-S // _attn.SPLIT_MIN_KEYS)
    for sms in (132, 114, 1):
        n = _attn.decode_splits(S, B, KV, sms)
        assert type(n) is int and 1 <= n <= cap
        assert n == cap or B * KV * n >= _attn.SPLIT_BLOCKS_PER_SM * sms
        for kend in range(1, S + 1):
            ranges = _split_ranges(kend, n)
            assert len(ranges) == n and ranges[0][0] == 0
            assert ranges[-1][1] == kend
            assert all(lo <= hi for lo, hi in ranges)
            assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
