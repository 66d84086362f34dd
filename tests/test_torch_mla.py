"""DeepSeek-V2's multi-head latent attention in the port, on the CPU.

The same numpy inputs and weights (``tests/_ref_params.py``) go through
the JAX package and the port:

  * flash attention with hd != hdv — the shape MLA's expand path gives
    it: (48, 32) at the reduced config, (192, 128) at full width — the
    JAX Pallas kernel in interpret mode and its jnp oracle against the
    port's plain version (what its wrapper runs for a CPU tensor; the
    CUDA kernel is held to it on the card), at lengths the Pallas kernel
    takes (Sq, Skv <= 128 or multiples of 128);
  * ``mla_attention`` at ``get_config("deepseek-v2-236b").reduced()``:
    without a cache, as a prefill into a cache, and one absorbed decode
    step after it, the JAX side with ``attn_impl`` "xla" and
    "pallas_interpret";
  * which kernel the port's layer reaches: flash attention once per MLA
    layer at prefill, no attention kernel at an absorbed decode step.

Tolerances, those of ``tests/test_kernels.py``: 2e-5 in float32, 2e-2 in
bf16.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_config
from repro.kernels.flash_attention.ops import flash_attention as j_fa
from repro.kernels.flash_attention.ref import flash_attention_ref as j_fa_ref
from repro.models.mla import mla_attention as j_mla
from repro.models.mla import mla_specs as j_mla_specs
from repro.sharding.rules import make_rules
from _ref_params import ref_params
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ref)
from repro_torch.models import (cache_specs, forward, from_reference,
                                zeros_from_specs)
from repro_torch.models import attention as attn_mod
from repro_torch.models.mla import mla_attention, mla_cache_specs, mla_specs

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
F32_TOL = 2e-5


def _close(port, ref, tol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), atol=tol)


# ---------------------------------------------------------------------------
# flash attention at hd != hdv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd,hdv", [(48, 32), (192, 128)])
@pytest.mark.parametrize("B,Sq,Skv,H,KV,kvl,off", [
    (2, 64, 128, 2, 2, (128, 90), 64),       # a prefill's tail, ragged kvl
    (1, 128, 256, 4, 2, (200,), 100),        # GQA, two key blocks
    (2, 16, 16, 2, 1, None, 0),              # no cache
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_at_mla_head_dims_matches_pallas(
        hd, hdv, B, Sq, Skv, H, KV, kvl, off, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.RandomState(hd + Sq)
    arrs = [(rng.randn(*s) * 0.3).astype(np.float32)
            for s in ((B, Sq, H, hd), (B, Skv, KV, hd), (B, Skv, KV, hdv))]
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in arrs)
    q, k, v = (torch.from_numpy(a).to(tdt) for a in arrs)
    pos = off + np.broadcast_to(np.arange(Sq, dtype=np.int32), (B, Sq))
    tkvl = None if kvl is None else torch.tensor(kvl, dtype=torch.int32)
    jkvl = None if kvl is None else jnp.asarray(kvl, jnp.int32)
    out = flash_attention(q, k, v, q_positions=torch.from_numpy(pos.copy()),
                          kv_valid_len=tkvl)
    assert out.shape == (B, Sq, H, hdv) and out.dtype == tdt
    assert torch.equal(out, flash_attention_ref(
        q, k, v, q_offset=torch.from_numpy(pos[:, 0].copy()),
        kv_valid_len=tkvl))
    _close(out, j_fa(jq, jk, jv, q_positions=jnp.asarray(pos),
                     kv_valid_len=jkvl, interpret=True), tol)
    _close(out, j_fa_ref(jq, jk, jv, q_offset=jnp.asarray(pos[:, 0]),
                         kv_valid_len=jkvl), tol)


# ---------------------------------------------------------------------------
# the MLA layer against the reference's
# ---------------------------------------------------------------------------

def _mla_models():
    jc = dataclasses.replace(jax_config("deepseek-v2-236b").reduced(),
                             compute_dtype="float32")
    tc = dataclasses.replace(get_config("deepseek-v2-236b").reduced(),
                             compute_dtype="float32")
    p = ref_params(j_mla_specs(jc), 0)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    return jc, tc, jax.tree.map(jnp.asarray, p), tp


def test_mla_specs_and_cache_specs_equal_the_reference():
    """The reduced config's leaves, and the latent cache at full width:
    ckv (B, max_len, 512) and krope (B, max_len, 64), bf16, with the
    "kv_seq" axis the serving engine finds cache rows by."""
    jc, tc, jp, tp = _mla_models()
    assert {k: (s.shape, s.axes, s.init) for k, s in mla_specs(tc).items()} \
        == {k: (s.shape, s.axes, s.init)
            for k, s in j_mla_specs(jc).items()}
    full = get_config("deepseek-v2-236b")
    assert mla_cache_specs(full, 8, 4096) == {
        "ckv": ((8, 4096, 512), ("batch", "kv_seq", "lora")),
        "krope": ((8, 4096, 64), ("batch", "kv_seq", None))}
    specs = cache_specs(full, 8, 4096)["layers"]
    assert len(specs) == 60
    assert all(sp[k].dtype == torch.bfloat16 and "kv_seq" in sp[k].axes
               for sp in specs for k in ("ckv", "krope"))


def _x(cfg, B, S, seed):
    return (np.random.RandomState(seed).randn(B, S, cfg.d_model)
            .astype(np.float32))


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_mla_attention_without_a_cache_matches_jax(impl):
    jc, tc, jp, tp = _mla_models()
    jc = dataclasses.replace(jc, attn_impl=impl)
    B, S = 2, 32
    x = _x(tc, B, S, 0)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    jout, jcache = j_mla(jc, jp, jnp.asarray(x),
                         rules=make_rules(jc, None, None),
                         positions=jnp.asarray(pos))
    out, cache = mla_attention(tc, tp, torch.from_numpy(x),
                               positions=torch.from_numpy(pos))
    assert cache is None and jcache is None
    assert out.shape == (B, S, tc.d_model)
    _close(out, jout, F32_TOL)


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_mla_prefill_then_absorbed_decode_match_jax(impl):
    """A 12-token prefill into a 32-row cache (the expand path over the
    whole cache, bounded by the valid length), then one absorbed decode
    step at ragged positions (row 1 rewinds to 9): the outputs and both
    latent caches equal the reference's."""
    jc, tc, jp, tp = _mla_models()
    jc = dataclasses.replace(jc, attn_impl=impl)
    rules = make_rules(jc, None, None)
    B, P, max_len = 2, 12, 32
    raw = mla_cache_specs(tc, B, max_len)
    jcache = {k: jnp.zeros(shape, jnp.float32)
              for k, (shape, _) in raw.items()}
    cache = {k: torch.zeros(shape) for k, (shape, _) in raw.items()}
    pre = np.broadcast_to(np.arange(P, dtype=np.int32), (B, P)).copy()
    steps = [(_x(tc, B, P, 1), pre),
             (_x(tc, B, 1, 2), np.asarray([[P], [9]], np.int32))]
    for x, pos in steps:
        jout, jcache = j_mla(jc, jp, jnp.asarray(x), rules=rules,
                             positions=jnp.asarray(pos), cache=jcache)
        out, got = mla_attention(tc, tp, torch.from_numpy(x),
                                 positions=torch.from_numpy(pos),
                                 cache=cache)
        assert got is cache                     # written in place
        _close(out, jout, F32_TOL)
        for k in ("ckv", "krope"):
            _close(cache[k], jcache[k], F32_TOL)


def test_mla_layers_reach_flash_attention_at_prefill_only(monkeypatch):
    """Through the model: each MLA layer's expand path calls the flash
    attention wrapper once per prefill, at (hd, hdv) = (nope + rope, v)
    with the whole cache as its keys; an absorbed decode step calls no
    attention kernel."""
    tc = dataclasses.replace(get_config("deepseek-v2-236b").reduced(),
                             compute_dtype="float32")
    jc = dataclasses.replace(jax_config("deepseek-v2-236b").reduced(),
                             compute_dtype="float32")
    from repro.models import model_specs as j_specs
    params = from_reference(tc, ref_params(j_specs(jc), 1), "cpu")
    calls = {"flash": [], "decode": 0}
    real = attn_mod.flash_attention

    def flash(q, k, v, **kw):
        calls["flash"].append((q.shape, k.shape, v.shape))
        return real(q, k, v, **kw)

    def decode(*args, **kw):
        calls["decode"] += 1
        raise AssertionError("MLA decodes by absorbed products")
    monkeypatch.setattr(attn_mod, "flash_attention", flash)
    monkeypatch.setattr(attn_mod, "decode_attention", decode)
    B, P, max_len = 2, 8, 16
    cache = zeros_from_specs(cache_specs(tc, B, max_len), "cpu")
    toks = np.random.RandomState(0).randint(0, tc.vocab_size, (B, P + 1))
    pos = np.broadcast_to(np.arange(P, dtype=np.int32), (B, P)).copy()
    forward(tc, params, {"tokens": torch.from_numpy(toks[:, :P]),
                         "positions": torch.from_numpy(pos)}, cache=cache)
    m, H = tc.mla, tc.num_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    assert calls["flash"] == [((B, P, H, qk), (B, max_len, H, qk),
                               (B, max_len, H, m.v_head_dim))] * 2
    forward(tc, params, {"tokens": torch.from_numpy(toks[:, P:]),
                         "positions": torch.full((B, 1), P,
                                                 dtype=torch.int32)},
            cache=cache)
    assert len(calls["flash"]) == 2 and calls["decode"] == 0
