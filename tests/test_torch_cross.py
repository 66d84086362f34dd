"""Cross attention and the modality frontends on the CPU against the JAX
package's.

The reduced llama-3.2-vision-90b (5 layers: 4 self, then 1 cross; a
vision stub of 16 patch tokens of width 64) and the reduced
musicgen-large (2 layers, MHA; a frame frontend of width 64), float32
compute, the same weights (``tests/_ref_params.py``) in both frameworks,
held against the reference's default ``"xla"`` route.

The reference's init sets every cross layer's ``gate`` to 0, and its
engine feeds zero vision: either way a cross layer adds exactly 0, so
nothing of its path would be tested. The tests here redraw the gates to
nonzero values (:func:`_redraw_gates`) and feed seeded vision and frame
inputs of unit scale times ``VIS_SCALE`` (the frontend's 0.02-scaled
projection would otherwise leave K and V near 0 and the softmax near
uniform).

The decode steps run at positions below ``n_vis - 1``: there the
reference's xla route attends to all vision rows and its Pallas route
only to the first ``position + 1``; the port follows the xla route (a
cross layer's decode passes no query position to the kernel).

Tolerance, that of ``tests/test_torch_model.py``: 2e-5 absolute in
float32 (hidden states of magnitude ~4, logits ~1).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_config
from repro.models import attention as j_attn
from repro.models import cache_specs as j_cache_specs
from repro.models import forward as j_forward
from repro.models import layers as j_layers
from repro.models import logits_from_hidden as j_logits
from repro.models import model_specs as j_specs
from repro.models.params import is_spec
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro.sharding.rules import make_rules
from _ref_params import ref_params
from repro_torch.configs import get_config
from repro_torch.models import (cache_specs, forward, from_reference,
                                logits_from_hidden, model_specs,
                                zeros_from_specs)
from repro_torch.models import attention as t_attn
from repro_torch.models import layers as t_layers
from repro_torch.serving import Request, ServingEngine

F32_TOL = 2e-5
VLM, AUDIO = "llama-3.2-vision-90b", "musicgen-large"
VIS_SCALE = 4.0
CROSS = 4                       # the reduced vlm's cross layer


def _redraw_gates(tree, rng):
    """``tree`` with every ``gate`` leaf redrawn to +-U(0.5, 1.5)."""
    if isinstance(tree, dict):
        return {k: (rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32)
                    * rng.choice([-1.0, 1.0], np.shape(v)).astype(np.float32)
                    if k == "gate" else _redraw_gates(v, rng))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_redraw_gates(v, rng) for v in tree)
    return tree


def _configs(arch):
    kw = dict(compute_dtype="float32")
    return (dataclasses.replace(jax_config(arch).reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


@pytest.fixture(scope="module")
def models():
    """arch -> (jax cfg, port cfg, jax params, port params), gates
    redrawn."""
    out = {}
    for arch in (VLM, AUDIO):
        jc, tc = _configs(arch)
        p = _redraw_gates(ref_params(j_specs(jc), 0),
                          np.random.RandomState(0))
        out[arch] = (jc, tc, jax.tree.map(jnp.asarray, p),
                     from_reference(tc, p, "cpu"))
    return out


def _raw(cfg, B, T, seed):
    """Seeded (B, T, raw_dim) float32 patch or frame embeddings."""
    rng = np.random.RandomState(seed)
    return (VIS_SCALE * rng.standard_normal(
        (B, T, cfg.vision.raw_dim))).astype(np.float32)


def _tokens(cfg, B, S, seed=0):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _pos(B, S, start=0):
    return np.broadcast_to(np.arange(start, start + S, dtype=np.int32),
                           (B, S)).copy()


def _close(port, ref, tol=F32_TOL):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), atol=tol)


def test_configs_and_specs(models):
    jc, tc, jp, tp = models[VLM]
    assert [m for m, _ in tc.layer_specs()] == ["attn"] * 4 + ["cross"]
    assert tc.vision.num_tokens == 16 and tc.vision.raw_dim == 64
    assert tp["frontend"]["proj"].shape == (64, tc.d_model)
    gate = tp["layers"][CROSS]["mixer"]["gate"]
    assert gate.shape == () and gate.dtype == torch.float32
    assert float(gate) != 0.0
    assert "gate" not in tp["layers"][0]["mixer"]
    cache = cache_specs(tc, 3, 32)["layers"]
    assert sorted(cache[CROSS]) == ["ck", "cv"]
    assert cache[CROSS]["ck"].shape == (3, 16, tc.num_kv_heads, tc.head_dim)
    assert "kv_seq" not in cache[CROSS]["ck"].axes
    _, ac, _, ap = models[AUDIO]
    assert {m for m, _ in ac.layer_specs()} == {"attn"}
    assert ac.num_kv_heads == ac.num_heads
    assert ap["frontend"]["proj"].shape == (64, ac.d_model)


@pytest.mark.parametrize("S", [1, 5, 32])
def test_cross_attention_module(models, S):
    """One cross layer without a cache: queries of S tokens against the
    projected vision rows, tanh-gated (S = 1 is the decode kernel's
    route, the others flash attention's, non-causal)."""
    jc, tc, jp, tp = models[VLM]
    rng = np.random.RandomState(S)
    B, T = 2, jc.vision.num_tokens
    x = rng.standard_normal((B, S, jc.d_model)).astype(np.float32)
    vis = rng.standard_normal((B, T, jc.d_model)).astype(np.float32)
    pos = _pos(B, S, start=3)
    jout, _ = j_attn.attention(
        jc, jp["prefix"][CROSS]["mixer"], jnp.asarray(x),
        rules=make_rules(jc, None, None), positions=jnp.asarray(pos),
        vision=jnp.asarray(vis), cross=True)
    tout, _ = t_attn.cross_attention(
        tc, tp["layers"][CROSS]["mixer"], torch.from_numpy(x),
        positions=torch.from_numpy(pos), vision=torch.from_numpy(vis))
    _close(tout, jout)
    assert float(tout.abs().max()) > 1e-2      # the gate let it through


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_frontend(models, arch):
    jc, tc, jp, tp = models[arch]
    raw = _raw(jc, 2, 7, seed=1)
    _close(t_layers.frontend(tp["frontend"], torch.from_numpy(raw),
                             torch.float32),
           j_layers.frontend(jp["frontend"], jnp.asarray(raw), jnp.float32))


def test_vlm_forward(models):
    """Tokens and vision, no cache; the cross layer changes the output
    (with its gate at 0 the hidden states differ)."""
    jc, tc, jp, tp = models[VLM]
    B, S = 2, 12
    toks, vis = _tokens(jc, B, S), _raw(jc, B, jc.vision.num_tokens, 2)
    pos = _pos(B, S)
    jx, _, _ = j_forward(jc, jp, {"tokens": jnp.asarray(toks),
                                  "positions": jnp.asarray(pos),
                                  "vision": jnp.asarray(vis)},
                         rules=make_rules(jc, None, None))
    batch = {"tokens": torch.from_numpy(toks),
             "positions": torch.from_numpy(pos),
             "vision": torch.from_numpy(vis)}
    tx, _, _ = forward(tc, tp, batch)
    _close(tx, jx)
    _close(logits_from_hidden(tc, tp, tx),
           j_logits(jc, jp, jx, make_rules(jc, None, None)))
    shut = dict(tp, layers=list(tp["layers"]))
    shut["layers"][CROSS] = dict(tp["layers"][CROSS])
    shut["layers"][CROSS]["mixer"] = dict(
        tp["layers"][CROSS]["mixer"], gate=torch.zeros(()))
    assert float((forward(tc, shut, batch)[0] - tx).abs().max()) > 1e-2


def _prefill_decode(jc, tc, jp, tp, steps=3):
    """Prefill 8 tokens with vision, then ``steps`` decode steps at
    positions below n_vis - 1 (row 1 rewinds to 3): the port's decode
    gets no vision (its cross layer reads the cache), the reference's the
    zeros its engine feeds (its cross layer reads the cache too). float32
    caches in both. Returns the last-position logits of every step and
    both caches."""
    rules = make_rules(jc, None, None)
    B, P, max_len = 2, 8, 32
    T = jc.vision.num_tokens
    toks = _tokens(jc, B, P + steps, seed=3)
    vis = _raw(jc, B, T, seed=4)
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          j_cache_specs(jc, B, max_len, jnp.float32),
                          is_leaf=is_spec)
    tcache = zeros_from_specs(cache_specs(tc, B, max_len, torch.float32),
                              "cpu")
    jb = {"tokens": jnp.asarray(toks[:, :P]),
          "positions": jnp.asarray(_pos(B, P)), "vision": jnp.asarray(vis)}
    tb = {"tokens": torch.from_numpy(toks[:, :P]),
          "positions": torch.from_numpy(_pos(B, P)),
          "vision": torch.from_numpy(vis)}
    outs = []
    for t in range(steps + 1):
        jx, jcache, _ = j_forward(jc, jp, jb, rules=rules, cache=jcache)
        tx, tcache, _ = forward(tc, tp, tb, cache=tcache)
        outs.append((logits_from_hidden(tc, tp, tx, last_only=True),
                     j_logits(jc, jp, jx, rules, last_only=True)))
        if t == steps:
            break
        tk = toks[:, P + t:P + t + 1]
        ps = np.asarray([[P + t], [3 + t]], np.int32)
        assert ps.max() < T - 1
        jb = {"tokens": jnp.asarray(tk), "positions": jnp.asarray(ps),
              "vision": jnp.zeros((B, T, jc.vision.raw_dim), jnp.float32)}
        tb = {"tokens": torch.from_numpy(tk),
              "positions": torch.from_numpy(ps)}
    return outs, tcache, jcache


def test_vlm_prefill_then_decode(models):
    """Prefill writes the cross layer's vision K/V into the cache in
    place; the decode steps read them and attend to every vision row."""
    jc, tc, jp, tp = models[VLM]
    outs, tcache, jcache = _prefill_decode(jc, tc, jp, tp)
    for port, ref in outs:
        _close(port, ref)
    layers = from_reference(tc, jax.tree.map(np.asarray, jcache),
                            "cpu")["layers"]
    for got, want in zip(tcache["layers"], layers, strict=True):
        assert sorted(got) == sorted(want)
        for name in got:
            _close(got[name], want[name])
    assert float(tcache["layers"][CROSS]["ck"].abs().max()) > 0.1


def test_vlm_decode_follows_the_xla_route_not_the_pallas_one(models):
    """The reference's own two routes disagree at a cross layer's decode
    below n_vis - 1 (its Pallas decode kernel masks vision rows past the
    query position); the port equals the xla route (above) and so not
    the Pallas one."""
    jc, tc, jp, tp = models[VLM]
    pallas = dataclasses.replace(jc, attn_impl="pallas_interpret")
    outs, _, _ = _prefill_decode(pallas, tc, jp, tp, steps=1)
    port, ref = outs[-1]
    assert np.abs(port.numpy() - np.asarray(ref)).max() > 1e-3


@pytest.mark.parametrize("with_tokens", [False, True])
def test_audio_frames_forward(models, with_tokens):
    """musicgen's input is the frontend's projection of the frames, plus
    the token embedding when tokens come too."""
    jc, tc, jp, tp = models[AUDIO]
    B, S = 2, 10
    frames, pos = _raw(jc, B, S, seed=5), _pos(B, S)
    jb = {"frames": jnp.asarray(frames), "positions": jnp.asarray(pos)}
    tb = {"frames": torch.from_numpy(frames),
          "positions": torch.from_numpy(pos)}
    if with_tokens:
        toks = _tokens(jc, B, S, seed=6)
        jb["tokens"], tb["tokens"] = jnp.asarray(toks), torch.from_numpy(toks)
    jx, _, _ = j_forward(jc, jp, jb, rules=make_rules(jc, None, None))
    tx, _, _ = forward(tc, tp, tb)
    _close(tx, jx)


@pytest.mark.parametrize("scattered", [False, True])
def test_engine_writes_the_cross_cache_in_place(models, scattered):
    """The engine's prefill, given nonzero vision, leaves in its cache
    rows the vision K/V of a direct forward: through one view of
    consecutive slots, or gathered and written back for scattered ones
    (a cross layer that returned a new cache would leave zeros)."""
    jc, tc, jp, tp = models[VLM]
    eng = ServingEngine(tc, tp, batch_slots=3, max_len=32, device="cpu")
    vis = {}
    inner = eng._prefill_sample

    def prefill(params, batch, cache):
        n = batch["tokens"].shape[0]
        vis[n] = torch.from_numpy(_raw(tc, n, tc.vision.num_tokens, 7 + n))
        return inner(params, dict(batch, vision=vis[n]), cache)
    eng._prefill_sample = prefill
    rng = np.random.RandomState(8)
    prompt = lambda n: rng.randint(1, tc.vocab_size, n).astype(np.int32)
    if scattered:           # slots 0 and 2 finish at admission
        for n, m in ((2, 1), (3, 9), (5, 1)):
            eng.submit(Request(prompt=prompt(n), max_new_tokens=m))
        eng.step()
        slots = eng._free_slots()
        assert slots == [0, 2]
    else:
        slots = [0, 1]
    for _ in slots:
        eng.submit(Request(prompt=prompt(4), max_new_tokens=3))
    eng._admit()
    direct = zeros_from_specs(cache_specs(tc, 2, 32), "cpu")
    forward(tc, tp, {"tokens": torch.zeros((2, 4), dtype=torch.int32),
                     "positions": torch.from_numpy(_pos(2, 4)),
                     "vision": vis[2]}, cache=direct)
    for name in ("ck", "cv"):
        got = eng.cache["layers"][CROSS][name][slots]
        assert float(got.float().abs().max()) > 0.1
        torch.testing.assert_close(got, direct["layers"][CROSS][name])


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_engine_tokens_equal_the_jax_engine(models, arch):
    """More requests than slots, slots recycled, three prompt lengths,
    the default bf16 cache: every request gets the JAX engine's tokens
    (both engines feed a vlm zero vision at prefill; the port none at
    decode)."""
    jc, tc, jp, tp = models[arch]
    jeng = JServingEngine(jc, jp, make_rules(jc, None, None),
                          batch_slots=3, max_len=32)
    teng = ServingEngine(tc, tp, batch_slots=3, max_len=32, device="cpu")
    rng = np.random.RandomState(9)
    specs = [(rng.randint(1, tc.vocab_size, L).astype(np.int32), m)
             for L, m in ((3, 5), (5, 4), (3, 6), (7, 2), (5, 5), (3, 3))]
    jreqs = [JRequest(prompt=p, max_new_tokens=m) for p, m in specs]
    treqs = [Request(prompt=p, max_new_tokens=m) for p, m in specs]
    for jr, tr in zip(jreqs, treqs):
        jeng.submit(jr)
        teng.submit(tr)
    jeng.run_until_drained()
    teng.run_until_drained()
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    for key in ("prefill_dispatches", "decode_steps", "tokens_generated"):
        assert teng.stats()[key] == jeng.stats()[key], key
    if arch == VLM:
        assert _kv_leaf(teng) == (0, "k")


def _kv_leaf(eng):
    """(layer, leaf) of the ST payload's KV leaf: the first self layer's
    ``k``, never a cross layer's vision cache."""
    layer, name, _ = eng._find_kv_leaf(cache_specs(eng.cfg, eng.B,
                                                   eng.max_len))
    return layer, name


def test_full_width_param_counts(models):
    """The port's full-width trees count what the reference's do, and
    the 20-layer cut of llama served on the card: four whole 5-layer
    periods (16 self, 4 cross), 19.21 B params."""
    from repro.models.params import param_count as j_param_count
    from repro_torch.models import param_count
    for arch in (VLM, AUDIO):
        assert param_count(model_specs(get_config(arch))) == \
            j_param_count(j_specs(jax_config(arch)))
    cut = dataclasses.replace(get_config(VLM), num_layers=20)
    mixers = [m for m, _ in cut.layer_specs()]
    assert mixers.count("cross") == 4 and mixers[-1] == "cross"
    jcut = dataclasses.replace(jax_config(VLM), num_layers=20)
    assert round(jcut.param_counts()["total"] / 1e9, 2) == 19.21
    assert param_count(model_specs(cut)) == j_param_count(j_specs(jcut))
