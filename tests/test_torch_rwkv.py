"""The port's rwkv6 on the CPU against the JAX package's.

Kernel level: the plain WKV6 version ``wkv6_ref`` (and the wrapper
``wkv6``, which takes it for CPU tensors) against the JAX ``wkv6``
(its Pallas kernel in interpret mode) at the shapes of
``tests/test_kernels.py``, and against the JAX ``wkv6_ref`` at lengths
the Pallas kernel refuses (S = 100 is no multiple of its 64-step
chunk). ``wkv6_chunked``, the recurrence's chunked decomposition in
plain PyTorch, against ``wkv6_ref`` and the JAX Pallas kernel at S = 1,
one chunk - 1, one chunk, one chunk + 1 and 100 steps, with the state
carried across calls, and with the card's inputs' decays (logw =
-exp(N(0,1))) plus the steps that strain a chunked form most: a decay
of -90 in one step followed by steps of -0.011. Tolerance 1e-5, that of
``test_kernels.py``: all sides sum the same float32 terms in other
orders (measured ~2e-7; the chunked form ~1e-6 at 4 x 1000).

Model level: the reduced rwkv6-1.6b (2 layers, d_model 128, 4 heads of
32) with the same weights (the reference's leaf rules drawn by
``tests/_ref_params.py``, a fixed function of the seed, with the
token-shift mixes, decay base, bonus and ``ln_x`` redrawn by
``tests/_rwkv_draws.py`` so that none is inert, handed over as numpy
through ``from_reference``):
``time_mix``/``channel_mix`` and the whole ``forward`` without a cache
and as a prefill plus decode steps through the cache, against the JAX
functions with ``attn_impl`` "xla" and "pallas_interpret". Tolerances
those of ``tests/test_torch_model.py``: float32 2e-5, bf16 2e-2.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_config
from repro.kernels.rwkv6 import wkv6 as j_wkv6
from repro.kernels.rwkv6.kernel import wkv6_fwd as j_wkv6_fwd
from repro.kernels.rwkv6.ref import wkv6_ref as j_wkv6_ref
from repro.models import cache_specs as j_cache_specs
from repro.models import forward as j_forward
from repro.models import logits_from_hidden as j_logits
from repro.models import model_specs as j_specs
from repro.models import rwkv as j_rwkv
from repro.models.params import is_spec, param_count as j_param_count
from repro.sharding.rules import make_rules
from repro_torch.configs import get_config
from repro_torch.models import (cache_specs, forward, from_reference,
                                init_params, logits_from_hidden,
                                model_specs, param_count,
                                zeros_from_specs)
from repro_torch.models import rwkv
from repro_torch.kernels import _build
from repro_torch.kernels.rwkv6 import wkv6, wkv6_ref
from repro_torch.kernels.rwkv6.ref import CHUNK, wkv6_chunked
from _ref_params import ref_params
from _rwkv_draws import redraw_rwkv

WKV_TOL = 1e-5
F32_TOL = 2e-5
BF16_TOL = 2e-2


def _np(t):
    return t.float().numpy()


# ---------------------------------------------------------------------------
# WKV6: plain version and wrapper
# ---------------------------------------------------------------------------

def _wkv_inputs(B, S, H, hd, seed=0):
    """The inputs of test_kernels.py's wkv6 cases: r, k, v at scale 0.3,
    logw = -exp(0.3 N(0,1)), u and s0 at scale 0.1."""
    rng = np.random.RandomState(seed)
    r, k, v = [(rng.randn(B, S, H, hd) * 0.3).astype(np.float32)
               for _ in range(3)]
    logw = -np.exp(rng.randn(B, S, H, hd) * 0.3).astype(np.float32)
    u = (rng.randn(H, hd) * 0.1).astype(np.float32)
    s0 = (rng.randn(B, H, hd, hd) * 0.1).astype(np.float32)
    return r, k, v, logw, u, s0


@pytest.mark.parametrize("B,S,H,hd", [(2, 128, 2, 32), (1, 256, 4, 64)])
def test_wkv6_matches_the_jax_kernel(B, S, H, hd):
    ins = _wkv_inputs(B, S, H, hd)
    jy, jsT = j_wkv6(*map(jnp.asarray, ins), interpret=True)
    for fn in (wkv6_ref, wkv6):
        y, sT = fn(*map(torch.from_numpy, ins))
        assert y.dtype == sT.dtype == torch.float32
        assert y.shape == (B, S, H, hd) and sT.shape == (B, H, hd, hd)
        np.testing.assert_allclose(_np(y), np.asarray(jy), atol=WKV_TOL)
        np.testing.assert_allclose(_np(sT), np.asarray(jsT), atol=WKV_TOL)


@pytest.mark.parametrize("S", [1, 100])
def test_wkv6_takes_any_length(S):
    """S = 1 is a decode step; S = 100 a prompt the Pallas kernel
    refuses (S % 64 != 0): against the JAX plain version."""
    ins = _wkv_inputs(2, S, 4, 32, seed=1)
    jy, jsT = j_wkv6_ref(*map(jnp.asarray, ins))
    y, sT = wkv6(*map(torch.from_numpy, ins))
    np.testing.assert_allclose(_np(y), np.asarray(jy), atol=WKV_TOL)
    np.testing.assert_allclose(_np(sT), np.asarray(jsT), atol=WKV_TOL)


def test_wkv6_carries_state_across_calls():
    """Two runs of 60 and 40 steps with the state carried equal one run
    of 100 (test_wkv6_state_continuity, at a ragged split)."""
    r, k, v, logw, u, s0 = map(torch.from_numpy, _wkv_inputs(1, 100, 2, 32))
    y, sT = wkv6(r, k, v, logw, u, s0)
    y1, s1 = wkv6(r[:, :60], k[:, :60], v[:, :60], logw[:, :60], u, s0)
    y2, s2 = wkv6(r[:, 60:], k[:, 60:], v[:, 60:], logw[:, 60:], u, s1)
    np.testing.assert_allclose(_np(torch.cat([y1, y2], 1)), _np(y),
                               atol=WKV_TOL)
    np.testing.assert_allclose(_np(s2), _np(sT), atol=WKV_TOL)


def test_wkv6_in_place_writes_the_state_over_s0():
    r, k, v, logw, u, s0 = map(torch.from_numpy, _wkv_inputs(2, 9, 2, 32))
    y, sT = wkv6(r, k, v, logw, u, s0.clone())
    cache = s0.clone()
    y2, sT2 = wkv6(r, k, v, logw, u, cache, inplace=True)
    assert sT2 is cache
    assert torch.equal(y2, y) and torch.equal(cache, sT)
    assert not torch.equal(cache, s0)


def test_wkv6_takes_bf16_inputs_as_their_float32_values():
    """bf16 r, k, v are upcast: the result is that of their float32
    values (both sides see the same numbers)."""
    ins = list(_wkv_inputs(2, 70, 2, 32, seed=2))
    r, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in ins[:3])
    y, sT = wkv6(r, k, v, *map(torch.from_numpy, ins[3:]))
    jy, jsT = j_wkv6_ref(*(jnp.asarray(_np(t)) for t in (r, k, v)),
                         *map(jnp.asarray, ins[3:]))
    np.testing.assert_allclose(_np(y), np.asarray(jy), atol=WKV_TOL)
    np.testing.assert_allclose(_np(sT), np.asarray(jsT), atol=WKV_TOL)


def _pallas_wkv6(ins):
    """The JAX Pallas kernel in interpret mode, with a chunk that divides
    S (it asserts S % chunk == 0)."""
    S = ins[0].shape[1]
    chunk = max(c for c in range(1, 65) if S % c == 0)
    return j_wkv6_fwd(*map(jnp.asarray, ins), chunk=chunk, interpret=True)


def _held(got, *wants):
    """(y, sT) against each (y, sT) of ``wants`` within WKV_TOL."""
    for want in wants:
        for a, b in zip(got, want):
            np.testing.assert_allclose(_np(a), np.asarray(b), atol=WKV_TOL)


@pytest.mark.parametrize("S", [1, CHUNK - 1, CHUNK, CHUNK + 1, 100])
def test_wkv6_chunked_matches_ref_and_the_jax_kernel(S):
    """The chunked decomposition at every edge of its chunking (a single
    step, a ragged chunk, exactly one, one step into a second, and 100 =
    6 chunks + 4, no multiple of 16 or 64), from a nonzero s0."""
    ins = _wkv_inputs(2, S, 2, 32, seed=3)
    got = wkv6_chunked(*map(torch.from_numpy, ins))
    assert got[0].dtype == got[1].dtype == torch.float32
    assert got[0].shape == (2, S, 2, 32) and got[1].shape == (2, 2, 32, 32)
    _held(got, wkv6_ref(*map(torch.from_numpy, ins)), _pallas_wkv6(ins))


def test_wkv6_chunked_carries_state_across_calls():
    """Two calls of 37 and 63 steps (ragged chunks on both sides) with the
    state carried equal one call of 100 and the JAX plain version."""
    r, k, v, logw, u, s0 = map(torch.from_numpy, _wkv_inputs(1, 100, 2, 64,
                                                             seed=4))
    y1, s1 = wkv6_chunked(r[:, :37], k[:, :37], v[:, :37], logw[:, :37], u,
                          s0)
    y2, s2 = wkv6_chunked(r[:, 37:], k[:, 37:], v[:, 37:], logw[:, 37:], u,
                          s1)
    got = (torch.cat([y1, y2], 1), s2)
    _held(got, wkv6_chunked(r, k, v, logw, u, s0),
          j_wkv6_ref(*(jnp.asarray(_np(t)) for t in (r, k, v, logw, u,
                                                     s0))))


def test_wkv6_chunked_takes_the_worst_decays():
    """The decays of the card's inputs (logw = -exp(N(0,1)), down to
    about -20 a step at these sizes), with a step of logw = -90 (exp(4.5),
    the deepest of a 4 x 1000 x 32 x 64 draw) followed by steps of
    -0.011 (exp(-4.5)) in every head: a form that took decays as
    differences of long prefix sums of logw would lose their spacing
    here. Against the Pallas kernel and the plain version."""
    rng = np.random.RandomState(5)
    r, k, v, _, u, s0 = _wkv_inputs(2, 100, 2, 64, seed=5)
    logw = -np.exp(rng.randn(*r.shape)).astype(np.float32)
    logw[:, 20] = -np.exp(4.5)
    logw[:, 21:40] = -np.exp(-4.5)
    logw[:, 50:53] = -np.exp(4.5)
    ins = (r, k, v, logw, u, s0)
    got = wkv6_chunked(*map(torch.from_numpy, ins))
    _held(got, wkv6_ref(*map(torch.from_numpy, ins)), _pallas_wkv6(ins))


@pytest.mark.parametrize("what", ["head", "dtype", "state", "device"])
def test_wkv6_kernel_refuses_what_it_cannot_take(what):
    """Off the CPU the wrapper launches the kernel or raises: the input
    checks run before any launch (shown here on meta tensors)."""
    B, S, H, hd = 2, 5, 2, 32
    mk = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt,
                                                  device="meta")
    args = dict(r=mk(B, S, H, hd), k=mk(B, S, H, hd), v=mk(B, S, H, hd),
                logw=mk(B, S, H, hd), u=mk(H, hd), s0=mk(B, H, hd, hd))
    if what == "head":
        args = {n: a[..., :24] if n != "s0" else mk(B, H, 24, 24)
                for n, a in args.items()}
        err, match = ValueError, "head size 24"
    elif what == "dtype":
        for n in ("r", "k", "v"):
            args[n] = args[n].half()
        err, match = TypeError, "one dtype"
    elif what == "state":
        args["s0"] = mk(B, H, hd, 2 * hd)[..., :hd]
        err, match = ValueError, "state"
    else:
        err, match = ValueError, "CUDA tensor"
    _build.reset_launches()
    with pytest.raises(err, match=match):
        wkv6(**args)
    assert _build.LAUNCHES["wkv6"] == 0


# ---------------------------------------------------------------------------
# the reduced model against the JAX package's
# ---------------------------------------------------------------------------

def _configs(dtype="float32"):
    kw = dict(compute_dtype=dtype)
    return (dataclasses.replace(jax_config("rwkv6-1.6b").reduced(), **kw),
            dataclasses.replace(get_config("rwkv6-1.6b").reduced(), **kw))


def _models(dtype="float32", seed=0):
    jc, tc = _configs(dtype)
    jp = redraw_rwkv(ref_params(j_specs(jc), seed),
                     np.random.RandomState(seed))
    tp = from_reference(tc, jp, "cpu", dtype=getattr(torch, dtype))
    return jc, tc, jax.tree.map(jnp.asarray, jp), tp


@pytest.fixture(scope="module")
def models():
    return _models()


def _tokens(cfg, B, S, seed=0):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _close(port, ref, tol):
    np.testing.assert_allclose(_np(port), np.asarray(ref, np.float32),
                               atol=tol)


def test_reduced_config_and_weights(models):
    jc, tc, jp, tp = models
    assert (tc.num_layers, tc.d_model, tc.rwkv.head_size) == (2, 128, 32)
    assert tc.layer_specs() == [("rwkv", "rwkv")] * 2
    assert param_count(model_specs(tc)) == j_param_count(j_specs(jc))
    mixer = tp["layers"][1]["mixer"]
    np.testing.assert_array_equal(mixer["bonus"].numpy(),
                                  np.asarray(jp["unit"][0]["mixer"]
                                             ["bonus"][1]))
    assert mixer["mix_r"].dtype == torch.float32
    assert not torch.all(mixer["mix_r"] == 1)


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_time_mix_and_channel_mix_match_jax(models, impl, cached):
    """One layer's mixers on the same pre-norm'd input, with and without
    a cache holding nonzero shifts and state; the caches they write too."""
    jc, tc, jp, tp = models
    rules = make_rules(jc, None, None)
    B, S, D = 2, 48, tc.d_model
    H, hd = D // tc.rwkv.head_size, tc.rwkv.head_size
    rng = np.random.RandomState(3)
    x = rng.randn(B, S, D).astype(np.float32)
    jcache = tcache = None
    if cached:
        c = {"shift_t": rng.randn(B, D).astype(np.float32),
             "shift_c": rng.randn(B, D).astype(np.float32),
             "wkv": (rng.randn(B, H, hd, hd) * 0.1).astype(np.float32)}
        jcache = {k: jnp.asarray(a) for k, a in c.items()}
        tcache = {k: torch.from_numpy(a.copy()) for k, a in c.items()}
    jt = jax.tree.map(lambda a: a[0], jp["unit"][0])
    tl = tp["layers"][0]
    jo, jnc = j_rwkv.time_mix(jc, jt["mixer"], jnp.asarray(x), rules=rules,
                              cache=jcache, impl=impl)
    to, tnc = rwkv.time_mix(tc, tl["mixer"], torch.from_numpy(x),
                            cache=tcache)
    _close(to, jo, F32_TOL)
    jo2, jnc2 = j_rwkv.channel_mix(jc, jt["ffn"], jnp.asarray(x),
                                   rules=rules, cache=jnc)
    to2, tnc2 = rwkv.channel_mix(tc, tl["ffn"], torch.from_numpy(x),
                                 cache=tnc)
    _close(to2, jo2, F32_TOL)
    if cached:
        for k in ("shift_t", "shift_c", "wkv"):
            _close(tnc2[k], jnc2[k], F32_TOL)


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_forward_matches_jax(models, impl):
    """float32 hidden states (|x| up to ~4.5) and logits of 32 tokens
    within F32_TOL of the reference's route ``impl``, plus the distance
    between the reference's own two routes (xla and pallas_interpret: the
    WKV sums in two orders). That distance reached 2.8e-5 of the hidden
    states on one of 21 weight draws, beyond F32_TOL alone (the port lay
    3.8e-5 from the pallas_interpret route and 1.1e-5 from xla there)."""
    jc, tc, jp, tp = models
    B, S = 2, 32
    toks = _tokens(jc, B, S)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()

    def reference(route):
        c = dataclasses.replace(jc, attn_impl=route)
        rules = make_rules(c, None, None)
        x, _, _ = j_forward(c, jp, {"tokens": jnp.asarray(toks),
                                    "positions": jnp.asarray(pos)},
                            rules=rules)
        return np.asarray(x, np.float32), np.asarray(
            j_logits(c, jp, x, rules), np.float32)
    refs = {r: reference(r) for r in ("xla", "pallas_interpret")}
    jx, jl = refs[impl]
    spread = [float(np.abs(a - b).max())
              for a, b in zip(refs["xla"], refs["pallas_interpret"])]
    for route in ("kernel", "plain"):
        tx, _, aux = forward(dataclasses.replace(tc, attn_impl=route), tp,
                             {"tokens": torch.from_numpy(toks),
                              "positions": torch.from_numpy(pos)})
        _close(tx, jx, F32_TOL + spread[0])
        _close(logits_from_hidden(tc, tp, tx), jl, F32_TOL + spread[1])
        assert float(aux) == 0.0


def _prefill_decode(jc, tc, jp, tp, cache_dt, P=64):
    """Prefill P tokens into a (B, max_len) cache, then 3 decode steps;
    last-position logits of every step from both frameworks."""
    rules = make_rules(jc, None, None)
    B, max_len = 2, 96
    toks = _tokens(jc, B, P + 3, seed=1)
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          j_cache_specs(jc, B, max_len, cache_dt[0]),
                          is_leaf=is_spec)
    tcache = zeros_from_specs(cache_specs(tc, B, max_len, cache_dt[1]),
                              "cpu")
    pos = np.broadcast_to(np.arange(P, dtype=np.int32), (B, P)).copy()
    steps = [(toks[:, :P], pos)]
    for t in range(3):
        steps.append((toks[:, P + t:P + t + 1],
                      np.full((B, 1), P + t, np.int32)))
    outs = []
    for tk, ps in steps:
        jx, jcache, _ = j_forward(jc, jp, {"tokens": jnp.asarray(tk),
                                           "positions": jnp.asarray(ps)},
                                  rules=rules, cache=jcache)
        tx, tcache, _ = forward(tc, tp, {"tokens": torch.from_numpy(tk),
                                         "positions": torch.from_numpy(ps)},
                                cache=tcache)
        outs.append((logits_from_hidden(tc, tp, tx, last_only=True),
                     j_logits(jc, jp, jx, rules, last_only=True)))
    return outs, tcache, jcache


@pytest.mark.parametrize("cache_dt", ["bfloat16", "float32"])
@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_prefill_and_decode_match_jax(models, impl, cache_dt):
    """float32 compute. With a float32 cache both sides carry the same
    float32 state: 2e-5. With the default bf16 cache the token shifts
    are rounded to bf16 on both sides (the wkv state stays float32), and
    a float32 input that differs by ~1e-6 between the frameworks may
    round to the neighbouring bf16 value (measured: logits 1.2e-4
    apart), so that case takes the bf16 tolerance, as the granite
    cache comparison of test_torch_model.py does."""
    jc, tc, jp, tp = models
    jc = dataclasses.replace(jc, attn_impl=impl)
    outs, tcache, jcache = _prefill_decode(
        jc, tc, jp, tp, (getattr(jnp, cache_dt), getattr(torch, cache_dt)))
    tol = F32_TOL if cache_dt == "float32" else BF16_TOL
    for port, ref in outs:
        _close(port, ref, tol)
    for layer in range(tc.num_layers):
        c = tcache["layers"][layer]
        assert c["wkv"].dtype == torch.float32
        assert c["shift_t"].dtype == getattr(torch, cache_dt)
        for name in ("shift_t", "shift_c", "wkv"):
            _close(c[name], jcache["unit"][0][name][layer], tol)


def test_prefill_and_decode_match_jax_in_bf16():
    """bf16 compute and cache. Each framework rounds to bf16 at its own
    points, and over 2 layers, a 40-token prefill and 3 decode steps the
    reference's own bf16 logits lie 0.011-0.030 from its float32 ones
    (21 weight draws), beyond BF16_TOL alone. So each step's logits are
    held within BF16_TOL of the reference's bf16 logits plus that step's
    distance of the reference's bf16 run from its float32 run (the same
    weights and tokens), as test_torch_mamba.py's ``_bf16_close`` holds
    jamba's."""
    jc, tc, jp, tp = _models("bfloat16", seed=1)
    assert tp["layers"][0]["mixer"]["wr"].dtype == torch.bfloat16
    outs, _, _ = _prefill_decode(jc, tc, jp, tp,
                                 (jnp.bfloat16, torch.bfloat16), P=40)
    jc32, tc32, jp32, tp32 = _models("float32", seed=1)
    outs32, _, _ = _prefill_decode(jc32, tc32, jp32, tp32,
                                   (jnp.float32, torch.float32), P=40)
    for (port, ref), (_, ref32) in zip(outs, outs32):
        ref, ref32 = (np.asarray(a, np.float32) for a in (ref, ref32))
        _close(port, ref, BF16_TOL + float(np.abs(ref - ref32).max()))


def test_full_rwkv_config():
    cfg = get_config("rwkv6-1.6b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.d_ff,
            cfg.vocab_size, cfg.rwkv.head_size, cfg.tie_embeddings) == \
        (24, 2048, 32, 7168, 65536, 64, False)
    specs = model_specs(cfg)
    assert param_count(specs) == j_param_count(
        j_specs(jax_config("rwkv6-1.6b")))
    assert 1.5e9 < param_count(specs) < 1.7e9
    c = cache_specs(cfg, 8, 4096)["layers"][0]
    assert c["wkv"].shape == (8, 32, 64, 64)
    assert c["wkv"].dtype == torch.float32
    assert c["shift_t"].shape == (8, 2048)
    assert c["shift_c"].dtype == torch.bfloat16


def test_init_params_draws_rwkv_leaves():
    cfg = get_config("rwkv6-1.6b").reduced()
    p = init_params(model_specs(cfg), torch.Generator().manual_seed(0),
                    "cpu", torch.bfloat16)
    mixer = p["layers"][0]["mixer"]
    assert mixer["wr"].dtype == torch.bfloat16
    assert mixer["w0"].dtype == torch.float32
    assert torch.equal(mixer["mix_k"], torch.ones(cfg.d_model))
    assert p["embed"]["unembed"].shape == (cfg.d_model, cfg.padded_vocab)
