"""The port's mamba, MoE and jamba on the CPU against the JAX package's.

Kernel level: the plain selective scan ``mamba_scan_ref`` (and the
wrapper ``mamba_scan``, which takes it for CPU tensors) against the JAX
``mamba_scan`` (its Pallas kernel in interpret mode) and ``mamba_scan_ref``
at the shapes of ``tests/test_kernels.py``, and against the JAX
``mamba_scan_ref`` at lengths the Pallas kernel refuses (S = 100 is no
multiple of its 64-step chunk) and at S = 1. Tolerance 1e-5 in float32,
that of ``test_kernels.py`` (both sides sum the same float32 terms in
other orders), and 2e-2 for a bf16 y (one bf16 rounding of the same
float32 value may land one spacing apart).

Model level, with the same weights (the reference's leaf rules drawn by
``tests/_ref_params.py``, a fixed function of the seed, with the mamba
leaves the reference's init leaves degenerate redrawn by
``tests/_mamba_draws.py``, handed over as numpy through
``from_reference``): ``mamba()`` without and with a cache (a prefill,
then 3 decode steps), ``moe_dense`` and ``moe_gshard`` (outputs and aux
loss, with a case where capacity drops tokens), and the reduced
jamba-1.5-large-398b ``forward`` at its 8 layers and at a 4-layer cut,
each with ``attn_impl`` "xla" and "pallas_interpret". Tolerances those of
``tests/test_torch_model.py``: float32 2e-5; bf16 2e-2 over the
reference's own bf16 spread (see ``_bf16_close``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_config
from repro.kernels.mamba_scan import mamba_scan as j_mamba_scan
from repro.kernels.mamba_scan.ref import mamba_scan_ref as j_mamba_scan_ref
from repro.models import forward as j_forward
from repro.models import logits_from_hidden as j_logits
from repro.models import mamba as j_mamba
from repro.models import model_specs as j_specs
from repro.models import moe as j_moe
from repro.models.params import param_count as j_param_count
from repro.sharding.rules import make_rules
from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.kernels.mamba_scan import mamba_scan, mamba_scan_ref
from repro_torch.models import (cache_specs, forward, from_reference,
                                init_params, logits_from_hidden,
                                model_specs, param_count)
from repro_torch.models import mamba, moe
from _mamba_draws import redraw_mamba
from _ref_params import ref_params

ARCH = "jamba-1.5-large-398b"
SCAN_TOL = 1e-5
F32_TOL = 2e-5
BF16_TOL = 2e-2
# the summed MoE aux loss (~0.04-0.09): the two frameworks' router
# softmax and mean sum in other orders
AUX_RTOL = 1e-3
# in bf16 the aux also counts each token's top-2 experts, and a near-tie
# that rounds the other way in one framework moves it by a step that the
# reference's own bf16-vs-float32 distance on one draw need not show
# (measured 8.8e-7 to 1.92e-3 of the aux over 21 weight draws x 4 cases,
# while the port's bf16 aux lay up to 1.68e-3 from the reference's). So
# the bf16 bound adds that spread's largest value, rounded up.
AUX_BF16_SPREAD = 2e-3


def _np(t):
    return t.float().numpy()


def _close(port, ref, tol):
    np.testing.assert_allclose(_np(port), np.asarray(ref, np.float32),
                               atol=tol)


# ---------------------------------------------------------------------------
# the selective scan: plain version and wrapper
# ---------------------------------------------------------------------------

def _scan_inputs(B, S, di, ds, seed=0):
    """test_kernels.py's mamba inputs: a_log at scale 0.1, dt = |0.1
    N(0,1)|, b, c, xc at scale 0.3, h0 at scale 0.1."""
    rng = np.random.RandomState(seed)
    mk = lambda *s, sc=0.3: (rng.randn(*s) * sc).astype(np.float32)
    return (mk(di, ds, sc=0.1), np.abs(mk(B, S, di, sc=0.1)), mk(B, S, ds),
            mk(B, S, ds), mk(B, S, di), mk(B, di, ds, sc=0.1))


@pytest.mark.parametrize("B,S,di,ds", [(2, 128, 64, 8), (1, 64, 128, 16)])
def test_mamba_scan_matches_the_jax_kernel(B, S, di, ds):
    ins = _scan_inputs(B, S, di, ds)
    jy, jhT = j_mamba_scan(*map(jnp.asarray, ins), interpret=True)
    ry, rhT = j_mamba_scan_ref(*map(jnp.asarray, ins))
    for fn in (mamba_scan_ref, mamba_scan):
        y, hT = fn(*map(torch.from_numpy, ins))
        assert y.dtype == hT.dtype == torch.float32
        assert y.shape == (B, S, di) and hT.shape == (B, di, ds)
        for ref_y, ref_hT in ((jy, jhT), (ry, rhT)):
            _close(y, ref_y, SCAN_TOL)
            _close(hT, ref_hT, SCAN_TOL)


@pytest.mark.parametrize("S", [1, 100])
def test_mamba_scan_takes_any_length(S):
    """S = 1 is a decode step; S = 100 a prompt the Pallas kernel
    refuses (S % 64 != 0): against the JAX plain version."""
    ins = _scan_inputs(3, S, 32, 8, seed=1)
    jy, jhT = j_mamba_scan_ref(*map(jnp.asarray, ins))
    y, hT = mamba_scan(*map(torch.from_numpy, ins))
    _close(y, jy, SCAN_TOL)
    _close(hT, jhT, SCAN_TOL)


def test_mamba_scan_carries_state_across_calls():
    """Two runs of 50 steps with the state carried equal one of 100."""
    a, dt, b, c, x, h0 = map(torch.from_numpy, _scan_inputs(2, 100, 64, 16))
    y, hT = mamba_scan(a, dt, b, c, x, h0)
    y1, h1 = mamba_scan(a, dt[:, :50], b[:, :50], c[:, :50], x[:, :50], h0)
    y2, h2 = mamba_scan(a, dt[:, 50:], b[:, 50:], c[:, 50:], x[:, 50:], h1)
    _close(torch.cat([y1, y2], 1), _np(y), SCAN_TOL)
    _close(h2, _np(hT), SCAN_TOL)


def test_mamba_scan_in_place_writes_the_state_over_h0():
    a, dt, b, c, x, h0 = map(torch.from_numpy, _scan_inputs(2, 9, 32, 8))
    y, hT = mamba_scan(a, dt, b, c, x, h0.clone())
    cache = h0.clone()
    y2, hT2 = mamba_scan(a, dt, b, c, x, cache, inplace=True)
    assert hT2 is cache
    assert torch.equal(y2, y) and torch.equal(cache, hT)
    assert not torch.equal(cache, h0)


def test_mamba_scan_takes_bf16_inputs_and_returns_y_in_their_dtype():
    """bf16 dt, b, c, xc are read as their float32 values: the state is
    that of those values to 1e-5, y the float32 result rounded to bf16."""
    ins = list(_scan_inputs(2, 70, 64, 16, seed=2))
    lo = [torch.from_numpy(a).to(torch.bfloat16) for a in ins[1:5]]
    a_log, h0 = torch.from_numpy(ins[0]), torch.from_numpy(ins[5])
    y, hT = mamba_scan(a_log, *lo, h0)
    assert y.dtype == torch.bfloat16 and hT.dtype == torch.float32
    jy, jhT = j_mamba_scan_ref(jnp.asarray(ins[0]),
                               *(jnp.asarray(_np(t)) for t in lo),
                               jnp.asarray(ins[5]))
    _close(y, jy, BF16_TOL * max(1.0, float(np.abs(jy).max())))
    _close(hT, jhT, SCAN_TOL)


@pytest.mark.parametrize("what", ["state size", "dtype", "a_log", "h0",
                                  "layout", "device"])
def test_mamba_scan_kernel_refuses_what_it_cannot_take(what):
    """Off the CPU the wrapper launches the kernel or raises: the input
    checks run before any launch (shown here on meta tensors)."""
    B, S, di, ds = 2, 5, 32, 16
    mk = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt,
                                                  device="meta")
    args = dict(a_log=mk(di, ds), dt=mk(B, S, di), b=mk(B, S, ds),
                c=mk(B, S, ds), xc=mk(B, S, di), h0=mk(B, di, ds))
    if what == "state size":
        args.update(a_log=mk(di, 4), b=mk(B, S, 4), c=mk(B, S, 4),
                    h0=mk(B, di, 4))
        err, match = ValueError, "state size 4"
    elif what == "dtype":
        for n in ("dt", "b", "c", "xc"):
            args[n] = args[n].half()
        err, match = TypeError, "one dtype"
    elif what in ("a_log", "h0"):
        args[what] = args[what].bfloat16()
        err, match = TypeError, f"{what} must be float32"
    elif what == "layout":
        args["h0"] = mk(B, ds, di).transpose(1, 2)
        err, match = ValueError, "contiguous"
    else:
        err, match = ValueError, "CUDA tensor"
    _build.reset_launches()
    with pytest.raises(err, match=match):
        mamba_scan(**args)
    assert _build.LAUNCHES["mamba_scan"] == 0


# ---------------------------------------------------------------------------
# the reduced jamba against the JAX package's
# ---------------------------------------------------------------------------

def _configs(dtype="float32", num_layers=None):
    kw = dict(compute_dtype=dtype)
    if num_layers:
        kw["num_layers"] = num_layers
    return (dataclasses.replace(jax_config(ARCH).reduced(), **kw),
            dataclasses.replace(get_config(ARCH).reduced(), **kw))


def _models(dtype="float32", seed=0, num_layers=None):
    jc, tc = _configs(dtype, num_layers)
    jp = redraw_mamba(ref_params(j_specs(jc), seed),
                      np.random.RandomState(seed))
    tp = from_reference(tc, jp, "cpu", dtype=getattr(torch, dtype))
    return jc, tc, jax.tree.map(jnp.asarray, jp), tp


@pytest.fixture(scope="module")
def models():
    return _models()


def test_reduced_config_and_weights(models):
    jc, tc, jp, tp = models
    assert (tc.num_layers, tc.d_model, tc.mamba.d_state, tc.moe.num_experts,
            tc.moe.top_k) == (8, 128, 8, 8, 2)
    assert tc.layer_specs() == jc.layer_specs() == \
        [("attn", "dense")] + [("mamba", "moe"), ("mamba", "dense")] * 3 \
        + [("mamba", "moe")]
    assert param_count(model_specs(tc)) == j_param_count(j_specs(jc))
    mixer = tp["layers"][4]["mixer"]          # unit[0], second repeat
    np.testing.assert_array_equal(
        mixer["a_log"].numpy(), np.asarray(jp["unit"][0]["mixer"]["a_log"]
                                           [1]))
    a = -np.exp(mixer["a_log"].numpy())
    assert -16 <= a.min() < a.max() <= -1 and np.unique(a).size > 1


def _mamba_layer(jp, tp):
    """The first mamba layer: the reference's prefix[1], the port's
    layers[1]."""
    return jp["prefix"][1]["mixer"], tp["layers"][1]["mixer"]


@pytest.mark.parametrize("route", ["kernel", "plain"])
@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_mamba_matches_jax(models, impl, route):
    """One mamba mixer on the same pre-norm'd input: without a cache, and
    as a 64-token prefill into a cache holding nonzero conv rows and
    state followed by 3 decode steps, the caches it writes compared
    after every step (S = 64: the Pallas scan takes S % 64 == 0)."""
    jc, tc, jp, tp = models
    tc = dataclasses.replace(tc, attn_impl=route)
    rules = make_rules(jc, None, None)
    jw, tw = _mamba_layer(jp, tp)
    B, S, D = 2, 64, tc.d_model
    di, ds = 2 * D, tc.mamba.d_state
    rng = np.random.RandomState(3)
    x = rng.randn(B, S + 3, D).astype(np.float32)
    jo, _ = j_mamba.mamba(jc, jw, jnp.asarray(x[:, :S]), rules=rules,
                          impl=impl)
    to, _ = mamba.mamba(tc, tw, torch.from_numpy(x[:, :S]))
    _close(to, jo, F32_TOL)

    c = {"conv": rng.randn(B, 3, di).astype(np.float32),
         "ssm": (rng.randn(B, di, ds) * 0.1).astype(np.float32)}
    jcache = {k: jnp.asarray(a) for k, a in c.items()}
    tcache = {k: torch.from_numpy(a.copy()) for k, a in c.items()}
    for lo, hi in ((0, S), (S, S + 1), (S + 1, S + 2), (S + 2, S + 3)):
        jo, jcache = j_mamba.mamba(jc, jw, jnp.asarray(x[:, lo:hi]),
                                   rules=rules, cache=jcache, impl=impl)
        to, tcache = mamba.mamba(tc, tw, torch.from_numpy(x[:, lo:hi]),
                                 cache=tcache)
        _close(to, jo, F32_TOL)
        for k in ("conv", "ssm"):
            _close(tcache[k], jcache[k], F32_TOL)


def _moe_input(tc, B, S, seed, skew):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, S, tc.d_model).astype(np.float32)
    return x + skew


@pytest.mark.parametrize("case", ["balanced", "drops"])
def test_moe_dense_and_gshard_match_jax(models, case):
    """Both implementations on one MoE layer's weights, outputs and aux
    loss. "balanced": 4 tokens a row and 4 slots per expert, so no
    expert can overflow (a token picks an expert once) and gshard equals
    the dense oracle. "drops": a router that sends every
    token to experts 0 and 1 (a shared input direction they favour), so
    each of them gets 64 (token, k) pairs of a row for its 20 slots and
    gshard drops the rest, which the dense oracle does not."""
    jc, tc, jp, tp = models
    rules = make_rules(jc, None, None)
    jw = dict(jp["unit"][1]["ffn"])
    jw = jax.tree.map(lambda a: a[0], jw)           # layer 3's MoE
    tw = dict(tp["layers"][3]["ffn"])
    B, S = 2, 64 if case == "drops" else 4
    skew = 0.0
    if case == "drops":
        router = np.asarray(jw["router"]).copy()
        router[:, 0] += 0.5
        router[:, 1] += 0.4
        jw["router"] = jnp.asarray(router)
        tw["router"] = torch.from_numpy(router)
        skew = 3.0
    x = _moe_input(tc, B, S, 4, skew)
    outs = {}
    for impl, jfn, tfn in (("dense", j_moe.moe_dense, moe.moe_dense),
                           ("gshard", j_moe.moe_gshard, moe.moe_gshard)):
        jo, jaux = jfn(jc, jw, jnp.asarray(x), rules)
        to, taux = tfn(tc, tw, torch.from_numpy(x))
        _close(to, jo, F32_TOL)
        assert taux.dtype == torch.float32
        np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
        to2, _ = moe.moe(tc, tw, torch.from_numpy(x), impl=impl)
        assert torch.equal(to2, to)
        outs[impl] = to
    C = moe._capacity(tc, S)
    assert C == (20 if case == "drops" else 4)
    # each row is one group of S tokens: an expert given more than C
    # (token, k) pairs of one row drops the rest
    _, sel, _ = moe._router(tc, tw, torch.from_numpy(x))
    load = torch.nn.functional.one_hot(sel, tc.moe.num_experts).sum((1, 2))
    dropped = bool((load > C).any())
    assert dropped == (case == "drops")
    differ = not torch.allclose(outs["dense"], outs["gshard"], atol=1e-4)
    assert differ == dropped


def test_moe_a2a_is_not_ported_yet(models):
    """Named for what it held before the expert-parallel MoE was ported
    (that ``impl="a2a"`` raised); now it holds the port's a2a against the
    dense oracle on one MoE layer: 4 tokens leave every expert under its
    4 slots, so nothing is dropped and the two agree (float32)."""
    _, tc, _, tp = models
    w = tp["layers"][3]["ffn"]
    x = torch.from_numpy(_moe_input(tc, 1, 4, 7, 0.0))
    out, aux = moe.moe(tc, w, x, impl="a2a")
    want, waux = moe.moe_dense(tc, w, x)
    _close(out, want.numpy(), F32_TOL)
    assert out.any() and torch.equal(aux, waux)


# bf16: each framework rounds to bf16 at its own points (XLA's fused
# elementwise chains against PyTorch's ops, attention's scores), and over
# 4-8 layers of random weights, dense MoE and the scans that carries to
# 1-4 bf16 spacings of the logits (|logit| ~1, spacing 2^-7): measured
# 0.008-0.034 between the frameworks over six weight draws, while the
# reference's own bf16 logits lie 0.014-0.026 from its float32 ones. So
# the bf16 forward is held to the reference's float32 logits: no farther
# (RMS) than REPLAY_RATIO times the reference's bf16 run (measured
# 0.92-0.99), and within BF16_TOL of the reference's bf16 logits plus that
# run's own largest distance from float32. A wrong cast or route moves
# the logits by ~0.1 and fails both.
REPLAY_RATIO = 1.25


def _bf16_close(port, ref16, ref32):
    port, ref16, ref32 = (np.asarray(_np(a) if isinstance(a, torch.Tensor)
                                     else a, np.float32)
                          for a in (port, ref16, ref32))
    rms = lambda a: float(np.sqrt(np.mean(np.square(a - ref32))))
    assert rms(port) <= REPLAY_RATIO * rms(ref16)
    np.testing.assert_allclose(
        port, ref16, atol=BF16_TOL + float(np.abs(ref16 - ref32).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("num_layers", [8, 4])
@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_forward_matches_jax(impl, num_layers, dtype):
    """The whole reduced jamba (8 layers: prefix 2 + unit 2 x 3) and its
    4-layer cut (the depth the card serves at full width: all prefix),
    dense MoE: in float32 the hidden states and logits at F32_TOL and the
    summed aux loss at AUX_RTOL; in bf16 the logits as ``_bf16_close``
    says, and the aux loss at AUX_RTOL + AUX_BF16_SPREAD plus this draw's
    distance of the reference's bf16 aux from its float32 aux (as
    ``_bf16_close`` widens the logits' bound)."""
    jc, tc, jp, tp = _models(dtype, seed=1, num_layers=num_layers)
    jc = dataclasses.replace(jc, attn_impl=impl)
    rules = make_rules(jc, None, None)
    B, S = 2, 32
    toks = np.random.RandomState(0).randint(
        0, jc.vocab_size, (B, S)).astype(np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    batch = {"tokens": jnp.asarray(toks), "positions": jnp.asarray(pos)}

    def reference(cfg):
        x, _, aux = j_forward(cfg, jp, batch, rules=rules, moe_impl="dense")
        return x, j_logits(cfg, jp, x, rules), aux
    jx, jl, jaux = reference(jc)
    aux_rtol, aux_atol = AUX_RTOL, 0.0
    if dtype == "bfloat16":
        _, jl32, jaux32 = reference(dataclasses.replace(
            jc, compute_dtype="float32"))
        aux_rtol += AUX_BF16_SPREAD
        aux_atol = abs(float(jaux) - float(jaux32))
    for route in ("kernel", "plain"):
        tx, _, aux = forward(dataclasses.replace(tc, attn_impl=route), tp,
                             {"tokens": torch.from_numpy(toks),
                              "positions": torch.from_numpy(pos)},
                             moe_impl="dense")
        tl = logits_from_hidden(tc, tp, tx)
        if dtype == "float32":
            _close(tx, jx, F32_TOL)
            _close(tl, jl, F32_TOL)
        else:
            _bf16_close(tl, jl, jl32)
        np.testing.assert_allclose(float(aux), float(jaux), rtol=aux_rtol,
                                   atol=aux_atol)
        assert float(aux) > 0


@pytest.mark.parametrize("source", ["init_params", "from_reference"])
def test_bf16_params_keep_a_log_float32(source):
    """At bf16, a_log (di, d_state) stays float32 — the reference's scan
    reads it so and never casts it — while every other matrix is bf16."""
    cfg = get_config(ARCH).reduced()
    if source == "init_params":
        p = init_params(model_specs(cfg), torch.Generator().manual_seed(0),
                        "cpu", torch.bfloat16)
    else:
        jp = ref_params(j_specs(jax_config(ARCH).reduced()), 0)
        p = from_reference(cfg, jp, "cpu", torch.bfloat16)
    for layer in p["layers"]:
        for part in layer.values():
            for name, t in part.items():
                if name == "a_log":
                    assert t.dtype == torch.float32 and t.dim() == 2
                elif t.dim() >= 2:
                    assert t.dtype == torch.bfloat16, name
    assert p["layers"][1]["mixer"]["in_proj"].dtype == torch.bfloat16


def test_full_jamba_config_and_its_depth_cut():
    """All 72 layers at full width (398.6 B params), and the 4-layer cut
    a card serves: (attn, dense), (mamba, moe), (mamba, dense), (mamba,
    moe), 23.02 B params, with a float32 ssm state beside the conv rows
    and one attention layer's KV cache."""
    cfg = get_config(ARCH)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size) == \
        (72, 8192, 64, 8, 128, 24576, 65536)
    assert (cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.expert_ff,
            cfg.mamba.d_state, cfg.mamba.expand) == (16, 2, 24576, 16, 2)
    full = param_count(model_specs(cfg))
    assert full == j_param_count(j_specs(jax_config(ARCH)))
    assert 398.5e9 < full < 398.7e9
    cut = dataclasses.replace(cfg, num_layers=4)
    assert cut.layer_specs() == [("attn", "dense"), ("mamba", "moe"),
                                 ("mamba", "dense"), ("mamba", "moe")]
    n = param_count(model_specs(cut))
    assert n == j_param_count(j_specs(dataclasses.replace(
        jax_config(ARCH), num_layers=4)))
    assert 23.0e9 < n < 23.05e9
    c = cache_specs(cut, 8, 4096)["layers"]
    assert c[0]["k"].shape == (8, 4096, 8, 128)
    assert c[1]["ssm"].shape == (8, 16384, 16)
    assert c[1]["ssm"].dtype == torch.float32
    assert c[1]["conv"].shape == (8, 3, 16384)
    assert c[1]["conv"].dtype == torch.bfloat16
