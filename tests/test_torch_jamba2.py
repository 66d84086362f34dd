"""jamba2-mini (AI21-Jamba2-Mini) on the CPU against the benchmark's plain
float32 reference (``stbench/reference/jamba.py``, imported through the
repository root), on seeded random weights at ``reduced()``'s size: a
whole 8-layer period (attention at layer 4, MoE on the odd layers), d
128, 8 experts top-2, d_state 8.

The four switches jamba2-mini turns on, each held to the reference alone:
the attention layer's offset in its period, attention without RoPE, the
Mamba mixer's dt/B/C RMSNorms (on the kernel route's plain version, the
plain route and the decode step through the cache) and top-2 gates that
are not renormalized (``dense``; ``gshard`` and ``a2a`` at a capacity
that drops nothing). Then the serving engine with ST-routed decode:
prefill, then decode through the cache, logits at every served position
against the reference's full forward. Last, the switches at their
defaults leave jamba-1.5-large-398b, granite-3-2b and deepseek-moe-16b
computing bit for bit what they computed before the switches existed.

Tolerances, float32 throughout: 2e-5 of a mixer's or layer's output,
the difference of two float32 sums of the same terms in other orders
(``tests/test_torch_model.py``'s); 1e-4 of a logit, over a whole
8-layer model and its unembedding.
"""
import dataclasses
import functools
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import (cache_specs, forward,  # noqa: E402
                                init_params, logits_from_hidden,
                                model_specs)
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import mamba as mamba_mod  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.params import tree_map  # noqa: E402
from repro_torch.models.params import zeros_from_specs  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402
from stbench.drivers import serve_jamba  # noqa: E402
from stbench.reference import jamba as ref  # noqa: E402

ARCH = "jamba2-mini"
F32_TOL = 2e-5
LOGIT_TOL = 1e-4


def hf_names(cfg) -> dict:
    """The port's config in the reference's Hugging Face names."""
    return {"hidden_size": cfg.d_model, "intermediate_size": cfg.d_ff,
            "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads,
            "head_dim": cfg.head_dim, "vocab_size": cfg.vocab_size,
            "rms_norm_eps": cfg.norm_eps,
            "attn_layer_period": cfg.mamba_attn_period,
            "attn_layer_offset": cfg.attn_layer_offset,
            "expert_layer_period": cfg.moe_every,
            "expert_layer_offset": cfg.moe_every - 1,
            "mamba_d_state": cfg.mamba.d_state,
            "mamba_d_conv": cfg.mamba.d_conv,
            "mamba_expand": cfg.mamba.expand,
            "mamba_dt_rank": cfg.mamba.dt_rank,
            "num_experts": cfg.moe.num_experts,
            "num_experts_per_tok": cfg.moe.top_k}


@pytest.fixture(scope="module")
def model():
    """(cfg, float32 params, reference weights, m): the benchmark's
    weights (bf16 draws, upcast) with the Mamba vectors redrawn from
    Mamba's init ranges and the norm scales drawn near 1, so that no
    leaf is inert."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(),
                              compute_dtype="float32")
    params = tree_map(lambda t: t.float(), serve_jamba.make_weights(
        model_specs(cfg), 7, torch.device("cpu")))
    gen = torch.Generator().manual_seed(8)
    for layer in params["layers"]:
        for name, t in layer["mixer"].items():
            if name == "dt_bias":
                t.copy_(torch.empty_like(t).uniform_(-4.0, -2.0,
                                                     generator=gen))
            elif name in ("d_skip", "dt_norm", "b_norm", "c_norm",
                          "conv_b"):
                t.add_(torch.empty_like(t).uniform_(-0.3, 0.3,
                                                    generator=gen))
    m = hf_names(cfg)
    return cfg, params, serve_jamba.reference_weights(params, m), m


def _x(cfg, S=24, B=2, seed=3):
    return torch.randn((B, S, cfg.d_model),
                       generator=torch.Generator().manual_seed(seed))


def _layer(cfg, kind):
    return next(i for i, sp in enumerate(cfg.layer_specs())
                if kind in sp)


# -- configuration -----------------------------------------------------------

def test_layer_specs_of_the_published_config():
    cfg = get_config(ARCH)
    specs = cfg.layer_specs()
    assert cfg.num_layers == 32 and cfg.d_model == 4096
    assert [i for i, (mx, _) in enumerate(specs) if mx == "attn"] == \
        [4, 12, 20, 28]
    assert all(mx == "mamba" for i, (mx, _) in enumerate(specs)
               if i % 8 != 4)
    assert [i for i, (_, f) in enumerate(specs) if f == "moe"] == \
        list(range(1, 32, 2))
    one_period = dataclasses.replace(cfg, num_layers=8)
    assert round(one_period.param_counts()["total"] / 1e9, 2) == 13.29


def test_reduced_keeps_the_four_switches():
    full, red = get_config(ARCH), get_config(ARCH).reduced()
    assert red.num_layers == 8
    assert red.attn_layer_offset == full.attn_layer_offset == 4
    assert red.use_rope is full.use_rope is False
    assert red.mamba.inner_norms is full.mamba.inner_norms is True
    assert red.moe.renormalize is full.moe.renormalize is False
    assert red.layer_specs() == full.layer_specs()[:8]
    assert {"dt_norm", "b_norm", "c_norm"} <= set(
        model_specs(red)["layers"][0]["mixer"])


# -- each switch against the reference ---------------------------------------

def test_attention_without_rope_equals_the_reference(model):
    cfg, params, wref, m = model
    i = _layer(cfg, "attn")
    x = _x(cfg)
    pos = torch.arange(x.shape[1])[None].expand(x.shape[0], -1)
    out, _ = attn_mod.attention(cfg, params["layers"][i]["mixer"], x,
                                positions=pos)
    for b in range(x.shape[0]):
        want = ref._attention_mixer(wref["layers"][i]["mixer"], m, x[b],
                                    ref.linear_f32)
        torch.testing.assert_close(out[b], want, rtol=0, atol=F32_TOL)
    roped, _ = attn_mod.attention(dataclasses.replace(cfg, use_rope=True),
                                  params["layers"][i]["mixer"], x,
                                  positions=pos)
    assert (roped - out).abs().max() > 1e-2


@pytest.mark.parametrize("route", ["kernel", "plain"])
def test_mamba_norms_equal_the_reference(model, route):
    """The mixer over a whole sequence on the CPU: "kernel" takes the
    kernel wrapper's plain version, "plain" the plain scan."""
    cfg, params, wref, m = model
    cfg = dataclasses.replace(cfg, attn_impl=route)
    i = _layer(cfg, "mamba")
    x = _x(cfg)
    out, _ = mamba_mod.mamba(cfg, params["layers"][i]["mixer"], x)
    for b in range(x.shape[0]):
        want = ref._mamba_mixer(wref["layers"][i]["mixer"], m, x[b],
                                ref.linear_f32)
        torch.testing.assert_close(out[b], want, rtol=0, atol=F32_TOL)
    bare = dataclasses.replace(cfg, mamba=dataclasses.replace(
        cfg.mamba, inner_norms=False))
    plain, _ = mamba_mod.mamba(bare, params["layers"][i]["mixer"], x)
    assert (plain - out).abs().max() > 1e-2


def test_mamba_norms_at_the_decode_step_equal_the_reference(model):
    """A prefill of 9 tokens into the cache, then one step a token: each
    step's output is the reference's at its position."""
    cfg, params, wref, m = model
    i = _layer(cfg, "mamba")
    p = params["layers"][i]["mixer"]
    x = _x(cfg, S=20)
    cache = {k: torch.zeros(shape) for k, (shape, _) in
             mamba_mod.mamba_cache_specs(cfg, x.shape[0]).items()}
    outs = [mamba_mod.mamba(cfg, p, x[:, :9], cache=cache)[0]]
    for t in range(9, x.shape[1]):
        outs.append(mamba_mod.mamba(cfg, p, x[:, t:t + 1], cache=cache)[0])
    out = torch.cat(outs, dim=1)
    for b in range(x.shape[0]):
        want = ref._mamba_mixer(wref["layers"][i]["mixer"], m, x[b],
                                ref.linear_f32)
        torch.testing.assert_close(out[b], want, rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("impl", ["dense", "gshard", "a2a"])
def test_gates_not_renormalized_equal_the_reference(model, impl):
    """Every implementation weights its two experts by their softmax
    probabilities as they are; a capacity factor of 8 leaves every
    gshard and a2a queue under capacity, so nothing is dropped."""
    cfg, params, wref, m = model
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))
    i = _layer(cfg, "moe")
    x = _x(cfg)
    out, _ = moe_mod.moe(cfg, params["layers"][i]["ffn"], x, impl=impl)
    for b in range(x.shape[0]):
        want = ref._moe(wref["layers"][i]["ffn"], m, x[b], ref.linear_f32)
        torch.testing.assert_close(out[b], want, rtol=0, atol=F32_TOL)
    renorm = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, renormalize=True))
    other, _ = moe_mod.moe(renorm, params["layers"][i]["ffn"], x, impl=impl)
    assert (other - out).abs().max() > 1e-2


def test_forward_equals_the_reference(model):
    cfg, params, wref, m = model
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size, 30)
    S = len(toks)
    x, _, _ = forward(cfg, params, {"tokens": torch.as_tensor(toks)[None],
                                    "positions": torch.arange(S)[None]},
                      moe_impl="dense")
    got = logits_from_hidden(cfg, params, x)[0, :, :cfg.vocab_size]
    want = ref.logits_at(wref, m, toks, list(range(S)))
    torch.testing.assert_close(got, want, rtol=0, atol=LOGIT_TOL)


# -- the serving engine ------------------------------------------------------

def test_engine_prefill_then_decode_equals_the_reference(model,
                                                         monkeypatch):
    """Served with ST-routed decode (4 virtual ranks, the hidden blocks
    dispatched) and dense MoE, 3 slots recycled over 6 requests: the
    logits of every served position (the prefill's last, then each
    decode step's) equal the reference's over the whole sequence.

    The cache is float32 here (bf16 as served): a bf16 cache row rounds
    by ~4e-3, and where two experts' router probabilities are that close
    the top-2 choice flips, swapping one expert's output for another's;
    that rounding is held on the card, by the benchmark's limit."""
    from repro_torch.serving import engine as engine_mod
    from repro_torch.train import steps
    cfg, params, wref, m = model
    monkeypatch.setattr(engine_mod, "cache_specs", functools.partial(
        cache_specs, cache_dtype=torch.float32))
    seen = []                       # the last step's logits
    real = steps.logits_from_hidden

    def recording(cfg, params, x, last_only=False):
        out = real(cfg, params, x, last_only)
        seen.append(out[:, -1, :cfg.vocab_size].clone())
        return out
    monkeypatch.setattr(steps, "logits_from_hidden", recording)
    eng = ServingEngine(cfg, params, batch_slots=3, max_len=64,
                        moe_impl="dense", st_mode="st", st_ranks=4,
                        st_config=None, device="cpu")
    rng = np.random.RandomState(5)
    reqs = [Request(prompt=rng.randint(0, cfg.vocab_size, L)
                    .astype(np.int32), max_new_tokens=n)
            for L, n in ((5, 6), (9, 4), (5, 3), (17, 5), (9, 2), (3, 7))]
    got = {id(r): [] for r in reqs}
    real_pre, real_dec = eng._prefill_sample, eng._decode_sample

    def prefill(params, batch, cache):
        out = real_pre(params, batch, cache)
        lg = seen.pop()
        for row, toks in zip(lg, batch["tokens"].numpy()):
            r = next(r for r in reqs if np.array_equal(r.prompt, toks))
            got[id(r)].append(row)
        return out

    def decode(params, batch, cache):
        out = real_dec(params, batch, cache)
        lg = seen.pop()
        for slot, r in enumerate(eng.slot_req):
            if r is not None:
                got[id(r)].append(lg[slot])
        return out

    eng._prefill_sample, eng._decode_sample = prefill, decode
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    assert eng._router.moe_on
    assert [len(r.out_tokens) for r in reqs] == [6, 4, 3, 5, 2, 7]
    for r in reqs:
        seq = np.concatenate([r.prompt, np.asarray(r.out_tokens[:-1])])
        want = ref.logits_at(wref, m, seq, ref.served_positions(
            len(r.prompt), len(r.out_tokens)))
        torch.testing.assert_close(torch.stack(got[id(r)]), want, rtol=0,
                                   atol=LOGIT_TOL)


# -- the switches at their defaults ------------------------------------------

def _parent_router(cfg, params, x):
    """``moe._router`` as it was before ``renormalize``: the top-k gates
    always divided by their sum."""
    mo = cfg.moe
    logits = torch.einsum("gtd,de->gte", x, params["router"].to(x.dtype))
    probs = torch.softmax(logits.float(), dim=-1)
    gates, sel = moe_mod._top_k(probs, mo.top_k)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(sel, mo.num_experts).float().mean(dim=(0, 1, 2))
    aux = mo.router_aux_coef * mo.num_experts * torch.sum(me * ce) \
        * mo.top_k
    return gates, sel, aux


def _parent_mixers(cfg) -> list:
    """``layer_specs``' mixers as they were before
    ``attn_layer_offset``: a hybrid's attention at i % period == 0."""
    if not cfg.mamba_attn_period:
        return [mx for mx, _ in cfg.layer_specs()]
    return ["attn" if i % cfg.mamba_attn_period == 0 else "mamba"
            for i in range(cfg.num_layers)]


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "granite-3-2b",
                                  "deepseek-moe-16b"])
def test_other_archs_are_unchanged_at_the_defaults(arch, monkeypatch):
    """With the switches at their defaults: the same layer pattern and
    param tree, the Mamba norms never applied, RoPE applied, and a
    prefill plus three decode steps through the cache bit for bit what
    the parent's router gives."""
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              compute_dtype="float32")
    assert cfg.attn_layer_offset == 0 and cfg.use_rope
    assert cfg.moe is None or cfg.moe.renormalize
    assert cfg.mamba is None or not cfg.mamba.inner_norms
    assert [mx for mx, _ in cfg.layer_specs()] == _parent_mixers(cfg)
    for layer in model_specs(cfg)["layers"]:
        assert not {"dt_norm", "b_norm", "c_norm"} & set(layer["mixer"])

    def run(moe_impl):
        params = init_params(model_specs(cfg),
                             torch.Generator().manual_seed(0), "cpu")
        cache = zeros_from_specs(cache_specs(cfg, 2, 32), "cpu")
        toks = torch.as_tensor(np.random.RandomState(2).randint(
            0, cfg.vocab_size, (2, 12)))
        outs = []
        x, _, _ = forward(cfg, params, {"tokens": toks[:, :9],
                                        "positions": torch.arange(9)
                                        .expand(2, 9)},
                          cache=cache, moe_impl=moe_impl)
        outs.append(logits_from_hidden(cfg, params, x))
        for t in range(9, 12):
            x, _, _ = forward(cfg, params, {
                "tokens": toks[:, t:t + 1],
                "positions": torch.full((2, 1), t)}, cache=cache,
                moe_impl=moe_impl)
            outs.append(logits_from_hidden(cfg, params, x))
        return torch.cat(outs, dim=1)

    def no_norm(*a, **k):
        raise AssertionError("a Mamba norm applied at the defaults")

    monkeypatch.setattr(mamba_mod, "add_norm", no_norm)
    impls = ["dense", "gshard"] if cfg.moe is not None else ["gshard"]
    for impl in impls:
        now = run(impl)
        with monkeypatch.context() as mp:
            mp.setattr(moe_mod, "_router", _parent_router)
            before = run(impl)
        assert torch.equal(now, before)


def test_eager_forward_opens_a_span_per_mixer_and_moe(model):
    """Under the profiler, the eager forward of the whole period opens
    ``repro_torch.model.mamba`` 7 times, ``.attn`` once and ``.moe`` 4
    times, one per call; with no profiler, none."""
    from torch.profiler import ProfilerActivity, profile
    cfg, params, _, _ = model
    batch = {"tokens": torch.zeros((1, 5), dtype=torch.long),
             "positions": torch.arange(5)[None]}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        forward(cfg, params, batch, moe_impl="dense")
    names = [e.name for e in prof.events()
             if e.name.startswith("repro_torch.model.")]
    assert sorted(names) == sorted(["repro_torch.model.mamba"] * 7
                                   + ["repro_torch.model.attn"]
                                   + ["repro_torch.model.moe"] * 4)


def test_engine_counts_moe_rows_and_staged_bytes(model):
    """``stats()``: the MoE rows computed (dense: every expert on every
    row of each dispatch, a decode step's idle slots included) and
    routed (top-2 a real token), over the 4 MoE layers; the bytes the
    router staged by payload, every rank's whole bucket a dispatch."""
    cfg, params, _, _ = model
    eng = ServingEngine(cfg, params, batch_slots=3, max_len=64,
                        moe_impl="dense", st_mode="st", st_ranks=4,
                        st_config=None, device="cpu")
    prompts, decoded = [], []
    real = eng._decode_batch

    def decode_batch(active):
        decoded.append(len(active))
        return real(active)
    eng._decode_batch = decode_batch
    for L, n in ((5, 6), (9, 4), (5, 3), (7, 2)):
        prompts.append(L)
        eng.submit(Request(prompt=np.arange(L, dtype=np.int32),
                           max_new_tokens=n))
    eng.run_until_drained()
    st = eng.stats()
    E, K, n_moe = cfg.moe.num_experts, cfg.moe.top_k, 4
    assert st["moe_rows_computed"] == n_moe * E * (
        sum(prompts) + 3 * len(decoded))
    assert st["moe_rows_routed"] == n_moe * K * (sum(prompts)
                                                 + sum(decoded))
    buckets = eng.stats()["st"]["buckets"]
    kv = cfg.num_kv_heads * cfg.head_dim
    want = {"kv": 0, "ids": 0, "hid": 0}
    for b, meta in buckets.items():
        want["kv"] += meta["dispatches"] * 4 * b * kv * 4
        want["ids"] += meta["dispatches"] * 4 * b * 4
        want["hid"] += meta["dispatches"] * 4 * b * cfg.d_model * 4
    assert st["st_payload_bytes"] == want
    assert sum(m["dispatches"] for m in buckets.values()) == len(decoded)
