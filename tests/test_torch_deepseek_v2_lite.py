"""deepseek-v2-lite (DeepSeek-V2-Lite) on the CPU against the benchmark's
plain float32 reference (``stbench/reference/deepseek_v2.py``, imported
through the repository root), on seeded random weights at a tiny size:
the configuration file's block with every width cut (d 128, 4 heads,
latent rank 32, nope 32 + rope 16, v 32, 64 routed experts of width 32
top-6 beside 2 shared, vocab 512), 3 layers (the dense one, two MoE).

What deepseek-v2-lite turns on, each held to the reference: the query
as one projection (``q_lora_rank`` 0) and, beside it, the compressed
query of deepseek-v2-236b; YaRN's frequencies and its softmax factor in
both MLA paths (the expand path at prefill, the absorbed decode through
the latent cache); top-6 gates that are not renormalized, with shared
experts. Then the serving engine with ST-routed decode: prefill, then
decode through the cache, logits at every served position against the
reference's full forward. YaRN's numbers at the published sizes. Last,
the new fields at their defaults leave every architecture of the JAX
package and jamba2-mini computing bit for bit what they computed before
the fields existed, and flash attention without a scale is the kernel's
default.

Tolerances, float32 throughout: 2e-5 of a layer's output, the
difference of two float32 sums of the same terms in other orders
(``tests/test_torch_model.py``'s); 1e-4 of a logit, over the whole model
and its unembedding; 1e-6 of a cos or sin (the same float32 operations
on both sides, one rounding apart at most).
"""
import dataclasses
import functools
import math
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from repro_torch.configs import ARCH_IDS, MLAConfig, get_config  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_ref)
from repro_torch.models import (cache_specs, forward,  # noqa: E402
                                init_params, logits_from_hidden,
                                model_specs)
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import mla as mla_mod  # noqa: E402
from repro_torch.models.params import tree_map  # noqa: E402
from repro_torch.models.params import zeros_from_specs  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402
from stbench.drivers import serve_deepseek  # noqa: E402
from stbench.reference import deepseek_v2 as ref  # noqa: E402
from stbench.reference.granite import linear_f32, linear_fp8  # noqa: E402

ARCH = "deepseek-v2-lite"
F32_TOL = 2e-5
LOGIT_TOL = 1e-4
TABLE_TOL = 1e-6


def tiny_m(**over) -> dict:
    """The configuration file at the tiny size, in its own names."""
    import json
    with open(os.path.join(ROOT, "stbench/configs/deepseek-v2-lite.json")) \
            as f:
        m = json.load(f)
    m.update(hidden_size=128, intermediate_size=64, moe_intermediate_size=32,
             num_attention_heads=4, num_key_value_heads=4, kv_lora_rank=32,
             qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
             n_routed_experts=64, num_hidden_layers=3, vocab_size=512,
             torch_dtype="float32")
    m.update(over)
    return m


def _model(m, seed=7):
    """(cfg, float32 params, reference weights): the benchmark's weights
    (bf16 draws, upcast), the norm scales drawn near 1 so that none is
    inert."""
    cfg = serve_deepseek.port_config(ARCH, m)
    params = tree_map(lambda t: t.float(), serve_deepseek.make_weights(
        model_specs(cfg), seed, torch.device("cpu")))
    gen = torch.Generator().manual_seed(seed + 1)
    scales = [params["final_norm"]["scale"]]
    for layer in params["layers"]:
        scales += [layer["norm1"]["scale"], layer["norm2"]["scale"],
                   layer["mixer"]["kv_norm"]]
        if "q_norm" in layer["mixer"]:
            scales.append(layer["mixer"]["q_norm"])
    for t in scales:
        t.add_(torch.empty_like(t).uniform_(-0.3, 0.3, generator=gen))
    return cfg, params, serve_deepseek.reference_weights(params, m)


@pytest.fixture(scope="module")
def model():
    m = tiny_m()
    return (*_model(m), m)


def _x(cfg, S=24, B=2, seed=3):
    return torch.randn((B, S, cfg.d_model),
                       generator=torch.Generator().manual_seed(seed))


def _positions(B, S):
    return torch.arange(S)[None].expand(B, S)


# -- configuration -----------------------------------------------------------

def test_the_published_config():
    cfg = get_config(ARCH)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.vocab_size) == \
        (27, 2048, 16, 102400)
    assert cfg.layer_specs() == [("mla", "dense")] + [("mla", "moe")] * 26
    assert cfg.dense_ff_for(0) == 10944 and cfg.mla.q_lora_rank == 0
    assert (cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.expert_ff,
            cfg.moe.num_shared, cfg.moe.shared_ff) == (64, 6, 1408, 2, 2816)
    assert not cfg.moe.renormalize and not cfg.tie_embeddings
    assert round(cfg.param_counts()["total"] / 1e9, 2) == 15.71
    mixer = model_specs(dataclasses.replace(cfg, num_layers=1))["layers"][0][
        "mixer"]
    assert "wq" in mixer and not {"wq_a", "q_norm", "wq_b"} & set(mixer)
    assert mixer["wq"].shape == (2048, 16, 192)
    assert ARCH not in ARCH_IDS         # no JAX counterpart to hold it to


def test_the_file_gives_the_registered_config():
    """The benchmark's file, through its driver's ``port_config``, is the
    registered config at every published size."""
    import json
    with open(os.path.join(ROOT, "stbench/configs/deepseek-v2-lite.json")) \
            as f:
        m = json.load(f)
    assert m["reduced"] == []
    assert serve_deepseek.port_config(ARCH, m) == get_config(ARCH)


def test_reduced_keeps_no_q_compression_and_yarn():
    full, red = get_config(ARCH), get_config(ARCH).reduced()
    assert red.mla.q_lora_rank == 0 and red.rope_scaling == \
        full.rope_scaling
    assert red.layer_specs() == full.layer_specs()[:red.num_layers]
    assert get_config("deepseek-v2-236b").reduced().mla.q_lora_rank == 48


def test_yarn_numbers_at_the_published_sizes():
    """The ramp from index 10 to 23 of the 32 rope frequencies, the
    softmax factor 1.58963 (so the scale 0.114721), cos and sin unscaled
    (mscale = mscale_all_dim); the port's table is the reference's at
    positions up to the published context."""
    cfg = get_config(ARCH)
    y = cfg.rope_scaling
    assert y.ramp(64, cfg.rope_theta) == (10, 23)
    assert round(y.softmax_factor, 5) == 1.58963
    assert y.cos_sin_factor == 1.0
    assert round(mla_mod.softmax_scale(cfg), 6) == 0.114721
    import json
    with open(os.path.join(ROOT, "stbench/configs/deepseek-v2-lite.json")) \
            as f:
        m = json.load(f)
    assert ref.yarn_ramp(m) == (10, 23)
    assert math.isclose(ref.softmax_scale(m), mla_mod.softmax_scale(cfg),
                        rel_tol=1e-12)
    inv = L.rope_freqs(64, cfg.rope_theta, scaling=y)
    plain = L.rope_freqs(64, cfg.rope_theta)
    # kept up to the ramp's start (index 10, r = 0), blended inside it,
    # interpolated from its end on
    assert torch.equal(inv[:11], plain[:11])
    torch.testing.assert_close(inv[23:], plain[23:] / 40, rtol=1e-6, atol=0)
    assert ((inv[11:23] < plain[11:23]) & (inv[11:23] > plain[11:23] / 40)
            ).all()
    pos = torch.tensor([0, 1, 7, 4095, 40000, 163839])
    cos, sin = L.rope_table(pos[None], 64, cfg.rope_theta, y)
    rcos, rsin = ref.rope_cos_sin(m, 163840, torch.device("cpu"))
    torch.testing.assert_close(cos[0], rcos[pos], rtol=0, atol=TABLE_TOL)
    torch.testing.assert_close(sin[0], rsin[pos], rtol=0, atol=TABLE_TOL)
    # where mscale and mscale_all_dim differ, cos and sin carry their
    # ratio (1.26080 / 1 here), in the port as in the reference
    y2 = dataclasses.replace(y, mscale_all_dim=0.0)
    m2 = dict(m, rope_scaling=dict(m["rope_scaling"], mscale_all_dim=0.0))
    assert y2.softmax_factor == 1.0 and y2.cos_sin_factor > 1.26
    cos, sin = L.rope_table(pos[None], 64, cfg.rope_theta, y2)
    rcos, rsin = ref.rope_cos_sin(m2, 163840, torch.device("cpu"))
    torch.testing.assert_close(cos[0], rcos[pos], rtol=0, atol=2 * TABLE_TOL)
    torch.testing.assert_close(sin[0], rsin[pos], rtol=0, atol=2 * TABLE_TOL)


# -- MLA against the reference -----------------------------------------------

@pytest.mark.parametrize("q_lora_rank", [None, 24])
def test_mla_layer_equals_the_reference(q_lora_rank):
    """The MLA mixer over whole sequences (the expand path, YaRN's
    frequencies and softmax factor) with one query projection and with
    a compressed query; each against the reference's branch of its
    kind, and the two kinds' param trees as they must be."""
    m = tiny_m(q_lora_rank=q_lora_rank)
    cfg, params, wref = _model(m)
    p = params["layers"][1]["mixer"]
    if q_lora_rank:
        assert {"wq_a", "q_norm", "wq_b"} <= set(p) and "wq" not in p
    else:
        assert "wq" in p and not {"wq_a", "q_norm", "wq_b"} & set(p)
    x = _x(cfg)
    out, _ = mla_mod.mla_attention(cfg, p, x,
                                   positions=_positions(*x.shape[:2]))
    S = x.shape[1]
    cos, sin = ref.rope_cos_sin(m, S, x.device)
    for b in range(x.shape[0]):
        want = ref._mla(wref["layers"][1]["attn"], m, x[b], cos, sin,
                        linear_f32)
        torch.testing.assert_close(out[b], want, rtol=0, atol=F32_TOL)
    no_yarn = dataclasses.replace(cfg, rope_scaling=None)
    other, _ = mla_mod.mla_attention(no_yarn, p, x,
                                     positions=_positions(*x.shape[:2]))
    assert (other - out).abs().max() > 1e-2


def test_param_counts_follow_the_specs():
    """``param_counts`` counts the one query projection at q_lora_rank 0
    and the compressed one otherwise, as the specs hold them."""
    for q in (None, 24):
        cfg = serve_deepseek.port_config(ARCH, tiny_m(q_lora_rank=q))
        one = dataclasses.replace(cfg, num_layers=1)
        specs = model_specs(one)["layers"][0]["mixer"].values()
        mixer = sum(int(np.prod(s.shape)) for s in specs
                    if len(s.shape) >= 2)           # the norms not counted
        d = cfg.d_model
        assert one.param_counts()["total"] == (
            mixer + 3 * d * cfg.dense_ff_for(0) + 2 * d * cfg.vocab_size)


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
    # the control's arithmetic, float8 products, misses the tolerance
    low = ref.logits_at(wref, m, toks, list(range(S)), linear=linear_fp8)
    assert (low - got).abs().max() > 100 * LOGIT_TOL


def test_engine_prefill_then_decode_equals_the_reference(model,
                                                         monkeypatch):
    """Served with ST-routed decode (4 virtual ranks, the hidden blocks
    dispatched) and dense MoE, 3 slots recycled over 6 requests: the
    logits of every served position (the prefill's last, through the
    expand path; then each decode step's, absorbed over the latent
    cache) equal the reference's over the whole sequence.

    The cache is float32 here (bf16 as served): a bf16 latent row rounds
    by ~4e-3, and where two experts' router probabilities are that close
    the top-6 choice flips, swapping one expert's output for another's;
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
    reqs = [Request(prompt=rng.randint(0, cfg.vocab_size, n)
                    .astype(np.int32), max_new_tokens=k)
            for n, k in ((5, 6), (9, 4), (5, 3), (17, 5), (9, 2), (3, 7))]
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
    assert eng._router.moe_on and eng._kv_leaf == (0, "ckv", 32)
    assert [len(r.out_tokens) for r in reqs] == [6, 4, 3, 5, 2, 7]
    for r in reqs:
        seq = np.concatenate([r.prompt, np.asarray(r.out_tokens[:-1])])
        want = ref.logits_at(wref, m, seq, ref.served_positions(
            len(r.prompt), len(r.out_tokens)))
        torch.testing.assert_close(torch.stack(got[id(r)]), want, rtol=0,
                                   atol=LOGIT_TOL)


def test_absorbed_decode_equals_the_expand_path(model):
    """One decode step through the latent cache, absorbed, against the
    same step on the expand path (a two-token step whose first token
    rewrites its own cache row), at every slot's own position."""
    cfg, params, _, _ = model
    p = params["layers"][1]["mixer"]
    B, S = 3, 11
    x = _x(cfg, S=S, B=B)
    cache = {k: torch.zeros(shape) for k, (shape, _) in
             mla_mod.mla_cache_specs(cfg, B, 32).items()}
    mla_mod.mla_attention(cfg, p, x[:, :S - 1], cache=cache,
                          positions=_positions(B, S - 1))
    pos = torch.full((B, 1), S - 1)
    absorbed, _ = mla_mod.mla_attention(cfg, p, x[:, S - 1:], cache=cache,
                                        positions=pos)
    expand, _ = mla_mod.mla_attention(cfg, p, x[:, S - 2:], cache=cache,
                                      positions=pos - 1 + torch.arange(2))
    torch.testing.assert_close(absorbed[:, 0], expand[:, 1], rtol=0,
                               atol=F32_TOL)


# -- the new fields at their defaults ----------------------------------------

def _parent_rope_table(positions, head_dim, theta, scaling=None):
    """``layers.rope_table`` as it was before ``rope_scaling``."""
    assert scaling is None
    half = head_dim // 2
    inv = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                        device=positions.device) / half))
    ang = (positions.float()[..., None] * inv)[..., None, :]
    return torch.cos(ang), torch.sin(ang)


def _parent_latents(cfg, params, x, rope, dt):
    """``mla._latents`` as it was before ``q_lora_rank`` 0."""
    m = cfg.mla
    cq = mla_mod._proj(x, params["wq_a"], dt)
    cq = L.rmsnorm_nl(cq, cfg.norm_eps) * params["q_norm"].to(dt)
    q = mla_mod._proj(cq, params["wq_b"], dt)
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = L.apply_rope(q[..., m.qk_nope_head_dim:], rope)
    kv = mla_mod._proj(x, params["wkv_a"], dt)
    ckv = L.rmsnorm_nl(kv[..., :m.kv_lora_rank], cfg.norm_eps) \
        * params["kv_norm"].to(dt)
    krope = L.apply_rope(kv[:, :, None, m.kv_lora_rank:], rope)[:, :, 0]
    return q_nope, q_rope, ckv, krope


def _no_scale(real):
    """The flash route's plain version, refusing a scale: the default
    (the kernel's own hd^-1/2, as before the argument) must reach it."""
    def fa(*args, scale=None, **kw):
        assert scale is None
        return real(*args, **kw)
    return fa


def _batch(cfg, toks, positions, prefill):
    batch = {"tokens": toks, "positions": positions}
    if cfg.vision is not None and prefill and cfg.family == "vlm":
        batch["vision"] = torch.randn(
            (toks.shape[0], cfg.vision.num_tokens, cfg.vision.raw_dim),
            generator=torch.Generator().manual_seed(4))
    return batch


@pytest.mark.parametrize("arch", ARCH_IDS + ["jamba2-mini"])
def test_other_archs_are_unchanged_at_the_defaults(arch, monkeypatch):
    """With ``rope_scaling`` None and a nonzero ``q_lora_rank`` (where
    there is MLA): the same param tree, and a prefill plus three decode
    steps through the cache bit for bit what the parent's RoPE table,
    query latents and MLA scale give, no scale ever handed to the
    attention kernels' routes."""
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              compute_dtype="float32")
    assert cfg.rope_scaling is None
    assert cfg.mla is None or cfg.mla.q_lora_rank > 0
    if cfg.mla is not None:
        assert {"wq_a", "q_norm", "wq_b"} <= set(
            model_specs(cfg)["layers"][0]["mixer"])

    def run():
        params = init_params(model_specs(cfg),
                             torch.Generator().manual_seed(0), "cpu")
        cache = zeros_from_specs(cache_specs(cfg, 2, 32), "cpu")
        toks = torch.as_tensor(np.random.RandomState(2).randint(
            0, cfg.vocab_size, (2, 12)))
        x, _, _ = forward(cfg, params, _batch(
            cfg, toks[:, :9], torch.arange(9).expand(2, 9), True),
            cache=cache, moe_impl="dense")
        outs = [logits_from_hidden(cfg, params, x)]
        for t in range(9, 12):
            x, _, _ = forward(cfg, params, _batch(
                cfg, toks[:, t:t + 1], torch.full((2, 1), t), False),
                cache=cache, moe_impl="dense")
            outs.append(logits_from_hidden(cfg, params, x))
        return torch.cat(outs, dim=1)

    monkeypatch.setattr(attn_mod, "flash_attention_ref",
                        _no_scale(flash_attention_ref))
    monkeypatch.setattr(attn_mod, "flash_attention",
                        _no_scale(flash_attention))
    now = run()
    with monkeypatch.context() as mp:
        mp.setattr(attn_mod, "rope_table", _parent_rope_table)
        mp.setattr(mla_mod, "_latents", _parent_latents)
        mp.setattr(mla_mod, "softmax_scale", lambda cfg: 1.0 / math.sqrt(
            cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim))
        before = run()
    assert torch.equal(now, before)


def _parent_flash_ref(q, k, v, *, q_offset, kv_valid_len, causal):
    """``flash_attention_ref`` as it was before ``scale``."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    if H // KV > 1:
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
    scores = torch.einsum("bqhd,bshd->bhqs", q, k).float() * (
        1.0 / (hd ** 0.5))
    kv_idx = torch.arange(k.shape[1])
    q_pos = q_offset[:, None] + torch.arange(Sq)[None, :]
    mask = torch.ones((B, Sq, k.shape[1]), dtype=torch.bool)
    if causal:
        mask &= kv_idx[None, None, :] <= q_pos[:, :, None]
    mask &= kv_idx[None, None, :] < kv_valid_len[:, None, None]
    scores = torch.where(mask[:, None, :, :], scores, -1e30)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqs,bshd->bqhd", w, v)


@pytest.mark.parametrize("hd,hdv,KV", [(64, 64, 2), (192, 128, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_default_scale_is_unchanged(hd, hdv, KV, dtype):
    """Without a scale the wrapper's CPU route (the kernel's plain
    version) is the parent's bit for bit; a given scale is the scores'
    scale (hd^-1/2 itself within a float32 rounding of the default)."""
    gen = torch.Generator().manual_seed(hd)
    B, Sq, Skv, H = 2, 5, 9, 4
    q = torch.randn((B, Sq, H, hd), generator=gen).to(dtype)
    k = torch.randn((B, Skv, KV, hd), generator=gen).to(dtype)
    v = torch.randn((B, Skv, KV, hdv), generator=gen).to(dtype)
    pos = 4 + torch.arange(Sq)[None].expand(B, Sq)
    kvl = torch.tensor([9, 7], dtype=torch.int32)
    out = flash_attention(q, k, v, q_positions=pos, kv_valid_len=kvl)
    want = _parent_flash_ref(q, k, v, q_offset=pos[:, 0].int(),
                             kv_valid_len=kvl, causal=True)
    assert torch.equal(out, want)
    same = flash_attention(q, k, v, q_positions=pos, kv_valid_len=kvl,
                           scale=hd ** -0.5)
    torch.testing.assert_close(same.float(), out.float(), rtol=0,
                               atol=1e-6 if dtype == torch.float32 else 0)
    scaled = flash_attention(q, k, v, q_positions=pos, kv_valid_len=kvl,
                             scale=1.58963 * hd ** -0.5)
    assert (scaled.float() - out.float()).abs().max() > 1e-2


def test_decode_route_refuses_a_scale(model):
    cfg, _, _, _ = model
    q = torch.zeros((1, 1, 4, 32))
    with pytest.raises(ValueError, match="decode route"):
        attn_mod.attention_core(cfg, q, q, q, q_positions=torch.zeros(
            (1, 1), dtype=torch.long), scale=0.5)
