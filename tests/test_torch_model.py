"""The port's dense model on the CPU against the JAX package's.

The same weights (drawn in the reference's layout by
``tests/_ref_params.py``, a fixed function of the seed, handed over as
numpy through ``from_reference``) and the same numpy tokens go through the
JAX ``forward`` — with ``attn_impl="xla"`` and ``"pallas_interpret"``
(its Pallas kernels in interpret mode) — and through the port's
``forward`` (plain attention on the CPU): without a cache, and as a
prefill plus ragged decode steps through a KV cache. granite-3-2b's
``reduced()`` config has G = 1 (4 heads, 4 KV heads); the ``kv2``
variant has G = 2. The other variants are the ``reduced()`` configs of
the attention archs ported with DeepSeek-V2's MLA: deepseek-v2-236b
(MLA mixers: the expand path at prefill, the absorbed decode; a dense
first FFN, then MoE with shared experts), deepseek-moe-16b (the same MoE
layout behind GQA attention), qwen3-32b (qk-norm), minitron-4b and
granite-34b (MQA).

Tolerances, those of ``tests/test_kernels.py``: float32 compute, 2e-5
absolute on hidden states of magnitude ~4 and logits of magnitude ~1
(XLA and PyTorch sum in other orders; measured differences ~3e-6);
bf16 compute, 2e-2 absolute on logits (bf16 keeps 8 bits, 4e-3
relative, and the two frameworks round at other points; measured
~9e-3).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_config
from repro.models import cache_specs as j_cache_specs
from repro.models import forward as j_forward
from repro.models import logits_from_hidden as j_logits
from repro.models import model_specs as j_specs
from repro.models.params import is_spec, param_count as j_param_count
from repro.sharding.rules import make_rules
from repro.train.steps import (make_decode_sample_step as j_decode_step,
                               make_prefill_sample_step as j_prefill_step)
from repro_torch.configs import get_config
from repro_torch.models import (cache_specs, forward, from_reference,
                                init_params, logits_from_hidden,
                                model_specs, param_count, stack_specs,
                                zeros_from_specs)
from repro_torch.models.params import tree_leaves
from repro_torch.train.steps import (make_decode_sample_step,
                                     make_prefill_sample_step)
from _ref_params import ref_params

F32_TOL = 2e-5
BF16_TOL = 2e-2


# the archs ported beside MLA, each a variant of its own
ARCHS = ["deepseek-v2-236b", "deepseek-moe-16b", "qwen3-32b", "minitron-4b",
         "granite-34b"]
VARIANTS = ["g1", "kv2"] + ARCHS


def _configs(variant, dtype="float32"):
    kw = dict(compute_dtype=dtype)
    if variant == "kv2":
        kw["num_kv_heads"] = 2
    arch = variant if variant in ARCHS else "granite-3-2b"
    jc = dataclasses.replace(jax_config(arch).reduced(), **kw)
    tc = dataclasses.replace(get_config(arch).reduced(), **kw)
    return jc, tc


def _layer_caches(tc, jcache):
    """The reference's cache tree (prefix blocks, stacked unit) as the
    port's per-layer list, float32 numpy leaves."""
    return from_reference(tc, jax.tree.map(np.asarray, jcache),
                          "cpu")["layers"]


@pytest.fixture(scope="module")
def models():
    """variant -> (jax cfg, port cfg, jax params, port params)."""
    out = {}
    for variant in VARIANTS:
        jc, tc = _configs(variant)
        p = ref_params(j_specs(jc), 0)
        out[variant] = (jc, tc, jax.tree.map(jnp.asarray, p),
                        from_reference(tc, p, "cpu"))
    return out


def _tokens(cfg, B, S, seed=0):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _close(port, ref, tol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), atol=tol)


def test_reduced_config_is_g1_and_variant_g2(models):
    for variant, g in (("g1", 1), ("kv2", 2)):
        tc = models[variant][1]
        assert tc.num_heads // tc.num_kv_heads == g
        assert tc.num_layers == 2


def test_from_reference_unstacks_the_layer_axis(models):
    jc, tc, jp, tp = models["kv2"]
    groups = jc.layer_groups()
    assert len(tp["layers"]) == jc.num_layers
    for i in range(groups.repeats):
        for j in range(len(groups.unit)):
            layer = tp["layers"][len(groups.prefix) + i * len(groups.unit)
                                 + j]
            ref = jp["unit"][j]
            np.testing.assert_array_equal(
                layer["mixer"]["wq"].numpy(),
                np.asarray(ref["mixer"]["wq"][i]))
            np.testing.assert_array_equal(
                layer["ffn"]["w_down"].numpy(),
                np.asarray(ref["ffn"]["w_down"][i]))
    np.testing.assert_array_equal(tp["embed"]["tok"].numpy(),
                                  np.asarray(jp["embed"]["tok"]))
    assert param_count(model_specs(tc)) == j_param_count(j_specs(jc))
    # stacking the port's per-layer specs gives the reference's unit
    stacked = stack_specs(model_specs(tc)["layers"][0], groups.repeats)
    ref_unit = j_specs(jc)["unit"][0]
    assert stacked["mixer"]["wq"].shape == ref_unit["mixer"]["wq"].shape
    assert stacked["ffn"]["w_up"].axes == ref_unit["ffn"]["w_up"].axes


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_forward_matches_jax(models, variant, impl):
    jc, tc, jp, tp = models[variant]
    jc = dataclasses.replace(jc, attn_impl=impl)
    rules = make_rules(jc, None, None)
    B, S = 2, 32
    toks = _tokens(jc, B, S)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    jx, _, jaux = j_forward(jc, jp, {"tokens": jnp.asarray(toks),
                                     "positions": jnp.asarray(pos)},
                            rules=rules)
    tx, _, aux = forward(tc, tp, {"tokens": torch.from_numpy(toks),
                                  "positions": torch.from_numpy(pos)})
    _close(tx, jx, F32_TOL)
    _close(logits_from_hidden(tc, tp, tx), j_logits(jc, jp, jx, rules),
           F32_TOL)
    if tc.moe is None:
        assert float(aux) == 0.0
    else:                               # the load-balance loss, summed
        assert float(aux) > 0.0
        _close(aux, jaux, F32_TOL)


def _prefill_decode(jc, tc, jp, tp, cache_dt):
    """Prefill 12 tokens, then 3 decode steps with ragged positions (row
    1 rewinds to 9, overwriting its cache rows); last-position logits of
    every step from both frameworks."""
    rules = make_rules(jc, None, None)
    B, P, max_len = 2, 12, 32
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
                      np.asarray([[P + t], [9 + t]], np.int32)))
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


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_prefill_and_decode_match_jax(models, variant, impl):
    jc, tc, jp, tp = models[variant]
    jc = dataclasses.replace(jc, attn_impl=impl)
    outs, tcache, jcache = _prefill_decode(
        jc, tc, jp, tp, (jnp.float32, torch.float32))
    for port, ref in outs:
        _close(port, ref, F32_TOL)
    # the caches agree too (k, v; an MLA layer's ckv, krope)
    for got, want in zip(tcache["layers"], _layer_caches(tc, jcache),
                         strict=True):
        assert sorted(got) == sorted(want)
        for name in got:
            _close(got[name], want[name], F32_TOL)


def test_prefill_and_decode_match_jax_in_bf16():
    jc, tc = _configs("kv2", "bfloat16")
    p = ref_params(j_specs(jc), 1)
    jp = jax.tree.map(jnp.asarray, p)
    tp = from_reference(tc, p, "cpu", dtype=torch.bfloat16)
    assert tp["layers"][0]["mixer"]["wq"].dtype == torch.bfloat16
    assert tp["layers"][0]["norm1"]["scale"].dtype == torch.float32
    outs, _, _ = _prefill_decode(jc, tc, jp, tp,
                                 (jnp.bfloat16, torch.bfloat16))
    for port, ref in outs:
        _close(port, ref, BF16_TOL)


@pytest.mark.parametrize("variant", VARIANTS)
def test_sample_steps_match_jax_greedy_ids(models, variant):
    """The serving steps (default bf16 cache): greedy ids of a prefill
    and two decode steps equal the reference's."""
    jc, tc, jp, tp = models[variant]
    rules = make_rules(jc, None, None)
    B, P, max_len = 3, 8, 16
    toks = _tokens(jc, B, P, seed=2)
    pos = np.broadcast_to(np.arange(P, dtype=np.int32), (B, P)).copy()
    jids, jcache = jax.jit(j_prefill_step(jc, rules, max_len=max_len))(
        jp, {"tokens": jnp.asarray(toks), "positions": jnp.asarray(pos)})
    tids, tcache = make_prefill_sample_step(tc, max_len=max_len)(
        tp, {"tokens": torch.from_numpy(toks),
             "positions": torch.from_numpy(pos)})
    for got, spec in zip(tcache["layers"],
                         cache_specs(tc, B, max_len)["layers"]):
        assert {k: t.shape for k, t in got.items()} == \
            {k: sp.shape for k, sp in spec.items()}
    assert tids.dtype == torch.int32
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    jstep, tstep = jax.jit(j_decode_step(jc, rules)), \
        make_decode_sample_step(tc)
    for t in range(2):
        p = np.full((B, 1), P + t, np.int32)
        tk = np.asarray(tids, np.int32)[:, None]
        jids, jhid, jcache = jstep(jp, {"tokens": jnp.asarray(tk),
                                        "positions": jnp.asarray(p)}, jcache)
        tids, thid, tcache = tstep(tp, {"tokens": torch.from_numpy(tk),
                                        "positions": torch.from_numpy(p)},
                                   tcache)
        np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
        # the last-position hidden block, ST-routed decode's MoE payload;
        # it attends over the bf16 caches, so the caches' tolerance
        assert thid.shape == (B, tc.d_model)
        _close(thid, jhid, BF16_TOL)
        # the bf16 caches after the step: float32 values equal to ~1e-7
        # may round to neighbouring bf16 values, so a bf16 tolerance
        for got, want in zip(tcache["layers"], _layer_caches(tc, jcache),
                             strict=True):
            for name in got:
                _close(got[name], want[name], BF16_TOL)


def test_init_params_is_seeded_and_typed():
    cfg = get_config("granite-3-2b").reduced()
    specs = model_specs(cfg)

    def make(seed):
        return init_params(specs, torch.Generator().manual_seed(seed),
                           "cpu", torch.bfloat16)

    a, b, c = make(0), make(0), make(1)
    assert torch.equal(a["layers"][1]["ffn"]["w_up"],
                       b["layers"][1]["ffn"]["w_up"])
    assert not torch.equal(a["layers"][1]["ffn"]["w_up"],
                           c["layers"][1]["ffn"]["w_up"])
    assert a["embed"]["tok"].shape == (cfg.padded_vocab, cfg.d_model)
    assert a["embed"]["tok"].dtype == torch.bfloat16
    assert a["final_norm"]["scale"].dtype == torch.float32
    assert torch.equal(a["final_norm"]["scale"], torch.ones(cfg.d_model))
    std = a["layers"][0]["ffn"]["w_up"].float().std().item()   # fan-in d
    assert abs(std - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5


def test_full_granite_config_and_unported_kinds():
    cfg = get_config("granite-3-2b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.d_ff, cfg.vocab_size, cfg.padded_vocab) == \
        (40, 2048, 32, 8, 8192, 49155, 49408)
    # ~2.5 B params at full width (tied embeddings over the padded vocab)
    assert 2.4e9 < param_count(model_specs(cfg)) < 2.6e9
    # every arch of the registry comes across now, the two with cross
    # attention and a modality frontend too, and a cross-attention mixer
    # gets the gated specs and the vision cache
    for arch in ("llama-3.2-vision-90b", "musicgen-large"):
        assert get_config(arch).vision is not None
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("llama-4")
    cross = dataclasses.replace(cfg.reduced(), cross_attn_period=2,
                                vision=get_config(
                                    "llama-3.2-vision-90b").reduced().vision)
    assert ("cross", "dense") in cross.layer_specs()
    specs = model_specs(cross)
    assert specs["layers"][1]["mixer"]["gate"].shape == ()
    assert specs["frontend"]["proj"].shape == (64, cross.d_model)
    assert sorted(cache_specs(cross, 2, 8)["layers"][1]) == ["ck", "cv"]


# (num_layers, d_model, num_heads, num_kv_heads, head_dim, vocab_size) and
# the reference's param_counts()["total"] at full width, in billions
FULL = {
    "deepseek-v2-236b": ((60, 5120, 128, 128, 128, 102400), 235.74),
    "deepseek-moe-16b": ((28, 2048, 16, 16, 128, 102400), 16.38),
    "qwen3-32b": ((64, 5120, 64, 8, 128, 151936), 32.76),
    "minitron-4b": ((32, 3072, 24, 8, 128, 256000), 5.10),
    "granite-34b": ((88, 6144, 48, 1, 128, 49152), 47.25),
    "llama-3.2-vision-90b": ((100, 8192, 64, 8, 128, 128256), 87.665),
    "musicgen-large": ((48, 2048, 32, 32, 64, 2048), 3.23),
}


# the port's switches the reference has not (jamba2-mini and
# deepseek-v2-lite turn them on),
# with the defaults under which every reference architecture runs
PORT_SWITCHES = {"attn_layer_offset": 0, "use_rope": True,
                 "renormalize": True, "inner_norms": False,
                 "rope_scaling": None}


@pytest.mark.parametrize("arch", list(FULL))
def test_full_width_configs_equal_the_reference(arch):
    """Every field the port keeps equals the reference's (the attention
    route apart; the port's own switches at their defaults), and the full
    model's parameter tree counts what the reference's counts (the
    padded vocab included); the reference's own param_counts() gives the
    size quoted in the config's docstring."""
    cfg, jc = get_config(arch), jax_config(arch)

    def plain(x):                       # sub-configs by their fields
        if not dataclasses.is_dataclass(x):
            return x
        d = dataclasses.asdict(x)
        for k in PORT_SWITCHES:         # the port's own, at their defaults
            if k in d:
                assert d.pop(k) == PORT_SWITCHES[k], k
        return d
    for f in dataclasses.fields(cfg):
        if f.name in PORT_SWITCHES:
            assert getattr(cfg, f.name) == PORT_SWITCHES[f.name], f.name
        elif f.name != "attn_impl":     # the port names its own routes
            assert plain(getattr(cfg, f.name)) == \
                plain(getattr(jc, f.name)), f.name
    dims, billions = FULL[arch]
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.vocab_size) == dims
    assert param_count(model_specs(cfg)) == j_param_count(j_specs(jc))
    assert round(jc.param_counts()["total"] / 1e9, 2) == pytest.approx(
        billions, abs=0.01)


def test_deepseek_v2_tree_with_a_stacked_unit_comes_across():
    """deepseek-v2 cut to 4 layers: the reference keeps the dense first
    layer as a prefix block and stacks the 3 MoE layers (3-D ``wq_b``,
    ``wk_b``, ``wv_b`` per layer, 4-D stacked); ``from_reference`` gives
    each layer its own slice, and the forward matches."""
    jc, tc = _configs("deepseek-v2-236b")
    jc, tc = (dataclasses.replace(c, num_layers=4) for c in (jc, tc))
    groups = jc.layer_groups()
    assert [tuple(sp) for sp in groups.prefix] == [("mla", "dense")]
    assert groups.unit == (("mla", "moe"),) and groups.repeats == 3
    p = ref_params(j_specs(jc), 3)
    assert p["unit"][0]["mixer"]["wk_b"].shape == (3, 32, 4, 32)
    tp = from_reference(tc, p, "cpu")
    assert [sorted(layer["ffn"]) for layer in tp["layers"]] == \
        [["w_down", "w_gate", "w_up"]] + \
        [["router", "shared", "w_down", "w_gate", "w_up"]] * 3
    assert tp["layers"][0]["ffn"]["w_up"].shape == (128, 64)
    for i in range(3):
        for name in ("wq_b", "wk_b", "wv_b", "wo"):
            np.testing.assert_array_equal(
                tp["layers"][1 + i]["mixer"][name].numpy(),
                p["unit"][0]["mixer"][name][i])
    rules = make_rules(jc, None, None)
    toks = _tokens(jc, 2, 16, seed=4)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16)).copy()
    jx, _, _ = j_forward(jc, jax.tree.map(jnp.asarray, p),
                         {"tokens": jnp.asarray(toks),
                          "positions": jnp.asarray(pos)}, rules=rules)
    tx, _, _ = forward(tc, tp, {"tokens": torch.from_numpy(toks),
                                "positions": torch.from_numpy(pos)})
    _close(tx, jx, F32_TOL)


def test_from_reference_takes_bf16_numpy_leaves():
    """A reference tree held in bf16 (``jax.tree.map(np.asarray, ...)`` of
    bf16 params gives ml_dtypes' bfloat16, whose numpy kind is "V", not
    "f"): every leaf comes across with its bf16 values."""
    jc, tc = _configs("deepseek-v2-236b")
    p = ref_params(j_specs(jc), 5)
    p16 = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                       p)
    assert p16["embed"]["tok"].dtype.kind == "V"
    tp = from_reference(tc, p16, "cpu", dtype=torch.bfloat16)
    want = from_reference(tc, p, "cpu", dtype=torch.bfloat16)
    for a, b in zip(tree_leaves(tp), tree_leaves(want), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
