"""The port's baseline serving engine on the CPU.

The contract of ``tests/test_serving.py`` (continuous batching: FIFO
deque admission, one prefill dispatch per length group, batched equal
to serial admission, slot recycling under churn, EOS, ragged per-slot
positions and timestamps, deterministic completion order), held on the
port's engine; its greedy tokens equal the JAX package's engine on the
same params and requests (float32 compute) — granite's, rwkv6's,
jamba's, deepseek-v2's (MLA) and deepseek-moe-16b's; and the entry point
runs on CUDA unless asked for the CPU.
"""
import dataclasses
from collections import deque

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro.configs import get_config as jax_config
from repro.models import model_specs as j_specs
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro.sharding.rules import make_rules
from _mamba_draws import redraw_mamba
from _ref_params import ref_params
from _rwkv_draws import redraw_rwkv
from repro_torch.configs import get_config
from repro_torch.models import from_reference, init_params, model_specs
from repro_torch.serving import Request, ServingEngine

TINY = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=1,
            d_ff=128, vocab_size=256, head_dim=32)


def _tiny_cfg():
    return dataclasses.replace(get_config("granite-3-2b").reduced(), **TINY)


@pytest.fixture(scope="module")
def tiny_model():
    cfg = _tiny_cfg()
    params = init_params(model_specs(cfg), torch.Generator().manual_seed(0),
                         "cpu", getattr(torch, cfg.compute_dtype))
    return cfg, params


def _engine(tiny_model, **kw):
    cfg, params = tiny_model
    kw.setdefault("batch_slots", 2)
    kw.setdefault("max_len", 32)
    return ServingEngine(cfg, params, device="cpu", **kw)


def _prompt(*toks):
    return np.asarray(toks, np.int32)


# ---------------------------------------------------------------------------
# continuous batching (the contract of tests/test_serving.py)
# ---------------------------------------------------------------------------

def test_admission_queue_is_fifo_deque(tiny_model):
    eng = _engine(tiny_model)
    reqs = [Request(prompt=_prompt(i + 1), max_new_tokens=1)
            for i in range(5)]
    for r in reqs:
        eng.submit(r)
    assert isinstance(eng.queue, deque)
    eng.run_until_drained()
    assert [r.req_id for r in eng.completed] == [r.req_id for r in reqs]


def test_batch_prefill_one_dispatch_per_length_group(tiny_model):
    eng = _engine(tiny_model, batch_slots=4)
    for i in range(3):                       # same length: ONE dispatch
        eng.submit(Request(prompt=_prompt(1 + i, 2 + i),
                           max_new_tokens=1))
    eng.step()
    assert eng.prefill_dispatches == 1
    assert len(eng._active()) + len(eng.completed) == 3

    eng2 = _engine(tiny_model, batch_slots=4)
    eng2.submit(Request(prompt=_prompt(1, 2), max_new_tokens=1))
    eng2.submit(Request(prompt=_prompt(3, 4, 5), max_new_tokens=1))
    eng2.submit(Request(prompt=_prompt(6, 7), max_new_tokens=1))
    eng2.step()                              # two length groups
    assert eng2.prefill_dispatches == 2


def test_batch_prefill_matches_serial_admission(tiny_model):
    prompts = [_prompt(5, 6, 7), _prompt(9, 10, 11)]
    eng = _engine(tiny_model, batch_slots=2)
    for p in prompts:
        eng.submit(Request(prompt=p, max_new_tokens=3))
    eng.run_until_drained()
    together = [r.out_tokens for r in eng.completed]

    serial = []
    for p in prompts:                        # fresh engine per request
        e1 = _engine(tiny_model, batch_slots=2)
        e1.submit(Request(prompt=p, max_new_tokens=3))
        e1.run_until_drained()
        serial.append(e1.completed[0].out_tokens)
    assert together == serial


def test_slot_recycling_under_churn(tiny_model):
    eng = _engine(tiny_model, batch_slots=2)
    budgets = [3, 1, 4, 2, 1, 3, 2]
    for i, b in enumerate(budgets):
        eng.submit(Request(prompt=_prompt(i + 1), max_new_tokens=b))
    eng.run_until_drained()
    assert len(eng.completed) == len(budgets)
    assert sorted(len(r.out_tokens) for r in eng.completed) == \
        sorted(budgets)
    assert eng._free_slots() == [0, 1]
    assert eng.stats()["queued"] == 0


def test_prefill_into_scattered_slots_matches_fresh_engine(tiny_model):
    """A length group admitted into slots that are not consecutive (the
    prefill gathers their rows and writes them back) serves the same
    tokens as an engine where they are."""
    eng = _engine(tiny_model, batch_slots=3)
    eng.submit(Request(prompt=_prompt(1, 2, 3), max_new_tokens=4))
    eng.submit(Request(prompt=_prompt(4), max_new_tokens=1))  # done at once
    eng.submit(Request(prompt=_prompt(5, 6), max_new_tokens=9))
    eng.step()                 # slot 0: len-1 (done), 1: len-2, 2: len-3
    assert eng.slot_req[0] is None and eng._active() == [1, 2]
    for _ in range(3):
        eng.step()             # the len-3 request (slot 2) finishes
    assert eng._free_slots() == [0, 2]
    late = [Request(prompt=_prompt(7, 8, 9, 10), max_new_tokens=3),
            Request(prompt=_prompt(11, 12, 13, 14), max_new_tokens=3)]
    for r in late:
        eng.submit(r)
    before = eng.prefill_dispatches
    eng.run_until_drained()
    assert eng.prefill_dispatches == before + 1     # one group, slots 0, 2

    fresh = _engine(tiny_model, batch_slots=2)
    ref = [Request(prompt=r.prompt, max_new_tokens=3) for r in late]
    for r in ref:
        fresh.submit(r)
    fresh.run_until_drained()
    assert [r.out_tokens for r in late] == [r.out_tokens for r in ref]


def test_eos_stops_early(tiny_model):
    pilot = _engine(tiny_model)
    pilot.submit(Request(prompt=_prompt(5, 6, 7), max_new_tokens=6))
    pilot.run_until_drained()
    toks = pilot.completed[0].out_tokens
    eos = toks[2]
    first_hit = toks.index(eos)

    eng = _engine(tiny_model)
    eng.submit(Request(prompt=_prompt(5, 6, 7), max_new_tokens=6,
                       eos_id=eos))
    eng.run_until_drained()
    assert eng.completed[0].out_tokens == toks[:first_hit + 1]


def test_ragged_positions_and_timestamps(tiny_model):
    eng = _engine(tiny_model, batch_slots=2)
    ra = Request(prompt=_prompt(1, 2), max_new_tokens=3)
    rb = Request(prompt=_prompt(3, 4, 5, 6, 7), max_new_tokens=3)
    eng.submit(ra)
    eng.submit(rb)
    eng.step()                               # admit both + one decode
    assert sorted(eng.slot_pos.tolist()) == [3, 6]
    eng.run_until_drained()
    for r in (ra, rb):
        assert (r.submitted_at <= r.admitted_at <= r.first_token_at
                <= r.done_at)
    stats = eng.stats()
    assert stats["prefill_dispatches"] == 2 and stats["decode_steps"] >= 2
    assert stats["prefill_seconds"] > 0 and stats["decode_seconds"] > 0


def test_deterministic_completion_order(tiny_model):
    def run():
        eng = _engine(tiny_model, batch_slots=2)
        specs = [((2, 9), 3), ((4, 5, 6), 1), ((7,), 2), ((8, 3), 4),
                 ((1, 1, 2), 2)]
        reqs = [Request(prompt=_prompt(*p), max_new_tokens=m)
                for p, m in specs]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        by_id = {id(r): i for i, r in enumerate(reqs)}
        return ([by_id[id(r)] for r in eng.completed],
                [r.out_tokens for r in eng.completed])

    assert run() == run()


# ---------------------------------------------------------------------------
# against the JAX package's engine; device selection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_heads", [1, 2])
def test_greedy_tokens_equal_the_jax_engine(kv_heads):
    """Same params (``ref_params``, handed over as numpy), same
    requests — three prompt lengths, more requests than slots, ragged
    budgets — float32 compute: every request gets the same tokens."""
    kw = dict(TINY, num_kv_heads=kv_heads, compute_dtype="float32")
    jcfg = dataclasses.replace(jax_config("granite-3-2b").reduced(), **kw)
    tcfg = dataclasses.replace(get_config("granite-3-2b").reduced(), **kw)
    params = ref_params(j_specs(jcfg), 0)
    jparams = jax.tree.map(jax.numpy.asarray, params)
    tparams = from_reference(tcfg, params, "cpu")
    jeng = JServingEngine(jcfg, jparams, make_rules(jcfg, None, None),
                          batch_slots=3, max_len=32)
    teng = ServingEngine(tcfg, tparams, batch_slots=3, max_len=32,
                         device="cpu")
    rng = np.random.RandomState(3)
    specs = [(rng.randint(1, 256, L).astype(np.int32), m)
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


def test_engine_asks_for_cuda_by_default_and_raises_without_a_card(
        tiny_model, monkeypatch):
    cfg, params = tiny_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(cfg, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(cfg, params, device="cuda")


def test_submit_refuses_prompts_the_cache_cannot_hold(tiny_model):
    eng = _engine(tiny_model, max_len=8)
    for n in (0, 8, 9):
        with pytest.raises(ValueError, match="prompt of"):
            eng.submit(Request(prompt=np.ones(n, np.int32)))
    eng.submit(Request(prompt=np.ones(7, np.int32), max_new_tokens=5))
    eng.run_until_drained()
    assert len(eng.completed[0].out_tokens) == 1    # the cache is full


# ---------------------------------------------------------------------------
# recurrent state in the cache: rwkv6 and jamba
# ---------------------------------------------------------------------------

def _state_models(arch, redraw):
    """The reduced ``arch`` in float32 for both frameworks, the same
    weights: ``ref_params`` with the leaves the reference's init leaves
    constant redrawn by ``redraw`` (``tests/_rwkv_draws.py``,
    ``tests/_mamba_draws.py``: the init's constants would leave rwkv's
    token shift and bonus inert and mamba's decays all alike)."""
    jcfg = dataclasses.replace(jax_config(arch).reduced(),
                               compute_dtype="float32")
    tcfg = dataclasses.replace(get_config(arch).reduced(),
                               compute_dtype="float32")
    params = redraw(ref_params(j_specs(jcfg), 0), np.random.RandomState(0))
    return (jcfg, tcfg, jax.tree.map(jax.numpy.asarray, params),
            from_reference(tcfg, params, "cpu"))


def _rwkv_models():
    return _state_models("rwkv6-1.6b", redraw_rwkv)


def _jamba_models():
    return _state_models("jamba-1.5-large-398b", redraw_mamba)


# (prompt length, budget): slots 0 and 2 finish at admission while slot 1
# decodes, so the next length group (two prompts of 4) lands in the
# scattered slots [0, 2], each holding its previous request's state
STATE_SPECS = ((1, 1), (2, 9), (3, 1), (4, 3), (4, 3), (2, 5), (3, 2),
               (6, 4))


def _recording(eng, states=None):
    """Record the slots of every prefill dispatch of ``eng``, and in
    ``states`` (a list, if given) the slots' state rows it wrote (per
    layer {leaf: rows})."""
    seen, inner = [], eng._prefill_group

    def prefill_group(slots, toks):
        seen.append(list(slots))
        out = inner(slots, toks)
        if states is not None:
            states.append([{k: c[k][slots].clone() for k in keys}
                           for c, keys in zip(eng.cache["layers"],
                                              eng._state_keys)])
        return out
    eng._prefill_group = prefill_group
    return seen


def _tokens_equal_the_jax_engine(models, seed):
    """More requests than slots, slots recycled, one length group
    admitted into non-consecutive slots: every request gets the JAX
    engine's tokens (the reference engine's default dense MoE). Returns
    the port's engine."""
    jcfg, tcfg, jparams, tparams = models
    jeng = JServingEngine(jcfg, jparams, make_rules(jcfg, None, None),
                          batch_slots=3, max_len=32)
    teng = ServingEngine(tcfg, tparams, batch_slots=3, max_len=32,
                         device="cpu")
    dispatched = _recording(teng)
    rng = np.random.RandomState(seed)
    specs = [(rng.randint(1, tcfg.vocab_size, L).astype(np.int32), m)
             for L, m in STATE_SPECS]
    jreqs = [JRequest(prompt=p, max_new_tokens=m) for p, m in specs]
    treqs = [Request(prompt=p, max_new_tokens=m) for p, m in specs]
    for jr, tr in zip(jreqs, treqs):
        jeng.submit(jr)
        teng.submit(tr)
    jeng.run_until_drained()
    teng.run_until_drained()
    assert [0, 2] in dispatched                     # scattered admission
    assert len(dispatched) > 3                      # slots recycled
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    for key in ("prefill_dispatches", "decode_steps", "tokens_generated"):
        assert teng.stats()[key] == jeng.stats()[key], key
    return teng


def _recycled_slot_serves_a_fresh_engines_tokens(tcfg, tparams, scattered):
    """A request admitted into a slot whose state a finished request
    left behind — consecutive slots (prefilled through one view) or not
    (gathered and written back) — gets the tokens of a fresh engine, and
    its prefill leaves the state rows that engine's does (a stale row may
    move the logits too little to change a greedy token)."""
    rng = np.random.RandomState(5)
    prompt = lambda n: rng.randint(1, tcfg.vocab_size, n).astype(np.int32)
    eng = ServingEngine(tcfg, tparams, batch_slots=3, max_len=32,
                        device="cpu")
    states, fresh_states = [], []
    dispatched = _recording(eng, states)
    # slots 0, 1, 2 by prompt length; scattered: slots 0 and 2 finish
    # after one decode step while slot 1 goes on decoding
    budgets = (2, 8, 2) if scattered else (4, 4, 4)
    for n, m in zip((2, 3, 5), budgets):
        eng.submit(Request(prompt=prompt(n), max_new_tokens=m))
    if scattered:
        eng.step()
        assert eng._free_slots() == [0, 2]
    else:
        eng.run_until_drained()
    late = [Request(prompt=prompt(4), max_new_tokens=5)
            for _ in range(2)]
    for r in late:
        eng.submit(r)
    eng.run_until_drained()
    assert dispatched[-1] == ([0, 2] if scattered else [0, 1])
    fresh = ServingEngine(tcfg, tparams, batch_slots=3, max_len=32,
                          device="cpu")
    _recording(fresh, fresh_states)
    ref = [Request(prompt=r.prompt, max_new_tokens=5) for r in late]
    for r in ref:
        fresh.submit(r)
    fresh.run_until_drained()
    assert [r.out_tokens for r in late] == [r.out_tokens for r in ref]
    # the default tolerance of each leaf's dtype: the two prefills attend
    # over differently cut KV rows, which may move a bf16 conv row or
    # token shift by one rounding; a stale row moves the state far more
    for got, want in zip(states[-1], fresh_states[0]):
        for k in got:
            torch.testing.assert_close(got[k], want[k])


def test_rwkv_greedy_tokens_equal_the_jax_engine():
    """rwkv6 (float32 compute, the default bf16 cache): a slot that kept
    its previous request's state, or a state leaf cut to the prompt
    length, changes the tokens."""
    jcfg, tcfg, jparams, tparams = models = _rwkv_models()
    teng = _tokens_equal_the_jax_engine(models, seed=4)
    shift = teng.cache["layers"][0]["shift_t"]
    assert shift.shape == (3, tcfg.d_model) and shift.dtype == torch.bfloat16


@pytest.mark.parametrize("scattered", [False, True])
def test_rwkv_recycled_slot_serves_a_fresh_engines_tokens(scattered):
    _, tcfg, _, tparams = _rwkv_models()
    _recycled_slot_serves_a_fresh_engines_tokens(tcfg, tparams, scattered)


def test_jamba_greedy_tokens_equal_the_jax_engine():
    """The reduced jamba (attention, mamba and dense-MoE layers; float32
    compute, the default bf16 cache): a slot that kept its previous
    request's conv rows or SSM state changes the tokens."""
    jcfg, tcfg, jparams, tparams = models = _jamba_models()
    teng = _tokens_equal_the_jax_engine(models, seed=6)
    layer = teng.cache["layers"][1]
    assert layer["conv"].shape == (3, 3, 2 * tcfg.d_model)
    assert layer["conv"].dtype == torch.bfloat16
    assert layer["ssm"].dtype == torch.float32


@pytest.mark.parametrize("scattered", [False, True])
def test_jamba_recycled_slot_serves_a_fresh_engines_tokens(scattered):
    _, tcfg, _, tparams = _jamba_models()
    _recycled_slot_serves_a_fresh_engines_tokens(tcfg, tparams, scattered)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "deepseek-moe-16b"])
def test_deepseek_greedy_tokens_equal_the_jax_engine(arch):
    """The reduced deepseek-v2 (MLA: the expand path at prefill, over the
    whole cache of a slot or over a scattered group's gathered rows, and
    the absorbed decode over the latent cache) and deepseek-moe-16b (GQA
    attention) — a dense first FFN, then MoE with shared experts; float32
    compute, the default bf16 cache — serve the JAX engine's tokens."""
    models = _state_models(arch, lambda p, rng: p)
    tcfg = models[1]
    teng = _tokens_equal_the_jax_engine(models, seed=7)
    layer = teng.cache["layers"][0]
    if tcfg.mla is not None:
        assert sorted(layer) == ["ckv", "krope"]
        assert layer["ckv"].shape == (3, 32, tcfg.mla.kv_lora_rank)
        assert layer["krope"].shape == (3, 32, tcfg.mla.qk_rope_head_dim)
    assert all(t.dtype == torch.bfloat16 for t in layer.values())


@pytest.mark.parametrize("moe_impl", ["dense", "gshard", "a2a"])
def test_jamba_engine_moe_impl(moe_impl):
    """The engine passes ``moe_impl`` to the model: "dense" (its
    default), "gshard" and "a2a" all serve (a prompt of 3 tokens leaves
    every expert under capacity, so all give the same tokens)."""
    _, tcfg, _, tparams = _jamba_models()
    tokens = {}
    for impl in ("dense", moe_impl):
        eng = ServingEngine(tcfg, tparams, batch_slots=2, max_len=16,
                            moe_impl=impl, device="cpu")
        eng.submit(Request(prompt=np.asarray([5, 6, 7], np.int32),
                           max_new_tokens=4))
        eng.run_until_drained()
        tokens[impl] = eng.completed[0].out_tokens
    assert len(tokens["dense"]) == 4
    assert tokens["dense"] == tokens[moe_impl]


@pytest.mark.parametrize("arch", ["deepseek-v2-lite", "deepseek-v2-236b"])
def test_engine_counts_mla_rows(arch):
    """``stats()``: the latent rows the absorbed MLA decode scored (every
    slot's ``max_len`` rows a step, idle slots included) and the valid
    ones (position + 1 an active slot), over the MLA layers; both with
    and without query compression. A model without MLA has neither."""
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              compute_dtype="float32")
    params = init_params(model_specs(cfg), torch.Generator().manual_seed(0),
                         "cpu")
    eng = ServingEngine(cfg, params, batch_slots=3, max_len=32,
                        device="cpu")
    valid = []
    real = eng._decode_batch

    def decode_batch(active):
        valid.append(sum(int(eng.slot_pos[i]) + 1 for i in active))
        return real(active)
    eng._decode_batch = decode_batch
    for n, k in ((5, 6), (9, 4), (5, 3), (7, 2)):
        eng.submit(Request(prompt=np.arange(1, n + 1, dtype=np.int32),
                           max_new_tokens=k))
    eng.run_until_drained()
    st = eng.stats()
    n_mla = cfg.num_layers
    assert st["mla_rows_scored"] == n_mla * 3 * 32 * len(valid)
    assert st["mla_rows_valid"] == n_mla * sum(valid)
    assert len(valid) == eng.decode_steps > 0
    granite = ServingEngine(_tiny_cfg(), init_params(
        model_specs(_tiny_cfg()), torch.Generator().manual_seed(0), "cpu"),
        batch_slots=2, max_len=16, device="cpu")
    assert "mla_rows_scored" not in granite.stats()
