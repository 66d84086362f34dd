"""ST-routed decode in the port: the ``serve`` pattern, the decode router
and the serving engine's ``st_mode``, against the JAX package's and a
numpy oracle, on the CPU.

  * ``pattern_programs("serve", ...)``: node ``structural_key()``
    sequences, ``stats()``, segment plans, host dispatch counts and the
    simulated cost equal to the reference's for R in {1, 4}, MoE
    dispatch on and off, default, double-buffered two-stream and fused
    schedules;
  * the router at 4 virtual ranks with MoE dispatch against a numpy
    oracle (the committed ids and KV rows are the staged ones; the
    combined hidden block the staged one plus each peer shift's, in
    shift order; padded rows zeroed; counters at one epoch's counts),
    in every mode;
  * the contract of ``tests/test_serving.py``'s ST cases on the tiny
    granite (weights from ``tests/_ref_params.py``, float32 compute):
    the tokens of the ST, host and fused engines, with the default
    config and with ``"auto"``, equal the port's baseline and the
    reference's ST engine (one rank in the tests' process, as the
    reference's device count there); the payload rows each decode step
    extracts equal the reference's, bit for bit; the bucket meta equals the
    reference's; bucket caching; the tuned cache populated; the router
    committing bit-exact; the traffic driver;
  * the tiny jamba at 4 ranks (the hidden block riding three peer
    shifts) serves its baseline's tokens; rwkv (no KV rows) refuses
    ``st_mode``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro.configs import get_config as jax_config
from repro.core import host_dispatch_count as ref_dispatch_count
from repro.core import pattern_programs as ref_programs
from repro.core import simulate_pattern as ref_simulate
from repro.core.autotune import ScheduleConfig as RefScheduleConfig
from repro.models import model_specs as j_specs
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro.sharding.rules import make_rules
from _ref_params import ref_params
from repro_torch.configs import get_config
from repro_torch.core import (counters_expected, host_dispatch_count,
                              pattern_programs, simulate_pattern)
from repro_torch.core.autotune import ScheduleConfig, load_tuned
from repro_torch.launch.traffic import TrafficConfig, run_traffic
from repro_torch.models import from_reference, init_params, model_specs
from repro_torch.serving import Request, ServingEngine, STDecodeRouter

MODES = ("st", "host", "fused")
TINY = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=1,
            d_ff=128, vocab_size=256, head_dim=32, compute_dtype="float32")


# ---------------------------------------------------------------------------
# the serve pattern's programs
# ---------------------------------------------------------------------------

SCHEDULES = {"default": {},
             "db_nstreams2": dict(double_buffer=True, nstreams=2),
             "fused": dict(fused=True)}


def _plan(prog):
    plan = prog.meta.get("segment_plan")
    if plan is None:
        return None
    pos = {n.op_id: i for i, n in enumerate(prog.nodes)}
    return ([(s.stream, s.wave, tuple(pos[o] for o in s.op_ids),
              tuple(sorted(s.arena.items())), s.arena_nbytes)
             for s in plan.segments],
            sorted(pos[h] for h in plan.heads))


@pytest.mark.parametrize("sched", sorted(SCHEDULES))
@pytest.mark.parametrize("moe", [True, False])
@pytest.mark.parametrize("R", [1, 4])
def test_serve_programs_equal_the_reference(R, moe, sched):
    kw = dict(SCHEDULES[sched], grid=(R,), slots=4, kv_dim=24, d_model=40,
              moe=moe)
    got, ref = pattern_programs("serve", 3, **kw), ref_programs(
        "serve", 3, **kw)
    assert len(got) == len(ref) == 1
    for g, r in zip(got, ref):
        assert [n.structural_key() for n in g.nodes] == \
            [n.structural_key() for n in r.nodes]
        assert g.key() == r.key()
        assert g.stats() == r.stats()
        assert _plan(g) == _plan(r)
        assert host_dispatch_count(g) == ref_dispatch_count(r)
    # KV + ids on the +1 shift, plus the hidden block to every peer shift
    assert got[0].stats()["puts"] == 3 * (2 + (R - 1 if moe else 0))
    sim = {k: v for k, v in kw.items() if k != "double_buffer"}
    assert simulate_pattern("serve", 3, double_buffer=kw.get(
        "double_buffer", False), **sim) == ref_simulate(
        "serve", 3, double_buffer=kw.get("double_buffer", False), **sim)


# ---------------------------------------------------------------------------
# the router against a numpy oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("config", ["default", "db_nstreams2"])
@pytest.mark.parametrize("mode", MODES)
def test_router_with_moe_at_four_ranks_equals_numpy(mode, config):
    spec = ScheduleConfig(**{k: v for k, v in SCHEDULES[config].items()})
    r = STDecodeRouter(kv_dim=6, d_model=5, moe=True, slot_cap=4,
                       mode=mode, config=spec, ndev=4, device="cpu")
    rng = np.random.RandomState(0)
    for A in (4, 3, 1, 3):                   # buckets 4, 4, 1, 4
        kv = rng.randn(A, 6).astype(np.float32)
        ids = rng.randint(0, 1 << 20, A).astype(np.int32)
        hid = rng.randn(A, 5).astype(np.float32)
        tok, mirror, hmir = r.dispatch(kv, ids, hid=hid)
        np.testing.assert_array_equal(tok, ids)
        np.testing.assert_array_equal(mirror, kv)
        want = hid.copy()
        for _ in range(3):                   # h = hid; h = h + recvh_k
            want = want + hid
        np.testing.assert_array_equal(hmir, want)
        e = r._entries[4 if A > 1 else 1]
        q = e.win.qual
        # every rank committed the staged rows; the rows past A are zero
        for name, x in (("mirror", kv), ("outtok", ids), ("hmir", want)):
            full = e.state[q(name)].numpy()
            assert full.shape[0] == 4
            np.testing.assert_array_equal(full[:, :A], np.broadcast_to(
                x, (4,) + x.shape))
            assert not full[:, A:].any()
        # one epoch's counts: a post signal from every peer; a completion
        # per put in the slot of its arrival direction, the opposite of
        # its shift k (slot 3 - k): kv, ids and the first hidden block
        # ride shift 1
        want_sig = {e.win.post_sig: counters_expected(1, 3),
                    e.win.comp_sig: np.asarray([1, 1, 3], np.int32)}
        for cname in e.win.counter_names():
            got = e.state[cname].numpy()
            if cname not in want_sig:        # the unused pong set
                assert not got.any()
                continue
            np.testing.assert_array_equal(
                got, np.broadcast_to(want_sig[cname], (4, 3)))
    st = r.stats()
    assert st["moe"] and st["ndev"] == 4 and st["mode"] == mode
    assert {b: m["dispatches"] for b, m in st["buckets"].items()} == \
        {1: 1, 4: 3}
    assert st["buckets"][4]["puts"] == 2 + 3
    if mode == "fused":
        assert st["buckets"][4]["fused"]
    with pytest.raises(ValueError, match="hid payload"):
        r.dispatch(kv, ids)


def test_router_commits_staged_payloads_bit_exact():
    r = STDecodeRouter(kv_dim=6, slot_cap=4, mode="st",
                       config=ScheduleConfig(), device="cpu")
    kv = np.arange(18, dtype=np.float32).reshape(3, 6) * 0.5
    ids = np.asarray([7, 9, 11], np.int32)
    tok, mirror, hmir = r.dispatch(kv, ids)
    np.testing.assert_array_equal(tok, ids)
    np.testing.assert_array_equal(mirror, kv)
    assert hmir is None
    assert r.stats()["buckets"][4]["dispatches"] == 1
    # device tensors in, payload dtype converted on staging (bf16 rows)
    tok, mirror, _ = r.dispatch(torch.from_numpy(kv).bfloat16(),
                                torch.from_numpy(ids))
    np.testing.assert_array_equal(mirror, kv)
    with pytest.raises(ValueError, match="st_mode"):
        STDecodeRouter(kv_dim=6, mode="nope", device="cpu")


# ---------------------------------------------------------------------------
# the engine on the tiny granite, against its baseline and the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    """(port cfg, port params, jax cfg, jax params): the same weights."""
    jcfg = dataclasses.replace(jax_config("granite-3-2b").reduced(), **TINY)
    tcfg = dataclasses.replace(get_config("granite-3-2b").reduced(), **TINY)
    params = ref_params(j_specs(jcfg), 0)
    return (tcfg, from_reference(tcfg, params, "cpu"), jcfg,
            jax.tree.map(jax.numpy.asarray, params))


def _specs():
    rng = np.random.RandomState(3)
    return [(rng.randint(1, 256, L).astype(np.int32), m)
            for L, m in ((2, 3), (3, 3), (4, 3), (3, 4), (6, 2))]


def _payloads(router):
    """Record every dispatch's payload rows and ids on the host."""
    seen, inner = [], router.dispatch

    def dispatch(kv, ids, hid=None):
        seen.append((np.asarray(torch.as_tensor(kv)),
                     np.asarray(torch.as_tensor(ids))))
        return inner(kv, ids, hid=hid)
    router.dispatch = dispatch
    return seen


def _serve(tiny, slots=2, **kw):
    cfg, params = tiny[:2]
    eng = ServingEngine(cfg, params, batch_slots=slots, max_len=32,
                        device="cpu", **kw)
    seen = _payloads(eng._router) if eng._router is not None else None
    reqs = [Request(prompt=p, max_new_tokens=m) for p, m in _specs()]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    return eng, [r.out_tokens for r in reqs], seen


@pytest.fixture(scope="module")
def reference_st(tiny):
    """The reference's ST engine: tokens, payloads, bucket meta."""
    _, _, jcfg, jparams = tiny
    eng = JServingEngine(jcfg, jparams, make_rules(jcfg, None, None),
                         batch_slots=2, max_len=32, st_mode="st",
                         st_config=RefScheduleConfig())
    seen = _payloads(eng._router)
    reqs = [JRequest(prompt=p, max_new_tokens=m) for p, m in _specs()]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    return [r.out_tokens for r in reqs], seen, eng.stats()


@pytest.fixture(scope="module")
def baseline(tiny):
    return _serve(tiny)[1]


@pytest.mark.parametrize("config", ["default", "auto"])
@pytest.mark.parametrize("mode", MODES)
def test_st_decode_tokens_equal_baseline_and_reference(
        tiny, baseline, reference_st, mode, config, tmp_path):
    ref_tokens, ref_seen, ref_stats = reference_st
    conf = ScheduleConfig() if config == "default" else "auto"
    eng, got, seen = _serve(tiny, st_mode=mode, st_config=conf,
                            tuned_path=str(tmp_path / "tuned.json"))
    assert got == baseline == ref_tokens
    st = eng.stats()["st"]
    assert st["pattern"] == "serve" and st["mode"] == mode
    assert st["ndev"] == 1 and not st["moe"]
    for meta in st["buckets"].values():
        assert meta["puts"] >= 1 and meta["descriptors"] > 0
        assert meta["pattern"] == "serve"
        if mode == "fused":
            assert meta["fused"] and meta["segments"] >= 1
    if mode == "st" and config == "default":
        assert st == ref_stats["st"]
    # the payload each step extracted: the cache rows the decode wrote,
    # bit for bit the reference's
    assert len(seen) == len(ref_seen) == eng.decode_steps
    for (kv, ids), (rkv, rids) in zip(seen, ref_seen):
        np.testing.assert_array_equal(ids, rids)
        np.testing.assert_array_equal(kv, rkv)
    assert eng.stats()["st_dispatch_seconds"] > 0


def test_st_schedule_cache_buckets(tiny):
    eng, _, _ = _serve(tiny, slots=3, st_mode="st",
                       st_config=ScheduleConfig())
    st = eng.stats()["st"]
    # ragged active counts reuse power-of-two buckets, capped at slots
    assert set(st["buckets"]) <= {1, 2, 3} and len(st["buckets"]) > 1
    assert sum(m["dispatches"] for m in st["buckets"].values()) \
        == eng.decode_steps


def test_st_auto_config_populates_tuned_cache(tiny, tmp_path):
    tuned = str(tmp_path / "tuned.json")
    cfg, params = tiny[:2]
    eng = ServingEngine(cfg, params, batch_slots=2, max_len=32,
                        st_mode="st", st_config="auto", tuned_path=tuned,
                        st_ranks=4, device="cpu")
    eng.submit(Request(prompt=np.asarray([3, 1], np.int32),
                       max_new_tokens=2))
    eng.run_until_drained()
    cache = load_tuned(tuned)
    assert "serve|4|rpn0|b1" in cache
    label = eng.stats()["st"]["buckets"][1]["config"]
    assert ScheduleConfig.from_dict(
        cache["serve|4|rpn0|b1"]["config"]).label() == label


def test_traffic_driver_smoke(tiny):
    cfg, params = tiny[:2]
    tcfg = TrafficConfig(requests=8, rate=500.0, replicas=2,
                         batch_slots=2, max_len=32, prompt_len=(1, 4),
                         max_new=(1, 3), seed=7, device="cpu")
    engines = [ServingEngine(cfg, params, batch_slots=2, max_len=32,
                             device="cpu") for _ in range(tcfg.replicas)]
    s = run_traffic(tcfg, engines=engines)
    assert s["queue_drained"] and s["completed"] == 8
    assert np.isfinite(s["latency_p99_ms"]) and s["latency_p99_ms"] > 0
    assert np.isfinite(s["ttft_p99_ms"])
    assert s["tokens"] == sum(len(r.out_tokens)
                              for e in engines for r in e.completed)
    assert len(s["per_replica"]) == 2


def test_traffic_driver_st_meta(tiny):
    cfg, params = tiny[:2]
    tcfg = TrafficConfig(requests=3, rate=500.0, replicas=1,
                         batch_slots=2, max_len=32, prompt_len=(1, 3),
                         max_new=(1, 2), seed=3, st_mode="st", st_ranks=4,
                         device="cpu")
    engines = [ServingEngine(cfg, params, batch_slots=2, max_len=32,
                             st_mode="st", st_config=ScheduleConfig(),
                             st_ranks=4, device="cpu")]
    s = run_traffic(tcfg, engines=engines)
    assert s["queue_drained"]
    assert s["per_replica"][0]["st"]["buckets"]
    assert s["config"]["st_ranks"] == 4


# ---------------------------------------------------------------------------
# jamba (MoE dispatch on four ranks) and rwkv (no KV rows)
# ---------------------------------------------------------------------------

def _reduced(arch):
    cfg = get_config(arch).reduced()
    params = init_params(model_specs(cfg), torch.Generator().manual_seed(0),
                         "cpu", getattr(torch, cfg.compute_dtype))
    return cfg, params


@pytest.mark.parametrize("mode", ["st", "fused"])
def test_jamba_at_four_ranks_serves_its_baseline_tokens(mode):
    cfg, params = _reduced("jamba-1.5-large-398b")
    out = {}
    for st_mode in (None, mode):
        eng = ServingEngine(cfg, params, batch_slots=3, max_len=32,
                            st_mode=st_mode, st_config=ScheduleConfig(),
                            st_ranks=4, device="cpu")
        rng = np.random.RandomState(1)
        reqs = [Request(prompt=rng.randint(1, cfg.vocab_size, L)
                        .astype(np.int32), max_new_tokens=m)
                for L, m in ((3, 4), (5, 3), (3, 2), (4, 3))]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        out[st_mode] = [r.out_tokens for r in reqs]
    assert out[mode] == out[None]
    st = eng.stats()["st"]
    assert st["moe"] and st["ndev"] == 4
    # KV + ids on the +1 shift, the hidden block on shifts 1, 2 and 3
    assert all(m["puts"] == 5 for m in st["buckets"].values())
    # the first layer with KV rows: jamba's attention layer, its k
    assert eng._kv_leaf == (0, "k", cfg.num_kv_heads * cfg.head_dim)


def test_rwkv_refuses_st_mode():
    cfg, params = _reduced("rwkv6-1.6b")
    with pytest.raises(ValueError, match="KV-cache leaf"):
        ServingEngine(cfg, params, st_mode="st", device="cpu")
