"""The port's schedule tuner (``repro_torch.core.autotune``) against the
JAX package's.

Both are pure Python over the same IR, schedule passes and simulator, so
the match is exact: the search spaces (as dicts), and each ``autotune``
leaderboard — labels, order, and the derived cost of every candidate —
for Faces at (2, 2, 2), the serving decode epoch at (4,) for 1, 2 and 8
slots with and without MoE dispatch, one two-node (ranks_per_node=2)
serve search at a small payload, and ring (4,), broadcast (2, 4) (its
multicast and unicast candidates) and a2a (4,), each on one node and on
two. Then the analogues of
``tests/test_autotune.py``: tuned <= default, a cache hit skips the
search, the size-token key, ``resolve_config``'s forms, a config threaded
through ``pattern_programs`` and ``simulate_pattern``, and a raw stream
refusing ``"auto"``; the cache's own path.
"""
import os
import sys

import pytest

pytest.importorskip("torch")

from repro.core.autotune import autotune as ref_autotune
from repro.core.autotune import search_space as ref_search_space
from repro_torch.core import (STStream, build_pattern, pattern_programs,
                              simulate_pattern, simulate_pipeline)
from repro_torch.core.autotune import (AutotuneResult, ScheduleConfig,
                                       autotune, resolve_config,
                                       search_space, slot_bucket,
                                       tuned_config, tuned_key, tuned_path)

FACES = dict(n=(4, 4, 4))


def _serve(slots, moe, width=16):
    return dict(slots=slots, kv_dim=width, d_model=width, moe=moe)


# (pattern, grid, ranks_per_node, build kwargs); broadcast's searches
# take the multicast knob both ways (mc and uni)
SEARCHES = {
    "faces": ("faces", (2, 2, 2), None, FACES),
    **{f"serve_b{b}_{'moe' if m else 'ring'}":
       ("serve", (4,), None, _serve(b, m, 64)) for b in (1, 2, 8)
       for m in (True, False)},
    "serve_rpn2": ("serve", (4,), 2, _serve(2, True)),
    **{f"{p}{'_rpn2' if rpn else ''}": (p, grid, rpn, kw)
       for p, grid, kw in (("ring", (4,), {}),
                           ("broadcast", (2, 4), dict(tile=8)),
                           ("a2a", (4,), {}))
       for rpn in (None, 2)},
}


def _board(result):
    return [(c.to_dict(), c.label(), d) for c, d in result.leaderboard]


# ---------------------------------------------------------------------------
# equal to the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pattern,rpn", [
    ("faces", None), ("serve", None), ("serve", 2), ("faces", 4),
    ("ring", None), ("ring", 2), ("broadcast", None), ("broadcast", 2),
    ("a2a", None), ("a2a", 2)])
def test_search_space_equals_the_reference(pattern, rpn):
    mine = [c.to_dict() for c in search_space(pattern, rpn)]
    assert mine == [c.to_dict() for c in ref_search_space(pattern, rpn)]
    mcast = pattern == "broadcast"
    assert len(mine) == (192 if rpn else 24) * (2 if mcast else 1)
    assert any(c["fused"] for c in mine)        # the knob is enumerated
    assert {c["multicast"] for c in mine} == \
        ({True, False} if mcast else {None})


@pytest.mark.parametrize("case", sorted(SEARCHES))
def test_autotune_leaderboard_equals_the_reference(case):
    pattern, grid, rpn, kw = SEARCHES[case]
    mine = autotune(pattern, 2, grid=grid, ranks_per_node=rpn, size="s",
                    **kw)
    ref = ref_autotune(pattern, 2, grid=grid, ranks_per_node=rpn,
                       size="s", **kw)
    assert _board(mine) == _board(ref)
    assert mine.best.label() == ref.best.label()
    assert (mine.best_derived, mine.default_derived, mine.evaluated) == \
        (ref.best_derived, ref.default_derived, ref.evaluated)
    assert not mine.errors and not ref.errors
    assert mine.to_dict() == ref.to_dict()


# ---------------------------------------------------------------------------
# the contract of tests/test_autotune.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["faces", "serve_rpn2"])
def test_autotune_no_worse_than_default(case):
    pattern, grid, rpn, kw = SEARCHES[case]
    r = autotune(pattern, 2, grid=grid, ranks_per_node=rpn, **kw)
    assert isinstance(r, AutotuneResult)
    assert r.best_derived <= r.default_derived
    assert r.evaluated == len(r.leaderboard) > 1
    ders = [d for _, d in r.leaderboard]
    assert ders == sorted(ders)
    assert any(c == r.default_config for c, _ in r.leaderboard)


def test_autotune_errors_are_recorded_not_raised():
    bad = ScheduleConfig(throttle="no_such_policy")
    r = autotune("serve", 2, grid=(4,), candidates=[bad], **_serve(2, True))
    assert len(r.errors) == 1 and r.errors[0][0] == bad
    assert r.best == r.default_config


def test_tuned_cache_hit_skips_search(tmp_path, monkeypatch):
    # tuned_config calls autotune by its plain name, so the spy on the
    # module sees every search
    at = sys.modules["repro_torch.core.autotune"]
    path = str(tmp_path / "tuned.json")
    calls = []
    real = at.autotune

    def spy(*a, **kw):
        calls.append(a)
        return real(*a, **kw)

    monkeypatch.setattr(at, "autotune", spy)
    kw = _serve(8, True)
    c1 = at.tuned_config("serve", grid=(4,), size="b8", path=path, **kw)
    assert len(calls) == 1 and os.path.exists(path)
    c2 = at.tuned_config("serve", grid=(4,), size="b8", path=path, **kw)
    assert len(calls) == 1, "cache hit must skip the search"
    assert c1 == c2
    # a different size token is a different point -> fresh search
    at.tuned_config("serve", grid=(4,), size="b2", path=path,
                    **_serve(2, True))
    assert len(calls) == 2
    assert set(at.load_tuned(path)) == {"serve|4|rpn0|b8",
                                        "serve|4|rpn0|b2"}


def test_tuned_config_missing_without_autotune_raises(tmp_path):
    with pytest.raises(KeyError, match="no tuned config"):
        tuned_config("serve", grid=(4,), size="b8",
                     path=str(tmp_path / "tuned.json"),
                     autotune_missing=False, **_serve(8, True))


def test_tuned_key_is_size_token_based():
    assert tuned_key("faces", (2, 2, 2), 4, "b4") == "faces|2x2x2|rpn4|b4"
    assert tuned_key("serve", (4,), None, None) == "serve|4|rpn0|-"


def test_tuned_cache_has_its_own_path(monkeypatch):
    """Never the JAX package's results/tuned.json or $REPRO_TUNED."""
    monkeypatch.delenv("REPRO_TORCH_TUNED", raising=False)
    monkeypatch.setenv("REPRO_TUNED", "/elsewhere/tuned.json")
    assert tuned_path() == os.path.join("results", "tuned_torch.json")
    monkeypatch.setenv("REPRO_TORCH_TUNED", "/x/t.json")
    assert tuned_path() == "/x/t.json"
    assert tuned_path("/y/t.json") == "/y/t.json"


def test_slot_bucket():
    assert [slot_bucket(a) for a in (1, 2, 3, 4, 5, 8, 9)] \
        == [1, 2, 4, 4, 8, 8, 16]
    assert slot_bucket(3, cap=3) == 3
    assert slot_bucket(9, cap=8) == 8
    with pytest.raises(ValueError):
        slot_bucket(0)


def test_resolve_config_forms(tmp_path):
    cfg = ScheduleConfig(nstreams=2, pack=True)
    assert resolve_config(None, "serve") is None
    assert resolve_config(cfg, "serve") is cfg
    assert resolve_config(cfg.to_dict(), "serve") == cfg
    with pytest.raises(TypeError, match="config must be"):
        resolve_config(42, "serve")
    with pytest.raises(ValueError, match="unknown field"):
        resolve_config({"nope": 1}, "serve")
    auto = resolve_config("auto", "serve", grid=(4,), size="b8",
                          path=str(tmp_path / "t.json"), **_serve(8, True))
    assert isinstance(auto, ScheduleConfig)


def test_config_threads_through_pattern_programs():
    """A config-built program equals the spelled-out-kwargs program and
    stamps the resolved config into meta."""
    cfg = ScheduleConfig(throttle="static", resources=8, nstreams=2,
                         node_aware=True, pack=True)
    via_cfg = pattern_programs("faces", 2, grid=(2, 2, 2),
                               ranks_per_node=4, config=cfg, **FACES)
    assert via_cfg[0].meta["config"] == cfg.to_dict()
    spelled = pattern_programs("faces", 2, grid=(2, 2, 2),
                               ranks_per_node=4, throttle="static",
                               resources=8, nstreams=2, node_aware=True,
                               pack=True, **FACES)
    assert [p.key() for p in via_cfg] == [p.key() for p in spelled]
    assert simulate_pipeline(via_cfg) == simulate_pipeline(spelled)
    # double_buffer is build-time: the config changes the enqueued program
    db = pattern_programs("serve", 2, grid=(4,), config=ScheduleConfig(
        nstreams=2, double_buffer=True), **_serve(2, True))
    assert db[0].key() != pattern_programs(
        "serve", 2, grid=(4,), nstreams=2, **_serve(2, True))[0].key()


def test_config_auto_through_pattern_programs(tmp_path):
    path = str(tmp_path / "tuned.json")
    kw = _serve(8, True)
    progs = pattern_programs("serve", 2, grid=(4,), config="auto",
                             tuned_path=path, size="b8", **kw)
    cached = tuned_config("serve", grid=(4,), size="b8", path=path, **kw)
    assert progs[0].meta["config"] == cached.to_dict()
    tuned = simulate_pattern("serve", 2, grid=(4,), config="auto",
                             tuned_path=path, size="b8", **kw)
    default = simulate_pattern("serve", 2, grid=(4,), **kw)
    assert tuned <= default


def test_stream_refuses_a_string_config_and_takes_a_dict():
    stream = STStream(None, ("data",), grid_shape=(4,))
    build_pattern(stream, "serve", 2, **_serve(2, True))
    with pytest.raises(ValueError, match="tuned_config"):
        stream.scheduled_programs(config="auto")
    cfg = ScheduleConfig(throttle="static", resources=8)
    via_cfg = stream.scheduled_programs(config=cfg.to_dict())
    spelled = stream.scheduled_programs(throttle="static", resources=8,
                                        merged=True)
    assert via_cfg is spelled      # same schedule cache entry
