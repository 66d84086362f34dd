"""The port's data pipeline (bit for bit the JAX package's batches) and
its fault-tolerance runtime (the reference's detector and training loop
tests, over the port's checkpointer)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import SyntheticTokens as JSyntheticTokens
from repro_torch.data import SyntheticTokens, make_batch_iterator
from repro_torch.runtime import (HeartbeatMonitor, StragglerDetector,
                                 TrainingRuntime)


@pytest.mark.parametrize("kw", [
    dict(vocab_size=512, seq_len=64, global_batch=8, seed=3),
    dict(vocab_size=49155, seq_len=128, global_batch=4, seed=0),
    dict(vocab_size=64, seq_len=4, global_batch=2, seed=1),
    dict(vocab_size=512, seq_len=32, global_batch=8, seed=1, num_hosts=2,
         host_id=1)])
def test_batches_bit_for_bit_the_reference(kw):
    a, b = SyntheticTokens(**kw), JSyntheticTokens(**kw)
    np.testing.assert_array_equal(a.motifs, b.motifs)
    for step in (0, 1, 5, 1000):
        x, y = a.batch_at(step), b.batch_at(step)
        assert set(x) == set(y) == {"tokens", "targets", "positions"}
        for k in x:
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k])


def test_data_deterministic_and_shifted():
    ds = SyntheticTokens(vocab_size=512, seq_len=64, global_batch=8, seed=3)
    b1, b2 = ds.batch_at(5), ds.batch_at(5)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(b1["tokens"], ds.batch_at(6)["tokens"])
    assert b1["tokens"].shape == b1["targets"].shape == (8, 64)
    np.testing.assert_array_equal(b1["tokens"][:, 1:],
                                  b1["targets"][:, :-1])
    assert (b1["positions"][0] == np.arange(64)).all()


def test_data_host_sharding_disjoint():
    kw = dict(vocab_size=512, seq_len=32, global_batch=8, seed=1,
              num_hosts=2)
    h0 = SyntheticTokens(host_id=0, **kw).batch_at(0)
    h1 = SyntheticTokens(host_id=1, **kw).batch_at(0)
    assert h0["tokens"].shape == (4, 32)
    assert not np.array_equal(h0["tokens"], h1["tokens"])


def test_prefetch_iterator_resumes():
    ds = SyntheticTokens(vocab_size=128, seq_len=16, global_batch=2)
    it = make_batch_iterator(ds, start_step=7, prefetch=2)
    b = next(it)
    it.close()
    np.testing.assert_array_equal(b["tokens"], ds.batch_at(7)["tokens"])


def test_straggler_detector_flags_slow_host():
    det = StragglerDetector(patience=2)
    flagged = []
    for _ in range(6):
        flagged = det.observe({0: 1.0, 1: 1.0, 2: 1.0, 3: 5.0})
    assert flagged == [3]


def test_straggler_detector_ignores_transient():
    det = StragglerDetector(patience=3)
    det.observe({0: 1.0, 1: 1.0, 2: 10.0})
    assert det.observe({0: 1.0, 1: 1.0, 2: 1.0}) == []


def test_heartbeat_timeout():
    hb = HeartbeatMonitor(timeout_s=10)
    hb.beat(0, now=100.0)
    hb.beat(1, now=105.0)
    assert hb.dead_hosts(now=112.0) == [0]


def test_runtime_checkpoints_and_resumes(tmp_path):
    def step_fn(state, batch):
        return ({"x": state["x"] + 1, "t": state["t"] + 1},
                {"loss": float(state["x"])})

    ds = SyntheticTokens(vocab_size=64, seq_len=8, global_batch=2)
    rt = TrainingRuntime(str(tmp_path), ckpt_every=5)
    it = make_batch_iterator(ds)
    state = {"x": np.zeros(()), "t": torch.zeros(3)}
    state, step, preempted = rt.run(state, it, step_fn, total_steps=12,
                                    log_fn=lambda *a: None)
    it.close()
    assert not preempted and step == 12
    rt2 = TrainingRuntime(str(tmp_path))
    restored, next_step, extra = rt2.maybe_restore(
        {"x": np.zeros(()), "t": torch.zeros(3)})
    assert next_step == 12 and extra == {"reason": "final"}
    assert float(restored["x"]) == 12.0
    assert torch.equal(restored["t"], torch.full((3,), 12.0))


def test_runtime_saves_and_exits_when_preempted(tmp_path):
    rt = TrainingRuntime(str(tmp_path), ckpt_every=0)

    def step_fn(state, batch):
        if state["x"] == 3:
            rt._handle(None, None)          # SIGTERM arrives
        return {"x": state["x"] + 1}, {}

    ds = SyntheticTokens(vocab_size=64, seq_len=8, global_batch=2)
    it = make_batch_iterator(ds)
    _, step, preempted = rt.run({"x": np.zeros(())}, it, step_fn,
                                total_steps=10, log_fn=lambda *a: None)
    it.close()
    assert preempted and step == 3
    restored, next_step, extra = TrainingRuntime(
        str(tmp_path)).maybe_restore({"x": np.zeros(())})
    assert next_step == 4 and float(restored["x"]) == 4.0
    assert extra == {"reason": "preempt"}


def test_runtime_remesh_callback(tmp_path):
    calls = []
    ds = SyntheticTokens(vocab_size=64, seq_len=8, global_batch=2)
    rt = TrainingRuntime(str(tmp_path), ckpt_every=0,
                         on_remesh=lambda hosts: calls.append(hosts))
    it = make_batch_iterator(ds)
    rt.run({"x": np.zeros(())}, it, lambda s, b: (s, {}), total_steps=8,
           host_times_fn=lambda step, dt: {0: 1.0, 1: 1.0, 2: 8.0},
           log_fn=lambda *a: None)
    it.close()
    assert calls and calls[0] == [2]
