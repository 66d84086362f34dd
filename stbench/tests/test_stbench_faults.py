"""Each fault a cell can have, planted under the timed path, makes the
run's ``correct`` false: a step that returns its state unchanged, the
exchange between ranks left out, an answer altered where it is made."""
import pytest
import torch

import stbench_tiny as tiny


def _drop_payload(monkeypatch):
    from repro_torch.core import engine
    real = engine.put_signal

    def no_exchange(x, perm, sig=None, upd=None):
        out = real(x, perm, sig, upd)
        if sig is None:
            return torch.zeros_like(out)
        return torch.zeros_like(out[0]), out[1]
    monkeypatch.setattr(engine, "put_signal", no_exchange)


def _unchanged_faces(monkeypatch):
    from repro_torch.core.stream import STStream
    monkeypatch.setattr(STStream, "synchronize",
                        lambda self, state, **kw: state)


def _altered_acc(monkeypatch):
    from repro_torch.kernels.halo_pack import ops
    real = ops.halo_unpack_split

    def altered(recvs, n, with_max=False):
        acc, *rest = real(recvs, n, with_max=True)
        acc = acc.clone()
        acc.view(-1)[-1] += 1
        return (acc, *rest) if with_max else acc
    monkeypatch.setattr(ops, "halo_unpack_split", altered)


@pytest.mark.parametrize("fault", [_unchanged_faces, _drop_payload,
                                   _altered_acc])
def test_faces_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    result, checks = tiny.run_tiny("faces-64r-n64", tiny.faces_overrides())
    assert result["correct"] is False
    assert checks["mismatches"][0] > 0


def _stale_cache(monkeypatch):
    # the decode step leaves the cache as it was (prefill still writes)
    from repro_torch.models import attention
    real = attention._update_cache

    def keep(cache_k, k_new, index):
        return cache_k if k_new.shape[1] == 1 else real(cache_k, k_new,
                                                        index)
    monkeypatch.setattr(attention, "_update_cache", keep)


def _altered_token(monkeypatch):
    from repro_torch.train import steps
    real = steps._greedy_ids
    monkeypatch.setattr(steps, "_greedy_ids",
                        lambda cfg, logits: (real(cfg, logits) + 1)
                        % cfg.vocab_size)


@pytest.mark.parametrize("fault", [_stale_cache, _drop_payload,
                                   _altered_token])
def test_serve_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    result, checks = tiny.run_tiny("granite-3-2b-decode",
                                   tiny.serve_overrides())
    assert result["correct"] is False
    value, limit = checks["max_logit_gap"]
    assert value > limit
