"""The traffic generator: a fixed function of the seed."""
import itertools

import numpy as np

import stbench_tiny  # noqa: F401
from stbench import traffic

MIX = traffic.load_mix("reasoning-decode")


def _take(seed, client, n, mix=MIX):
    return list(itertools.islice(
        traffic.client_requests(mix, seed, client, 49155), n))


def test_same_seed_same_requests():
    a, b = _take(2**31 + 12345, 3, 20), _take(2**31 + 12345, 3, 20)
    assert all(np.array_equal(p, q) and m == n
               for (p, m), (q, n) in zip(a, b))


def test_other_seed_or_client_other_requests():
    a = _take(1, 0, 5)
    assert any(not np.array_equal(p, q) for (p, _), (q, _) in
               zip(a, _take(2, 0, 5)))
    assert any(not np.array_equal(p, q) for (p, _), (q, _) in
               zip(a, _take(1, 1, 5)))


def _sizes(seed, n):
    return sorted(tuple((len(p), m) for p, m in _take(seed, c, n))
                  for c in range(MIX["clients"]))


def test_every_seed_serves_the_same_sizes():
    # the same length sequences, dealt to the clients in another order
    assert _sizes(1, 6) == _sizes(2**31 + 99, 6)
    dealt = [[(len(p), m) for p, m in _take(s, 0, 3)] for s in (1, 5)]
    assert dealt[0] != dealt[1]


def test_a_client_takes_the_pool_in_turn():
    pool = MIX["pool"]
    reqs = _take(7, 0, 1 + pool)[1:]
    assert sorted(m for _, m in reqs) == \
        sorted(traffic.stratified(MIX["output_tokens"], pool))
    assert sorted(len(p) for p, _ in reqs) == \
        sorted(traffic.stratified(MIX["prompt_tokens"], pool))


def test_first_request_is_a_residual_within_range():
    lo, hi = MIX["output_tokens"]["uniform"]
    plo, phi = MIX["prompt_tokens"]["uniform"]
    for c in range(32):
        (p, m), = _take(5, c, 1)
        assert 1 <= m <= hi and plo <= len(p) <= phi + hi - 1
        assert len(p) + m <= phi + hi


def test_warmup_steps_through_every_slot_count():
    reqs = list(traffic.warmup_requests(MIX, 3, 32, 49155))
    assert sorted(m for _, m in reqs) == list(range(2, 34))
    assert max(len(p) for p, _ in reqs) == 512 + 2047


def test_check_sample_has_the_longest():
    pick = traffic.check_sample([5, 90, 7, 12, 3], 3, 8)
    assert pick[0] == 1 and len(set(pick)) == 3
    assert traffic.check_sample([5, 90, 7, 12, 3], 3, 8) == pick
