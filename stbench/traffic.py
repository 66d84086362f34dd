"""The general traffic generator: turns a mix file's parameters and a
seed into the inputs of a run. A mix is data (``stbench/traffic/
<name>.json``); a new mix is a new file, read by these functions.

Serving mixes are closed loops: ``clients`` clients, each sending its
next request as soon as the previous one completes. A client's requests
are a fixed function of (seed, client, index), whatever the timing.
Every seed serves the same sizes in the same arrangement, only dealt to
the clients in another order: the lengths are ``clients`` fixed
sequences (drawn once from ``layout_seed``), and the seed permutes which
client takes which, and draws the prompts' token ids (uniform over the
vocabulary). A window holds a client's first few requests only, so
lengths drawn afresh for each seed would change the work from seed to
seed. Each sequence takes its lengths from ``pool`` evenly spaced
quantiles of the mix's distribution, in a shuffled order.

With ``"first_request": "length_biased_residual"`` a client's first
request is the remainder of a request already under way: its length L
is drawn in proportion to L (the length a random instant finds in
service), an already-served part u uniform in [0, L) joins the prompt,
and L - u tokens remain. So slots finish staggered from the first step
and the cache holds steady-state lengths from the start.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Iterator, Tuple

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"


def load_mix(name: str) -> dict:
    return json.loads((TRAFFIC_DIR / f"{name}.json").read_text())


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 63), *stream])


def stratified(dist: dict, count: int) -> np.ndarray:
    """``count`` evenly spaced quantiles of ``dist`` (``{"uniform": [lo,
    hi]}``, integers, both ends included)."""
    lo, hi = dist["uniform"]
    q = (np.arange(count) + 0.5) / count
    return (lo + np.floor(q * (hi - lo + 1))).astype(np.int64)


def client_requests(mix: dict, seed: int, client: int,
                    vocab: int) -> Iterator[Tuple[np.ndarray, int]]:
    """(prompt ids int32, tokens to generate) of one client, in order."""
    dealt = int(_rng(seed, 0).permutation(mix["clients"])[client])
    sizes = _rng(mix.get("layout_seed", 0), 1, dealt)
    rng = _rng(seed, 1, client)
    pool = int(mix.get("pool", 256))
    prompts = stratified(mix["prompt_tokens"], pool)
    outputs = stratified(mix["output_tokens"], pool)

    def ids(length):
        return rng.integers(0, vocab, size=int(length), dtype=np.int32)

    if mix.get("first_request") == "length_biased_residual":
        L = int(sizes.choice(outputs, p=outputs / outputs.sum()))
        done = int(sizes.integers(0, L))
        yield ids(int(sizes.choice(prompts)) + done), L - done
    while True:
        for p, o in zip(sizes.permutation(prompts),
                        sizes.permutation(outputs)):
            yield ids(p), int(o)


def warmup_requests(mix: dict, seed: int, slots: int, vocab: int):
    """Set-up traffic that reaches every shape the window will: ``slots``
    requests at once, their outputs 2 .. slots + 1 tokens long, so the
    active slots step down through every count from ``slots`` to 1, and
    their prompts spread from the shortest the mix sends to the longest
    (a first request's prompt included), one prefill dispatch each."""
    rng = _rng(seed, 2)
    longest = mix["prompt_tokens"]["uniform"][1]
    if mix.get("first_request") == "length_biased_residual":
        longest += mix["output_tokens"]["uniform"][1] - 1
    shortest = mix["prompt_tokens"]["uniform"][0]
    lengths = np.linspace(longest, shortest, slots).round().astype(int)
    for i, length in enumerate(lengths):
        yield rng.integers(0, vocab, size=length, dtype=np.int32), i + 2


def check_sample(finished: list, count: int, seed: int) -> list:
    """Indices of the finished requests the reference checks: the one
    with the most served tokens, and ``count - 1`` more drawn by the
    seed. ``finished``: served-token counts, in completion order."""
    if not finished:
        return []
    longest = int(np.argmax(finished))
    rest = [i for i in range(len(finished)) if i != longest]
    k = min(count - 1, len(rest))
    drawn = _rng(seed, 3).choice(rest, size=k, replace=False) if k else []
    return [longest] + sorted(int(i) for i in drawn)
