"""The controls (the reference one precision below the configuration's,
in the program's place) come out not correct; kept here at a size a
test run holds. On the card they run at each cell's own size through
``stbench/control.py``."""
import numpy as np
import pytest
import torch

import stbench_tiny as tiny
from stbench import control, harness
from stbench.reference.faces import FacesReplay, mismatches


def test_faces_bf16_control_mismatches():
    program, ctl = control.readings(harness.load_benchmark(),
                                    "faces-64r-n64", 11, 0.5,
                                    torch.device("cpu"),
                                    tiny.faces_overrides())
    assert program["mismatches"] == 0
    assert ctl > 0


def _served(seed):
    """The tiny decoder served through the engine (8 requests of 24
    tokens, drained), the reference's weights and the requests."""
    from repro_torch.models import model_specs
    from repro_torch.serving.engine import Request, ServingEngine
    from stbench.drivers import serve
    over = tiny.serve_overrides()
    m, S = over["config"]["model"], over["config"]["serving"]
    cfg = serve.port_config(over["config"]["arch"], m)
    params = serve.make_weights(model_specs(cfg), seed, torch.device("cpu"))
    eng = ServingEngine(cfg, params, batch_slots=S["slots"],
                        max_len=S["max_len"], st_mode=S["st_mode"],
                        st_config=S["st_config"], st_ranks=S["st_ranks"],
                        device="cpu")
    rng = np.random.default_rng(seed)
    reqs = [Request(prompt=rng.integers(0, m["vocab_size"], 12,
                                        dtype=np.int32), max_new_tokens=24)
            for _ in range(8)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    return serve.reference_weights(params, m), m, reqs


@pytest.mark.parametrize("seed", [1, 5, 9])
def test_serve_fp8_control_is_over_the_limit(seed):
    from stbench.reference import granite as ref
    w, m, reqs = _served(seed)
    program = max(ref.served_gaps(w, m, r.prompt, r.out_tokens).max()
                  for r in reqs)
    ctl = max(ref.control_gaps(w, m, r.prompt, r.out_tokens).max()
              for r in reqs)
    assert program <= tiny.TINY_GAP_LIMIT < ctl


def test_faces_replay_matches_a_plain_loop():
    # the replay's lookup table against the increment done cell by cell
    rng = np.random.default_rng(0)
    src0 = rng.integers(0, 50, (8, 3, 3, 3)).astype(np.float32)
    rep = FacesReplay.from_blocks(src0, (2, 2, 2))
    got = rep.state(7)
    src = src0.copy()
    for it in range(7):
        src = (src + np.float32(1)) + np.float32(it % 3)
    assert np.array_equal(got["faces.src"], src)
    assert got["faces.it"].max() == 7 and got["faces.comp_sig"].min() == 7
    assert mismatches(got, got) == 0
    worse = dict(got, **{"faces.acc": got["faces.acc"] + 1})
    assert mismatches(worse, got) == got["faces.acc"].size
