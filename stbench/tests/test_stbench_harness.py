"""The harness end to end at tiny sizes on the CPU, and its refusals:
no card, no program beside it. Card tests carry the ``cuda`` marker and
skip here."""
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

import stbench_tiny as tiny
from stbench import harness


def test_faces_cell_runs_and_is_correct():
    result, checks = tiny.run_tiny("faces-64r-n64", tiny.faces_overrides())
    assert result["correct"] is True
    assert checks == {"mismatches": [0, 0]}
    assert set(result["metrics"]) == {"setup_s", "faces_iter_ms"}
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"


def test_serve_cell_runs_and_is_correct():
    result, checks = tiny.run_tiny("granite-3-2b-decode",
                                   tiny.serve_overrides())
    assert result["correct"] is True, checks
    assert set(result["metrics"]) == {"setup_s", "tokens_per_s",
                                      "itl_p95_ms"}
    value, limit = checks["max_logit_gap"]
    assert 0 <= value <= limit
    assert list(result)[-1] == "checks"


def test_prefill_cell_reports_ttft():
    over = tiny.serve_overrides()
    over["mix"].update(prompt_tokens={"uniform": [20, 40]},
                       output_tokens={"uniform": [2, 4]})
    result, _ = tiny.run_tiny("granite-3-2b-prefill", over)
    assert result["correct"] is True
    assert set(result["metrics"]) == {"setup_s", "tokens_per_s",
                                      "ttft_p95_ms"}


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH="")
    return subprocess.run([sys.executable, "stbench/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_no_card_exits_without_a_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = _run(["--workload", "faces-64r-n64", "--seed", "1",
              "--seconds", "1", "--trace", "0"], tiny.ROOT)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_without_the_program_it_exits_without_a_result(tmp_path):
    shutil.copy(os.path.join(tiny.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(tiny.ROOT, "stbench"), tmp_path / "stbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(["--workload", "granite-3-2b-decode", "--seed", "1",
              "--seconds", "1", "--trace", "0"], tmp_path)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_every_named_file_is_there():
    bench = harness.load_benchmark()
    stb = os.path.join(tiny.ROOT, "stbench")
    for w in bench["workloads"]:
        cell, config, mix, limits = harness.cell_files(bench, w["name"])
        assert os.path.isfile(os.path.join(stb, "drivers",
                                           config["driver"] + ".py"))
        assert limits
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.isfile(os.path.join(stb, "metrics",
                                           m["name"] + ".py")), m["name"]


def test_metrics_not_read_return_none():
    # a reader that finds nothing to read leaves its metric out
    for m in harness.load_benchmark()["per_layer"]:
        if m["source"] == "device_trace":
            assert harness.read_metric(m["name"], {"trace": None}) is None


@pytest.mark.cuda
def test_cells_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import time
    bench = harness.load_benchmark()
    for w, over in (("faces-64r-n64", tiny.faces_overrides()),
                    ("granite-3-2b-decode", tiny.serve_overrides())):
        result, _ = harness.run_cell(bench, w, seed=7, seconds=2.0,
                                     trace=True,
                                     device=torch.device("cuda", 0),
                                     t_start=time.perf_counter(),
                                     overrides=over)
        assert result["correct"], json.dumps(result)
        assert result["device"]["busy_s"] > 0
