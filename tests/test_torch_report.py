"""The port's report tables (``launch/report.py``): the descriptor-stats
cases the JAX package's ``tests/test_topology.py`` holds its report to
(an unbounded policy's resources as a dash, records written before a
column existed), and the serving table on a record the port's own
traffic driver writes (``launch/traffic.py --out``)."""
import json
import sys

import pytest

pytest.importorskip("torch")

from repro_torch.launch import report, traffic
from repro_torch.launch.report import serve_table, st_stats_table


def test_report_renders_unbounded_resources_as_dash():
    rec = {"name": "x", "pattern": "faces", "mode": "host",
           "throttle": "none", "resources": None, "us_per_iter": 1.0,
           "derived_us_per_iter": 2.0,
           "stats": {"puts_per_epoch": 26.0, "resource_high_water": 3,
                     "critical_path_depth": 4, "dep_edges": 0}}
    table = st_stats_table([rec])
    row = table.splitlines()[-1]
    assert "| — |" in row and "KeyError" not in table


def test_report_renders_pre_overlap_records_with_defaults():
    """A record written before the nstreams/double_buffer/topology
    columns existed must render, not raise."""
    old = {"name": "fig12_stRMA_8r", "pattern": "faces", "mode": "st",
           "throttle": "adaptive", "us_per_iter": 10.0,
           "derived_us_per_iter": 20.0,
           "stats": {"puts_per_epoch": 26.0, "resource_high_water": 16,
                     "critical_path_depth": 7, "dep_edges": 12}}
    table = st_stats_table([old])
    row = table.splitlines()[-1]
    assert "fig12_stRMA_8r" in row
    assert "| 1 |" in row                  # nstreams default
    bare = {"name": "minimal", "stats": {}}
    assert "minimal" in st_stats_table([old, bare])


def test_serve_table_reads_the_ports_traffic_record(tmp_path, capsys,
                                                   monkeypatch):
    """A Poisson run of the reduced granite on the CPU, written by the
    driver's --out, renders as one row with its own numbers; the CLI's
    serve table reads the same directory."""
    out = tmp_path / "serve" / "traffic_torch.json"
    traffic.main(["--device", "cpu", "--requests", "6", "--rate", "200",
                  "--max-new", "2", "4", "--out", str(out)])
    rec = json.loads(out.read_text())
    rows = serve_table([rec]).splitlines()
    assert len(rows) == 3
    cells = [c.strip() for c in rows[-1].strip("|").split("|")]
    assert cells[:5] == ["6", "200", "1", "baseline",
                         "y" if rec["queue_drained"] else "n"]
    assert cells[5] == format(rec["latency_p50_ms"], ".0f")
    assert cells[-1] == format(rec["tokens_per_s"], ".1f")
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", ["report", "--what", "serve", "--dir",
                                      str(out.parent)])
    report.main()
    assert rows[-1] in capsys.readouterr().out
