"""What the benchmark loads: nothing whose top-level name is JAX's or
the JAX package's (``repro``), compared whole; and its references load
nothing of the program."""
import os
import subprocess
import sys

import stbench_tiny as tiny

RUN = """
import sys
sys.path[:0] = [{root!r}, {tests!r}]
import stbench_tiny as tiny
tiny.run_tiny("faces-64r-n64", tiny.faces_overrides())
tiny.run_tiny("granite-3-2b-decode", tiny.serve_overrides())
from stbench import harness
print(sorted({{m.split(".")[0] for m in sys.modules}}))
print(harness.forbidden_modules())
"""

REFS = """
import sys
sys.path[:0] = [{root!r}]
import stbench.reference.faces, stbench.reference.granite
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def _py(code):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    return [eval(line) for line in p.stdout.strip().splitlines()[-2:]]


def test_runs_load_neither_jax_nor_the_jax_package():
    tests = os.path.dirname(os.path.abspath(__file__))
    loaded, forbidden = _py(RUN.format(root=tiny.ROOT, tests=tests))
    assert forbidden == []
    assert not {"jax", "jaxlib", "flax", "repro"} & set(loaded)
    assert "repro_torch" in loaded


def test_references_load_nothing_of_the_program():
    *_, loaded = _py(REFS.format(root=tiny.ROOT))
    assert not {"repro_torch", "repro", "jax"} & set(loaded)
