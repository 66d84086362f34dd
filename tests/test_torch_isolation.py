"""The port stands alone: no JAX, nothing of the JAX package, no silent
CPU fallback.

  * importing every ``repro_torch`` module (and ``chip_smoke.py``) in a
    fresh interpreter loads no ``jax*`` and no ``repro``/``repro.*``
    module, and no source file of the port imports one;
  * an entry point asked for CUDA on a machine without a card raises
    instead of running on the CPU; ``device=None`` is device-free;
  * ``chip_smoke.py`` exits non-zero, printing no result, without a card
    and when it stands alone in a directory.
"""
import ast
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import STStream, halo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")
SMOKE = os.path.join(ROOT, "chip_smoke.py")


def _forbidden(name):
    return (name == "jax" or name.startswith("jax.")
            or name.startswith("jaxlib") or name == "repro"
            or name.startswith("repro."))


def test_importing_the_port_loads_no_jax_and_no_reference():
    script = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        bad = sorted(m for m in sys.modules
                     if m in ("jax", "jaxlib", "repro")
                     or m.startswith(("jax.", "jaxlib.", "repro.")))
        print(len(names), bad)
    """)
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"),
                                           ROOT]))
    r = subprocess.run([sys.executable, "-c", script], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    count, bad = r.stdout.split(" ", 1)
    assert int(count) >= 15
    assert bad.strip() == "[]"


def _sources():
    for dirpath, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield SMOKE


def test_no_source_of_the_port_imports_jax_or_the_reference():
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert not _forbidden(name), (path, name)


def test_cuda_entry_point_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        STStream(grid_shape=(2, 2, 2))             # defaults to CUDA
    with pytest.raises(RuntimeError, match="device='cpu'"):
        STStream("cuda:0", ("x", "y", "z"), grid_shape=(2, 2, 2))


def test_device_free_stream_schedules_but_does_not_execute():
    stream = STStream(None, ("x", "y", "z"), grid_shape=(2, 2, 2))
    halo.build_faces_program(stream, (4, 4, 4), 1)
    assert stream.scheduled_programs()[0].puts()
    with pytest.raises(ValueError, match="device-free"):
        stream.allocate()
    with pytest.raises(ValueError, match="device-free"):
        stream.synchronize({})


def test_cpu_stream_allocates_on_cpu_and_checks_state_keys():
    stream = STStream("cpu", ("x", "y", "z"), grid_shape=(2, 2, 2))
    halo.build_faces_program(stream, (4, 4, 4), 1)
    state = stream.allocate()
    assert all(v.device.type == "cpu" for v in state.values())
    with pytest.raises(ValueError, match="keys differ"):
        stream.synchronize({})


def _run_smoke(cwd):
    # no card: hidden, so the check means the same on a machine with one
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card_or_the_program(where, tmp_path):
    if where == "alone":
        shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
        cwd = str(tmp_path)
    else:
        cwd = ROOT
    r = _run_smoke(cwd)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and '"kernels"' not in r.stdout
