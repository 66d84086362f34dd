"""Faces' increment wrapper (``kernels/halo_pack`` ``faces_increment``) on
the CPU.

Its CPU route must give the Faces closure's association,
``(src + 1.0) + mod(it, 3.0)`` with each rank's step broadcast over its
block, and ``it + 1.0``, bit for bit, and leave its inputs as they were.
The card's route is checked here for what it hands the kernel (a faked
launch on meta tensors) and what it refuses; the kernel itself is held
to this plain version on the card (``tests/test_torch_cuda.py``).
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build
from repro_torch.kernels.halo_pack import faces_increment
from repro_torch.kernels.halo_pack import ops

# iteration counts: each step 0, 1 and 2, a count past 3, the last float32
# range where + 1 is exact, and the remainder's sign rule (-1 -> 2)
IT_VALUES = (0.0, 1.0, 2.0, 3.0, float(2 ** 24 - 3), -1.0, 2.5)
BLOCKS = [(4, 4, 4), (5, 6, 7), (16, 16, 16)]
DTYPES = {"float32": (torch.float32, np.float32),
          "float64": (torch.float64, np.float64)}


def _inputs(R, n, dtype, first, seed=0):
    tdt, ndt = DTYPES[dtype]
    rng = np.random.RandomState(seed)
    src = rng.standard_normal((R,) + n).astype(ndt) * 1000
    it = np.array([IT_VALUES[(first + r) % len(IT_VALUES)]
                   for r in range(R)], dtype=ndt).reshape(R, 1)
    return torch.from_numpy(src), torch.from_numpy(it), src, it


def _bits(t):
    return t.view(torch.int32 if t.element_size() == 4 else torch.int64)


@pytest.mark.parametrize("first", range(len(IT_VALUES)))
@pytest.mark.parametrize("n", BLOCKS, ids=lambda n: "x".join(map(str, n)))
@pytest.mark.parametrize("R", [1, 8, 64])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cpu_route_equals_the_closures_association(dtype, R, n, first):
    src, it, src_np, it_np = _inputs(R, n, dtype, first)
    kept = (src.clone(), it.clone())
    got, got_it = faces_increment(src, it)
    # the closure the wrapper replaces, and NumPy's own remainder
    step = torch.remainder(it, 3.0).reshape(R, 1, 1, 1)
    ndt = DTYPES[dtype][1]
    want_np = (src_np + ndt(1)) + np.remainder(it_np, ndt(3)).reshape(
        R, 1, 1, 1)
    for want in ((src + 1.0) + step, torch.from_numpy(want_np)):
        assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(got_it), _bits(it + 1.0))
    assert got.dtype == got_it.dtype == DTYPES[dtype][0]
    assert tuple(got.shape) == (R,) + n and tuple(got_it.shape) == (R, 1)
    assert torch.equal(_bits(src), _bits(kept[0]))          # untouched
    assert torch.equal(_bits(it), _bits(kept[1]))


@pytest.mark.parametrize("case", ["it_flat", "it_wide", "it_ranks",
                                  "src_3d", "src_empty", "devices"])
def test_refuses_what_does_not_match(case):
    src = torch.zeros(4, 3, 3, 3)
    it = torch.zeros(4, 1)
    bad = {"it_flat": (src, torch.zeros(4)),
           "it_wide": (src, torch.zeros(4, 2)),
           "it_ranks": (src, torch.zeros(5, 1)),
           "src_3d": (torch.zeros(3, 3, 3), it),
           "src_empty": (torch.zeros(4, 3, 0, 3), it),
           "devices": (src, it.to("meta"))}[case]
    with pytest.raises(ValueError):
        faces_increment(*bad)


class _FakeLaunch:
    """The kernel library as the increment wrapper calls it: records each
    launch's arguments and reports success."""

    def __init__(self):
        self.calls = []

    def faces_increment_launch(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def fake_card(monkeypatch):
    """The card's route on meta tensors: the device check bypassed, the
    launch faked."""
    lib = _FakeLaunch()
    monkeypatch.setattr(ops, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(ops._build, "load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    _build.reset_launches()
    yield lib
    _build.reset_launches()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_card_route_hands_the_kernel_its_shape_and_dtype(fake_card, dtype):
    """One launch a call with the dtype's code, R and the cells of a rank;
    fresh outputs of the inputs' dtype and shapes."""
    src = torch.zeros((3, 5, 6, 7), dtype=dtype, device="meta")
    it = torch.zeros((3, 1), dtype=dtype, device="meta")
    out, it_out = faces_increment(src, it)
    assert out.dtype == it_out.dtype == dtype
    assert tuple(out.shape) == (3, 5, 6, 7) and tuple(it_out.shape) == (3, 1)
    # (src, it, out, it out, dtype code, R, cells, stream)
    call, = fake_card.calls
    assert call[4:7] == (ops.INCREMENT_DTYPES[dtype], 3, 5 * 6 * 7)
    assert _build.LAUNCHES["faces_increment"] == 1
    faces_increment(src[:0], it[:0])                # no rank: no launch
    assert len(fake_card.calls) == 1


@pytest.mark.parametrize("case", ["bfloat16", "int32", "mixed",
                                  "strided_src", "strided_it"])
def test_card_route_refuses_what_the_kernel_does_not_take(fake_card, case):
    f32 = dict(dtype=torch.float32, device="meta")
    src, it = torch.zeros((2, 4, 4, 4), **f32), torch.zeros((2, 1), **f32)
    args, err = {
        "bfloat16": ((src.bfloat16(), it.bfloat16()), TypeError),
        "int32": ((src.int(), it.int()), TypeError),
        "mixed": ((src, it.double()), TypeError),
        "strided_src": ((src.transpose(1, 3), it), ValueError),
        "strided_it": ((src, torch.zeros((2, 2), **f32)[:, :1]),
                       ValueError),
    }[case]
    with pytest.raises(err):
        faces_increment(*args)
    assert not fake_card.calls
