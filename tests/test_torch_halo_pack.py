"""The port's halo pack/unpack and counter-bump modules on the CPU.

The plain versions (what the wrappers run for a CPU tensor) must equal
the JAX package's Pallas kernels — run in interpret mode, as
``tests/test_kernels.py`` runs them — bit for bit, per rank of a batch,
and the generic packed/chunked put helpers must equal their jnp
counterparts. The CUDA kernels themselves are held against these plain
versions on the card (``tests/test_torch_cuda.py``).
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                       # degrade to example-based sweeps
    from _hypothesis_fallback import given, settings, strategies as st

import jax.numpy as jnp

from repro.kernels.halo_pack import ref as jref
from repro.kernels.halo_pack.ops import halo_pack as jax_halo_pack
from repro.kernels.halo_pack.ops import halo_unpack as jax_halo_unpack
from repro_torch.core.halo import DIRECTIONS, offsets_of, surface_size
from repro_torch.kernels import _build
from repro_torch.kernels.counter_bump import counter_bump
from repro_torch.kernels.halo_pack import (faces_increment, halo_pack,
                                           halo_pack_split, halo_unpack,
                                           halo_unpack_split)
from repro_torch.kernels.halo_pack import ops
from repro_torch.kernels.halo_pack import ref as tref

R = 3


def _field(rng, n):
    return rng.standard_normal((R,) + tuple(n)).astype(np.float32)


# the pack is a pure copy of any dtype (``halo_pack_fwd``'s output takes
# the field's dtype), compared as bits: an integer type of each size
PACK_DTYPES = {"float32": (torch.float32, jnp.float32),
               "bfloat16": (torch.bfloat16, jnp.bfloat16),
               "int32": (torch.int32, jnp.int32)}
BITS = {2: (torch.int16, np.int16), 4: (torch.int32, np.int32)}


@pytest.mark.parametrize("dtype", list(PACK_DTYPES))
@pytest.mark.parametrize("n", [(4, 4, 4), (6, 5, 4), (8, 8, 8)])
def test_pack_unpack_match_pallas_per_rank(n, dtype, rng):
    tdt, jdt = PACK_DTYPES[dtype]
    if dtype == "int32":
        f = rng.randint(-1 << 20, 1 << 20, (R,) + n).astype(np.int32)
    else:
        f = _field(rng, n)
    got = halo_pack(torch.from_numpy(f).to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == (R, offsets_of(n)[1])
    tbits, nbits = BITS[got.element_size()]
    flat = got.view(tbits).numpy()
    for r in range(R):
        want = jax_halo_pack(jnp.asarray(f[r], dtype=jdt), interpret=True)
        assert want.dtype == jdt
        np.testing.assert_array_equal(flat[r], np.asarray(want).view(nbits))
    if dtype != "float32":
        return              # the unpack's other dtypes: the test below
    # unpack a received buffer that is NOT a packed field, so every
    # surface carries independent values into the shared cells
    recv = rng.standard_normal(flat.shape).astype(np.float32)
    acc = halo_unpack(torch.from_numpy(recv), n).numpy()
    assert acc.shape == (R,) + n
    for r in range(R):
        want = np.asarray(jax_halo_unpack(jnp.asarray(recv[r]), n,
                                          interpret=True))
        np.testing.assert_array_equal(acc[r], want)


UNPACK_DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
                 "float16": (torch.float16, jnp.float16),
                 "int32": (torch.int32, jnp.int32)}


@pytest.mark.parametrize("dtype", list(UNPACK_DTYPES))
@pytest.mark.parametrize("n", [(4, 4, 4), (6, 5, 4), (8, 8, 8)])
def test_unpack_in_each_dtype_matches_pallas_per_rank(n, dtype, rng):
    """``halo_unpack_fwd`` accumulates in its input's dtype, each add
    rounded to it; so does the plain unpack (the card's kernel is held to
    the plain version in tests/test_torch_cuda.py): bit for bit, integers
    wrapping alike."""
    tdt, jdt = UNPACK_DTYPES[dtype]
    total = offsets_of(n)[1]
    if dtype == "int32":
        recv = torch.from_numpy(
            rng.randint(-1 << 30, 1 << 30, (R, total)).astype(np.int32))
    else:
        recv = torch.from_numpy(
            rng.standard_normal((R, total)).astype(np.float32)).to(tdt)
    acc = halo_unpack(recv, n)
    assert acc.dtype == tdt and tuple(acc.shape) == (R,) + n
    tbits, nbits = BITS[acc.element_size()]
    for r in range(R):
        want = jax_halo_unpack(
            jnp.asarray(recv[r].view(tbits).numpy().view(nbits)).view(jdt)
            if dtype != "int32" else jnp.asarray(recv[r].numpy()),
            n, interpret=True)
        assert want.dtype == jdt
        np.testing.assert_array_equal(acc[r].view(tbits).numpy(),
                                      np.asarray(want).view(nbits))


@pytest.mark.parametrize("n", [(4, 4, 4), (6, 5, 4)])
def test_split_forms_equal_flat_forms(n, rng):
    f = torch.from_numpy(_field(rng, n))
    parts = halo_pack_split(f)
    assert len(parts) == 26
    for d, p in zip(DIRECTIONS, parts):
        assert tuple(p.shape) == (R, surface_size(n, d))
    flat = halo_pack(f)
    assert torch.equal(torch.cat(parts, dim=1), flat)
    recv = torch.from_numpy(
        rng.standard_normal(tuple(flat.shape)).astype(np.float32))
    offs, _ = offsets_of(n)
    split = [recv[:, o:o + s] for o, s in (offs[d] for d in DIRECTIONS)]
    assert torch.equal(halo_unpack_split(split, n), halo_unpack(recv, n))


@settings(max_examples=10, deadline=None)
@given(nx=st.integers(3, 8), ny=st.integers(3, 8), nz=st.integers(3, 8))
def test_unpack_of_pack_counts_surface_multiplicity(nx, ny, nz):
    """Every cell of unpack(pack(ones)) counts the surfaces containing
    it: interior 0, face 1, edge 3, corner 7 (3 faces + 3 edges + 1)."""
    n = (nx, ny, nz)
    up = halo_unpack(halo_pack(torch.ones((2,) + n)), n).numpy()
    assert up[:, 1:-1, 1:-1, 1:-1].sum() == 0
    assert (up[:, 0, 0, 0] == 7).all() and (up[:, -1, -1, -1] == 7).all()
    assert (up[:, 0, 0, 1:-1] == 3).all()
    assert (up[:, 0, 1:-1, 1:-1] == 1).all()


def test_generic_put_helpers_match_reference(rng):
    shapes = [(R, 5), (R, 2, 3), (R, 7)]
    parts = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    tparts = [torch.from_numpy(p) for p in parts]
    jparts = [jnp.asarray(p) for p in parts]
    flat = tref.pack_flat(tparts)
    np.testing.assert_array_equal(flat.numpy(),
                                  np.asarray(jref.pack_flat(jparts)))
    for got, want in zip(tref.unpack_flat(flat, tparts),
                         jref.unpack_flat(jnp.asarray(flat.numpy()),
                                          jparts)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for offset, count in [(0, 4), (3, 6), (4, 9), (12, 6)]:
        g = tref.chunk_gather(tparts, offset, count)
        np.testing.assert_array_equal(
            g.numpy(), np.asarray(jref.chunk_gather(jparts, offset, count)))
        got = tref.chunk_scatter(g * 2, tparts, offset, count)
        want = jref.chunk_scatter(jnp.asarray(g.numpy() * 2), jparts,
                                  offset, count)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the helpers never write into their inputs
    for t, p in zip(tparts, parts):
        np.testing.assert_array_equal(t.numpy(), p)


def test_cpu_wrappers_launch_no_kernel(rng):
    _build.reset_launches()
    f = torch.from_numpy(_field(rng, (4, 3, 5)))
    halo_unpack_split(halo_pack_split(f), (4, 3, 5))
    halo_unpack(halo_pack(f), (4, 3, 5))
    faces_increment(f, torch.zeros(R, 1))
    sig = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    assert torch.equal(counter_bump(sig, sig), sig * 2)
    assert set(_build.LAUNCHES.values()) == {0}


class _FakeLaunch:
    """The kernel library as the pack and unpack wrappers call it:
    records each launch's arguments and reports success."""

    def __init__(self):
        self.calls = []
        self.unpacks = []

    def halo_pack_launch(self, *args):
        self.calls.append(args)
        return 0

    def halo_unpack_launch(self, *args):
        self.unpacks.append(args)
        return 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int32,
                                   torch.float64, torch.uint8, torch.int8,
                                   torch.int16], ids=str)
def test_cuda_pack_wrapper_takes_any_element_size(monkeypatch, dtype):
    """On the card's route the pack wrapper refuses no 1-, 2-, 4- or
    8-byte dtype: it hands the kernel the element size (the kernel copies
    bytes) and returns the field's dtype. The unpack, which adds, takes
    the dtypes the plain version adds, the 1- and 2-byte integers too: it
    hands the kernel the surfaces' dtype code and returns an accumulator
    (and, for a float, a per-rank max) of that dtype; a 16-byte element
    (complex128), a bool accumulator and an integer ``with_max`` (the
    plain norm refuses it) stay refused. The launch is faked and the
    device check bypassed, so this runs without a card, on meta
    tensors."""
    lib = _FakeLaunch()
    monkeypatch.setattr(ops, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(ops._build, "load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    n = (4, 3, 5)
    _, total = offsets_of(n)
    field = torch.zeros((2,) + n, dtype=dtype, device="meta")
    _build.reset_launches()
    flat = halo_pack(field)
    parts = halo_pack_split(field)
    assert flat.dtype == dtype and tuple(flat.shape) == (2, total)
    assert [p.dtype for p in parts] == [dtype] * 26
    # (src, R, nx, ny, nz, element bytes, ptrs, strides, stream)
    assert [c[1:6] for c in lib.calls] == [(2,) + n + (field.element_size(),)
                                           ] * 2
    assert _build.LAUNCHES["halo_pack"] == 2
    with pytest.raises(TypeError, match="1, 2, 4 or 8 bytes"):
        halo_pack(torch.zeros((2,) + n, dtype=torch.complex128,
                              device="meta"))
    acc = halo_unpack(flat, n)
    acc2 = halo_unpack_split(parts, n)
    for a in (acc, acc2):
        assert a.dtype == dtype and tuple(a.shape) == (2,) + n
    # (acc, dtype code, R, nx, ny, nz, ptrs, strides, rank max, stream)
    code = ops.UNPACK_DTYPES[dtype]
    assert [c[1:6] for c in lib.unpacks] == [(code, 2) + n] * 2
    assert [c[8] for c in lib.unpacks] == [None] * 2
    assert _build.LAUNCHES["halo_unpack"] == 2
    if dtype.is_floating_point:
        acc, res = halo_unpack_split(parts, n, with_max=True)
        assert res.dtype == dtype and tuple(res.shape) == (2, 1)
        assert lib.unpacks[-1][8] is not None
    else:
        with pytest.raises(TypeError, match="with_max"):
            halo_unpack(flat, n, with_max=True)
        with pytest.raises(TypeError, match="with_max"):
            halo_unpack_split(parts, n, with_max=True)
    with pytest.raises(TypeError, match="int16, got torch.bool"):
        halo_unpack(torch.zeros((2, total), dtype=torch.bool,
                                device="meta"), n)
    with pytest.raises(TypeError, match="one dtype"):
        halo_unpack_split([parts[0].float()] + list(parts[1:]), n)
    assert len(lib.calls) == 2
    assert len(lib.unpacks) == 2 + dtype.is_floating_point
    _build.reset_launches()


def test_wrappers_reject_bad_inputs():
    with pytest.raises(ValueError):
        halo_pack(torch.zeros(4, 4, 4))                # no rank dim
    with pytest.raises(ValueError):
        halo_unpack(torch.zeros(2, 10), (4, 4, 4))     # wrong total
    with pytest.raises(ValueError):
        halo_unpack_split([torch.zeros(2, 1)] * 25, (4, 4, 4))
    with pytest.raises(TypeError):
        counter_bump(torch.zeros(2, 3), torch.zeros(2, 3))
    with pytest.raises(ValueError):
        counter_bump(torch.zeros(2, 3, dtype=torch.int32),
                     torch.zeros(3, 2, dtype=torch.int32))
