"""The port's CUDA kernels and its Faces path on the card.

Marked ``cuda``: skipped without an NVIDIA card (a CUDA kernel has no
CPU mode), run on the card with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

The Faces kernels must equal their plain PyTorch versions exactly, and
Faces on the card must equal Faces on the CPU bit for bit in every mode.
The attention kernels accumulate in float32 (the bf16 flash kernel
rounds its unnormalised weights to bf16 for the tensor cores, where the
plain version rounds the normalised ones), so on unit-normal inputs they
are held to the tolerances of ``tests/test_kernels.py``: 2e-5 in float32
and, in bf16, 2e-2 of the largest |output|. Run the attention cases
alone with ``-m cuda -k attention``. The WKV6 kernel and its plain version both
compute in float32 on the same values: 1e-5. So do the selective-scan
kernel and its plain version: 1e-5 of max(1, the largest |value|) for
the state and a float32 y, 2e-2 of it for a bf16 y (one rounding of the
same float32 value). The serving engine on the card must serve the CPU's
greedy tokens, granite-3-2b's, rwkv6's, jamba's and deepseek-v2's (MLA:
flash attention at (hd, hdv) = (192, 128) at prefill, absorbed products
at decode). Training: each autograd Function (flash attention, WKV6, the
selective scan) gives the bare kernel's forward and the plain version's
gradients bit for bit (its backward is that computation); a reduced
train step through the kernels equals the plain route (1e-5 relative
loss, 1e-4 of the largest gradient, float32); a bf16 checkpoint written
from the card restores on the CPU and back, bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import STStream, engine, halo
from repro_torch.core.halo import _max_abs
from repro_torch.kernels import _build
from repro_torch.kernels.counter_bump import (counter_bump, put_signal,
                                              put_signal_ref)
from repro_torch.kernels.halo_pack import (halo_pack, halo_pack_split,
                                           halo_unpack, halo_unpack_split)
from repro_torch.kernels.halo_pack import ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "mode (their plain versions are tested on the CPU)")
    return torch.device("cuda", 0)


# the pack's cases: blocks of one cell, one row, one plane, nz of 1, 2 or
# 3 (rows off 16-byte alignment), odd sizes, and the main path's 64^3
HALO_SHAPES = [(1, 1, 1), (1, 3, 2), (2, 1, 3), (3, 3, 1), (3, 3, 3),
               (4, 4, 4), (6, 5, 3), (6, 5, 4), (5, 7, 5), (16, 8, 4),
               (64, 64, 64)]
PACK_DTYPES = [torch.float32, torch.bfloat16, torch.int32, torch.uint8,
               torch.int8]


def _pack_field(gen, shape, dtype, dev):
    if dtype == torch.int32:
        return torch.randint(-1 << 20, 1 << 20, shape, generator=gen,
                             device=dev, dtype=dtype)
    if not dtype.is_floating_point:        # a 1-byte integer's whole range
        info = torch.iinfo(dtype)
        return torch.randint(info.min, info.max + 1, shape, generator=gen,
                             device=dev, dtype=dtype)
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


@pytest.mark.parametrize("dtype", PACK_DTYPES, ids=str)
@pytest.mark.parametrize("R", [1, 5, 64])
@pytest.mark.parametrize("n", HALO_SHAPES)
def test_halo_kernels_equal_plain_versions(dev, n, R, dtype):
    """The pack (a copy of any 1-, 2-, 4- or 8-byte dtype), split and
    flat, and the unpack in the same dtype: bit for bit their plain
    versions."""
    gen = torch.Generator(device=dev).manual_seed(0)
    field = _pack_field(gen, (R,) + n, dtype, dev)
    _build.reset_launches()
    for a, b in zip(halo_pack_split(field), ref.halo_pack_split_ref(field)):
        assert torch.equal(a, b) and a.dtype == dtype
    flat = halo_pack(field)
    assert torch.equal(flat, ref.halo_pack_ref(field)) and flat.dtype == dtype
    # the unpack adds in the surfaces' dtype, as the plain version
    recv = _pack_field(gen, flat.shape, dtype, dev)
    assert torch.equal(halo_unpack(recv, n), ref.halo_unpack_ref(recv, n))
    parts = [p.contiguous() for p in
             torch.split(recv, [p.shape[1] for p in
                                halo_pack_split(field)], dim=1)]
    assert torch.equal(halo_unpack_split(parts, n),
                       ref.halo_unpack_split_ref(parts, n))
    assert _build.LAUNCHES["halo_pack"] == 3
    assert _build.LAUNCHES["halo_unpack"] == 2


@pytest.mark.parametrize("dtype", PACK_DTYPES, ids=str)
def test_halo_pack_off_16_byte_alignment(dev, dtype):
    """A flat output whose rank rows start off 16-byte boundaries (total *
    element size not a multiple of 16), from a field that starts off one
    too: the copies' 16-byte stores align on each destination run and
    load the source in the widest pieces its alignment allows."""
    n, R = (6, 5, 3), 5
    gen = torch.Generator(device=dev).manual_seed(5)
    cells = R * int(np.prod(n))
    base = _pack_field(gen, (cells + 1,), dtype, dev)
    field = base[1:].view((R,) + n)
    assert field.data_ptr() % 16 and (
        halo.offsets_of(n)[1] * field.element_size()) % 16
    flat = halo_pack(field)
    assert torch.equal(flat, ref.halo_pack_ref(field))
    for a, b in zip(halo_pack_split(field), ref.halo_pack_split_ref(field)):
        assert torch.equal(a, b)


UNPACK_DTYPES = [torch.float32, torch.bfloat16, torch.float16,
                 torch.float64, torch.int32, torch.int64, torch.uint8,
                 torch.int8, torch.int16]


def _unpack_recv(gen, shape, dtype, dev):
    if dtype.is_floating_point:
        return torch.randn(shape, generator=gen, device=dev).to(dtype)
    info = torch.iinfo(dtype)
    if info.bits <= 16:                    # the whole range: adds wrap
        return torch.randint(info.min, info.max + 1, shape, generator=gen,
                             device=dev, dtype=dtype)
    # large enough that the 7 adds of a corner cell wrap
    return torch.randint(-1 << 30, 1 << 30, shape, generator=gen,
                         device=dev, dtype=dtype) << (
        32 if dtype == torch.int64 else 0)


@pytest.mark.parametrize("dtype", UNPACK_DTYPES, ids=str)
@pytest.mark.parametrize("n", [(1, 3, 2), (6, 5, 3), (6, 5, 4), (16, 8, 8),
                               (64, 64, 64)])
def test_halo_unpack_in_each_dtype_equals_the_plain_version(dev, n, dtype):
    """The unpack in every dtype it takes, split and flat, bit for bit
    the plain version (each add rounded to the dtype in DIRECTIONS order,
    integers wrapping); with the per-rank max in the accumulator's dtype
    for a float, a NaN propagated to its rank; an integer max refused, as
    the plain norm refuses it."""
    gen = torch.Generator(device=dev).manual_seed(3)
    R = 5
    total = halo.offsets_of(n)[1]
    flat = _unpack_recv(gen, (R, total), dtype, dev)
    sizes = [halo.surface_size(n, d) for d in halo.DIRECTIONS]
    parts = [p.contiguous() for p in torch.split(flat, sizes, dim=1)]
    want = ref.halo_unpack_ref(flat, n)
    _build.reset_launches()
    for got in (halo_unpack(flat, n), halo_unpack_split(parts, n)):
        assert got.dtype == dtype and torch.equal(got, want)
    assert _build.LAUNCHES["halo_unpack"] == 2
    if not dtype.is_floating_point:
        with pytest.raises(TypeError, match="with_max"):
            halo_unpack(flat, n, with_max=True)
        with pytest.raises(RuntimeError):
            _max_abs(want)                  # the plain version refuses too
        return
    parts[7] = parts[7].clone()
    parts[7][2, -1] = float("nan")
    want = ref.halo_unpack_split_ref(parts, n)
    for got, m in (halo_unpack_split(parts, n, with_max=True),
                   halo_unpack(torch.cat(parts, dim=1), n, with_max=True)):
        torch.testing.assert_close(got, want, rtol=0, atol=0,
                                   equal_nan=True)
        assert m.dtype == dtype
        torch.testing.assert_close(m, _max_abs(want), rtol=0, atol=0,
                                   equal_nan=True)
        assert bool(m[2].isnan()) and not m[[0, 1, 3, 4]].isnan().any()


def test_halo_unpack_takes_rank_strided_surfaces(dev):
    """The parts of a packed put arrive as views of one staging buffer
    (``ref.unpack_flat``): each rank's elements contiguous, ranks at the
    staging buffer's stride. The kernel reads them in place."""
    n = (6, 5, 4)
    gen = torch.Generator(device=dev).manual_seed(1)
    flat = torch.randn((5, halo.offsets_of(n)[1] + 7), generator=gen,
                       device=dev)
    sizes = [halo.surface_size(n, d) for d in halo.DIRECTIONS]
    views = ref.unpack_flat(flat[:, 3:-4], [torch.empty((5, s))
                                            for s in sizes])
    assert not views[0].is_contiguous()
    assert torch.equal(halo_unpack_split(views, n),
                       ref.halo_unpack_split_ref(views, n))
    assert torch.equal(halo_unpack(flat[:, 3:-4], n),
                       ref.halo_unpack_ref(flat[:, 3:-4], n))
    acc, res = halo_unpack_split(views, n, with_max=True)
    want = ref.halo_unpack_split_ref(views, n)
    assert torch.equal(acc, want) and torch.equal(res, _max_abs(want))
    face = sizes.index(max(sizes))          # a surface of many elements
    column_major = list(views)
    column_major[face] = views[face].t().contiguous().t()   # rank stride 1
    with pytest.raises(ValueError, match="contiguous"):
        halo_unpack_split(column_major, n)


def test_counter_bump_equals_add(dev):
    sig = torch.arange(64 * 26, dtype=torch.int32, device=dev).view(64, 26)
    upd = torch.ones_like(sig)
    assert torch.equal(counter_bump(sig, upd), sig + upd)
    with pytest.raises(ValueError):
        counter_bump(sig.t(), upd.t())             # not contiguous


def _device_kernels(fn, calls=3):
    """Names of the device kernels (not memsets) ``calls`` calls of
    ``fn()`` run, each name once per launch. The profiler sometimes
    returns no device event at all for a short trace: that says nothing
    of the kernel, so such a trace is taken again (at most twice)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and "emset" not in e.key
                 for _ in range(e.count)]
        if names:
            return names
    return names


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32], ids=str)
@pytest.mark.parametrize("periodic", [True, False])
def test_put_signal_equals_plain_version(dev, periodic, dtype):
    """Gather and zero-filled scatter, rows of 1, 3, 64 and 4096
    elements, rows that start off a 16-byte boundary (narrower vectors),
    with and without the signal: equal to the plain version bit for
    bit, one launch a call."""
    stream = STStream(dev, ("x", "y", "z"), periodic=periodic,
                      grid_shape=(4, 4, 4))
    R = stream.num_ranks
    gen = torch.Generator(device=dev).manual_seed(3)
    sig = torch.randint(0, 1 << 20, (R, 26), generator=gen, device=dev,
                        dtype=torch.int32)
    upd = torch.randint(0, 3, (R, 26), generator=gen, device=dev,
                        dtype=torch.int32)
    calls = 0
    _build.reset_launches()
    for d in ((1, 0, 0), (-1, 1, 0), (1, 1, 1)):
        perm = engine._perm_index(stream, d)
        assert bool((perm < 0).any()) == (not periodic)
        for s in (1, 3, 64, 4096):
            wide = torch.randint(-1000, 1000, (R, s + 1), generator=gen,
                                 device=dev).to(dtype)
            for x in (wide[:, :s].contiguous(), wide[:, 1:]):
                want = put_signal_ref(x, perm)
                assert torch.equal(put_signal(x, perm), want)
                got, cnt = put_signal(x, perm, sig, upd)
                assert torch.equal(got, want) and got.dtype == dtype
                assert torch.equal(cnt, sig + upd)
                calls += 2
    assert _build.LAUNCHES["put_signal"] == calls
    x = torch.randn((R, 64), generator=gen, device=dev)
    assert len(_device_kernels(lambda: put_signal(x, perm, sig, upd))) == 3
    with pytest.raises(ValueError, match="contiguous"):
        put_signal(x.t().contiguous().t(), perm)      # rank stride 1


@pytest.mark.parametrize("n", [(4, 4, 4), (6, 5, 4), (1, 3, 2), (2, 1, 3),
                               (3, 3, 3), (16, 8, 4)])
def test_halo_unpack_is_one_kernel_with_the_max(dev, n):
    """The one-pass unpack: one device kernel a call (and a memset of the
    R maxima with ``with_max``), equal to the plain unpack and its
    max|acc| pass, a NaN in one surface propagated to its rank's max."""
    gen = torch.Generator(device=dev).manual_seed(2)
    field = torch.randn((5,) + n, generator=gen, device=dev)
    recvs = [torch.randn(p.shape, generator=gen, device=dev)
             for p in halo_pack_split(field)]
    want = ref.halo_unpack_split_ref(recvs, n)
    _build.reset_launches()
    acc, res = halo_unpack_split(recvs, n, with_max=True)
    assert torch.equal(acc, want) and torch.equal(res, _max_abs(want))
    assert _build.LAUNCHES["halo_unpack"] == 1
    for with_max in (False, True):
        names = _device_kernels(
            lambda: halo_unpack_split(recvs, n, with_max=with_max))
        assert len([k for k in names if "unpack" in k]) == 3, names
        assert len(names) == 3 * (1 + with_max), names  # + the maxima's zeros
    recvs[7] = recvs[7].clone()
    recvs[7][2, -1] = float("nan")
    acc, res = halo_unpack_split(recvs, n, with_max=True)
    want = ref.halo_unpack_split_ref(recvs, n)
    torch.testing.assert_close(acc, want, rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(res, _max_abs(want), rtol=0, atol=0,
                               equal_nan=True)
    assert bool(res[2].isnan()) and not res[[0, 1, 3, 4]].isnan().any()


def test_put_signal_and_unpack_never_sync(dev):
    n, R = (6, 5, 3), 8
    gen = torch.Generator(device=dev).manual_seed(4)
    field = torch.randn((R,) + n, generator=gen, device=dev)
    x = torch.randn((R, 33), generator=gen, device=dev)
    sig = torch.zeros((R, 26), dtype=torch.int32, device=dev)
    perm = torch.tensor([1, 2, 3, 4, 5, 6, 7, -1], device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        put_signal(x, perm)
        put_signal(x, perm, sig, sig)
        recvs = halo_pack_split(field)
        halo_unpack_split(recvs, n, with_max=True)
        halo_unpack(halo_pack(field), n, with_max=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


PACK = dict(pack=True, node_aware=True)


@pytest.mark.parametrize("mode,merged,sched", [
    ("st", True, {}), ("st", False, {}), ("host", True, {}),
    ("fused", True, {}),
    # two nodes of four ranks: the off-node puts pack (their recv
    # buffers arrive as views of one staging buffer) and chunk
    ("st", True, PACK), ("host", True, PACK), ("fused", True, PACK),
    ("st", True, dict(PACK, chunk_bytes=32)),
    ("fused", True, dict(PACK, chunk_bytes=32)),
], ids=lambda v: "-".join(v) if isinstance(v, dict) else None)
def test_faces_on_the_card_equals_the_cpu(dev, mode, merged, sched):
    src0 = np.random.RandomState(0).rand(8, 4, 3, 5).astype(np.float32)
    outs = {}
    for device in ("cpu", dev):
        stream = STStream(device, ("x", "y", "z"), grid_shape=(2, 2, 2))
        halo.build_faces_program(stream, (4, 3, 5), 3, merged=merged,
                                 ranks_per_node=4 if sched else None)
        state = stream.allocate()
        state["faces.src"] = torch.from_numpy(src0).to(device)
        outs[str(device)] = stream.synchronize(state, mode=mode,
                                               merged=merged, **sched)
        if sched:                                           # not vacuous
            assert stream.scheduled_programs(
                merged=merged, fused=mode == "fused",
                **sched)[0].stats()["packed_puts"]
    cpu, gpu = outs["cpu"], outs[str(dev)]
    for k in cpu:
        assert torch.equal(cpu[k], gpu[k].cpu()), k


# the parity configurations: st and fused replay CUDA graphs
GRAPH_CASES = [("st", True, {}), ("st", False, {}), ("fused", True, {}),
               ("st", True, PACK), ("fused", True, PACK),
               ("st", True, dict(PACK, chunk_bytes=32)),
               ("fused", True, dict(PACK, chunk_bytes=32)),
               ("fused", True, dict(nstreams=2))]


@pytest.mark.parametrize("mode,merged,sched", GRAPH_CASES,
                         ids=lambda v: "-".join(map(str, v))
                         if isinstance(v, dict) else None)
def test_faces_graphs_equal_the_eager_emission_and_host_mode(dev, mode,
                                                             merged, sched):
    """st and fused replay their program's CUDA graphs: bit for bit the
    eager emission of the same program and host mode (eager); a second
    synchronize replays (no recapture) under sync-debug "error" and
    leaves the first result's tensors unchanged; per program one graph
    in st, one per planned segment in fused."""
    from repro_torch.core import host_dispatch_count
    from repro_torch.core.backends import _emit_st
    from repro_torch.core.engine import _emit_fused
    src0 = np.random.RandomState(1).rand(8, 4, 3, 5).astype(np.float32)
    nodes = 4 if sched.get("pack") else None
    opts = dict(merged=merged, **sched)

    def stream_state():
        stream = STStream(dev, ("x", "y", "z"), grid_shape=(2, 2, 2))
        halo.build_faces_program(stream, (4, 3, 5), 3, merged=merged,
                                 ranks_per_node=nodes)
        state = stream.allocate()
        state["faces.src"] = torch.from_numpy(src0).to(dev)
        return stream, state
    stream, state = stream_state()
    first = stream.synchronize(state, mode=mode, **opts)
    kept = {k: v.clone() for k, v in first.items()}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        second = stream.synchronize(state, mode=mode, **opts)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    cache = (stream._fused_cache if mode == "fused"
             else stream._compiled_cache)
    g, = cache.values()
    prog, = stream.scheduled_programs(fused=mode == "fused", **opts)
    assert len(g.chain) == (host_dispatch_count(prog) if mode == "fused"
                            else 1)
    emit = _emit_fused if mode == "fused" else _emit_st
    eager = emit(stream, prog, state)
    host_stream, host_state = stream_state()
    host = host_stream.synchronize(host_state, mode="host",
                                   **{k: v for k, v in opts.items()
                                      if k != "nstreams"})
    for k in first:
        assert torch.equal(first[k], kept[k]), k
        assert torch.equal(second[k], first[k]), k
        assert torch.equal(eager[k], first[k]), k
        assert torch.equal(host[k], first[k]), k


def test_faces_graph_launch_counts_and_freed_graphs(dev):
    """The replay accounting on the card: a synchronize adds each Faces
    kernel's launches once per iteration, as the eager emission; a
    stream's graphs are dropped by clear_graphs."""
    from repro_torch.core.backends import _emit_st
    stream = STStream(dev, ("x", "y", "z"), grid_shape=(2, 2, 2))
    halo.build_faces_program(stream, (4, 4, 4), 3)
    state = stream.allocate()
    prog, = stream.scheduled_programs()
    _build.reset_launches()
    _emit_st(stream, prog, state)
    once = dict(_build.LAUNCHES)
    stream.synchronize(state)                   # warm-up, capture, replay
    _build.reset_launches()
    for _ in range(2):
        stream.synchronize(state)
    assert _build.LAUNCHES == {k: 2 * v for k, v in once.items()}
    assert once["put_signal"] == 26 * 3 and once["halo_unpack"] == 3
    stream.clear_graphs()
    assert not stream._compiled_cache


# ---------------------------------------------------------------------------
# attention kernels and the serving path
# ---------------------------------------------------------------------------

# the plain versions' float32 products must stay float32 on the card
# (PyTorch's default; TF32 would keep ~3 digits)
ATOL_F32, RTOL_BF16 = 2e-5, 2e-2


def _attn_inputs(dev, dtype, B, Sq, Skv, H, KV, hd, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=gen, device=dev).to(dtype)
    return mk(B, Sq, H, hd), mk(B, Skv, KV, hd), mk(B, Skv, KV, hd)


def _assert_attn_close(out, ref):
    """Outputs of unit-normal inputs reach ~3, where one bf16 spacing is
    2^-6: the bf16 tolerance is relative to the largest |output|."""
    atol = (ATOL_F32 if ref.dtype == torch.float32
            else RTOL_BF16 * ref.float().abs().max().item())
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,kvl,off,causal", [
    (2, 1000, 4096, 32, 8, 64, (1000, 1000), 0, True),   # granite prefill
    (1, 256, 256, 8, 8, 64, None, 0, True),              # G = 1
    (1, 200, 333, 4, 1, 128, (333,), 133, True),         # hd 128, ragged
    (2, 130, 512, 4, 2, 32, (90, 512), 0, True),         # kvl < Sq
    (2, 77, 300, 8, 4, 64, (300, 150), 0, False),        # not causal
    # the edges of the 64-row q-tiles, the 64-key tiles and their
    # two-stage ring (Sq, Skv in {1, 15, 16, 63, 64, 65, 127, 129, 1000}),
    # hd 64 and 128, G 1, 4 and 8
    (1, 1, 1, 4, 4, 64, None, 0, True),
    (2, 15, 16, 8, 2, 64, (16, 15), 0, True),
    (1, 16, 15, 16, 2, 128, None, 0, False),
    (2, 63, 64, 8, 8, 64, (64, 63), 1, True),
    (1, 64, 65, 16, 2, 128, (65,), 1, True),
    (2, 65, 63, 8, 2, 64, (63, 1), 0, False),
    (1, 127, 129, 8, 2, 128, (129,), 2, True),
    (2, 129, 127, 8, 8, 64, (127, 64), 0, True),
    (1, 1, 1000, 32, 8, 64, (1000,), 999, True),         # one row, last key
    (1, 1000, 1000, 64, 8, 128, (1000,), 0, True),       # jamba prefill
    # llama-3.2-vision's cross layers: the prompt against every one of
    # the 1600 vision rows, no valid length; prompts of no multiple of 64
    (8, 1000, 1600, 64, 8, 128, None, 0, False),
    (2, 65, 1600, 64, 8, 128, None, 0, False),
    (8, 1000, 4096, 32, 32, 64, (1000,) * 8, 0, True),   # musicgen prefill
])
def test_flash_attention_kernel_equals_plain(dev, dtype, B, Sq, Skv, H, KV,
                                             hd, kvl, off, causal):
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    assert not torch.backends.cuda.matmul.allow_tf32
    q, k, v = _attn_inputs(dev, dtype, B, Sq, Skv, H, KV, hd)
    pos = (off + torch.arange(Sq, device=dev, dtype=torch.int32)).expand(
        B, Sq)
    kv_len = None if kvl is None else torch.tensor(kvl, device=dev,
                                                   dtype=torch.int32)
    _build.reset_launches()
    out = flash_attention(q, k, v, q_positions=pos, kv_valid_len=kv_len,
                          causal=causal)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention"] == 1
    ref = flash_attention_ref(q, k, v, q_offset=pos[:, 0],
                              kv_valid_len=kv_len, causal=causal)
    assert out.shape == ref.shape and out.dtype == dtype
    _assert_attn_close(out, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,hd,pos", [
    (8, 4096, 32, 8, 64, (1000, 128, 4095, 0, 600, 257, 3000, 64)),
    (2, 512, 8, 8, 64, (100, 511)),                      # G = 1
    (3, 1024, 4, 1, 128, (5, 700, 1023)),                # hd 128
    (2, 200, 16, 2, 32, (199, 13)),                      # ragged S
    # split edges: one key (only split 0 holds keys), fewer keys than
    # splits (empty splits), as many keys as splits x 4 (equal splits),
    # S = 1000 keys (no multiple of the split width or the 64-key tile)
    (4, 1000, 8, 2, 64, (0, 14, 63, 999)),               # G = 4
    (3, 4096, 64, 8, 128, (1016, 0, 4095)),              # jamba, G = 8
    (2, 129, 8, 8, 128, (128, 3)),                       # G = 1, hd 128
    # more than 16 heads per KV head: the bf16 kernel's head groups
    (2, 300, 32, 1, 64, (299, 17)),                      # G = 32
    (1, 200, 20, 1, 32, (150,)),                         # G = 20: 16 + 4
    (8, 4096, 32, 32, 64, (1000, 128, 4095, 0, 600, 257, 3000, 64)),
    #                                                      musicgen, MHA
])
def test_decode_attention_kernel_equals_plain(dev, dtype, B, S, H, KV, hd,
                                              pos):
    """Per case four sets of valid lengths: the positions', S // 2, and
    at the last position, one at a split boundary per sequence (a
    multiple of the split count) with sequence 0's keys ending inside
    split 0, and sequence 0 with no valid key (every split walks its keys
    masked) beside full ones. The wrapper makes no host
    synchronisation."""
    from repro_torch.kernels import _attn
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_ref)
    q, k, v = _attn_inputs(dev, dtype, B, 1, S, H, KV, hd)
    p = torch.tensor(pos, device=dev, dtype=torch.int32)[:, None]
    n = _attn.decode_splits(S, B, KV, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    last = torch.full((B, 1), S - 1, device=dev, dtype=torch.int32)
    at_bounds = [1] + [min(S, n * (3 + 5 * b)) for b in range(1, B)]
    full = [0] + [S] * (B - 1)
    for p, kvl in ((p, p[:, 0] + 1),
                   (p, torch.full((B,), S // 2, device=dev,
                                  dtype=torch.int32)),
                   (last, torch.tensor(at_bounds, device=dev,
                                       dtype=torch.int32)),
                   (last, torch.tensor(full, device=dev,
                                       dtype=torch.int32))):
        _build.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = decode_attention(q, k, v, q_positions=p, kv_valid_len=kvl)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        assert _build.LAUNCHES["decode_attention"] == 1
        ref = decode_attention_ref(q, k, v, q_positions=p, kv_valid_len=kvl)
        assert out.shape == ref.shape and out.dtype == dtype
        _assert_attn_close(out, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_decode_attends_every_vision_row(dev, dtype):
    """llama-3.2-vision's cross layers at decode: 8 slots at positions
    below 1600 against the 1600 cached vision rows. ``attention_core``
    with ``causal=False`` launches the decode kernel once with no query
    position, so every row is valid: it equals the plain version without
    positions or valid length, and not the one masked at the
    positions."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention_ref
    from repro_torch.models.attention import attention_core
    cfg = get_config("llama-3.2-vision-90b")
    q, k, v = _attn_inputs(dev, dtype, 8, 1, 1600, 64, 8, 128)
    pos = torch.tensor([0, 1, 5, 63, 64, 700, 1000, 1598], device=dev,
                       dtype=torch.int32)[:, None]
    _build.reset_launches()
    out = attention_core(cfg, q, k, v, q_positions=pos, causal=False)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["decode_attention"] == 1
    ref = decode_attention_ref(q, k, v)
    _assert_attn_close(out, ref)
    plain = attention_core(dataclasses.replace(cfg, attn_impl="plain"),
                           q, k, v, q_positions=pos, causal=False)
    _assert_attn_close(plain, ref)
    masked = decode_attention_ref(q, k, v, q_positions=pos)
    assert (out.float() - masked.float()).abs().max().item() > 0.1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Skv,H,KV,kvl,off", [
    (4, 1000, 4096, 128, 128, (1000,) * 4, 0),     # deepseek-v2 prefill
    (2, 1000, 1000, 16, 16, (700, 1000), 0),       # ragged
    (2, 65, 129, 16, 16, (129, 64), 64),           # tile edges
    (1, 1, 1, 4, 4, None, 0),
    (2, 63, 64, 8, 2, (64, 63), 1),                # GQA
    (1, 127, 129, 4, 4, (129,), 2),
])
def test_flash_attention_kernel_at_mla_head_dims_equals_plain(
        dev, dtype, B, Sq, Skv, H, KV, kvl, off):
    """(hd, hdv) = (192, 128), DeepSeek-V2's MLA prefill: q and k 192
    wide (24 16-byte chunks a bf16 row), v and the output 128, at the
    edges of the 64-row q-tiles and 64-key tiles."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    q, k, _ = _attn_inputs(dev, dtype, B, Sq, Skv, H, KV, 192)
    v = _attn_inputs(dev, dtype, B, 1, Skv, 1, KV, 128, seed=1)[2]
    pos = (off + torch.arange(Sq, device=dev, dtype=torch.int32)).expand(
        B, Sq)
    kv_len = None if kvl is None else torch.tensor(kvl, device=dev,
                                                   dtype=torch.int32)
    _build.reset_launches()
    out = flash_attention(q, k, v, q_positions=pos, kv_valid_len=kv_len)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention"] == 1
    ref = flash_attention_ref(q, k, v, q_offset=pos[:, 0],
                              kv_valid_len=kv_len)
    assert out.shape == (B, Sq, H, 128) and out.dtype == dtype
    _assert_attn_close(out, ref)


def test_attention_kernels_refuse_head_dims_they_are_not_built_for(dev):
    """No fallback: a pair the flash kernel was not compiled for (the
    reduced MLA config's (48, 32), and (192, 192)) and flash-decode at
    (192, 128) raise before any launch."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    _build.reset_launches()
    for hd, hdv in ((48, 32), (192, 192)):
        q, k, _ = _attn_inputs(dev, torch.bfloat16, 1, 8, 16, 4, 4, hd)
        v = _attn_inputs(dev, torch.bfloat16, 1, 1, 16, 1, 4, hdv)[2]
        with pytest.raises(ValueError, match="no kernel for head dims"):
            flash_attention(q, k, v)
    q, k, _ = _attn_inputs(dev, torch.bfloat16, 1, 1, 16, 4, 4, 192)
    v = _attn_inputs(dev, torch.bfloat16, 1, 1, 16, 1, 4, 128)[2]
    with pytest.raises(ValueError, match="no kernel for head dims"):
        decode_attention(q, k, v)
    assert _build.LAUNCHES["flash_attention"] == 0
    assert _build.LAUNCHES["decode_attention"] == 0


def test_attention_kernels_with_no_valid_key_average_uniformly(dev):
    """A sequence with no valid key gets the reference's uniform average
    over every key (the kernels walk the whole range then)."""
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_ref)
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    q, k, v = _attn_inputs(dev, torch.float32, 2, 1, 200, 4, 2, 64)
    kvl = torch.tensor([0, 50], device=dev, dtype=torch.int32)
    p = torch.tensor([[10], [60]], device=dev, dtype=torch.int32)
    torch.testing.assert_close(
        decode_attention(q, k, v, q_positions=p, kv_valid_len=kvl),
        decode_attention_ref(q, k, v, q_positions=p, kv_valid_len=kvl),
        rtol=0, atol=2e-5)
    q2, k2, v2 = _attn_inputs(dev, torch.float32, 2, 70, 200, 4, 2, 64)
    p2 = torch.arange(70, device=dev, dtype=torch.int32).expand(2, 70)
    torch.testing.assert_close(
        flash_attention(q2, k2, v2, q_positions=p2, kv_valid_len=kvl),
        flash_attention_ref(q2, k2, v2, q_offset=p2[:, 0],
                            kv_valid_len=kvl), rtol=0, atol=2e-5)


def test_attention_kernels_read_strided_views_and_refuse_what_they_cannot(
        dev):
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_ref)
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    # the serving prefill's view: some slots' rows of the whole cache,
    # and q's heads as a slice of a wider projection
    q_all, cache_k, cache_v = _attn_inputs(dev, torch.bfloat16, 6, 40, 256,
                                           16, 4, 64)
    q, k, v = (q_all[1:3, :, 4:12], cache_k[2:4, :, 1:3],
               cache_v[2:4, :, 1:3])
    assert not q.is_contiguous() and not k.is_contiguous()
    pos = torch.arange(40, device=dev, dtype=torch.int32).expand(2, 40)
    kvl = torch.tensor([40, 40], device=dev, dtype=torch.int32)
    _assert_attn_close(
        flash_attention(q, k, v, q_positions=pos, kv_valid_len=kvl),
        flash_attention_ref(q, k, v, q_offset=pos[:, 0], kv_valid_len=kvl))
    _assert_attn_close(
        decode_attention(q[:, :1], k, v, q_positions=pos[:, -1:]),
        decode_attention_ref(q[:, :1], k, v, q_positions=pos[:, -1:]))
    _build.reset_launches()
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(*(t[..., :48] for t in (q, k, v)))
    with pytest.raises(ValueError, match="aligned"):
        odd = torch.zeros((2, 40, 8, 65), device=dev,
                          dtype=torch.bfloat16)[..., 1:]
        flash_attention(odd, k, v)
    with pytest.raises(TypeError, match="one dtype"):
        decode_attention(q[:, :1].half(), k.half(), v.half())
    assert _build.LAUNCHES["flash_attention"] == 0
    assert _build.LAUNCHES["decode_attention"] == 0


def test_engine_on_the_card_equals_the_cpu_and_launches_the_kernels(dev):
    """The serving path on the card: every attention call goes through
    the two kernels (one launch per layer per prefill dispatch and per
    decode step), and the greedy tokens equal the plain path's on the
    CPU (float32 compute)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, model_specs
    from repro_torch.models.params import tree_map
    from repro_torch.serving import Request, ServingEngine
    cfg = dataclasses.replace(get_config("granite-3-2b").reduced(),
                              num_kv_heads=2, compute_dtype="float32")
    params = init_params(model_specs(cfg), torch.Generator().manual_seed(0),
                         "cpu", torch.float32)
    rng = np.random.RandomState(0)
    specs = [(rng.randint(1, cfg.vocab_size, L).astype(np.int32), m)
             for L, m in ((5, 6), (9, 4), (5, 3), (17, 5), (9, 2))]
    tokens = {}
    for device in ("cpu", dev):
        eng = ServingEngine(cfg, tree_map(lambda t: t.to(device), params),
                            batch_slots=3, max_len=64,
                            device=device)
        reqs = [Request(prompt=pr, max_new_tokens=m) for pr, m in specs]
        for r in reqs:
            eng.submit(r)
        _build.reset_launches()
        eng.run_until_drained()
        tokens[str(device)] = [r.out_tokens for r in reqs]
        if device != "cpu":
            n = cfg.num_layers
            assert _build.LAUNCHES["flash_attention"] == \
                n * eng.prefill_dispatches
            assert _build.LAUNCHES["decode_attention"] == \
                n * eng.decode_steps
    assert tokens[str(dev)] == tokens["cpu"]


# ---------------------------------------------------------------------------
# WKV6 kernel and the rwkv serving path
# ---------------------------------------------------------------------------

# both sides compute in float32 on the same values (bf16 inputs upcast),
# so only the summation order differs: 1e-5, test_kernels.py's tolerance
WKV_ATOL = 1e-5


def _wkv_inputs(dev, dtype, B, S, H, hd, seed=0):
    """r, k, v at scale 0.3 in ``dtype``, logw = -exp(N(0,1)), u and s0
    at scale 0.1 (tests/test_kernels.py's wkv6 inputs)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda *s, sc=0.3: sc * torch.randn(s, generator=gen, device=dev)
    r, k, v = (mk(B, S, H, hd).to(dtype) for _ in range(3))
    logw = -torch.exp(mk(B, S, H, hd, sc=1.0))
    return r, k, v, logw, mk(H, hd, sc=0.1), mk(B, H, hd, hd, sc=0.1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,hd", [
    (2, 128, 2, 32), (1, 256, 4, 64),         # test_kernels.py's shapes
    (8, 1, 32, 64),                           # rwkv6-1.6b decode
    (3, 1000, 32, 64),                        # ragged prefill
    (1, 1000, 32, 64),                        # one 1000-token prompt
    (2, 37, 4, 32),                           # ragged, hd 32
    # the sequential kernel at a chunk - 1, a chunk and a chunk + 1, and
    # either side of the staged kernel's threshold (2 chunks, 32 steps)
    (2, 15, 2, 64), (2, 16, 2, 64), (2, 17, 2, 64),
    (2, 31, 2, 64), (2, 32, 2, 64), (2, 33, 2, 64),
    (2, 47, 2, 32), (2, 48, 2, 32), (2, 49, 2, 32),   # chunk edges
])
def test_wkv6_kernel_equals_plain(dev, dtype, B, S, H, hd):
    from repro_torch.kernels.rwkv6 import wkv6, wkv6_ref
    ins = _wkv_inputs(dev, dtype, B, S, H, hd)
    _build.reset_launches()
    y, sT = wkv6(*ins)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["wkv6"] == 1
    yr, sTr = wkv6_ref(*ins)
    assert y.dtype == sT.dtype == torch.float32 and y.shape == yr.shape
    torch.testing.assert_close(y, yr, rtol=0, atol=WKV_ATOL)
    torch.testing.assert_close(sT, sTr, rtol=0, atol=WKV_ATOL)


def test_wkv6_kernel_takes_the_worst_decays(dev):
    """Steps of logw = -90 followed by steps of -0.011 (the extremes of
    exp(N(0,1)) over a 4 x 1000 x 32 x 64 draw) and a decay that
    underflows (w = exp(-1e4) = 0), at the staged and the sequential
    lengths."""
    from repro_torch.kernels.rwkv6 import wkv6, wkv6_ref
    for S in (100, 20):
        r, k, v, logw, u, s0 = _wkv_inputs(dev, torch.float32, 2, S, 4, 64,
                                           seed=S)
        logw[:, 5] = -90.0
        logw[:, 6:18] = -0.011
        logw[:, 19, :2] = -1e4
        y, sT = wkv6(r, k, v, logw, u, s0)
        yr, sTr = wkv6_ref(r, k, v, logw, u, s0)
        torch.testing.assert_close(y, yr, rtol=0, atol=WKV_ATOL)
        torch.testing.assert_close(sT, sTr, rtol=0, atol=WKV_ATOL)


@pytest.mark.parametrize("hd", [32, 64])
def test_wkv6_staged_kernel_gives_the_sequential_kernels_bits(dev, hd):
    """From 32 steps the C entry runs the staged kernel, below them the
    sequential one; both do the same float32 operations in the same
    order, so a 40-step call equals two 20-step calls with the state
    carried, bit for bit (the state is float32 between the calls)."""
    from repro_torch.kernels.rwkv6 import wkv6
    for dtype in (torch.float32, torch.bfloat16):
        r, k, v, logw, u, s0 = _wkv_inputs(dev, dtype, 2, 40, 4, hd, seed=7)
        y, sT = wkv6(r, k, v, logw, u, s0)
        y1, s1 = wkv6(r[:, :20], k[:, :20], v[:, :20], logw[:, :20], u, s0)
        y2, s2 = wkv6(r[:, 20:], k[:, 20:], v[:, 20:], logw[:, 20:], u, s1)
        assert torch.equal(torch.cat([y1, y2], 1), y)
        assert torch.equal(s2, sT)


def test_wkv6_kernel_carries_state_writes_in_place_reads_views(dev):
    """Two launches with the state carried equal one; ``inplace`` writes
    the final state over s0; r, k, v may be head slices of a wider
    projection, s0 some slots' rows of a cache."""
    from repro_torch.kernels.rwkv6 import wkv6, wkv6_ref
    r, k, v, logw, u, s0 = _wkv_inputs(dev, torch.bfloat16, 2, 300, 4, 64)
    y, sT = wkv6(r, k, v, logw, u, s0)
    y1, s1 = wkv6(r[:, :123], k[:, :123], v[:, :123], logw[:, :123], u, s0)
    y2, s2 = wkv6(r[:, 123:], k[:, 123:], v[:, 123:], logw[:, 123:], u, s1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, rtol=0,
                               atol=WKV_ATOL)
    torch.testing.assert_close(s2, sT, rtol=0, atol=WKV_ATOL)
    cache = torch.zeros((5, 4, 64, 64), device=dev)
    cache[1:3] = s0
    wide = torch.cat([r, r], dim=2)[:, :, 2:6]          # heads 2..5
    assert not wide.is_contiguous()
    _, out = wkv6(wide, k, v, logw, u, cache[1:3], inplace=True)
    assert out.data_ptr() == cache[1:3].data_ptr()
    torch.testing.assert_close(cache[1:3],
                               wkv6_ref(wide, k, v, logw, u, s0)[1],
                               rtol=0, atol=WKV_ATOL)
    assert not cache[0].any() and not cache[3:].any()


def test_wkv6_kernel_refuses_what_it_cannot_take(dev):
    from repro_torch.kernels.rwkv6 import wkv6
    r, k, v, logw, u, s0 = _wkv_inputs(dev, torch.float32, 2, 5, 2, 32)
    _build.reset_launches()
    with pytest.raises(ValueError, match="head size"):
        wkv6(*(t[..., :16] for t in (r, k, v, logw)), u[:, :16],
             s0[..., :16, :16].contiguous())
    with pytest.raises(TypeError, match="one dtype"):
        wkv6(r.half(), k.half(), v.half(), logw, u, s0)
    with pytest.raises(TypeError, match="float32"):
        wkv6(r, k, v, logw.bfloat16(), u, s0)
    with pytest.raises(ValueError, match="state"):
        wkv6(r, k, v, logw, u, torch.zeros((2, 2, 32, 64),
                                           device=dev)[..., :32])
    with pytest.raises(ValueError, match="CUDA"):
        wkv6(r, k, v, logw, u.cpu(), s0)
    assert _build.LAUNCHES["wkv6"] == 0


def test_rwkv_engine_on_the_card_equals_the_cpu_and_launches_the_kernel(
        dev):
    """The rwkv serving path on the card: every WKV recurrence goes
    through the kernel (one launch per layer per prefill dispatch and
    per decode step), and the greedy tokens equal the plain path's on
    the CPU (float32 compute), with slots recycled."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, model_specs
    from repro_torch.models.params import tree_map
    from repro_torch.serving import Request, ServingEngine
    from _rwkv_draws import redraw_rwkv_torch
    cfg = dataclasses.replace(get_config("rwkv6-1.6b").reduced(),
                              compute_dtype="float32")
    params = init_params(model_specs(cfg), torch.Generator().manual_seed(0),
                         "cpu", torch.float32)
    redraw_rwkv_torch(params, torch.Generator().manual_seed(1))
    rng = np.random.RandomState(0)
    specs = [(rng.randint(1, cfg.vocab_size, L).astype(np.int32), m)
             for L, m in ((5, 6), (9, 4), (5, 3), (17, 5), (9, 2),
                          (70, 3))]
    tokens = {}
    for device in ("cpu", dev):
        eng = ServingEngine(cfg, tree_map(lambda t: t.to(device), params),
                            batch_slots=3, max_len=128, device=device)
        reqs = [Request(prompt=pr, max_new_tokens=m) for pr, m in specs]
        for r in reqs:
            eng.submit(r)
        _build.reset_launches()
        eng.run_until_drained()
        tokens[str(device)] = [r.out_tokens for r in reqs]
        if device != "cpu":
            assert _build.LAUNCHES["wkv6"] == cfg.num_layers * (
                eng.prefill_dispatches + eng.decode_steps)
    assert tokens[str(dev)] == tokens["cpu"]


# ---------------------------------------------------------------------------
# selective-scan kernel and the jamba serving path
# ---------------------------------------------------------------------------

SCAN_RTOL, SCAN_RTOL_BF16 = 1e-5, 2e-2


def _scan_inputs(dev, dtype, B, S, di, ds, seed=0, extra=0):
    """Mamba's init ranges (tests/_mamba_draws.py): a_log = log U(1, 16),
    dt log-uniform in [1e-3, 1e-1]; unit-normal x, b, c; h0 at scale
    0.1. b and c are column slices of one (B, S, extra + 2 ds) tensor,
    as in the model (``extra`` columns of dt_rank before them)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    u = lambda *s: torch.rand(s, generator=gen, device=dev)
    a_log = torch.log(1 + 15 * u(di, ds))
    dt = torch.exp(np.log(1e-3) + np.log(100.0) * u(B, S, di)).to(dtype)
    x = torch.randn((B, S, di), generator=gen, device=dev).to(dtype)
    xdb = torch.randn((B, S, extra + 2 * ds), generator=gen,
                      device=dev).to(dtype)
    h0 = 0.1 * torch.randn((B, di, ds), generator=gen, device=dev)
    return (a_log, dt, xdb[..., extra:extra + ds], xdb[..., extra + ds:], x,
            h0)


def _assert_scan_close(y, hT, yr, hTr):
    for got, want, rtol in ((y, yr, SCAN_RTOL if y.dtype == torch.float32
                             else SCAN_RTOL_BF16), (hT, hTr, SCAN_RTOL)):
        assert got.dtype == want.dtype and got.shape == want.shape
        scale = max(1.0, want.float().abs().max().item())
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=rtol * scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,di,ds", [
    (2, 128, 64, 8), (1, 64, 128, 16),        # test_kernels.py's shapes
    (4, 1000, 16384, 16),                     # jamba prefill, S ragged
    (1, 1000, 16384, 16),                     # one 1000-token prompt
    (8, 1, 16384, 16),                        # jamba decode
    (3, 37, 200, 8),                          # di not a multiple of 128
    # the decode kernel up to its threshold (4 steps), the prefill kernel
    # from 5; ds 8 and a ragged di on the decode kernel
    (8, 4, 16384, 16), (8, 5, 16384, 16), (3, 2, 200, 8),
    # chunk edges (8-step chunks)
    (2, 7, 256, 16), (2, 8, 256, 16), (2, 9, 256, 16), (2, 17, 256, 16),
])
def test_mamba_scan_kernel_equals_plain(dev, dtype, B, S, di, ds):
    from repro_torch.kernels.mamba_scan import mamba_scan, mamba_scan_ref
    ins = _scan_inputs(dev, dtype, B, S, di, ds, extra=ds)
    _build.reset_launches()
    y, hT = mamba_scan(*ins)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["mamba_scan"] == 1
    assert y.dtype == dtype and hT.dtype == torch.float32
    _assert_scan_close(y, hT, *mamba_scan_ref(*ins))


def test_mamba_scan_kernel_carries_state_writes_in_place_reads_views(dev):
    """Two launches of 500 steps with the state carried equal one of
    1000; ``inplace`` writes the final state over h0 (some slots' rows of
    a cache); b and c are strided column slices (checked by the
    contiguous copies giving the same result)."""
    from repro_torch.kernels.mamba_scan import mamba_scan, mamba_scan_ref
    a, dt, b, c, x, h0 = _scan_inputs(dev, torch.bfloat16, 2, 1000, 4096,
                                      16, seed=1, extra=512)
    assert not b.is_contiguous() and b.stride(1) == 512 + 32
    y, hT = mamba_scan(a, dt, b, c, x, h0)
    y1, h1 = mamba_scan(a, dt[:, :500], b[:, :500], c[:, :500],
                        x[:, :500], h0)
    y2, h2 = mamba_scan(a, dt[:, 500:], b[:, 500:], c[:, 500:],
                        x[:, 500:], h1)
    _assert_scan_close(torch.cat([y1, y2], 1), h2, y, hT)
    yc, hc = mamba_scan(a, dt, b.contiguous(), c.contiguous(), x, h0)
    assert torch.equal(yc, y) and torch.equal(hc, hT)
    cache = torch.zeros((5, 4096, 16), device=dev)
    cache[1:3] = h0
    yi, out = mamba_scan(a, dt, b, c, x, cache[1:3], inplace=True)
    assert out.data_ptr() == cache[1].data_ptr()
    assert torch.equal(yi, y) and torch.equal(cache[1:3], hT)
    assert not cache[0].any() and not cache[3:].any()
    _assert_scan_close(y, hT, *mamba_scan_ref(a, dt, b, c, x, h0))


def test_mamba_scan_decode_kernel_in_place_and_unaligned(dev):
    """A decode step writes the state in place over some slots' cache
    rows (the decode kernel, float4 rows); a state that is not 16-byte
    aligned takes the prefill kernel at S = 1, with the same result."""
    from repro_torch.kernels.mamba_scan import mamba_scan, mamba_scan_ref
    a, dt, b, c, x, h0 = _scan_inputs(dev, torch.bfloat16, 3, 1, 4096, 16,
                                      seed=2, extra=512)
    yr, hr = mamba_scan_ref(a, dt, b, c, x, h0)
    cache = torch.zeros((5, 4096, 16), device=dev)
    cache[1:4] = h0
    _build.reset_launches()
    y, out = mamba_scan(a, dt, b, c, x, cache[1:4], inplace=True)
    assert out.data_ptr() == cache[1].data_ptr()
    _assert_scan_close(y, cache[1:4], yr, hr)
    assert not cache[0].any() and not cache[4].any()
    flat = torch.zeros(3 * 4096 * 16 + 1, device=dev)
    odd = flat[1:].view(3, 4096, 16)
    odd.copy_(h0)
    assert odd.data_ptr() % 16 != 0
    yo, ho = mamba_scan(a, dt, b, c, x, odd)
    _assert_scan_close(yo, ho, yr, hr)
    assert _build.LAUNCHES["mamba_scan"] == 2


def test_recurrent_kernels_do_not_sync_the_host(dev):
    """One wkv6 prefill call (the staged kernel) and one mamba_scan
    decode call (the decode kernel, in place over cache rows) under
    ``set_sync_debug_mode("error")``: neither asks the host anything."""
    from repro_torch.kernels.mamba_scan import mamba_scan
    from repro_torch.kernels.rwkv6 import wkv6
    wins = _wkv_inputs(dev, torch.bfloat16, 2, 100, 4, 64)
    a, dt, b, c, x, h0 = _scan_inputs(dev, torch.bfloat16, 8, 1, 4096, 16,
                                      extra=512)
    cache = h0.clone()
    wkv6(*wins)
    mamba_scan(a, dt, b, c, x, cache, inplace=True)     # built and loaded
    torch.cuda.synchronize()
    _build.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        wkv6(*wins)
        mamba_scan(a, dt, b, c, x, cache, inplace=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["wkv6"] == 1 and _build.LAUNCHES["mamba_scan"] == 1


def test_mamba_scan_kernel_refuses_what_it_cannot_take(dev):
    from repro_torch.kernels.mamba_scan import mamba_scan
    a, dt, b, c, x, h0 = _scan_inputs(dev, torch.float32, 2, 5, 256, 16)
    _build.reset_launches()
    with pytest.raises(ValueError, match="state size"):
        mamba_scan(a[:, :4].contiguous(), dt, b[..., :4], c[..., :4], x,
                   h0[..., :4].contiguous())
    with pytest.raises(TypeError, match="a_log must be float32"):
        mamba_scan(a.bfloat16(), dt, b, c, x, h0)
    with pytest.raises(TypeError, match="h0 must be float32"):
        mamba_scan(a, dt, b, c, x, h0.bfloat16())
    with pytest.raises(TypeError, match="one dtype"):
        mamba_scan(a, dt.half(), b.half(), c.half(), x.half(), h0)
    with pytest.raises(ValueError, match="contiguous"):
        mamba_scan(a, dt, b, c, x, h0.transpose(1, 2).contiguous()
                   .transpose(1, 2))
    with pytest.raises(ValueError, match="CUDA"):
        mamba_scan(a.cpu(), dt, b, c, x, h0)
    assert _build.LAUNCHES["mamba_scan"] == 0


def test_mamba_mixer_routes(dev):
    """The three routes of the scan in ``mamba()``: on CUDA tensors
    "kernel" launches the kernel once and "plain" runs the plain version
    (no launch); on CPU tensors "kernel" runs the plain version. All
    three agree (float32)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, mamba, model_specs
    from repro_torch.models.params import tree_map
    from _mamba_draws import redraw_mamba_torch
    cfg = dataclasses.replace(get_config("jamba-1.5-large-398b").reduced(),
                              compute_dtype="float32")
    params = init_params(model_specs(cfg), torch.Generator().manual_seed(0),
                         "cpu", torch.float32)
    redraw_mamba_torch(params, torch.Generator().manual_seed(1))
    w = params["layers"][1]["mixer"]
    x = torch.randn((2, 50, cfg.d_model), generator=torch.Generator()
                    .manual_seed(2))
    outs = {}
    for device, route, launches in (("cpu", "kernel", 0), (dev, "kernel", 1),
                                    (dev, "plain", 0)):
        _build.reset_launches()
        out, _ = mamba.mamba(dataclasses.replace(cfg, attn_impl=route),
                             tree_map(lambda t: t.to(device), w),
                             x.to(device))
        torch.cuda.synchronize()
        assert _build.LAUNCHES["mamba_scan"] == launches
        outs[(str(device), route)] = out.cpu()
    ref = outs[("cpu", "kernel")]
    for out in outs.values():
        torch.testing.assert_close(out, ref, rtol=0, atol=2e-5)


def test_jamba_engine_on_the_card_equals_the_cpu_and_launches_the_kernels(
        dev):
    """The reduced jamba served on the card: every selective scan goes
    through the kernel (one launch per mamba layer per prefill dispatch
    and per decode step), the attention layer through its two kernels,
    and the greedy tokens equal the plain path's on the CPU (float32
    compute, dense MoE), with slots recycled."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, model_specs
    from repro_torch.models.params import tree_map
    from repro_torch.serving import Request, ServingEngine
    from _mamba_draws import redraw_mamba_torch
    cfg = dataclasses.replace(get_config("jamba-1.5-large-398b").reduced(),
                              compute_dtype="float32")
    params = init_params(model_specs(cfg), torch.Generator().manual_seed(0),
                         "cpu", torch.float32)
    redraw_mamba_torch(params, torch.Generator().manual_seed(1))
    n_mamba = sum(m == "mamba" for m, _ in cfg.layer_specs())
    n_attn = cfg.num_layers - n_mamba
    rng = np.random.RandomState(0)
    specs = [(rng.randint(1, cfg.vocab_size, L).astype(np.int32), m)
             for L, m in ((5, 6), (9, 4), (5, 3), (17, 5), (9, 2),
                          (70, 3))]
    tokens = {}
    for device in ("cpu", dev):
        eng = ServingEngine(cfg, tree_map(lambda t: t.to(device), params),
                            batch_slots=3, max_len=128, device=device)
        reqs = [Request(prompt=pr, max_new_tokens=m) for pr, m in specs]
        for r in reqs:
            eng.submit(r)
        _build.reset_launches()
        eng.run_until_drained()
        tokens[str(device)] = [r.out_tokens for r in reqs]
        if device != "cpu":
            assert _build.LAUNCHES["mamba_scan"] == n_mamba * (
                eng.prefill_dispatches + eng.decode_steps)
            assert _build.LAUNCHES["flash_attention"] == \
                n_attn * eng.prefill_dispatches
            assert _build.LAUNCHES["decode_attention"] == \
                n_attn * eng.decode_steps
    assert tokens[str(dev)] == tokens["cpu"]


def test_vlm_engine_on_the_card_equals_the_cpu_and_launches_the_kernels(
        dev):
    """The reduced llama-3.2-vision served on the card with its gates
    redrawn nonzero and seeded vision inputs at every prefill (the
    engine's own are zeros): per prefill dispatch one flash attention
    launch per layer (the 4 self layers causal, the cross layer not), per
    decode step one decode-attention launch per layer (the cross layer's
    over the cached vision rows), and the CPU's greedy tokens (float32
    compute)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, model_specs
    from repro_torch.models.params import tree_map
    from repro_torch.serving import Request, ServingEngine
    cfg = dataclasses.replace(get_config("llama-3.2-vision-90b").reduced(),
                              compute_dtype="float32")
    params = init_params(model_specs(cfg), torch.Generator().manual_seed(0),
                         "cpu", torch.float32)
    for i, (mixer, _) in enumerate(cfg.layer_specs()):
        if mixer == "cross":
            params["layers"][i]["mixer"]["gate"].fill_(0.8)
    rng = np.random.RandomState(0)
    specs = [(rng.randint(1, cfg.vocab_size, L).astype(np.int32), m)
             for L, m in ((5, 6), (9, 4), (5, 3), (17, 5), (9, 2),
                          (70, 3))]
    tokens = {}
    for device in ("cpu", dev):
        eng = ServingEngine(cfg, tree_map(lambda t: t.to(device), params),
                            batch_slots=3, max_len=128, device=device)
        inner, calls = eng._prefill_sample, []

        def prefill(p, batch, cache, inner=inner, calls=calls,
                    device=device):
            n = batch["tokens"].shape[0]
            gen = torch.Generator().manual_seed(len(calls))
            calls.append(n)
            vis = 4 * torch.randn((n, cfg.vision.num_tokens,
                                   cfg.vision.raw_dim), generator=gen)
            return inner(p, dict(batch, vision=vis.to(device)), cache)
        eng._prefill_sample = prefill
        reqs = [Request(prompt=pr, max_new_tokens=m) for pr, m in specs]
        for r in reqs:
            eng.submit(r)
        _build.reset_launches()
        eng.run_until_drained()
        tokens[str(device)] = [r.out_tokens for r in reqs]
        if device != "cpu":
            assert _build.LAUNCHES["flash_attention"] == \
                cfg.num_layers * eng.prefill_dispatches
            assert _build.LAUNCHES["decode_attention"] == \
                cfg.num_layers * eng.decode_steps
    assert tokens[str(dev)] == tokens["cpu"]


# ---------------------------------------------------------------------------
# the decode step as a CUDA graph
# ---------------------------------------------------------------------------

def _graph_vs_eager_decode(eng, prompts, steps=8):
    """Admit ``prompts``; then per step replay the decode graph, put the
    cache back and run the eager step on the same batch: the ids and the
    cache must be equal."""
    from repro_torch.core.graphs import StepGraph
    from repro_torch.serving import Request
    g = eng._decode_sample
    assert isinstance(g, StepGraph)
    for p in prompts:
        eng.submit(Request(prompt=p, max_new_tokens=steps + 4))
    eng.step()                          # admission + the eager warm-up
    eng.step()                          # capture + replay
    assert g.captures == 1
    leaves = [t for layer in eng.cache["layers"] for t in layer.values()]
    for _ in range(steps):
        active = eng._active()
        batch = eng._decode_batch(active)
        saved = [t.clone() for t in leaves]
        ids_g = g(eng.params, batch, eng.cache)[0].cpu()
        after = [t.clone() for t in leaves]
        for t, v in zip(leaves, saved):
            t.copy_(v)
        ids_e = g.fn(eng.params, batch, eng.cache)[0].cpu()
        assert torch.equal(ids_g, ids_e)
        for a, b in zip(after, leaves):
            assert torch.equal(a, b)
        eng._record_decode(active, ids_e.numpy())
    assert g.captures == 1


@pytest.mark.parametrize("arch,moe_impl", [
    ("granite-3-2b", "dense"), ("rwkv6-1.6b", "dense"),
    ("jamba-1.5-large-398b", "dense"), ("jamba-1.5-large-398b", "gshard"),
    ("jamba-1.5-large-398b", "a2a"), ("llama-3.2-vision-90b", "dense"),
    ("musicgen-large", "dense")])
def test_decode_graph_equals_eager_decode(dev, arch, moe_impl):
    """Each reduced model's decode step replayed from its CUDA graph
    gives the eager step's ids and cache bit for bit, 8 steps on the same
    engine state, in bf16 (the served dtype); the gshard and a2a MoEs,
    whose capacity comes from shapes, capture too."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, model_specs
    from repro_torch.serving import ServingEngine
    cfg = get_config(arch).reduced()
    params = init_params(model_specs(cfg), torch.Generator(
        device=dev).manual_seed(0), dev, torch.bfloat16)
    eng = ServingEngine(dataclasses.replace(cfg), params, batch_slots=4,
                        max_len=64, moe_impl=moe_impl, device=dev)
    rng = np.random.RandomState(2)
    _graph_vs_eager_decode(eng, [rng.randint(1, cfg.vocab_size, L)
                                 .astype(np.int32) for L in (5, 9, 5, 12)])


def _mla_card_config():
    """deepseek-v2's reduced config at the full width of its attention
    heads — nope 128 + rope 64, v 128, so that its prefill runs the flash
    kernel at (192, 128) — with a narrow latent and model width."""
    import dataclasses
    from repro_torch.configs import MLAConfig, get_config
    return dataclasses.replace(
        get_config("deepseek-v2-236b").reduced(),
        mla=MLAConfig(kv_lora_rank=64, q_lora_rank=48, qk_nope_head_dim=128,
                      qk_rope_head_dim=64, v_head_dim=128))


def test_mla_engine_on_the_card_equals_the_cpu_and_launches_the_kernel(dev):
    """deepseek-v2's MLA layers served on the card: one flash attention
    launch per MLA layer per prefill dispatch, none at a decode step (the
    absorbed products), and the CPU's greedy tokens (float32 compute)."""
    import dataclasses
    from repro_torch.models import init_params, model_specs
    from repro_torch.models.params import tree_map
    from repro_torch.serving import Request, ServingEngine
    cfg = dataclasses.replace(_mla_card_config(), compute_dtype="float32")
    params = init_params(model_specs(cfg), torch.Generator().manual_seed(0),
                         "cpu", torch.float32)
    rng = np.random.RandomState(0)
    specs = [(rng.randint(1, cfg.vocab_size, L).astype(np.int32), m)
             for L, m in ((5, 6), (9, 4), (5, 3), (17, 5), (9, 2))]
    tokens = {}
    for device in ("cpu", dev):
        eng = ServingEngine(cfg, tree_map(lambda t: t.to(device), params),
                            batch_slots=3, max_len=64, device=device)
        reqs = [Request(prompt=pr, max_new_tokens=m) for pr, m in specs]
        for r in reqs:
            eng.submit(r)
        _build.reset_launches()
        eng.run_until_drained()
        tokens[str(device)] = [r.out_tokens for r in reqs]
        if device != "cpu":
            assert _build.LAUNCHES["flash_attention"] == \
                cfg.num_layers * eng.prefill_dispatches
            assert _build.LAUNCHES["decode_attention"] == 0
    assert tokens[str(dev)] == tokens["cpu"]


@pytest.mark.parametrize("moe_impl", ["dense", "gshard"])
def test_mla_decode_graph_equals_eager_decode(dev, moe_impl):
    """The absorbed MLA decode (its mask made on the device from the
    positions) captures as one CUDA graph whose replays give the eager
    step's ids and latent cache bit for bit, in bf16."""
    from repro_torch.models import init_params, model_specs
    from repro_torch.serving import ServingEngine
    cfg = _mla_card_config()
    params = init_params(model_specs(cfg), torch.Generator(
        device=dev).manual_seed(0), dev, torch.bfloat16)
    eng = ServingEngine(cfg, params, batch_slots=4, max_len=64,
                        moe_impl=moe_impl, device=dev)
    rng = np.random.RandomState(2)
    _graph_vs_eager_decode(eng, [rng.randint(1, cfg.vocab_size, L)
                                 .astype(np.int32) for L in (5, 9, 5, 12)])


# ---------------------------------------------------------------------------
# ST-routed decode on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["st", "host", "fused"])
def test_st_router_on_the_card_equals_its_cpu_route(dev, mode):
    """The router at 4 virtual ranks with MoE dispatch, on the card and on
    the CPU, the same payloads (bf16 KV rows and hidden blocks on the
    card, staged as float32): the committed ids, KV rows and combined
    hidden blocks equal bit for bit; the puts ride put_signal (st and
    fused: with their completion signal) and every post signal a
    counter_bump, and st and fused replay their program graphs."""
    from repro_torch.core.autotune import ScheduleConfig
    from repro_torch.serving import STDecodeRouter
    cfg = ScheduleConfig(nstreams=2, double_buffer=True)
    routers = {d: STDecodeRouter(kv_dim=512, d_model=2048, moe=True,
                                 slot_cap=8, mode=mode, config=cfg, ndev=4,
                                 device=d) for d in (dev, "cpu")}
    gen = torch.Generator(device=dev).manual_seed(4)
    # a graph's first run warms up eagerly before its capture, so the
    # launches are counted once buckets 8 and 1 have each run
    for i, A in enumerate((8, 8, 1, 5, 8, 1, 8)):
        if i == 3:
            _build.reset_launches()
        kv = torch.randn(A, 512, generator=gen, device=dev).bfloat16()
        ids = torch.randint(0, 49155, (A,), generator=gen, device=dev,
                            dtype=torch.int32)
        hid = torch.randn(A, 2048, generator=gen, device=dev).bfloat16()
        got = routers[dev].dispatch(kv, ids, hid=hid)
        want = routers["cpu"].dispatch(kv.cpu(), ids.cpu(), hid=hid.cpu())
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(got[0], ids.cpu().numpy())
    # per epoch: kv, ids and three hidden blocks
    assert _build.LAUNCHES["put_signal"] == 4 * 5
    assert _build.LAUNCHES["counter_bump"] == (
        4 * (1 + 5) if mode == "host" else 4)
    entry = routers[dev]._entries[8]
    cache = {"st": entry.stream._compiled_cache,
             "fused": entry.stream._fused_cache,
             "host": {}}[mode]
    assert len(cache) == (0 if mode == "host" else 1)


@pytest.mark.parametrize("mode", ["st", "fused"])
def test_serve_program_graph_equals_its_eager_emission(dev, mode):
    """The serve program's CUDA graph (st: one; fused: one per segment),
    replayed under sync-debug "error", equals the eager emission of the
    same program and leaves the first result unchanged."""
    from repro_torch.core import get_pattern
    from repro_torch.core.backends import _emit_st
    from repro_torch.core.engine import _emit_fused
    stream = STStream(dev, ("data",), grid_shape=(4,))
    win, _ = get_pattern("serve").build(stream, 2, slots=4, kv_dim=64,
                                        d_model=128, moe=True)
    state = stream.allocate()
    gen = torch.Generator(device=dev).manual_seed(6)
    for name in ("kv", "hid"):
        state[win.qual(name)] = torch.randn(state[win.qual(name)].shape,
                                            generator=gen, device=dev)
    state[win.qual("tok")] = torch.randint(
        0, 1 << 20, state[win.qual("tok")].shape, generator=gen,
        device=dev, dtype=torch.int32)
    first = stream.synchronize(state, mode=mode)
    kept = {k: v.clone() for k, v in first.items()}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        second = stream.synchronize(state, mode=mode)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    prog, = stream.scheduled_programs(fused=mode == "fused")
    eager = (_emit_fused if mode == "fused" else _emit_st)(stream, prog,
                                                           state)
    for k in first:
        assert torch.equal(first[k], kept[k]), k
        assert torch.equal(second[k], first[k]), k
        assert torch.equal(eager[k], first[k]), k
    # rank r commits what rank r - 1 put on the +1 shift
    assert torch.equal(first[win.qual("outtok")],
                       torch.roll(state[win.qual("tok")], 1, 0))
    assert first[win.qual("step")].eq(2).all()


@pytest.mark.parametrize("mode", ["st", "host", "fused"])
def test_granite_st_engine_serves_its_baseline_tokens(dev, mode):
    """A granite-shaped engine (the reduced config, bf16 weights on the
    card, 4 slots, 4 virtual ranks): the ST engine's tokens over more
    than 8 decode steps equal the baseline engine's on the same weights;
    its decode step is still one graph, and the router's program ran
    through its own graph (st, fused) beside it."""
    from repro_torch.configs import get_config
    from repro_torch.core.autotune import ScheduleConfig
    from repro_torch.models import init_params, model_specs
    from repro_torch.serving import Request, ServingEngine
    cfg = get_config("granite-3-2b").reduced()
    params = init_params(model_specs(cfg), torch.Generator(
        device=dev).manual_seed(0), dev, torch.bfloat16)
    tokens, engines = {}, {}
    for st_mode in (None, mode):
        eng = ServingEngine(cfg, params, batch_slots=4, max_len=64,
                            st_mode=st_mode, st_config=ScheduleConfig(),
                            st_ranks=4, device=dev)
        rng = np.random.RandomState(3)
        reqs = [Request(prompt=rng.randint(1, cfg.vocab_size, L)
                        .astype(np.int32), max_new_tokens=m)
                for L, m in ((5, 10), (9, 12), (5, 3), (12, 10), (7, 6))]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        tokens[st_mode], engines[st_mode] = [r.out_tokens for r in reqs], eng
    eng = engines[mode]
    assert eng.decode_steps > 8
    assert tokens[mode] == tokens[None]
    assert eng._decode_sample.captures == 1
    st = eng.stats()["st"]
    assert sum(m["dispatches"] for m in st["buckets"].values()) == \
        eng.decode_steps
    for b, e in eng._router._entries.items():
        graphs = {"st": e.stream._compiled_cache,
                  "fused": e.stream._fused_cache, "host": None}[mode]
        assert graphs is None or len(graphs) == 1


# ---------------------------------------------------------------------------
# the broadcast, ring and expert-parallel a2a transports on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32, torch.uint8], ids=str)
@pytest.mark.parametrize("periodic", [True, False])
def test_put_multicast_equals_plain_version(dev, periodic, dtype):
    """The broadcast's three branches on a (2, 4) grid (and, not
    periodic, branches with -1 entries), rows of 1, 3, 64 and 4096
    elements, aligned and one element off a 16-byte boundary, with and
    without the signal; and a hand-made table with repeated sources and
    an empty branch: bit for bit the plain version, one kernel a call."""
    from repro_torch.kernels.counter_bump import (put_multicast,
                                                  put_multicast_ref)
    stream = STStream(dev, ("row", "col"), periodic=periodic,
                      grid_shape=(2, 4))
    R = stream.num_ranks
    perms = engine._mcast_index(stream, [(0, 1), (0, 2), (0, 3)])
    assert bool((perms < 0).any()) == (not periodic)
    gen = torch.Generator(device=dev).manual_seed(5)
    sig = torch.randint(0, 1 << 20, (R, 3), generator=gen, device=dev,
                        dtype=torch.int32)
    upd = torch.randint(0, 3, (R, 3), generator=gen, device=dev,
                        dtype=torch.int32)
    odd = torch.tensor([[3, -1, 0, 7, 7, -1, 1, 2], [-1] * 8,
                        [0, 1, 2, 3, 4, 5, 6, 7]], device=dev)
    calls = 0
    _build.reset_launches()
    for table in (perms, odd):
        for s in (1, 3, 64, 4096):
            wide = torch.randint(0, 100, (R, s + 1), generator=gen,
                                 device=dev).to(dtype)
            for x in (wide[:, :s].contiguous(), wide[:, 1:]):
                want = put_multicast_ref(x, table)
                got = put_multicast(x, table)
                assert all(torch.equal(g, w) for g, w in zip(got, want))
                got, cnt = put_multicast(x, table, sig, upd)
                assert all(torch.equal(g, w) and g.dtype == dtype
                           for g, w in zip(got, want))
                assert torch.equal(cnt, sig + upd)
                calls += 2
    assert _build.LAUNCHES["put_multicast"] == calls
    x = torch.randn((R, 64), generator=gen, device=dev)
    assert _host_launches(lambda: put_multicast(x, perms, sig, upd)) == 3


def _host_launches(fn, calls=3):
    """Kernel launches the host makes in ``calls`` calls of ``fn()``
    (the profiler's cudaLaunchKernel calls: host events, which a short
    trace does not drop as it can drop device events)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.key.startswith("cudaLaunchKernel"))


def _transport(dev, name):
    """(stream, window, seeded state) of one transport's case on
    ``dev``: the broadcast (2, 4) mc/uni (double-buffered), ring at 4
    ranks, a2a at 4 shards, float32."""
    from repro_torch.core import get_pattern
    pattern, grid, axes, kw = {
        "broadcast_mc": ("broadcast", (2, 4), ("row", "col"),
                         dict(tile=64, multicast=True, double_buffer=True)),
        "broadcast_uni": ("broadcast", (2, 4), ("row", "col"),
                          dict(tile=64, multicast=False,
                               double_buffer=True)),
        "ring": ("ring", (4,), ("data",),
                 dict(batch=2, seq_per_rank=32, heads=4, head_dim=32)),
        "a2a": ("a2a", (4,), ("model",),
                dict(batch=2, seq=16, d_model=64, expert_ff=128,
                     experts=8)),
    }[name]
    stream = STStream(dev, axes, grid_shape=grid)
    win, _ = get_pattern(pattern).build(stream, 3, **kw)
    state = stream.allocate()
    gen = torch.Generator(device="cpu").manual_seed(7)
    seeds = {"broadcast": ("abase", "b"), "ring": ("q", "k", "v"),
             "a2a": ("x", "router", "wg", "wu", "wd")}[pattern]
    for b in seeds:
        k = win.qual(b)
        state[k] = (torch.rand(state[k].shape, generator=gen) * 0.3).to(dev)
    return stream, win, state


@pytest.mark.parametrize("name", ["broadcast_mc", "broadcast_uni", "ring",
                                  "a2a"])
def test_transport_modes_bit_for_bit_on_the_card(dev, name):
    """st and fused (CUDA graphs; the second run a replay under sync-debug
    "error") and host give the same bits, equal to the eager emission of
    the same program; every counter slot that a put or post signal feeds
    is the epoch count; the multicast program is one put_multicast
    launch per descriptor, with its signal (st, fused) or without it
    and a bump (host)."""
    from repro_torch.core.backends import _emit_st
    outs = {}
    for mode in ("st", "host", "fused"):
        stream, win, state = _transport(dev, name)
        stream.synchronize(state, mode=mode)
        torch.cuda.synchronize()
        _build.reset_launches()
        torch.cuda.set_sync_debug_mode("error" if mode != "host" else 0)
        try:
            outs[mode] = stream.synchronize(state, mode=mode)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        prog, = stream.scheduled_programs(fused=mode == "fused")
        mputs = sum(1 for n in prog.puts() if n.mcast_dirs)
        assert _build.LAUNCHES["put_multicast"] == mputs
        assert bool(mputs) == (name == "broadcast_mc")
    prog, = stream.scheduled_programs()
    eager = _emit_st(stream, prog, state)
    for mode, out in outs.items():
        for k, v in out.items():
            assert torch.equal(v, eager[k]), (mode, k)
    for k, v in eager.items():
        if k.endswith("post_sig") or k.endswith("post_sig__pp"):
            assert int(v.max()) > 0 and int(v.min()) == int(v.max()), k
    if name == "broadcast_mc":
        stream_u, _, state_u = _transport(dev, "broadcast_uni")
        uni = stream_u.synchronize(state_u, mode="st")
        for k, v in uni.items():
            assert torch.equal(v, eager[k]), k


def test_program_graph_copies_out_only_what_it_writes(dev):
    """The a2a program reads its tokens, router and expert weights and
    writes none: a run returns the caller's tensors for them, so it
    allocates only the fresh copies of what it wrote (counted in bytes,
    rounded to the allocator's 512-byte blocks)."""
    stream, win, state = _transport(dev, "a2a")
    first = stream.synchronize(state, mode="st")
    g, = stream._compiled_cache.values()
    read_only = {win.qual(k) for k in ("x", "router", "wg", "wu", "wd")}
    assert set(state) - set(g.written) == read_only
    for k in read_only:
        assert first[k] is state[k]
    copied = g.copied_bytes()
    sizes = {k: v.numel() * v.element_size() for k, v in state.items()}
    assert copied["in"] == sum(sizes.values())
    assert copied["out"] == sum(sizes[k] for k in g.written)
    del first
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    second = stream.synchronize(state, mode="st")
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated(dev) - before
    assert grown == sum(-(-sizes[k] // 512) * 512 for k in g.written)
    assert all(second[k] is state[k] for k in read_only)


# ---------------------------------------------------------------------------
# training: the kernels under autograd, a train step, the checkpointer
# ---------------------------------------------------------------------------

def _function_case(fn, ref, args, grad_idx, g):
    """The Function's forward against the bare kernel (no grad), its
    gradients against autograd through the plain version; returns the
    largest gradient difference."""
    leaves = [a.clone().requires_grad_(i in grad_idx)
              for i, a in enumerate(args)]
    with torch.no_grad():
        bare = fn(*args)
    out = fn(*leaves)
    outs = out if isinstance(out, tuple) else (out,)
    bares = bare if isinstance(bare, tuple) else (bare,)
    for a, b in zip(outs, bares):
        assert torch.equal(a, b)
    outs[0].backward(g)
    plain = [a.clone().requires_grad_(i in grad_idx)
             for i, a in enumerate(args)]
    r = ref(*plain)
    (r[0] if isinstance(r, tuple) else r).backward(g)
    for i in grad_idx:         # at S = 1 logw takes no part: both None
        if plain[i].grad is None:
            assert leaves[i].grad is None, i
            continue
        assert torch.isfinite(leaves[i].grad).all()
        assert torch.equal(leaves[i].grad, plain[i].grad), i


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [16, 77])
def test_flash_attention_function_equals_plain_version(dev, dtype, S):
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    gen = torch.Generator(device=dev).manual_seed(S)
    B, H, KV, hd = 2, 4, 2, 64
    q, k, v, g = (torch.randn((B, S, h, hd), generator=gen,
                              device=dev).to(dtype)
                  for h in (H, KV, KV, H))
    pos = torch.arange(S, device=dev, dtype=torch.int32)[None].expand(B, S)
    _function_case(
        lambda *a: flash_attention(*a, q_positions=pos),
        lambda *a: flash_attention_ref(*a, q_offset=pos[:, 0]),
        (q, k, v), (0, 1, 2), g)


@pytest.mark.parametrize("S", [1, 40])
def test_wkv6_function_equals_plain_version(dev, S):
    from repro_torch.kernels.rwkv6 import wkv6, wkv6_ref
    gen = torch.Generator(device=dev).manual_seed(S)
    B, H, hd = 2, 2, 32
    r, k, v = (torch.randn((B, S, H, hd), generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    logw = -torch.exp(torch.randn((B, S, H, hd), generator=gen, device=dev)
                      - 2.0)
    u = 0.5 * torch.randn((H, hd), generator=gen, device=dev)
    s0 = torch.randn((B, H, hd, hd), generator=gen, device=dev)
    g = torch.randn((B, S, H, hd), generator=gen, device=dev)
    _function_case(wkv6, wkv6_ref, (r, k, v, logw, u, s0),
                   (0, 1, 2, 3, 4, 5), g)


@pytest.mark.parametrize("S", [1, 33])
def test_mamba_scan_function_equals_plain_version(dev, S):
    from repro_torch.kernels.mamba_scan import mamba_scan, mamba_scan_ref
    gen = torch.Generator(device=dev).manual_seed(S)
    B, di, ds = 2, 64, 8
    a_log = 0.5 * torch.randn((di, ds), generator=gen, device=dev)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, di), generator=gen, device=dev) - 2.0)
    b, c = (torch.randn((B, S, ds), generator=gen, device=dev)
            for _ in range(2))
    xc = torch.randn((B, S, di), generator=gen, device=dev)
    h0 = torch.randn((B, di, ds), generator=gen, device=dev)
    g = torch.randn((B, S, di), generator=gen, device=dev)
    _function_case(mamba_scan, mamba_scan_ref, (a_log, dt, b, c, xc, h0),
                   (0, 1, 2, 3, 4, 5), g)


def test_inplace_call_needing_a_gradient_raises(dev):
    from repro_torch.kernels.rwkv6 import wkv6
    r = torch.zeros((1, 2, 1, 32), device=dev, requires_grad=True)
    with pytest.raises(ValueError):
        wkv6(r, r, r, r.detach() - 1, torch.zeros((1, 32), device=dev),
             torch.zeros((1, 1, 32, 32), device=dev), inplace=True)


@pytest.mark.parametrize("arch", ["granite-3-2b", "rwkv6-1.6b",
                                  "jamba-1.5-large-398b"])
def test_train_step_through_the_kernels_equals_the_plain_route(dev, arch):
    """A reduced config in float32, its remat mode "dots": the loss and
    gradients of one step through the kernels against the plain route
    on the card (1e-5 relative; 1e-4 of the largest |grad|)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.models import init_params, model_specs, trainable
    from repro_torch.train.steps import value_and_grad
    base = dataclasses.replace(get_config(arch).reduced(),
                               compute_dtype="float32", remat="dots")
    ds = SyntheticTokens(vocab_size=base.vocab_size, seq_len=64,
                         global_batch=2, seed=0)
    b = {k: torch.from_numpy(v).to(dev) for k, v in ds.batch_at(0).items()}
    res = {}
    for route in ("kernel", "plain"):
        cfg = dataclasses.replace(base, attn_impl=route)
        params = trainable(init_params(
            model_specs(cfg), torch.Generator(device=dev).manual_seed(0),
            device=dev))
        _build.reset_launches()
        loss, _, g = value_and_grad(cfg, "dense", params, b)
        res[route] = (float(loss), g, dict(_build.LAUNCHES))
    (lk, gk, nk), (lp, gp, np_) = res["kernel"], res["plain"]
    assert abs(lk - lp) <= 1e-5 * abs(lp)
    scale = max(float(t.abs().max()) for t in gp)
    assert max(float((a - c).abs().max()) for a, c in zip(gk, gp)) \
        <= 1e-4 * scale
    kernel = {"granite-3-2b": "flash_attention", "rwkv6-1.6b": "wkv6",
              "jamba-1.5-large-398b": "mamba_scan"}[arch]
    assert nk[kernel] > 0 and np_[kernel] == 0


def test_checkpoint_bf16_round_trip_from_the_device(dev, tmp_path):
    from repro_torch.checkpoint import Checkpointer
    gen = torch.Generator(device=dev).manual_seed(0)
    tree = {"w": torch.randn((64, 32), generator=gen, device=dev),
            "m": torch.randn((64, 32), generator=gen,
                             device=dev).to(torch.bfloat16),
            "count": torch.tensor(5, dtype=torch.int32, device=dev)}
    ck = Checkpointer(str(tmp_path), async_save=True)
    ck.save(5, tree)
    want = {k: v.clone() for k, v in tree.items()}
    tree["m"].add_(1)                       # after the snapshot
    ck.wait()
    like = {k: torch.empty_like(v) for k, v in tree.items()}
    on_cpu, step, _ = ck.restore(like, device="cpu")
    assert step == 5
    for k, v in on_cpu.items():
        assert v.device.type == "cpu" and v.dtype == want[k].dtype
        assert torch.equal(v, want[k].cpu())
    back, _, _ = ck.restore({k: v for k, v in on_cpu.items()}, device=dev)
    for k, v in back.items():
        assert v.device == want[k].device and torch.equal(v, want[k])


def test_accounting_bytes_equal_the_live_tensors_on_the_card(dev):
    """The dry run's spec-counted bytes (one card, no mesh) against the
    tensors on the card: a reduced granite train step's float32 masters
    and AdamW state after one step, and the reduced served engine's bf16
    weights and cache after a request: exactly their summed nbytes."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch.dryrun_lib import state_bytes
    from repro_torch.models import init_params, model_specs, trainable
    from repro_torch.models.params import tree_leaves
    from repro_torch.optim import opt_init
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.sharding import make_rules
    from repro_torch.train.steps import make_train_step
    nbytes = lambda t: sum(x.numel() * x.element_size()
                           for x in tree_leaves(t))
    cfg = get_config("granite-3-2b").reduced()
    rules = make_rules(cfg, None, None)
    params = trainable(init_params(
        model_specs(cfg), torch.Generator(device=dev).manual_seed(0), dev))
    opt = opt_init(cfg, params)
    ds = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=64,
                         global_batch=2, seed=0)
    b = {k: torch.from_numpy(v).to(dev) for k, v in ds.batch_at(0).items()}
    params, opt, _ = make_train_step(cfg)(params, opt, b)
    st = state_bytes(cfg, "train", 2, 64, rules)
    assert (st["params"], st["opt_state"], st["batch"]) == (
        nbytes(params), nbytes(opt), nbytes(b))
    served = init_params(model_specs(cfg),
                         torch.Generator(device=dev).manual_seed(0), dev,
                         torch.bfloat16)
    eng = ServingEngine(cfg, served, batch_slots=4, max_len=64, device=dev)
    eng.submit(Request(prompt=np.array([1, 2, 3], np.int32),
                       max_new_tokens=4))
    eng.run_until_drained()
    st = state_bytes(cfg, "decode", 4, 1, rules, cache_len=64)
    assert (st["params"], st["cache"]) == (nbytes(served), nbytes(eng.cache))
