"""The port's CUDA kernels and its Faces path on the card.

Marked ``cuda``: skipped without an NVIDIA card (a CUDA kernel has no
CPU mode), run on the card with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Each kernel must equal its plain PyTorch version exactly, and Faces on
the card must equal Faces on the CPU bit for bit in every mode.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import STStream, halo
from repro_torch.kernels import _build
from repro_torch.kernels.counter_bump import counter_bump
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


@pytest.mark.parametrize("n", [(4, 4, 4), (6, 5, 4), (1, 3, 2), (2, 1, 3),
                               (3, 3, 3), (16, 8, 4)])
def test_halo_kernels_equal_plain_versions(dev, n):
    gen = torch.Generator(device=dev).manual_seed(0)
    field = torch.randn((5,) + n, generator=gen, device=dev)
    _build.reset_launches()
    for a, b in zip(halo_pack_split(field), ref.halo_pack_split_ref(field)):
        assert torch.equal(a, b)
    flat = halo_pack(field)
    assert torch.equal(flat, ref.halo_pack_ref(field))
    recv = torch.randn(flat.shape, generator=gen, device=dev)
    assert torch.equal(halo_unpack(recv, n), ref.halo_unpack_ref(recv, n))
    parts = [p.contiguous() for p in
             torch.split(recv, [p.shape[1] for p in
                                halo_pack_split(field)], dim=1)]
    assert torch.equal(halo_unpack_split(parts, n),
                       ref.halo_unpack_split_ref(parts, n))
    assert _build.LAUNCHES["halo_pack"] == 3
    assert _build.LAUNCHES["halo_unpack"] == 2


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
