"""The port's checkpointer: round trip, checksum verify, atomic commit,
retention, async mode, bf16 leaves, restore onto another device, and
the layout of the JAX package's (the same keys and checksums for the
same float32 tree)."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import save_checkpoint as j_save_checkpoint
from repro_torch.checkpoint import (Checkpointer, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.models.params import tree_leaves, tree_map


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(4, 4, generator=g),
                       "b": torch.zeros(4),
                       "layers": [{"h": torch.randn(3, generator=g)
                                   .to(torch.bfloat16)}]},
            "opt": {"count": torch.tensor(7, dtype=torch.int32)}}


def _like(t):
    return tree_map(torch.zeros_like, t)


def _equal(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_roundtrip(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 10, t, {"note": "x"})
    restored, step, extra = restore_checkpoint(str(tmp_path), _like(t))
    assert step == 10 and extra == {"note": "x"}
    _equal(restored, t)


def test_bf16_leaves_stored_as_their_bits(tmp_path):
    t = _tree()
    d = save_checkpoint(str(tmp_path), 1, t)
    m = json.load(open(os.path.join(d, "manifest.json")))
    key = "['params']['layers'][0]['h']"
    assert m["leaf_dtypes"] == {key: "bfloat16"}
    with np.load(os.path.join(d, "shard_00000.npz")) as z:
        assert z[key].dtype == np.uint16
        bits = t["params"]["layers"][0]["h"].view(torch.int16).numpy()
        np.testing.assert_array_equal(z[key], bits.view(np.uint16))
    restored, _, _ = restore_checkpoint(str(tmp_path), _like(t))
    assert restored["params"]["layers"][0]["h"].dtype == torch.bfloat16


def test_checksum_detects_corruption(tmp_path):
    t = _tree()
    d = save_checkpoint(str(tmp_path), 1, t)
    mpath = os.path.join(d, "manifest.json")
    m = json.load(open(mpath))
    key = next(iter(m["leaf_checksums"]))
    m["leaf_checksums"][key] ^= 0xFF
    json.dump(m, open(mpath, "w"))
    with pytest.raises(IOError):
        restore_checkpoint(str(tmp_path), _like(t))


def test_incomplete_tmp_ignored(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 5, t)
    os.makedirs(os.path.join(str(tmp_path), "step_00000009.tmp"))
    assert latest_step(str(tmp_path)) == 5
    _, step, _ = restore_checkpoint(str(tmp_path), _like(t))
    assert step == 5


def test_retention_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2, async_save=False)
    t = _tree()
    for s in (1, 2, 3, 4):
        ck.save(s, t)
    kept = sorted(n for n in os.listdir(str(tmp_path))
                  if n.startswith("step_"))
    assert kept == ["step_00000003", "step_00000004"]


def test_async_save_snapshots_before_returning(tmp_path):
    """The async save writes the values of the call, though the caller
    updates its tensors in place right after."""
    ck = Checkpointer(str(tmp_path), async_save=True)
    t = _tree()
    want = tree_map(lambda x: x.clone(), t)
    ck.save(42, t)
    for x in tree_leaves(t):
        x.add_(1)
    ck.wait()
    restored, step, _ = ck.restore(_like(t))
    assert step == 42
    _equal(restored, want)


def test_async_error_raised_at_wait(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ck = Checkpointer(str(blocker), async_save=True)
    ck.save(1, _tree())
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()                       # raised once


def test_restore_onto_another_device(tmp_path):
    """Leaves go to ``device`` whatever the template's device (the
    single-device counterpart of the reference's re-sharding restore);
    requires_grad follows the template."""
    t = _tree()
    save_checkpoint(str(tmp_path), 3, t)
    like = tree_map(lambda x: torch.empty_like(x, device="meta"), t)
    like["params"]["w"].requires_grad_(True)
    restored, _, _ = restore_checkpoint(str(tmp_path), like, device="cpu")
    assert all(x.device.type == "cpu" for x in tree_leaves(restored))
    assert restored["params"]["w"].requires_grad
    assert not restored["params"]["b"].requires_grad
    _equal(tree_map(lambda x: x.detach(), restored), t)


def test_layout_is_the_references(tmp_path):
    """A float32/int32 tree saved by both: the same npz keys, arrays and
    checksums, and each restores the other's."""
    t = _tree()
    del t["params"]["layers"]
    a = save_checkpoint(str(tmp_path / "port"), 1, t)
    b = j_save_checkpoint(str(tmp_path / "ref"), 1,
                          tree_map(lambda x: x.numpy(), t))
    ma = json.load(open(os.path.join(a, "manifest.json")))
    mb = json.load(open(os.path.join(b, "manifest.json")))
    assert ma["leaf_checksums"] == mb["leaf_checksums"]
    assert ma["num_leaves"] == mb["num_leaves"]
    restored, _, _ = restore_checkpoint(str(tmp_path / "ref"), _like(t))
    _equal(restored, t)
