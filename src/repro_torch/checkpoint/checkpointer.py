"""Fault-tolerant checkpointing, following the JAX package's
``checkpoint/checkpointer.py``:

  * one ``shard_00000.npz`` of the tree's leaves, keyed by tree path
    (``['params']['layers'][0]['mixer']['wq']``, the reference's
    ``keystr`` form);
  * a ``manifest.json`` with the step, a crc32 per leaf, ``num_leaves``,
    ``extra`` and ``format``, and the dtype of each leaf numpy cannot
    hold: a bf16 leaf is stored as its 16-bit patterns (uint16), its
    dtype in ``leaf_dtypes``, its crc over those bytes;
  * two-phase commit: written to ``step_<n>.tmp/``, fsynced, renamed to
    ``step_<n>/``, so a crash mid-write never corrupts the newest
    checkpoint and incomplete directories are ignored;
  * async mode: a background thread writes (at most one save
    outstanding; its error is raised at the next ``wait``). The save
    snapshots every leaf to host memory before it returns, so the
    caller may go on updating its tensors in place;
  * restore picks the newest complete step, verifies the checksums and
    puts each leaf on ``device`` (the reference's ``shardings``): a
    checkpoint written on the card restores on the CPU and back.

Leaves are tensors (restored as tensors, ``requires_grad`` as the
template's) or numpy arrays and Python numbers (restored as numpy).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models.params import tree_paths, tree_unflatten

FORMAT = 1


def _keystr(path) -> str:
    return "".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]"
                   for k in path)


def _to_host(leaf):
    """(numpy array, dtype name or None): a snapshot of the leaf on the
    host; a bf16 tensor as its uint16 bit patterns."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), None
    return np.array(leaf, copy=True), None


def _snapshot(tree):
    flat = {}
    for path, leaf in tree_paths(tree):
        flat[_keystr(path)] = _to_host(leaf)
    return flat


def _write(ckpt_dir: str, step: int, flat: dict,
           extra: Optional[dict]) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"step_{step:08d}.tmp")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays = {k: a for k, (a, _) in flat.items()}
    manifest = {
        "step": step,
        "leaf_checksums": {k: zlib.crc32(a.tobytes()) & 0xFFFFFFFF
                           for k, a in arrays.items()},
        "leaf_dtypes": {k: dt for k, (_, dt) in flat.items() if dt},
        "num_leaves": len(arrays),
        "extra": extra or {},
        "format": FORMAT,
    }
    shard = os.path.join(tmp, "shard_00000.npz")
    with open(shard, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)          # atomic commit
    return final


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    extra: Optional[dict] = None) -> str:
    """Synchronous two-phase-commit save; returns the step's directory."""
    return _write(ckpt_dir, step, _snapshot(tree), extra)


def _complete_steps(ckpt_dir: str) -> list:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(
        int(n.split("_")[1]) for n in os.listdir(ckpt_dir)
        if n.startswith("step_") and not n.endswith(".tmp")
        and os.path.exists(os.path.join(ckpt_dir, n, "manifest.json")))


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _complete_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, tree_like: Any,
                       step: Optional[int] = None, device=None,
                       verify: bool = True):
    """Restore into the structure of ``tree_like``; returns (tree, step,
    extra). A tensor leaf of ``tree_like`` comes back as a tensor of the
    stored dtype on ``device`` (default: the template leaf's device),
    ``requires_grad`` as the template's; any other leaf as a numpy
    array. Raises FileNotFoundError without a complete checkpoint and
    IOError on a checksum mismatch."""
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    dtypes = manifest.get("leaf_dtypes", {})
    out = []
    with np.load(os.path.join(d, "shard_00000.npz")) as data:
        for path, like in tree_paths(tree_like):
            key = _keystr(path)
            arr = data[key]
            if verify:
                crc = zlib.crc32(arr.tobytes()) & 0xFFFFFFFF
                if crc != manifest["leaf_checksums"][key]:
                    raise IOError(f"checksum mismatch for {key} at step "
                                  f"{step}")
            if not isinstance(like, torch.Tensor):
                out.append(arr)
                continue
            t = torch.from_numpy(np.array(arr))
            if dtypes.get(key) == "bfloat16":
                t = t.view(torch.int16).view(torch.bfloat16)
            t = t.to(device if device is not None else like.device)
            if like.requires_grad:
                t.requires_grad_(True)
            out.append(t)
    return tree_unflatten(tree_like, out), step, manifest["extra"]


class Checkpointer:
    """Async double-buffered checkpointer with retention of ``keep``."""

    def __init__(self, ckpt_dir: str, keep: int = 3, async_save: bool = True):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        self.wait()   # at most one outstanding save
        # snapshot to host memory NOW so training can mutate buffers
        flat = _snapshot(tree)

        def work():
            try:
                _write(self.ckpt_dir, step, flat, extra)
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        if self.async_save:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
            self._raise_if_failed()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def restore(self, tree_like, device=None, step=None):
        return restore_checkpoint(self.ckpt_dir, tree_like, step=step,
                                  device=device)

    def _gc(self):
        for s in _complete_steps(self.ckpt_dir)[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"),
                          ignore_errors=True)
