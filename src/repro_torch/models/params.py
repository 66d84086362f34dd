"""Parameter specs and their materialization.

Models are described as trees (dicts and lists) of ``ParamSpec``: shape,
logical axes and init, as in the JAX package's ``models/params.py``.
The port materializes them as trees of tensors on one device:

  * :func:`init_params` — seeded random params (a ``torch.Generator``);
  * :func:`from_reference` — the JAX package's parameter tree, given as
    numpy arrays, as the port's tree (the tests hand both frameworks the
    same weights this way).

Unlike the reference, which stacks its repeated layers on a leading
axis for ``lax.scan``, the port keeps one dict of params per layer in
``params["layers"]``: PyTorch runs the layers as a Python loop.

Dtypes: weights (leaves of two or more dims) are cast to the compute
dtype once, at load — the reference casts its float32 params at every
use (``.astype(dt)``), which gives the same values. One-dim leaves stay
float32, and each user applies them as the reference does: RMSNorm
scales in float32, but rwkv's token-shift mixes and ``ln_x`` cast to the
compute dtype at use (``models/rwkv.py``), its ``w0`` and ``bonus`` in
float32. The leaves of :data:`FLOAT32_LEAVES` stay float32 whatever their
rank: mamba's ``a_log`` (di, d_state), which the reference's scan reads
in float32 and never casts (bf16 would move every decay rate by up to
0.4 %).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.compat import resolve_device


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    axes: tuple                   # logical axis name (or None) per dim
    init: str = "normal"          # normal | zeros | ones
    scale: Optional[float] = None  # stddev for normal (None -> 1/sqrt(fan_in))
    dtype: Any = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             "differ in length")


def tree_map(fn, tree):
    """``fn`` applied to every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    """Leaves in a fixed order: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _fan_in(shape) -> int:
    if len(shape) == 0:
        return 1
    if len(shape) == 1:
        return shape[0]
    return int(np.prod(shape[:-1]))


# leaves kept in float32 whatever their rank (see the module doc)
FLOAT32_LEAVES = frozenset({"a_log"})


def leaf_dtype(shape, dtype: torch.dtype, name=None) -> torch.dtype:
    """The dtype the leaf ``name`` is kept in: ``dtype`` for weights (two
    or more dims), float32 for scalars and vectors (norm scales, rwkv's
    mixes, decay and bonus; their users cast them as the reference does)
    and for the leaves of :data:`FLOAT32_LEAVES`."""
    if len(shape) >= 2 and name not in FLOAT32_LEAVES:
        return dtype
    return torch.float32


def init_params(spec_tree, generator: torch.Generator, device="cuda",
                dtype: torch.dtype = torch.float32):
    """Materialize params on ``device`` (CUDA unless the caller asks for
    the CPU; raises without a card): normal leaves draw float32 from
    ``generator`` (which must live on ``device``), leaf by leaf in
    :func:`tree_leaves` order, scaled by their std and cast to
    :func:`leaf_dtype`. A fixed seed gives fixed params; they are not the
    JAX package's numbers (use :func:`from_reference` for those)."""
    device = resolve_device(device)

    def make(spec: ParamSpec, name):
        dt = leaf_dtype(spec.shape, dtype, name)
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dt, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dt, device=device)
        std = (spec.scale if spec.scale is not None
               else 1.0 / np.sqrt(_fan_in(spec.shape)))
        x = torch.randn(spec.shape, generator=generator, device=device,
                        dtype=torch.float32)
        return x.mul_(std).to(dt)

    def build(tree, name=None):    # draws in tree_leaves order
        if isinstance(tree, dict):
            return {k: build(tree[k], k) for k in sorted(tree)}
        if isinstance(tree, (list, tuple)):
            return [build(v) for v in tree]
        return make(tree, name)

    return build(spec_tree)


def zeros_from_specs(spec_tree, device="cuda"):
    """Zeroed buffers of each spec's own shape and dtype (KV caches) on
    ``device`` (CUDA unless the caller asks for the CPU)."""
    device = resolve_device(device)
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                          device=device), spec_tree)


def param_count(spec_tree) -> int:
    return int(sum(np.prod(s.shape) for s in tree_leaves(spec_tree)))


def stack_specs(spec_tree, n: int):
    """Stack a spec tree along a new leading 'layers' axis (the
    reference's scan groups; :func:`from_reference` undoes it)."""
    return tree_map(
        lambda s: dataclasses.replace(
            s, shape=(n,) + tuple(s.shape), axes=("layers",) + tuple(s.axes)),
        spec_tree)


def _to_tensor(a, device, dtype, name) -> torch.Tensor:
    a = np.array(a)                       # a writable copy
    if a.dtype.kind not in "biu" and a.dtype not in (np.float32, np.float64,
                                                     np.float16):
        # bfloat16 and kin (ml_dtypes' kind is "V", not "f")
        a = a.astype(np.float32)
    return torch.from_numpy(a).to(
        device=device, dtype=leaf_dtype(a.shape, dtype, name))


def _convert(tree, device, dtype, name=None):
    """A numpy tree as tensors, each leaf by :func:`leaf_dtype` of its
    key."""
    if isinstance(tree, dict):
        return {k: _convert(v, device, dtype, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, device, dtype) for v in tree]
    return _to_tensor(tree, device, dtype, name)


def from_reference(cfg, tree, device="cuda",
                   dtype: torch.dtype = torch.float32):
    """The JAX package's param tree (numpy leaves, e.g.
    ``jax.tree.map(np.asarray, params)``) as the port's tree on
    ``device`` (CUDA unless the caller asks for the CPU).

    The reference keeps ``{"embed", "final_norm", "prefix": [block],
    "unit": [stacked block]}``, where ``unit[j]``'s leaves carry a
    leading axis over the unit's repeats: ``unit[j][...][i]`` is layer
    ``len(prefix) + i * len(unit) + j``. The port's tree is ``{"embed",
    "final_norm", "layers": [block] * num_layers}``.
    """
    groups = cfg.layer_groups()
    device = resolve_device(device)
    conv = lambda t: _convert(t, device, dtype)
    layers = [conv(b) for b in tree["prefix"]]
    unit = tree["unit"]
    for i in range(groups.repeats):
        for j in range(len(groups.unit)):
            layers.append(conv(tree_map(lambda a: np.asarray(a)[i],
                                        unit[j])))
    if len(layers) != cfg.num_layers:
        raise ValueError(f"reference tree has {len(layers)} layers, "
                         f"config {cfg.name} has {cfg.num_layers}")
    out = {k: conv(v) for k, v in tree.items()
           if k not in ("prefix", "unit")}
    out["layers"] = layers
    return out
