"""Parameter specs and their materialization.

Models are described as trees (dicts and lists) of ``ParamSpec``: shape,
logical axes and init, as in the JAX package's ``models/params.py``.
The port materializes them as trees of tensors on one device:

  * :func:`init_params` — seeded random params (a ``torch.Generator``);
  * :func:`from_reference` — the JAX package's parameter tree, given as
    numpy arrays, as the port's tree (the tests hand both frameworks the
    same weights this way);
  * :func:`abstract_params`, :func:`abstract_init_params` — tensors on
    the meta device, no allocation; :func:`param_pspecs` — partition
    specs through sharding rules (the accounting, ``launch/``).

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


def tree_unflatten(tree, leaves):
    """A tree of ``tree``'s structure holding ``leaves``, given in
    :func:`tree_leaves` order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)
    return build(tree)


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


# ---------------------------------------------------------------------------
# Accounting: meta tensors and partition specs (no allocation)
# ---------------------------------------------------------------------------

META = torch.device("meta")


def abstract_params(spec_tree, dtype: Optional[torch.dtype] = torch.float32):
    """Tensors on the meta device in the specs' shapes, each in ``dtype``
    (each spec's own dtype where ``dtype`` is None): the reference's
    ``ShapeDtypeStruct`` stand-ins, safe at any scale, no allocation."""
    return tree_map(lambda s: torch.empty(
        s.shape, dtype=s.dtype if dtype is None else dtype, device=META),
        spec_tree)


def abstract_init_params(spec_tree, dtype: torch.dtype = torch.float32):
    """The meta tensors :func:`init_params` would make at ``dtype``: each
    leaf in its :func:`leaf_dtype` (weights in ``dtype``, vectors and
    :data:`FLOAT32_LEAVES` float32), as the port holds them."""
    def build(tree, name=None):
        if isinstance(tree, dict):
            return {k: build(v, k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [build(v) for v in tree]
        return torch.empty(tree.shape, device=META,
                           dtype=leaf_dtype(tree.shape, dtype, name))
    return build(spec_tree)


def param_axes(spec_tree):
    return tree_map(lambda s: s.axes, spec_tree)


def param_pspecs(spec_tree, rules):
    """Tree of partition specs (tuples) derived via sharding rules."""
    return tree_map(lambda s: rules.pspec(s.axes), spec_tree)


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
    """A numpy leaf as a tensor of :func:`leaf_dtype`, or, with ``dtype``
    None, of the leaf's own dtype (bf16 numpy leaves as torch.bfloat16)."""
    a = np.array(a)                       # a writable copy
    own = torch.bfloat16 if a.dtype.name == "bfloat16" else None
    if a.dtype.kind not in "biu" and a.dtype not in (np.float32, np.float64,
                                                     np.float16):
        # bfloat16 and kin (ml_dtypes' kind is "V", not "f")
        a = a.astype(np.float32)
    t = torch.from_numpy(a)
    if dtype is None:
        return t.to(device=device, dtype=own or t.dtype)
    return t.to(device=device, dtype=leaf_dtype(a.shape, dtype, name))


def _convert(tree, device, dtype, name=None):
    """A numpy tree as tensors, each leaf by :func:`leaf_dtype` of its
    key (its own dtype with ``dtype`` None)."""
    if isinstance(tree, dict):
        return {k: _convert(v, device, dtype, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, device, dtype) for v in tree]
    return _to_tensor(tree, device, dtype, name)


def from_reference(cfg, tree, device="cuda",
                   dtype: Optional[torch.dtype] = torch.float32):
    """The JAX package's param tree (numpy leaves, e.g.
    ``jax.tree.map(np.asarray, params)``) as the port's tree on
    ``device`` (CUDA unless the caller asks for the CPU). Leaves take
    :func:`leaf_dtype` of ``dtype``, or with ``dtype=None`` their own
    dtype (an optimizer's moments).

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


# ---------------------------------------------------------------------------
# Training: the reference's leaf groups, trainable masters, optimizer state
# ---------------------------------------------------------------------------

def tree_paths(tree, prefix=()):
    """(path, leaf) pairs in :func:`tree_leaves` order; a path is a tuple
    of dict keys and list indices."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in tree_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in tree_paths(v, prefix + (i,))]
    return [(prefix, tree)]


def get_path(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def reference_groups(cfg, tree):
    """The port's leaves in the reference's layout: a list of
    ``(path, port_paths, stacked)``, one entry per leaf of the
    reference's tree. ``path`` is that leaf's path there (``("embed",
    "tok")``, ``("prefix", i, ...)``, ``("unit", j, ...)``);
    ``port_paths`` the paths of the port's leaves it holds: one, or for
    a unit leaf (``stacked``) those of the ``repeats`` layers
    ``len(prefix) + r * len(unit) + j`` that the reference stacks on a
    leading axis. The same paths index the params, their gradients and
    the optimizer's per-layer moments."""
    groups = cfg.layer_groups()
    P, U = len(groups.prefix), len(groups.unit)
    out = [(p, [p], False) for p, _ in tree_paths(
        {k: v for k, v in tree.items() if k != "layers"})]
    layers = tree["layers"]
    for i in range(P):
        out += [(("prefix", i) + p, [("layers", i) + p], False)
                for p, _ in tree_paths(layers[i])]
    for j in range(U):
        idx = [P + r * U + j for r in range(groups.repeats)]
        out += [(("unit", j) + p, [("layers", i) + p for i in idx], True)
                for p, _ in tree_paths(layers[idx[0]])]
    return out


def reference_tree(cfg, tree, fn):
    """A tree in the reference's layout (``{..., "prefix": [...],
    "unit": [...]}``) whose leaf at each path of
    :func:`reference_groups` is ``fn(leaves, stacked)``, ``leaves`` the
    port's tensors there."""
    groups = cfg.layer_groups()
    out = {"prefix": [{} for _ in groups.prefix],
           "unit": [{} for _ in groups.unit]}
    for path, port_paths, stacked in reference_groups(cfg, tree):
        node = out
        for k in path[:-1]:
            node = node[k] if isinstance(node, list) else \
                node.setdefault(k, {})
        node[path[-1]] = fn([get_path(tree, q) for q in port_paths],
                            stacked)
    return out


def trainable(params):
    """Marks every floating leaf of ``params`` as a leaf that autograd
    gives a gradient (the float32 masters of a train step); returns the
    tree."""
    for t in tree_leaves(params):
        if t.is_floating_point():
            t.requires_grad_(True)
    return params


def opt_state_from_reference(cfg, opt_tree, device="cuda"):
    """The JAX package's optimizer state (numpy leaves) as the port's,
    on ``device`` (CUDA unless the caller asks for the CPU): ``mu`` and
    ``nu`` per layer through :func:`from_reference`, each leaf in its own
    dtype; Adafactor's ``vr`` and ``vc`` as they are, since the port
    keeps them in the reference's layout (:mod:`repro_torch.optim`);
    ``count`` as an int32 scalar."""
    device = resolve_device(device)
    out = {}
    for k, v in opt_tree.items():
        if k in ("mu", "nu"):
            out[k] = from_reference(cfg, v, device, dtype=None)
        elif k in ("vr", "vc"):
            out[k] = _convert(v, device, None)
        elif k == "count":
            out[k] = torch.as_tensor(np.array(v), dtype=torch.int32,
                                     device=device)
        else:
            raise KeyError(f"optimizer state has no {k!r}")
    return out
