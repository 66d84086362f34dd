"""Logical-axis sharding rules, as the JAX package's ``sharding/rules.py``.

A ``ShardingRules`` maps logical axis names (used in ParamSpec.axes and in
activation constraints) to mesh axis names. Rules are built per
(model config, shape, mesh) because some choices are shape-dependent
(e.g. long-context KV-sequence sharding) or config-dependent (MQA cannot
shard its single KV head).

The port runs on one device and places nothing, so a mesh here is named
axis sizes (:class:`repro_torch.launch.mesh.MeshShape`: ``axis_names``
and ``shape[axis]``, all the reference's ``make_rules`` reads), not
devices. ``pspec`` gives the reference's ``PartitionSpec`` entries as a
plain tuple; the accounting (``launch/dryrun_lib.py``) divides each
sharded dimension by its mesh axes' sizes with it. ``sharding()`` is
None and ``constrain`` returns its input: on one device there is nothing
to place, which is also what the reference does without a mesh, and
what its launchers use (``make_rules(cfg, None, None)``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass
class ShardingRules:
    mesh: Optional[Any]
    map: dict = field(default_factory=dict)

    def pspec(self, axes) -> tuple:
        """Logical axes tuple -> the PartitionSpec's entries, de-duplicating
        mesh axes (first logical dim to claim a mesh axis wins)."""
        used = set()
        out = []
        for a in axes:
            m = self.map.get(a) if a is not None else None
            if m is None:
                out.append(None)
                continue
            ms = (m,) if isinstance(m, str) else tuple(m)
            ms = tuple(x for x in ms if x not in used and x is not None)
            if not ms:
                out.append(None)
                continue
            used.update(ms)
            out.append(ms[0] if len(ms) == 1 else ms)
        return tuple(out)

    def sharding(self, axes) -> None:
        """The reference's NamedSharding; None: one device places
        nothing."""
        return None

    def constrain(self, x, axes):
        """The reference's with_sharding_constraint; ``x`` unchanged: one
        device places nothing."""
        return x


def _auto_batch_axes(mesh, candidates, global_batch):
    """Longest prefix of candidate axes whose size-product divides the
    global batch (so pjit argument shardings are always legal)."""
    if mesh is None:
        return None
    cand = [a for a in candidates if a in mesh.axis_names]
    chosen = []
    prod = 1
    for a in cand:
        nxt = prod * mesh.shape[a]
        if global_batch is None or (global_batch % nxt == 0
                                    and global_batch >= nxt):
            chosen.append(a)
            prod = nxt
        else:
            break
    if not chosen:
        return None
    return tuple(chosen) if len(chosen) > 1 else chosen[0]


def make_rules(cfg=None, shape=None, mesh=None,
               overrides: Optional[dict] = None) -> ShardingRules:
    """Build rules for (arch config, input shape, mesh).

    overrides: hillclimb knob — raw {logical: mesh axis} replacements.
    Per-arch cfg.sharding_overrides apply first, then `overrides`.
    """
    model_size = 1
    if mesh is not None and "model" in mesh.axis_names:
        model_size = mesh.shape["model"]

    kv_heads = getattr(cfg, "num_kv_heads", 0) if cfg is not None else 0
    kv_shard = "model" if (kv_heads and kv_heads % max(model_size, 1) == 0
                           and model_size > 1) else None

    long_ctx = bool(shape is not None and shape.kind == "decode"
                    and shape.global_batch == 1)

    cfg_over = dict(getattr(cfg, "sharding_overrides", ()) or ())
    batch_candidates = cfg_over.pop("batch", ("pod", "data"))
    gb = shape.global_batch if shape is not None else None

    m = {
        # -- data / batch ---------------------------------------------------
        "batch": _auto_batch_axes(mesh, batch_candidates, gb),
        "seq": None,
        # activation (residual-stream) sequence dim: sequence parallelism
        # (disabled for decode steps: S=1 cannot usefully shard)
        "seq_act": ("model" if ((cfg is None or cfg.seq_shard_activations)
                                and not (shape is not None
                                         and shape.kind == "decode"))
                    else None),
        "embed_act": None,
        # KV cache sequence dim: long-context (batch=1) rings over the
        # data axis; other serving shapes shard it over "model" (the cache
        # is the dominant allocation at decode_32k x batch 128 — e.g.
        # deepseek-v2's latent cache is 290 GB unsharded).
        "kv_seq": (_auto_batch_axes(mesh, ("pod", "data"), None) if long_ctx
                   else ("model" if (shape is not None
                                     and shape.kind in ("decode", "prefill"))
                         else None)),
        # -- params -----------------------------------------------------------
        "vocab": "model",
        "embed": "data",            # FSDP / ZeRO-3 axis
        "mlp": "model",             # TP
        # decode is memory-bound on the seq-sharded cache: every model
        # shard reads its own cache slice for ALL heads, so head sharding
        # buys nothing and forces costly grouped-q resharding — replicate.
        "heads": (None if (shape is not None and shape.kind == "decode")
                  else "model"),
        "kv_heads": (None if (shape is not None and shape.kind == "decode")
                     else kv_shard),
        "head_dim": None,
        "lora": None,               # MLA low-rank dims
        "experts": "model",         # EP
        "expert_mlp": None,
        "capacity": None,
        "layers": None,             # scan-stacked dim
        "conv": None,
        "state": None,
        "vis_tokens": None,
        "vis_dim": None,
        "rwkv_head": kv_shard or "model",
    }
    m.update(cfg_over)
    if overrides:
        m.update(overrides)
    return ShardingRules(mesh=mesh, map=m)


DEFAULT_RULES = make_rules()


def logical_to_pspec(axes, rules: ShardingRules) -> tuple:
    return rules.pspec(axes)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x)


def pspec_tree(axes_tree, rules: ShardingRules):
    """The pspec of every logical-axes tuple in a tree of dicts and
    lists (a tuple of names is a leaf, as in the reference)."""
    if _is_axes(axes_tree):
        return rules.pspec(axes_tree)
    if isinstance(axes_tree, dict):
        return {k: pspec_tree(v, rules) for k, v in axes_tree.items()}
    if isinstance(axes_tree, (list, tuple)):
        return type(axes_tree)(pspec_tree(v, rules) for v in axes_tree)
    raise TypeError(f"pspec_tree: {axes_tree!r} is not a tuple of axis "
                    "names")


def constrain(x, axes, rules: ShardingRules):
    return rules.constrain(x, axes)
