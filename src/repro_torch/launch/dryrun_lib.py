"""Dry-run cell logic: the accounting of one (arch, shape, mesh) cell,
counted from the port's own step on fake tensors.

The JAX package's ``launch/dryrun_lib.py`` lowers and compiles each cell
with XLA on a 512-device mesh and reads XLA's ``memory_analysis``,
``cost_analysis`` and the collectives of the compiled HLO
(``launch/hlo_analysis.py``, which parses HLO text). The port lowers
nothing to HLO: it has no counterpart of ``hlo_analysis.py`` and none of
those three readings. Each record names what it does not have in
``not_counted``, and its ``collective_bytes_per_device`` is None.

What a record counts instead (per device):

  * argument bytes, exact: the parameters, the optimizer state (train),
    the cache (prefill and decode: the rows the step writes, which the
    serving engine holds) and the input batch, from their spec trees;
    each dimension a pspec shards is divided by its mesh axes' sizes,
    rounded up (a sharded array's padded share);
  * FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the port's
    real step (``train/steps.py``) at the cell's global batch on
    ``FakeTensorMode`` tensors (so the batch costs nothing), divided
    evenly over the chips (``flops_split`` says so). The attention
    kernels are stood in for by their output allocations
    (:func:`kernel_standins`): their forward FLOPs are a closed form
    (``kernel_flops``: causal pairs from position 0 for a prefill or a
    train step, every cache row for a decode step); a train step's
    backward is the plain version's VJP, which the counter counts;
  * the recurrences (WKV6, the selective scan): their plain versions
    loop over the sequence in Python, so they are stood in for too, and
    their FLOPs and bytes are :func:`recurrence_addendum`'s closed forms,
    the reference's;
  * peak: the live bytes of every storage the step makes, on the same
    fake tensors (``torch.distributed._tools.mem_tracker.MemTracker``,
    which counts a storage once and frees it when it dies), at the batch
    shard's size: the
    arguments and the step's activations. With a mesh the activations
    are those of the batch shard, not split over the "model" axis, and
    the arguments are the per-device shares; a stood-in recurrence's
    plain backward (a Python loop on the card) keeps per-step tensors the
    stand-in does not;
  * depth: as the reference's body probe, the step runs on the model cut
    to its prefix and one repeated unit, then two; each count is the
    one-unit count plus (repeats - 1) times the difference. A train step
    runs at most two micro-batches (which hold the accumulator as all of
    them do); its FLOPs scale to the step's micro-batches.

Everything runs on the host in seconds; no device is touched.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import time
import traceback

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import SHAPES, ShapeConfig, get_config, \
    shape_applicable
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import HBM_PER_CHIP, model_flops, terms_from
from repro_torch.launch.specs import BATCH_AXES, batch_specs
from repro_torch.models import cache_specs, model_specs
from repro_torch.models.params import (abstract_init_params,
                                       abstract_params, leaf_dtype,
                                       tree_leaves, trainable)
from repro_torch.optim import opt_init_specs
from repro_torch.sharding.rules import make_rules
from repro_torch.train.steps import (effective_accum,
                                     make_decode_sample_step,
                                     make_prefill_sample_step,
                                     make_train_step)

MESHES = ("none", "16x16", "2x16x16")

NOT_COUNTED = [
    "XLA memory_analysis (no XLA: the peak is the live bytes of the "
    "port's step on fake tensors)",
    "XLA cost_analysis (no XLA: FLOPs by torch's FlopCounterMode, the "
    "attention kernels' and recurrences' by closed forms)",
    "collectives (no HLO to read; collective_bytes_per_device is null)",
    "bytes accessed (bytes_per_device is the arguments read once plus "
    "the recurrences' closed form, a lower bound)",
]


# The params' dtype a record counts, and why: the port's programs, not
# the config's param_dtype (the reference's, which abstract_model keeps).
PARAMS_COUNTED = {
    True: {"param_dtype": "float32",
           "param_dtype_why": "the float32 masters the port's trainer "
                              "holds (launch/train.py); cfg.param_dtype "
                              "is not counted"},
    False: {"param_dtype": "bfloat16",
            "param_dtype_why": "the serving engine's bf16 weights, its "
                               "norm and gate vectors in float32"},
}


def mesh_of(name: str):
    """The mesh of a record name: "none", "16x16" or "2x16x16"."""
    if name == "none":
        return None
    if name not in MESHES:
        raise ValueError(f"mesh {name!r}: one of {MESHES}")
    return make_production_mesh(multi_pod=name == "2x16x16")


# ---------------------------------------------------------------------------
# Argument bytes from spec trees and pspecs
# ---------------------------------------------------------------------------

def shard_bytes(shape, dtype, pspec, mesh) -> int:
    """Bytes of one device's share of a (shape, dtype) array laid out by
    ``pspec`` (a tuple of None, an axis name or a tuple of names per
    dimension) over ``mesh``: each sharded dimension divided by its mesh
    axes' sizes, rounded up."""
    n = torch.empty((), dtype=dtype).element_size()
    for i, d in enumerate(shape):
        ax = pspec[i] if pspec is not None and i < len(pspec) else None
        if ax is None or mesh is None:
            n *= d
            continue
        k = 1
        for a in ((ax,) if isinstance(ax, str) else ax):
            k *= mesh.shape[a]
        n *= -(-d // k)
    return n


def spec_bytes(spec_tree, rules, dtype_of=None) -> int:
    """Per-device bytes of a spec tree; ``dtype_of(spec, name)`` gives a
    leaf's dtype (default: the spec's own)."""
    total = 0

    def walk(t, name=None):
        nonlocal total
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, k)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        else:
            dt = t.dtype if dtype_of is None else dtype_of(t, name)
            total += shard_bytes(t.shape, dt, rules.pspec(t.axes),
                                 rules.mesh)
    walk(spec_tree)
    return total


def state_bytes(cfg, kind: str, batch: int, seq_len: int, rules,
                cache_len=None) -> dict:
    """Per-device bytes of what a step of ``kind`` holds, by part:
    "params" (train: every leaf in float32, the masters the port's
    trainer holds, ``launch/train.py``; serving: the port's bf16 weights
    with float32 vectors, as ``init_params(..., dtype=torch.bfloat16)``
    makes them),
    "opt_state" (train), "cache" (prefill and decode: ``batch`` rows of
    ``cache_len`` positions, ``seq_len`` by default) and "batch"."""
    specs = model_specs(cfg)
    if kind == "train":
        out = {"params": spec_bytes(specs, rules,
                                    lambda s, n: torch.float32),
               "opt_state": spec_bytes(opt_init_specs(cfg, specs), rules),
               "cache": 0}
    else:
        out = {"params": spec_bytes(
            specs, rules, lambda s, n: leaf_dtype(s.shape, torch.bfloat16, n)),
               "opt_state": 0,
               "cache": spec_bytes(cache_specs(cfg, batch,
                                               cache_len or seq_len),
                                   rules)}
    shape = ShapeConfig("cell", seq_len, batch, kind)
    out["batch"] = sum(shard_bytes(t.shape, t.dtype,
                                   rules.pspec(BATCH_AXES[k]), rules.mesh)
                       for k, t in batch_specs(cfg, shape).items())
    return out


# ---------------------------------------------------------------------------
# Live bytes, kernel stand-ins, closed forms
# ---------------------------------------------------------------------------

def tracked_bytes(tracker, which=None) -> int:
    """Bytes of a ``MemTracker`` snapshot ("peak" or the current one),
    summed over its devices."""
    snap = (tracker.get_tracker_snapshot(which) if which
            else tracker.get_tracker_snapshot())
    return sum(v["Total"] for v in snap.values())


@contextlib.contextmanager
def kernel_standins(tally: dict):
    """The hand-written kernels' wrappers replaced, for the count, by
    their outputs' allocations: flash attention's and flash-decode's
    forward (their FLOPs added to ``tally`` in closed form), WKV6's and
    the selective scan's forward and backward (their FLOPs are
    :func:`recurrence_addendum`'s). On fake tensors the wrappers would
    take the plain versions, which materialize the score matrix or loop
    over the sequence; the card runs the kernels."""
    import repro_torch.kernels.flash_attention.ops as fa
    import repro_torch.kernels.mamba_scan.ops as ms
    import repro_torch.kernels.rwkv6.ops as rw
    import repro_torch.models.attention as attn

    def flash(q, k, v, q_offset, kvl, causal):
        # queries from position 0 (a train step's, a prefill's): the
        # causal pairs alone; not causal, every key
        B, Sq, H, hd = q.shape
        Skv, hdv = k.shape[1], v.shape[-1]
        pairs = Sq * (Sq + 1) // 2 if causal else Sq * Skv
        tally["flash_attention"] = (tally.get("flash_attention", 0)
                                    + 2 * B * H * pairs * (hd + hdv))
        return q.new_empty((B, Sq, H, hdv))

    def decode(q, k, v, *, q_positions=None, kv_valid_len=None):
        # every cache row: the positions are data a fake tensor lacks
        B, _, H, hd = q.shape
        S, hdv = v.shape[1], v.shape[-1]
        tally["decode_attention"] = (tally.get("decode_attention", 0)
                                     + 2 * B * H * S * (hd + hdv))
        return q.new_empty((B, 1, H, hdv))

    def wkv(r, k, v, logw, u, s0, inplace):
        return (r.new_empty(r.shape, dtype=torch.float32),
                s0 if inplace else torch.empty_like(s0))

    def scan(a_log, dt, b, c, xc, h0, inplace):
        return (torch.empty_like(xc),
                h0 if inplace else torch.empty_like(h0))

    def grads_of_inputs(ctx, *grads):
        return tuple(torch.empty_like(t) for t in ctx.saved_tensors)

    patches = [(fa, "_forward", flash), (attn, "decode_attention", decode),
               (rw, "_forward", wkv), (ms, "_forward", scan),
               (rw.WKV6, "backward", staticmethod(grads_of_inputs)),
               (ms.MambaScan, "backward", staticmethod(grads_of_inputs))]
    saved = [(obj, name, obj.__dict__[name]) for obj, name, _ in patches]
    try:
        for obj, name, fn in patches:
            setattr(obj, name, fn)
        yield tally
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)


def recurrence_addendum(cfg, shape, chips: int) -> dict:
    """Exact flops/bytes of the sequential recurrences (per device, per
    step, fwd+bwd for train), the reference's closed forms."""
    specs = cfg.layer_specs()
    n_mamba = sum(1 for m, _ in specs if m == "mamba")
    n_rwkv = sum(1 for m, _ in specs if m == "rwkv")
    if not (n_mamba or n_rwkv):
        return {"flops": 0.0, "bytes": 0.0}
    B = shape.global_batch
    S = 1 if shape.kind == "decode" else shape.seq_len
    mult = 3.0 if shape.kind == "train" else 1.0  # bwd ~ 2x fwd
    fl = by = 0.0
    if n_mamba:
        di = cfg.mamba.expand * cfg.d_model
        ds = cfg.mamba.d_state
        fl += n_mamba * B * S * di * ds * 9.0          # dA,h update,y dot
        by += n_mamba * B * S * di * ds * 8.0          # f32 state rd+wr
    if n_rwkv:
        H = cfg.d_model // cfg.rwkv.head_size
        hd = cfg.rwkv.head_size
        fl += n_rwkv * B * S * H * hd * hd * 8.0
        by += n_rwkv * B * S * H * hd * hd * 8.0
    return {"flops": fl * mult / chips, "bytes": by * mult / chips}


# ---------------------------------------------------------------------------
# One step on fake tensors
# ---------------------------------------------------------------------------

def _fake(meta_tree):
    """Fake CPU tensors of a tree of meta tensors (inside the mode)."""
    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return torch.empty(t.shape, dtype=t.dtype)
    return build(meta_tree)


@functools.lru_cache(maxsize=32)
def count_step(cfg, kind: str, batch: int, seq_len: int, *,
               cache_len=None, micro_batches: int = 1,
               moe_impl: str = "gshard") -> dict:
    """One step of the port on fake tensors: FLOPs (counted, plus the
    attention kernels' closed forms in "kernel_flops"), the live bytes
    of the arguments ("state_bytes") and the peak ("peak_bytes").

    kind "train": ``micro_batches`` micro-batches of ``batch //
    micro_batches`` rows of ``seq_len``, float32 params (the trainer's
    masters) and the optimizer's state; "prefill": ``batch`` x ``seq_len`` into a
    cache of ``cache_len`` positions (``seq_len`` by default); "decode":
    one token a row over that cache. The inputs are
    :func:`.specs.batch_specs`'. Memoized: the meshes of a cell share
    its global count (the result is not to be changed)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker

    shape = ShapeConfig("cell", seq_len, batch, kind)
    tally: dict = {}
    mem = MemTracker()
    flops = FlopCounterMode(display=False)
    with FakeTensorMode(), kernel_standins(tally):
        b = _fake(batch_specs(cfg, shape))
        if kind == "train":
            params = trainable(_fake(abstract_params(model_specs(cfg),
                                                     torch.float32)))
            opt = _fake(abstract_params(
                opt_init_specs(cfg, model_specs(cfg)), None))
            args = (params, opt, b)
            step = make_train_step(
                dataclasses.replace(cfg, grad_accum=micro_batches),
                moe_impl=moe_impl)
        else:
            params = _fake(abstract_init_params(model_specs(cfg),
                                                torch.bfloat16))
            cache = _fake(abstract_params(
                cache_specs(cfg, batch, cache_len or seq_len), None))
            args = (params, b, cache)
            if kind == "prefill":
                step = make_prefill_sample_step(cfg, moe_impl=moe_impl)
            else:
                step = make_decode_sample_step(cfg, moe_impl=moe_impl)
        mem.track_external(*tree_leaves(args))
        state = tracked_bytes(mem)
        with flops, mem:
            step(*args)
    return {"flops": float(flops.get_total_flops()),
            "kernel_flops": {k: float(v) for k, v in tally.items()},
            "state_bytes": state, "peak_bytes": tracked_bytes(mem, "peak")}


def _cut(cfg, units: int):
    groups = cfg.layer_groups()
    return dataclasses.replace(
        cfg, num_layers=len(groups.prefix) + units * len(groups.unit))


def count_model(cfg, kind: str, batch: int, seq_len: int, *,
                cache_len=None, micro_batches: int = 1,
                moe_impl: str = "gshard") -> dict:
    """:func:`count_step` of the whole model from the model cut to its
    prefix and one repeated unit, then two (the reference's body probe):
    each count is the one-unit count plus (repeats - 1) times the
    difference; a model without repeats runs whole. "activation_bytes"
    is the peak less the arguments' live bytes."""
    kw = dict(cache_len=cache_len, micro_batches=micro_batches,
              moe_impl=moe_impl)
    repeats = cfg.layer_groups().repeats
    if repeats <= 1:
        c = dict(count_step(cfg, kind, batch, seq_len, **kw))
        c.update(activation_bytes=c["peak_bytes"] - c["state_bytes"],
                 repeats=repeats, units_run=None)
        return c
    one = count_step(_cut(cfg, 1), kind, batch, seq_len, **kw)
    two = count_step(_cut(cfg, 2), kind, batch, seq_len, **kw)

    def ext(a, b):
        return a + (repeats - 1) * (b - a)
    act1 = one["peak_bytes"] - one["state_bytes"]
    act2 = two["peak_bytes"] - two["state_bytes"]
    names = set(one["kernel_flops"]) | set(two["kernel_flops"])
    return {"flops": ext(one["flops"], two["flops"]),
            "kernel_flops": {k: ext(one["kernel_flops"].get(k, 0.0),
                                    two["kernel_flops"].get(k, 0.0))
                             for k in sorted(names)},
            "activation_bytes": ext(act1, act2),
            "unit": {"flops": two["flops"] - one["flops"],
                     "activation_bytes": act2 - act1},
            "repeats": repeats, "units_run": [1, 2]}


def account(cfg, kind: str, batch: int, seq_len: int, *, rules=None,
            cache_len=None, moe_impl: str = "gshard") -> dict:
    """What one step of ``cfg`` holds and computes on one device, without
    a mesh (``rules`` None) or per device of ``rules.mesh``: "state" (the
    arguments' bytes by part, :func:`state_bytes`), "argument_bytes",
    "activation_bytes" (at the batch shard), "peak_bytes_est" (their
    sum), and the step's FLOPs over the whole batch ("flops_global", the
    attention kernels' share in "kernel_flops"). A train step runs
    :func:`effective_accum`'s micro-batches."""
    rules = rules if rules is not None else make_rules(cfg, None, None)
    accum = effective_accum(cfg, rules, batch) if kind == "train" else 1
    run = min(accum, 2) if kind == "train" else 1
    shards = 1
    ba = rules.map.get("batch")
    if rules.mesh is not None and ba:
        for a in (ba if isinstance(ba, tuple) else (ba,)):
            shards *= rules.mesh.shape[a]
    kw = dict(cache_len=cache_len, moe_impl=moe_impl)
    whole = count_model(cfg, kind, batch // accum * run, seq_len,
                        micro_batches=run, **kw)
    scale = accum / run
    if shards == 1:
        shard = whole
    else:
        b_dev = batch // shards
        shard = count_model(cfg, kind, b_dev // accum * run
                            if kind == "train" else b_dev, seq_len,
                            micro_batches=run, **kw)
    state = state_bytes(cfg, kind, batch, seq_len, rules,
                        cache_len=cache_len)
    args = sum(state.values())
    return {"state": state, "argument_bytes": args,
            "activation_bytes": shard["activation_bytes"],
            "peak_bytes_est": args + shard["activation_bytes"],
            "flops_global": whole["flops"] * scale,
            "kernel_flops": {k: v * scale
                             for k, v in whole["kernel_flops"].items()},
            "accum": accum, "micro_batches_run": run,
            "batch_shards": shards, "repeats": whole["repeats"],
            "units_run": whole["units_run"],
            "unit": whole.get("unit")}


# ---------------------------------------------------------------------------
# Records
# ---------------------------------------------------------------------------

def analyze(arch: str, shape_name: str, cfg, shape, mesh_name: str,
            rules, moe_impl: str, acct: dict) -> dict:
    """The record of one cell, with the reference's keys where they mean
    the same thing (its ``analyze_compiled``)."""
    mesh = rules.mesh
    chips = 1 if mesh is None else mesh.size
    add = recurrence_addendum(cfg, shape, chips)
    attn = sum(acct["kernel_flops"].values())
    flops = acct["flops_global"] / chips + add["flops"]
    byts = acct["argument_bytes"] + add["bytes"]
    terms = terms_from(flops, byts, 0.0)
    mflops = model_flops(cfg, shape)
    counted_global = flops * chips
    mem = dict(acct["state"])
    mem = {f"{k}_bytes": v for k, v in mem.items()}
    mem.update(argument_bytes=acct["argument_bytes"],
               activation_bytes=acct["activation_bytes"],
               peak_bytes_est=acct["peak_bytes_est"],
               fits_80gb=bool(acct["peak_bytes_est"] <= HBM_PER_CHIP),
               not_modeled=(
                   "activations of the batch shard on one device: not "
                   "split over the model axis (tensor or sequence "
                   "parallel); a train step's gradients and their "
                   "accumulator are whole, where a mesh shards them as "
                   "the params; no gathered-parameter or collective "
                   "buffers; a stood-in recurrence's plain backward "
                   "keeps per-step tensors it does not"
                   if mesh is not None else
                   "a stood-in recurrence's plain backward keeps "
                   "per-step tensors it does not"))
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "kind": shape.kind, "status": "ok", "chips": chips,
        "moe_impl": moe_impl, **PARAMS_COUNTED[shape.kind == "train"],
        "flops_per_device": flops,
        "flops_split": "even: the whole step's count divided by the chips",
        "bytes_per_device": byts,
        "collective_bytes_per_device": None,
        "accum_scale": acct["accum"],
        "collectives": None,
        "probe": {"repeats": acct["repeats"], "units_run": acct["units_run"],
                  "unit": acct["unit"],
                  "micro_batches_run": acct["micro_batches_run"],
                  "batch_shards": acct["batch_shards"]},
        "recurrence_addendum": add,
        "recurrences": ("stood in (outputs allocated); FLOPs and bytes by "
                        "recurrence_addendum's closed forms"
                        if add["flops"] else None),
        "kernel_flops_global": acct["kernel_flops"],
        "attention_flops_global": attn,
        "memory": mem,
        "roofline": terms.to_dict(),
        "model_flops_global": mflops,
        "useful_flops_ratio": (mflops / counted_global
                               if counted_global else 0.0),
        "not_counted": NOT_COUNTED,
    }


def run_cell(arch: str, shape_name: str, *, mesh: str = "16x16",
             overrides=None, moe_impl: str = "gshard", cfg_edit=None) -> dict:
    """The record of one (arch, shape, mesh) cell; ``mesh`` is "none"
    (one card), "16x16" or "2x16x16"."""
    t0 = time.time()
    try:
        cfg = get_config(arch)
        if cfg_edit is not None:
            cfg = cfg_edit(cfg)
        shape = SHAPES[shape_name]
        if not shape_applicable(cfg, shape):
            return {
                "arch": arch, "shape": shape_name, "mesh": mesh,
                "status": "skipped",
                "reason": "long_500k requires sub-quadratic attention",
            }
        rules = make_rules(cfg, shape, mesh_of(mesh), overrides=overrides)
        acct = account(cfg, shape.kind, shape.global_batch, shape.seq_len,
                       rules=rules, moe_impl=moe_impl)
        rec = analyze(arch, shape_name, cfg, shape, mesh, rules, moe_impl,
                      acct)
        rec["count_s"] = round(time.time() - t0, 2)
        if overrides:
            rec["overrides"] = overrides
        return rec
    except Exception as e:
        return {"arch": arch, "shape": shape_name, "mesh": mesh,
                "status": "error", "error": repr(e),
                "traceback": traceback.format_exc()[-4000:],
                "elapsed_s": round(time.time() - t0, 2)}


def save_record(rec: dict, out_dir: str):
    os.makedirs(out_dir, exist_ok=True)
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(rec, f, indent=1)
    return os.path.join(out_dir, name)
