"""Decode-step serving transport: KV mirror + MoE dispatch as put epochs.

The serving engine's decode loop is the workload where per-step host
dispatch dominates (GPU-centric communication survey, arXiv:2503.24230):
every generated token moves a tiny KV-cache row to the replica's peers
and — for MoE models — dispatches hidden states to every expert shard.
``build_serve_decode_program`` lowers ONE decode step onto the
triggered-op DAG as a single access epoch:

    post -> advance kernel (the decode forward standing in as the
    overlapped compute launch) -> start -> put(kv row)/put(token ids) on
    the +1 replica ring [+ an aggregated put of the hidden block to
    EVERY peer shift when ``moe``] -> complete -> wait -> commit kernel
    (lands the mirrored KV row, the sampled token ids, and the combined
    expert partials).

The payload shapes are keyed by the ACTIVE SLOT COUNT (``slots``), so a
continuously-batched engine builds one scheduled program per power-of-two
slot bucket and ragged decode batches reuse cached schedules
(``ServingEngine(st_mode=...)`` in repro_torch.serving). Every schedule
pass — throttling, merged signals, multi-stream overlap, node-aware
ordering, pack/chunk, the fused progress engine — and all three executors
apply to the serving epoch exactly as they do to Faces.

The committed ``outtok`` buffer is what the engine reads its sampled
tokens back from, so the transport is load-bearing: a scheduling or
delivery defect changes served tokens, which the bit-identity tests
catch.

Kernel closures see the GLOBAL view: every tensor carries all R ranks on
its leading dim (the JAX package's closures see one rank under
shard_map); the closures here are elementwise, so they are the same
functions. Window dtypes are numpy names (see window.py).
"""
from __future__ import annotations

from repro_torch.core.patterns import (register_pattern, ring_topology,
                                       shifts_topology)


def make_serve_kernels(moe: bool):
    """Iteration-stable kernel closures for the serving decode epoch.
    ``advance`` is the overlapped compute launch (the decode forward —
    represented by a step-counter bump so the closure is iteration-
    independent); ``commit`` lands the received payloads: the mirrored KV
    row and token ids, plus the expert combine (local partial + every
    peer shift's partial, in shift order) when ``moe``. Buffers carry the
    leading rank dim R."""

    def advance(step):
        return step + 1

    def commit(recvkv, recvtok):
        return recvkv, recvtok

    def commit_moe(recvkv, recvtok, hid, *recvh):
        h = hid
        for r in recvh:
            h = h + r
        return recvkv, recvtok, h

    return {"advance": advance,
            "commit": commit_moe if moe else commit}


def create_serve_window(stream, *, slots, kv_dim, d_model, moe,
                        dtype="float32", name="serve",
                        double_buffer=False, ranks_per_node=None):
    """Window with the decode step's outgoing payloads (the new KV row
    per slot, the sampled token ids, and — when ``moe`` — the hidden
    block for expert dispatch), the per-peer recv landing zones (the
    double-buffered set), the committed outputs, and a step counter.
    ``moe`` selects the shifts all-to-all group (KV rides the (1,)
    shift, hidden partials ride every shift); otherwise the plain
    replica ring."""
    n = stream.grid_shape[0]
    bufs = {"kv": ((slots, kv_dim), dtype),
            "tok": ((slots,), "int32"),
            "recvkv": ((slots, kv_dim), dtype),
            "recvtok": ((slots,), "int32"),
            "mirror": ((slots, kv_dim), dtype),
            "outtok": ((slots,), "int32"),
            "step": ((1,), "int32")}
    db_names = ["recvkv", "recvtok"]
    if moe:
        bufs["hid"] = ((slots, d_model), dtype)
        bufs["hmir"] = ((slots, d_model), dtype)
        for k in range(1, n):
            bufs[f"recvh{k}"] = ((slots, d_model), dtype)
            db_names.append(f"recvh{k}")
        topo = shifts_topology(n, stream.grid_axes,
                               ranks_per_node=ranks_per_node)
    else:
        topo = ring_topology(stream.grid_axes,
                             ranks_per_node=ranks_per_node)
    return stream.create_window(name, bufs, list(topo.group), topology=topo,
                                double_buffer=double_buffer,
                                db_names=db_names)


@register_pattern("serve", grid_axes=("data",), default_grid=(4,),
                  doc="decode-step KV mirror + MoE dispatch as one access "
                      "epoch per generated token")
def build_serve_decode_program(stream, niter, *, slots=4, kv_dim=16,
                               d_model=16, moe=True, dtype="float32",
                               merged=True, host_sync_every=0, kernels=None,
                               name="serve", double_buffer=False,
                               ranks_per_node=None, **_kw):
    """Enqueue ``niter`` decode steps: per step one access epoch — post
    -> advance kernel (overlap launch) -> start -> put(kv)/put(tok) on
    the +1 shift [+ put(hid) to every peer shift when ``moe``] ->
    complete -> wait -> commit kernel. ``moe`` degrades to the plain KV
    ring when the grid has a single rank (no peer shifts to dispatch
    to). ``merged`` is schedule-level (signal fusion); ``double_buffer``
    alternates steps over ping/pong recv+counter sets. Returns
    (window, kernels)."""
    stream.pattern = stream.pattern or "serve"
    n = stream.grid_shape[0]
    moe = bool(moe) and n > 1
    win = create_serve_window(stream, slots=slots, kv_dim=kv_dim,
                              d_model=d_model, moe=moe, dtype=dtype,
                              name=name, double_buffer=double_buffer,
                              ranks_per_node=ranks_per_node)
    kernels = kernels or make_serve_kernels(moe)
    for it in range(niter):
        phase = it % 2 if double_buffer else 0

        def q(b, _p=phase):
            return win.qual(b, _p)

        stream.post(win, phase=phase)
        stream.launch(kernels["advance"], [q("step")], [q("step")],
                      label="advance")
        stream.start(win, phase=phase)
        stream.put(win, q("kv"), q("recvkv"), (1,), phase=phase)
        stream.put(win, q("tok"), q("recvtok"), (1,), phase=phase)
        if moe:
            for k in range(1, n):
                stream.put(win, q("hid"), q(f"recvh{k}"), (k,), phase=phase)
        stream.complete(win, phase=phase)
        stream.wait(win, phase=phase)
        reads = [q("recvkv"), q("recvtok")]
        writes = [q("mirror"), q("outtok")]
        if moe:
            reads += [q("hid")] + [q(f"recvh{k}") for k in range(1, n)]
            writes.append(q("hmir"))
        stream.launch(kernels["commit"], reads, writes, label="commit")
        if host_sync_every and (it + 1) % host_sync_every == 0 \
                and it + 1 < niter:
            stream.host_sync()
    return win, kernels
