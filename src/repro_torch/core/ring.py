"""Ring / sharded-KV attention transport for long contexts.

The Faces pattern in 1-D: KV shards live on a ring of ``ranks`` virtual
ranks; for long-context decode each rank computes a partial flash-decode
over its local KV shard and the partials merge with ONE tiny gather of
the (m, l, acc) statistics (the log-sum-exp merge) instead of rotating
the ring — decode reads every KV byte exactly once wherever it lives.
For training-length sequences the full rotation variant (KV blocks
passed around the ring with compute/transfer double buffering) is
:func:`ring_attention_train` — the ST discipline: transfers for step
i+1 are enqueued (deferred) while step i computes.

``build_ring_program`` lowers that rotation onto the triggered-op DAG:
each ring step is one post/attend/start/put/complete/wait access epoch
(the block-attention kernel is the overlapped compute launch, the KV
blocks are the payload puts on the +1 ring direction), so throttling,
merged-signal fusion, P2P ordering, and the cost simulator apply to ring
attention exactly as they do to Faces. :func:`ring_attention_st` runs it
through any of the three executors and matches
:func:`ring_attention_train` numerically.

Virtual ranks on one device: every rank's block sits on the leading dim
of one tensor. Where the JAX package asks ``jax.lax.axis_index`` for
the rank, the port uses an explicit (R,) rank-index tensor; its
``ppermute`` to rank j+1 is a roll of +1 along the rank dim, its
``all_gather`` of the decode statistics is the rank dim itself, merged
in rank order. The attention products are PyTorch einsums, as they are
jnp einsums in the reference (no TPU kernel); the reference's casts are
kept: the scores are rounded to the inputs' dtype before they become
float32.
"""
from __future__ import annotations

import torch

from repro_torch.core.patterns import register_pattern, ring_topology
from repro_torch.core.window import dtype_of, torch_dtype

NEG_INF = -1e30


def _blocks(x, n):
    """(B, S, ...) -> (n, B, S/n, ...): rank i owns sequence block i."""
    B, S = x.shape[:2]
    return x.reshape(B, n, S // n, *x.shape[2:]).movedim(1, 0)


def _unblocks(x):
    """(n, B, S_l, ...) -> (B, n*S_l, ...)."""
    n, B, S_l = x.shape[:3]
    return x.movedim(0, 1).reshape(B, n * S_l, *x.shape[3:])


def sharded_decode_attention(q, k, v, positions, *, ranks):
    """One-token attention over a KV cache whose sequence dim is sharded
    over ``ranks`` virtual ranks. Each shard computes local (m, l, acc);
    the merge takes the shards' statistics in rank order.

    q: (B,1,H,hd); k,v: (B,S,KV,hd), S divisible by ``ranks``;
    positions: (B,) last valid position (global).
    """
    B, _, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    n = ranks
    S_l = S // n
    G = H // KV
    scale = 1.0 / (hd ** 0.5)
    kb = k.reshape(B, n, S_l, KV, hd)
    vb = v.reshape(B, n, S_l, KV, hd)
    # head h reads KV head h // G (the reference's jnp.repeat), without
    # materializing the repeat
    qg = q[:, 0].reshape(B, KV, G, hd)
    s = torch.einsum("bkgd,bnskd->nbkgs", qg, kb).float() * scale
    s = s.reshape(n, B, H, S_l)
    idx = (torch.arange(n, device=q.device)[:, None] * S_l
           + torch.arange(S_l, device=q.device))             # (n, S_l)
    mask = idx[:, None, :] <= positions[None, :, None]        # (n, B, S_l)
    s = torch.where(mask[:, :, None, :], s, NEG_INF)
    m = s.amax(dim=-1)                                        # (n,B,H)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("nbkgs,bnskd->nbkgd",
                       p.to(v.dtype).reshape(n, B, KV, G, S_l), vb)
    acc = acc.reshape(n, B, H, hd)
    # merge the shards' partials, in rank order
    m_g = m.amax(dim=0)
    w = torch.exp(m - m_g[None])
    l_g = l[0] * w[0]
    acc_g = acc[0] * w[0, ..., None].to(acc.dtype)
    for j in range(1, n):
        l_g = l_g + l[j] * w[j]
        acc_g = acc_g + acc[j] * w[j, ..., None].to(acc.dtype)
    out = acc_g / l_g.clamp(min=1e-30)[..., None].to(acc.dtype)
    return out[:, None].to(q.dtype)                           # (B,1,H,hd)


def _attend_step(qb, k_r, v_r, m, l, acc, src_block, S_l, scale, causal):
    """One ring step of block flash attention for every rank at once:
    ``src_block`` (R,) is the sequence block each rank's ``k_r``/``v_r``
    hold. Returns the new (m, l, acc)."""
    R = qb.shape[0]
    ar = torch.arange(S_l, device=qb.device)
    i = torch.arange(R, device=qb.device)
    s = torch.einsum("rbqhd,rbshd->rbhqs", qb, k_r).float().mul_(scale)
    if causal:
        q_pos = i[:, None] * S_l + ar                        # (R, S_l)
        k_pos = src_block[:, None] * S_l + ar
        mask = k_pos[:, None, :] <= q_pos[:, :, None]        # (R, q, s)
        s.masked_fill_(~mask[:, None, None], NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = s.sub_(m_new[..., None]).exp_()
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(dim=-1)
    acc_new = acc * alpha[..., None] + torch.einsum(
        "rbhqs,rbshd->rbhqd", p.to(v_r.dtype), v_r)
    return m_new, l_new, acc_new


def ring_attention_train(q, k, v, *, ranks, causal=True):
    """Training-length ring attention: KV rotates around ``ranks``
    virtual ranks; each step overlaps the next rotation with the current
    block's attention (the ST deferred-put discipline). q,k,v: (B, S, H,
    hd) with equal heads and S divisible by ``ranks``; causal masking by
    absolute block positions."""
    n = ranks
    B, S, H, hd = q.shape
    S_l = S // n
    scale = 1.0 / (hd ** 0.5)
    qb, k_r, v_r = _blocks(q, n), _blocks(k, n), _blocks(v, n)
    i = torch.arange(n, device=q.device)
    m = torch.full((n, B, H, S_l), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((n, B, H, S_l), dtype=torch.float32, device=q.device)
    acc = torch.zeros((n, B, H, S_l, hd), dtype=torch.float32,
                      device=q.device)
    for r in range(n):
        m, l, acc = _attend_step(qb, k_r, v_r, m, l, acc,
                                 torch.remainder(i - r, n), S_l, scale,
                                 causal)
        if r + 1 < n:
            # the ppermute j -> j+1 (the last one moves nothing read)
            k_r, v_r = k_r.roll(1, 0), v_r.roll(1, 0)
    out = acc / l.clamp(min=1e-30)[..., None]
    return _unblocks(out.transpose(2, 3).to(q.dtype))


# ---------------------------------------------------------------------------
# ST program: the rotation lowered onto the triggered-op DAG
# ---------------------------------------------------------------------------

def make_ring_kernels(n, seq_per_rank, head_dim, causal=True,
                      dtype="float32"):
    """Iteration-stable kernel closures for the ST ring program (one set
    per program; re-enqueued every ring step). Buffers carry the leading
    rank dim R; the step counter buffer (R, 1) keeps ``attend``
    iteration-independent, and each rank's source block is computed from
    it and the rank index on the device."""
    S_l = seq_per_rank
    scale = 1.0 / (head_dim ** 0.5)
    tdt = torch_dtype(dtype)

    def reset(m, l, acc, step):
        return (torch.full_like(m, NEG_INF), torch.zeros_like(l),
                torch.zeros_like(acc), torch.zeros_like(step))

    def attend(q, k_r, v_r, m, l, acc, step):
        """One ring step of block flash attention — identical math to
        :func:`ring_attention_train`'s step."""
        i = torch.arange(q.shape[0], device=q.device)
        src_block = torch.remainder(i - step[:, 0], n)
        m_new, l_new, acc_new = _attend_step(q, k_r, v_r, m, l, acc,
                                             src_block, S_l, scale,
                                             causal)
        return m_new, l_new, acc_new, step + 1

    def rotate(recv_k, recv_v):
        # double-buffer swap: the received blocks become the next step's
        # current KV (the put already moved the bytes)
        return recv_k, recv_v

    def finalize(acc, l):
        out = acc / l.clamp(min=1e-30)[..., None]
        return out.transpose(2, 3).to(tdt).contiguous()

    return {"reset": reset, "attend": attend, "rotate": rotate,
            "finalize": finalize}


def create_ring_window(stream, *, batch, seq_per_rank, heads, head_dim,
                       dtype="float32", name="ring",
                       double_buffer=False, ranks_per_node=None):
    """Window with the local Q block, the rotating KV double buffers, the
    f32 flash-merge accumulators, and a step counter (so the attend
    kernel is iteration-independent, like Faces' "it").
    ``double_buffer`` ping/pongs the recv landing zones (and counters) so
    adjacent ring steps' transfers never collide. ``ranks_per_node``
    sets the node mapping so the KV rotation puts lower with intra/inter
    link tags."""
    blk = (batch, seq_per_rank, heads, head_dim)
    bufs = {"q": (blk, dtype), "k": (blk, dtype), "v": (blk, dtype),
            "recvk": (blk, dtype), "recvv": (blk, dtype),
            "m": ((batch, heads, seq_per_rank), "float32"),
            "l": ((batch, heads, seq_per_rank), "float32"),
            "acc": ((batch, heads, seq_per_rank, head_dim), "float32"),
            "step": ((1,), "int32"),
            "out": (blk, dtype)}
    topo = ring_topology(stream.grid_axes, ranks_per_node=ranks_per_node)
    return stream.create_window(name, bufs, list(topo.group), topology=topo,
                                double_buffer=double_buffer,
                                db_names=("recvk", "recvv"))


@register_pattern("ring", grid_axes=("data",), default_grid=(4,),
                  doc="ring-attention KV rotation as put epochs per step")
def build_ring_program(stream, niter, *, batch=1, seq_per_rank=8, heads=2,
                       head_dim=8, causal=True, dtype="float32",
                       merged=True, host_sync_every=0, kernels=None,
                       name="ring", double_buffer=False,
                       ranks_per_node=None, **_kw):
    """Enqueue ``niter`` full ring-attention rotations: per ring step one
    access epoch — post -> attend kernel (overlap launch) -> start ->
    put(k)/put(v) on the +1 direction -> complete -> wait -> rotate
    kernel — then a finalize kernel. ``merged`` is schedule-level for
    this pattern (signal fusion); the enqueued epoch structure is
    identical either way. ``double_buffer`` alternates ring steps over
    ping/pong recv+counter sets. Returns (window, kernels)."""
    stream.pattern = stream.pattern or "ring"
    n = stream.grid_shape[0]
    win = create_ring_window(stream, batch=batch, seq_per_rank=seq_per_rank,
                             heads=heads, head_dim=head_dim, dtype=dtype,
                             name=name, double_buffer=double_buffer,
                             ranks_per_node=ranks_per_node)
    kernels = kernels or make_ring_kernels(n, seq_per_rank, head_dim,
                                           causal=causal, dtype=dtype)
    q = win.qual
    accs = [q("m"), q("l"), q("acc"), q("step")]
    ep = 0
    for it in range(niter):
        stream.launch(kernels["reset"], accs, accs, label="reset")
        for _ in range(n):
            phase = ep % 2 if double_buffer else 0
            ep += 1
            stream.post(win, phase=phase)
            stream.launch(kernels["attend"],
                          [q("q"), q("k"), q("v")] + accs, accs,
                          label="attend")
            stream.start(win, phase=phase)
            stream.put(win, q("k"), q("recvk", phase), (1,), phase=phase)
            stream.put(win, q("v"), q("recvv", phase), (1,), phase=phase)
            stream.complete(win, phase=phase)
            stream.wait(win, phase=phase)
            stream.launch(kernels["rotate"],
                          [q("recvk", phase), q("recvv", phase)],
                          [q("k"), q("v")], label="rotate")
        stream.launch(kernels["finalize"], [q("acc"), q("l")], [q("out")],
                      label="finalize")
        if host_sync_every and (it + 1) % host_sync_every == 0 \
                and it + 1 < niter:
            stream.host_sync()
    return win, kernels


def ring_stream(q, *, ranks, causal=True, double_buffer=False,
                ranks_per_node=None):
    """(stream, window) of a one-rotation ring program for ``q``'s shape
    and dtype on ``q``'s device: what :func:`ring_attention_st` allocates
    and runs (a caller that times many runs keeps the stream and its
    graphs)."""
    from repro_torch.core.stream import STStream

    B, S, H, hd = q.shape
    stream = STStream(q.device, ("data",), grid_shape=(ranks,))
    win, _ = build_ring_program(stream, 1, batch=B, seq_per_rank=S // ranks,
                                heads=H, head_dim=hd, causal=causal,
                                dtype=dtype_of(q),
                                double_buffer=double_buffer,
                                ranks_per_node=ranks_per_node)
    return stream, win


def ring_attention_st(q, k, v, *, ranks, causal=True, mode="st",
                      throttle="adaptive", resources=64, merged=True,
                      ranks_per_node=None, pack=False, chunk_bytes=0):
    """Ring attention executed THROUGH the ST pipeline (lower -> schedule
    -> st/host/fused executor) instead of the direct rotation loop, on
    ``ranks`` virtual ranks of ``q``'s device. Numerically equivalent to
    :func:`ring_attention_train`. ``ranks_per_node``/``pack`` select the
    multi-node topology and materialized put aggregation: each ring
    step's K,V pair rides ONE packed multi-buffer descriptor instead of
    two puts."""
    n = ranks
    stream, win = ring_stream(q, ranks=n, causal=causal,
                              ranks_per_node=ranks_per_node)
    state = stream.allocate({win.qual(nm): _blocks(t, n).contiguous()
                             for nm, t in (("q", q), ("k", k), ("v", v))})
    state = stream.synchronize(state, mode=mode, throttle=throttle,
                               resources=resources, merged=merged,
                               pack=pack, chunk_bytes=chunk_bytes)
    return _unblocks(state[win.qual("out")])
