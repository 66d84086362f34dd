"""Gather-based expert-parallel MoE, and its combine as an ST access epoch.

Every expert shard owns E/n experts, selects its tokens with a LOCAL
gather (no mask einsum, no dispatch collective — the tokens are
replicated over the shards), runs its experts, and scatter-adds partial
outputs, which one sum over the shards (the JAX package's ``psum``)
combines. The GShard-style dispatch (``models.moe.moe_gshard``) goes
through (G, Tg, E, C) one-hot products instead.

``build_moe_a2a_program`` lowers the combine onto the triggered-op DAG as
an aggregated-put access epoch — each shard's partial output is a
payload put to every peer shift and the combine kernel sums the received
partials — so the schedule passes and all three executors apply to
expert parallelism unchanged. ``moe_a2a_st`` runs it and matches
:func:`moe_a2a` numerically.

Virtual shards on one device: every shard sits on the leading dim of one
tensor, and :func:`_moe_shard` routes, gathers and computes all of them
in one batched pass, with the shard index an explicit (n,) tensor where
the JAX package asks ``jax.lax.axis_index``. The expert products are
PyTorch einsums, as they are jnp einsums in the reference (no TPU
kernel). Nothing here reads a device value on the host, so the decode
step and the ST program capture as CUDA graphs.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.nn.functional as F

from repro_torch.core.patterns import register_pattern, shifts_topology
from repro_torch.core.window import dtype_of
from repro_torch.models.moe import _capacity, _shared, _top_k


def moe_a2a(cfg, params, x, n_shards: int = 1):
    """x: (B,S,D) -> (out, aux float32). ``n_shards=1`` is the JAX
    package's single-device path (one shard owning all experts);
    ``n_shards > 1`` runs that many expert shards on ``x``'s device and
    sums their partial outputs in shard order (the ``psum``), the aux
    loss their mean (the ``pmean``)."""
    dt = x.dtype
    n = n_shards
    E, D, F_ = cfg.moe.num_experts, x.shape[-1], cfg.moe.expert_ff
    if E % n:
        raise ValueError(f"num_experts={E} must divide over {n} shards")
    e_l = E // n
    # each shard's slice of the experts is a view of the weights
    parts, aux = _moe_shard(
        cfg, x[None].expand(n, *x.shape),
        params["router"].to(dt)[None].expand(n, D, E),
        params["w_gate"].to(dt).reshape(n, e_l, D, F_),
        params["w_up"].to(dt).reshape(n, e_l, D, F_),
        params["w_down"].to(dt).reshape(n, e_l, F_, D),
        torch.arange(n, device=x.device), e_l)
    out, total = parts[0], aux[0]
    for j in range(1, n):
        out = out + parts[j]
        total = total + aux[j]
    if n > 1:
        total = total / n
    if cfg.moe.num_shared:
        out = out + _shared(params, x, dt)
    return out, total.float()


def _moe_shard(cfg, xl, router, wg, wu, wd, shard_id, e_l):
    """Every shard at once: route its tokens, gather the ones routed to
    its experts, compute, scatter-add. xl (n,Bl,S,D), router (n,D,E), wg
    and wu (n,e_l,D,F), wd (n,e_l,F,D), shard_id (n,) ->
    (partial out (n,Bl,S,D), aux (n,) float32)."""
    mo = cfg.moe
    dt = xl.dtype
    n, Bl, S, D = xl.shape
    T = Bl * S
    K = mo.top_k
    xt = xl.reshape(n, T, D)

    logits = torch.matmul(xt, router).float()                  # (n,T,E)
    probs = torch.softmax(logits, dim=-1)
    gates, sel = _top_k(probs, K)                               # (n,T,K)
    if mo.renormalize:
        gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    me = probs.mean(dim=1)
    ce = F.one_hot(sel, mo.num_experts).float().mean(dim=(1, 2))
    aux = mo.router_aux_coef * mo.num_experts * torch.sum(me * ce, -1) * K

    C = _capacity(cfg, max(T, 4))
    e0 = shard_id * e_l                                         # (n,)
    # (n, T*K) flattened assignments; keep only this shard's experts
    sel_f = sel.reshape(n, -1)
    gate_f = gates.reshape(n, -1)
    tok_f = torch.arange(T * K, device=xl.device) // K
    local_e = sel_f - e0[:, None]
    mine = (local_e >= 0) & (local_e < e_l)
    local_e = torch.where(mine, local_e, e_l)   # park strangers in slot e_l

    # slot position within each local expert's queue (stable order);
    # integer counts equal the reference's float32 ones exactly
    oh = F.one_hot(local_e, e_l + 1)                            # (n,T*K,e_l+1)
    pos = (torch.cumsum(oh, dim=1) * oh).sum(-1) - 1
    keep = mine & (pos >= 0) & (pos < C)
    slot = torch.where(keep, local_e * C + pos, e_l * C)        # overflow bin

    # the (e_l*C+1) slots' tokens and gates; the last slot is the trash
    # bin (written by every dropped or stranger assignment, never read)
    nslot = e_l * C + 1
    src_tok = torch.zeros((n, nslot), dtype=torch.long, device=xl.device)
    src_tok.scatter_(1, slot, torch.where(keep, tok_f, 0))
    filled = torch.zeros((n, nslot), dtype=torch.bool, device=xl.device)
    filled.scatter_(1, slot, keep)
    src_gate = torch.zeros((n, nslot), dtype=torch.float32,
                           device=xl.device)
    src_gate.scatter_(1, slot, torch.where(keep, gate_f, 0.0))
    src_tok, filled = src_tok[:, :e_l * C], filled[:, :e_l * C]
    h = torch.gather(xt, 1, src_tok[..., None].expand(n, e_l * C, D))
    h = torch.where(filled[..., None], h, 0)

    he = h.reshape(n, e_l, C, D)
    g = torch.einsum("necd,nedf->necf", he, wg)
    u = torch.einsum("necd,nedf->necf", he, wu)
    a = F.silu(g, inplace=True).mul_(u)
    del g, u
    y = torch.einsum("necf,nefd->necd", a, wd).reshape(n, e_l * C, D)
    y = y * src_gate[:, :e_l * C, None].to(dt)

    out = torch.zeros((n, T, D), dtype=dt, device=xl.device)
    out.scatter_add_(1, src_tok[..., None].expand(n, e_l * C, D), y)
    return out.reshape(n, Bl, S, D), aux


# ---------------------------------------------------------------------------
# ST program: the combine as an aggregated-put access epoch
# ---------------------------------------------------------------------------

def _tiny_moe_cfg(experts, top_k, expert_ff):
    """cfg duck-type for the self-contained (device-free) path;
    ``moe_a2a_st`` passes a real ModelConfig instead."""
    return SimpleNamespace(moe=SimpleNamespace(
        num_experts=experts, top_k=top_k, expert_ff=expert_ff,
        router_aux_coef=0.01, capacity_factor=1.25, num_shared=0,
        renormalize=True))


def make_moe_a2a_kernels(cfg, n_shards):
    """Kernel closures: the local gather/expert/scatter compute producing
    every shard's partial, and the combine summing all received partials
    (the psum replacement). Buffers carry the leading rank dim R."""
    e_l = cfg.moe.num_experts // n_shards

    def moe_shard(x, router, wg, wu, wd):
        sid = torch.arange(x.shape[0], device=x.device)
        out, aux = _moe_shard(cfg, x, router, wg, wu, wd, sid, e_l)
        return out, aux[:, None]

    def combine(partial, paux, *recvs):
        # recvs = peer partials then peer aux partials
        k = len(recvs) // 2
        out = partial
        for r in recvs[:k]:
            out = out + r
        aux = paux
        for r in recvs[k:]:
            aux = aux + r
        return out, aux / n_shards

    return {"moe_shard": moe_shard, "combine": combine}


def create_a2a_window(stream, *, batch, seq, d_model, expert_ff, e_l,
                      dtype="float32", name="a2a", double_buffer=False,
                      ranks_per_node=None):
    """Window with the (replicated) token block, this shard's expert
    weights, the partial-output/aux buffers, and one recv buffer per
    peer shift of the aggregated-put combine. ``double_buffer`` ping/
    pongs the partial/aux sources AND the recv landing zones (plus the
    counters) so layer e+1's expert compute and puts never touch the
    buffers layer e's combine is still reading."""
    n = stream.grid_shape[0]
    tok = (batch, seq, d_model)
    bufs = {"x": (tok, dtype),
            "router": ((d_model, e_l * n), dtype),
            "wg": ((e_l, d_model, expert_ff), dtype),
            "wu": ((e_l, d_model, expert_ff), dtype),
            "wd": ((e_l, expert_ff, d_model), dtype),
            "partial": (tok, dtype), "paux": ((1,), "float32"),
            "out": (tok, dtype), "aux": ((1,), "float32")}
    db_names = ["partial", "paux"]
    for k in range(1, n):
        bufs[f"recvp{k}"] = (tok, dtype)
        bufs[f"recva{k}"] = ((1,), "float32")
        db_names += [f"recvp{k}", f"recva{k}"]
    topo = shifts_topology(n, stream.grid_axes,
                           ranks_per_node=ranks_per_node)
    return stream.create_window(name, bufs, list(topo.group), topology=topo,
                                double_buffer=double_buffer,
                                db_names=db_names)


@register_pattern("a2a", grid_axes=("model",), default_grid=(2,),
                  doc="expert-parallel MoE combine as aggregated puts")
def build_moe_a2a_program(stream, niter, *, cfg=None, batch=1, seq=8,
                          d_model=16, expert_ff=16, experts=None, top_k=2,
                          dtype="float32", merged=True, host_sync_every=0,
                          kernels=None, name="a2a", double_buffer=False,
                          ranks_per_node=None, **_kw):
    """Enqueue ``niter`` expert-parallel MoE layers: post -> local
    gather/expert/scatter kernel -> start -> an aggregated put of the
    partial output (+ aux) to EVERY peer shift -> complete -> wait ->
    combine kernel. ``merged`` is schedule-level (signal fusion).
    ``double_buffer`` alternates layers over ping/pong partial/recv sets.
    Returns (window, kernels)."""
    stream.pattern = stream.pattern or "a2a"
    n = stream.grid_shape[0]
    if cfg is None:
        experts = experts if experts is not None else 2 * n
        cfg = _tiny_moe_cfg(experts, top_k, expert_ff)
    else:
        d_model = cfg.d_model
        expert_ff = cfg.moe.expert_ff
    if cfg.moe.num_experts % n:
        raise ValueError(f"num_experts={cfg.moe.num_experts} must divide "
                         f"over {n} shards")
    e_l = cfg.moe.num_experts // n
    win = create_a2a_window(stream, batch=batch, seq=seq, d_model=d_model,
                            expert_ff=expert_ff, e_l=e_l, dtype=dtype,
                            name=name, double_buffer=double_buffer,
                            ranks_per_node=ranks_per_node)
    kernels = kernels or make_moe_a2a_kernels(cfg, n)
    for it in range(niter):
        phase = it % 2 if double_buffer else 0

        def q(b, _p=phase):
            return win.qual(b, _p)

        recvp = [q(f"recvp{k}") for k in range(1, n)]
        recva = [q(f"recva{k}") for k in range(1, n)]
        stream.post(win, phase=phase)
        stream.launch(kernels["moe_shard"],
                      [q("x"), q("router"), q("wg"), q("wu"), q("wd")],
                      [q("partial"), q("paux")], label="moe_shard")
        stream.start(win, phase=phase)
        for k in range(1, n):
            stream.put(win, q("partial"), q(f"recvp{k}"), (k,), phase=phase)
            stream.put(win, q("paux"), q(f"recva{k}"), (k,), phase=phase)
        stream.complete(win, phase=phase)
        stream.wait(win, phase=phase)
        stream.launch(kernels["combine"],
                      [q("partial"), q("paux")] + recvp + recva,
                      [q("out"), q("aux")], label="combine")
        if host_sync_every and (it + 1) % host_sync_every == 0 \
                and it + 1 < niter:
            stream.host_sync()
    return win, kernels


def a2a_stream(cfg, params, x, *, ranks, niter=1, double_buffer=False,
               ranks_per_node=None):
    """(stream, window, state) of an expert-parallel program over
    ``ranks`` shards for ``x`` (B,S,D) on ``x``'s device: the tokens and
    router replicated over the rank dim (expanded views), each shard's
    expert weights a view of ``params`` (no copy). What
    :func:`moe_a2a_st` runs (a caller that times many runs keeps the
    stream and its graphs)."""
    from repro_torch.core.stream import STStream

    dt = x.dtype
    B, S, D = x.shape
    n = ranks
    e_l = cfg.moe.num_experts // n
    F_ = cfg.moe.expert_ff
    stream = STStream(x.device, ("model",), grid_shape=(n,))
    win, _ = build_moe_a2a_program(stream, niter, cfg=cfg, batch=B, seq=S,
                                   dtype=dtype_of(x),
                                   double_buffer=double_buffer,
                                   ranks_per_node=ranks_per_node)
    fills = {
        "x": x[None].expand(n, B, S, D),
        "router": params["router"].to(dt)[None].expand(n, D, e_l * n),
        "wg": params["w_gate"].to(dt).reshape(n, e_l, D, F_),
        "wu": params["w_up"].to(dt).reshape(n, e_l, D, F_),
        "wd": params["w_down"].to(dt).reshape(n, e_l, F_, D),
    }
    state = stream.allocate({win.qual(k): v for k, v in fills.items()})
    return stream, win, state


def moe_a2a_st(cfg, params, x, *, ranks, mode="st", throttle="adaptive",
               resources=64, merged=True, ranks_per_node=None, pack=False):
    """Expert-parallel MoE executed THROUGH the ST pipeline (lower ->
    schedule -> st/host/fused executor) on ``ranks`` virtual shards: the
    psum combine becomes the aggregated-put access epoch. Numerically
    equivalent to :func:`moe_a2a`. x: (B,S,D). ``ranks_per_node``/
    ``pack`` select the multi-node topology and materialized put
    aggregation: each shift's partial+aux pair rides ONE packed
    multi-buffer descriptor instead of two puts."""
    stream, win, state = a2a_stream(cfg, params, x, ranks=ranks,
                                    ranks_per_node=ranks_per_node)
    state = stream.synchronize(state, mode=mode, throttle=throttle,
                               resources=resources, merged=merged,
                               pack=pack)
    out = state[win.qual("out")][0]           # every rank holds the sum
    aux = state[win.qual("aux")][0, 0]
    if cfg.moe.num_shared:
        out = out + _shared(params, x, x.dtype)
    return out, aux.float()
