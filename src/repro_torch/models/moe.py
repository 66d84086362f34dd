"""Mixture-of-experts FFN: shared experts + routed top-k experts,
following the JAX package's ``models/moe.py``.

Implementations (``impl``, chosen by the caller):

  * ``"dense"``  — every expert computes every token, weighted by its
    gate; the exact oracle, and the serving engine's default, as in the
    reference;
  * ``"gshard"`` — group-wise capacity dispatch (GShard "dropping"
    style): tokens in groups of <= 4096, each (token, k) takes a slot in
    its expert's queue of ``_capacity`` slots, earlier tokens first;
    tokens past capacity are dropped from that expert;
  * ``"a2a"``   — the gather-based expert-parallel MoE
    (:func:`repro_torch.core.ep_a2a.moe_a2a`) on one shard owning every
    expert, which is what the reference's engine runs on one device:
    each expert gathers up to ``_capacity`` of its tokens (the whole
    batch is one group), earlier tokens first.

The top-k gates are divided by their sum, as in the reference, unless
``cfg.moe.renormalize`` is off (Jamba: the softmax probabilities as they
are), in every implementation.

Plain PyTorch products: the reference has no Pallas kernel for MoE. On
one device the reference's sharding constraints are no-ops and are left
out. The load-balance aux loss is returned, as there.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.params import ParamSpec

GROUP_TOKENS = 4096


def moe_specs(cfg) -> dict:
    mo, d = cfg.moe, cfg.d_model
    s = {
        "router": ParamSpec((d, mo.num_experts), ("embed", "experts"),
                            scale=0.02),
        "w_gate": ParamSpec((mo.num_experts, d, mo.expert_ff),
                            ("experts", "embed", "expert_mlp")),
        "w_up":   ParamSpec((mo.num_experts, d, mo.expert_ff),
                            ("experts", "embed", "expert_mlp")),
        "w_down": ParamSpec((mo.num_experts, mo.expert_ff, d),
                            ("experts", "expert_mlp", "embed")),
    }
    if mo.num_shared:
        s["shared"] = {
            "w_gate": ParamSpec((d, mo.shared_ff), ("embed", "mlp")),
            "w_up":   ParamSpec((d, mo.shared_ff), ("embed", "mlp")),
            "w_down": ParamSpec((mo.shared_ff, d), ("mlp", "embed")),
        }
    return s


def _top_k(probs, k):
    """``jax.lax.top_k``: the k largest along the last axis, an equal
    value's lower index first (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router(cfg, params, x):
    """x: (G, Tg, D) -> (gates (G,Tg,K) float32, sel (G,Tg,K), aux)."""
    mo = cfg.moe
    logits = torch.einsum("gtd,de->gte", x, params["router"].to(x.dtype))
    probs = torch.softmax(logits.float(), dim=-1)
    gates, sel = _top_k(probs, mo.top_k)
    if mo.renormalize:
        gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    # Switch-style load-balance aux loss
    me = probs.mean(dim=(0, 1))                               # (E,)
    ce = F.one_hot(sel, mo.num_experts).float().mean(dim=(0, 1, 2))
    aux = mo.router_aux_coef * mo.num_experts * torch.sum(me * ce) \
        * mo.top_k
    return gates, sel, aux


def _expert_ffn(params, h, dt):
    """h: (G, E, C, D) per-expert token slabs -> (G, E, C, D). The
    SwiGLU product is formed in place: at jamba's width a (16, 4000,
    24576) bf16 intermediate is 3.1 GB."""
    g = torch.einsum("gecd,edf->gecf", h, params["w_gate"].to(dt))
    u = torch.einsum("gecd,edf->gecf", h, params["w_up"].to(dt))
    a = F.silu(g, inplace=True).mul_(u)
    del u
    return torch.einsum("gecf,efd->gecd", a, params["w_down"].to(dt))


def _capacity(cfg, tg: int) -> int:
    mo = cfg.moe
    c = int(mo.top_k * tg / mo.num_experts * mo.capacity_factor)
    return max(-(-c // 4) * 4, 4)


def moe_gshard(cfg, params, x):
    """x: (B,S,D) -> (out, aux)."""
    mo = cfg.moe
    dt = x.dtype
    B, S, D = x.shape
    tg = min(S, GROUP_TOKENS)
    G = B * S // tg
    xg = x.reshape(G, tg, D)

    gates, sel, aux = _router(cfg, params, xg)
    E, K = mo.num_experts, mo.top_k
    C = _capacity(cfg, tg)

    # position of each (token, k) in its expert's queue, counted per
    # group, token-major so that earlier tokens win slots
    ohf = F.one_hot(sel, E).float().reshape(G, tg * K, E)
    pos = torch.cumsum(ohf, dim=1) * ohf - 1.0
    pos = pos.amax(dim=-1).reshape(G, tg, K)                  # slot per (t,k)
    keep = (pos >= 0) & (pos < C)
    pos = pos.clamp(0, C - 1).long()
    gates_f = gates * keep                                    # drop overflow

    combine = torch.zeros((G, tg, E, C), dtype=torch.float32,
                          device=x.device)
    for k in range(K):
        combine += (F.one_hot(sel[:, :, k], E).float()[..., None]
                    * F.one_hot(pos[:, :, k], C).float()[:, :, None, :]
                    * gates_f[:, :, k, None, None])
    dispatch = (combine > 0).to(dt)

    h = torch.einsum("gtec,gtd->gecd", dispatch, xg)
    y = _expert_ffn(params, h, dt)
    out = torch.einsum("gtec,gecd->gtd", combine.to(dt), y)
    out = out.reshape(B, S, D)
    if mo.num_shared:
        out = out + _shared(params, x, dt)
    return out, aux


def moe_dense(cfg, params, x):
    """Oracle: every expert on every token, weighted by the gates."""
    mo = cfg.moe
    dt = x.dtype
    B, S, D = x.shape
    xg = x.reshape(1, B * S, D)
    gates, sel, aux = _router(cfg, params, xg)
    h = xg[:, None].expand(1, mo.num_experts, B * S, D)       # (1,E,T,D)
    y = _expert_ffn(params, h, dt)                            # (1,E,T,D)
    w = torch.sum(F.one_hot(sel, mo.num_experts).float()
                  * gates[..., None], dim=2)                  # (1,T,E)
    out = torch.einsum("gte,getd->gtd", w.to(dt), y).reshape(B, S, D)
    if mo.num_shared:
        out = out + _shared(params, x, dt)
    return out, aux


def _shared(params, x, dt):
    p = params["shared"]
    g = torch.matmul(x, p["w_gate"].to(dt))
    u = torch.matmul(x, p["w_up"].to(dt))
    return torch.matmul(F.silu(g) * u, p["w_down"].to(dt))


def rows_computed(cfg, impl: str, batch: int, seq: int) -> int:
    """Expert rows (a token's pass through one expert's FFN) one MoE
    layer computes for a (batch, seq) input under ``impl``: "dense"
    every expert on every token; "gshard" every expert's ``_capacity``
    slots in each group; "a2a" every expert's slots in the one group.
    The rows a token is routed to are ``top_k`` a token; their ratio is
    the overcompute of the implementation."""
    mo = cfg.moe
    if impl == "dense":
        return mo.num_experts * batch * seq
    if impl == "gshard":
        tg = min(seq, GROUP_TOKENS)
        return batch * seq // tg * mo.num_experts * _capacity(cfg, tg)
    if impl == "a2a":
        return mo.num_experts * _capacity(cfg, max(batch * seq, 4))
    raise ValueError(f"moe_impl {impl!r}: the port has 'dense', 'gshard' "
                     "and 'a2a'")


def moe(cfg, params, x, impl: str = "gshard"):
    """x: (B,S,D) -> (out, aux loss float32)."""
    if impl == "dense":
        return moe_dense(cfg, params, x)
    if impl == "gshard":
        return moe_gshard(cfg, params, x)
    if impl == "a2a":
        from repro_torch.core.ep_a2a import moe_a2a
        return moe_a2a(cfg, params, x, n_shards=1)
    raise ValueError(f"moe_impl {impl!r}: the port has 'dense', 'gshard' "
                     "and 'a2a'")
