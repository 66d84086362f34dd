"""Optimizers: AdamW and Adafactor (factored second moment), following
the JAX package's ``optim/optimizers.py`` term for term: float32
upcasts, the step as float32 in the bias corrections, a global-norm
clip at 1.0, the moments cast back to ``cfg.opt_state_dtype``.

The state is a dict of tensors on the params' device, updated IN PLACE
with the params under ``torch.no_grad()`` (the reference returns new
trees): ``{"mu", "nu", "count"}`` for AdamW, ``{"mu", "vr", "vc",
"count"}`` for Adafactor. ``mu`` and ``nu`` are elementwise and mirror
the params tree, one leaf per layer. Adafactor's statistics are not
elementwise: the reference computes them, its state and its RMS clip
over its own leaves, which stack each unit position's layers on a
leading axis (``models/params.reference_groups``). A stacked (R, d)
norm scale is factored there, and its clip is one mean over all R
layers. The port's Adafactor works over the same groups, so ``vr`` and
``vc`` have the reference's layout and shapes (``{..., "prefix":
[...], "unit": [...]}``) and the update is the reference's function;
per layer it would be another optimizer.
"""
from __future__ import annotations

import torch

from repro_torch.models.params import (get_path, reference_groups,
                                       reference_tree, tree_leaves,
                                       tree_map)

OptState = dict


def _factored_axes(shape):
    """Factor over the two last dims if rank >= 2 and both are >= 2."""
    if len(shape) < 2 or min(shape[-2:]) < 2:
        return None
    return (len(shape) - 2, len(shape) - 1)


def _group_shape(leaves, stacked):
    shape = tuple(leaves[0].shape)
    return (len(leaves),) + shape if stacked else shape


def _count(params):
    dev = tree_leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


def adamw_init(params, dtype=torch.float32) -> OptState:
    zeros = lambda p: torch.zeros(p.shape, dtype=dtype, device=p.device)
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "count": _count(params)}


def adafactor_init(cfg, params, dtype=torch.float32) -> OptState:
    def vrow(leaves, stacked):
        shape = _group_shape(leaves, stacked)
        f = _factored_axes(shape)
        if f is not None:
            shape = tuple(d for i, d in enumerate(shape) if i != f[1])
        return torch.zeros(shape, dtype=dtype, device=leaves[0].device)

    def vcol(leaves, stacked):
        shape = _group_shape(leaves, stacked)
        f = _factored_axes(shape)
        shape = ((1,) if f is None else
                 tuple(d for i, d in enumerate(shape) if i != f[0]))
        return torch.zeros(shape, dtype=dtype, device=leaves[0].device)

    zeros = lambda p: torch.zeros(p.shape, dtype=dtype, device=p.device)
    return {"mu": tree_map(zeros, params),
            "vr": reference_tree(cfg, params, vrow),
            "vc": reference_tree(cfg, params, vcol),
            "count": _count(params)}


def opt_init(cfg, params) -> OptState:
    """Zeroed state for ``params`` in ``cfg.opt_state_dtype``."""
    dtype = getattr(torch, cfg.opt_state_dtype)
    if cfg.optimizer == "adafactor":
        return adafactor_init(cfg, params, dtype)
    return adamw_init(params, dtype)


# ---------------------------------------------------------------------------
# Updates
# ---------------------------------------------------------------------------

def _adamw_update(p, g, mu, nu, lr, b1, b2, eps, wd, step):
    """One leaf, written in place."""
    g = g.float()
    mu_f = mu.float() * b1 + (1 - b1) * g
    nu_f = nu.float() * b2 + (1 - b2) * g * g
    mu_hat = mu_f / (1 - b1 ** step)
    nu_hat = nu_f / (1 - b2 ** step)
    pf = p.float()
    upd = mu_hat / (torch.sqrt(nu_hat) + eps) + wd * pf
    p.copy_(pf - lr * upd)
    mu.copy_(mu_f)
    nu.copy_(nu_f)


def _adafactor_update(p, g, mu, vr, vc, lr, b1, b2, eps, wd, step):
    """One reference leaf (stacked or not); returns (new p, new mu,
    new vr, new vc) in their dtypes."""
    g = g.float()
    f = _factored_axes(p.shape)
    g2 = g * g + eps
    if f is None:
        vr_f = vr.float() * b2 + (1 - b2) * g2
        precond = torch.rsqrt(vr_f / (1 - b2 ** step))
        vc_f = vc.float()
    else:
        r = g2.mean(dim=f[1])
        c = g2.mean(dim=f[0])
        vr_f = vr.float() * b2 + (1 - b2) * r
        vc_f = vc.float() * b2 + (1 - b2) * c
        rh = vr_f / (1 - b2 ** step)
        ch = vc_f / (1 - b2 ** step)
        denom = rh.mean(dim=-1, keepdim=True)
        vhat = (rh.unsqueeze(f[1]) * ch.unsqueeze(f[0])
                / denom.unsqueeze(f[1]))
        precond = torch.rsqrt(vhat)
    u = g * precond
    # update clipping (Adafactor RMS clip)
    rms = torch.sqrt(torch.mean(u * u) + 1e-30)
    u = u / torch.clamp(rms, min=1.0)
    mu_f = mu.float() * b1 + (1 - b1) * u
    pf = p.float()
    new_p = pf - lr * (mu_f + wd * pf)
    return (new_p.to(p.dtype), mu_f.to(mu.dtype), vr_f.to(vr.dtype),
            vc_f.to(vc.dtype))


def _stack(leaves, stacked):
    return torch.stack(leaves) if stacked else leaves[0]


def _unstack_into(leaves, value, stacked):
    if stacked:
        for r, t in enumerate(leaves):
            t.copy_(value[r])
    else:
        leaves[0].copy_(value)


@torch.no_grad()
def clip_by_global_norm(grads):
    """The reference's clip, IN PLACE: every gradient times
    min(1, 1 / ||g||), the norm over all leaves in float32 (plus 1e-30),
    the factor cast to each gradient's dtype. Returns the norm."""
    leaves = tree_leaves(grads)
    total = sum(torch.sum(torch.square(g.float())) for g in leaves)
    gnorm = torch.sqrt(total + 1e-30)
    scale = torch.clamp(1.0 / gnorm, max=1.0)
    for g in leaves:
        g.mul_(scale.to(g.dtype))
    return gnorm


@torch.no_grad()
def opt_update(cfg, params, grads, state: OptState, lr,
               b1=0.9, b2=0.95, eps=1e-8, wd=0.1):
    """One optimizer step, IN PLACE on ``params`` and ``state``; returns
    ``(params, state)``, the same trees, ``state["count"]`` incremented.
    ``grads``: a tree like ``params`` (any float dtype), clipped in place
    at a global norm of 1.0 first. ``lr``: a float or a 0-dim tensor."""
    clip_by_global_norm(grads)
    step = state["count"] + 1
    stepf = step.to(torch.float32)
    if cfg.optimizer == "adafactor":
        for path, port_paths, stacked in reference_groups(cfg, params):
            ps, gs, mus = ([get_path(t, q) for q in port_paths]
                           for t in (params, grads, state["mu"]))
            vr, vc = get_path(state["vr"], path), get_path(state["vc"], path)
            new_p, new_mu, new_vr, new_vc = _adafactor_update(
                _stack(ps, stacked), _stack(gs, stacked),
                _stack(mus, stacked), vr, vc, lr, b1, b2, eps, wd, stepf)
            _unstack_into(ps, new_p, stacked)
            _unstack_into(mus, new_mu, stacked)
            vr.copy_(new_vr)
            vc.copy_(new_vc)
    else:
        for p, g, mu, nu in zip(tree_leaves(params), tree_leaves(grads),
                                tree_leaves(state["mu"]),
                                tree_leaves(state["nu"])):
            _adamw_update(p, g, mu, nu, lr, b1, b2, eps, wd, stepf)
    state["count"] = step
    return params, state

