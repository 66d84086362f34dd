"""Step builders, following the JAX package's ``train/steps.py``: the
train step (gradient accumulation over micro-batches, the optimizer),
and prefill and decode with device-side greedy sampling.

The reference's steps are pure functions for ``jax.jit``. The port's
train step updates the params and the optimizer state in place and
returns them; its serving steps write the KV cache in place and return
it, under ``torch.no_grad()``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import (cache_specs, forward, lm_loss_fused,
                                logits_from_hidden)
from repro_torch.models.params import (tree_leaves, tree_unflatten,
                                       zeros_from_specs)
from repro_torch.optim import cosine_schedule, opt_update


def _loss_fn(cfg, moe_impl, params, mbatch):
    """(loss + aux, (loss, aux)) of one micro-batch, as the reference's
    ``_loss_fn``."""
    x, _, aux = forward(cfg, params, mbatch, moe_impl=moe_impl)
    loss = lm_loss_fused(cfg, params, x, mbatch["targets"])
    return loss + aux, (loss, aux)


def effective_accum(cfg) -> int:
    """The number of micro-batches: ``cfg.grad_accum`` (at least 1). The
    reference clamps it so that each micro-batch still covers every
    batch shard of its mesh (from its ``global_batch``); on one device
    there is one shard, and it returns ``cfg.grad_accum`` as the
    reference does without a mesh."""
    return max(cfg.grad_accum, 1)


def _split(batch, accum):
    """The global batch as ``accum`` micro-batches along the leading dim
    (the reference's reshape to (accum, micro, ...))."""
    n = next(iter(batch.values())).shape[0]
    if n % accum:
        raise ValueError(f"global batch {n} is not a multiple of "
                         f"{accum} micro-batches")
    m = n // accum
    return [{k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            for i in range(accum)]


def value_and_grad(cfg, moe_impl, params, mbatch):
    """(loss, aux, grads) of one micro-batch: grads a list in
    :func:`tree_leaves` order of ``params``, zeros where a leaf takes no
    part (the reference's gradient of an unused param)."""
    leaves = tree_leaves(params)
    tot, (loss, aux) = _loss_fn(cfg, moe_impl, params, mbatch)
    grads = torch.autograd.grad(tot, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), aux.detach(), grads


def accumulate_grads(cfg, moe_impl, params, batch, accum: int,
                     acc_dtype=torch.float32):
    """(loss, aux, grads) of a global batch in ``accum`` micro-batches,
    as the reference's train step forms them: with one micro-batch the
    gradients as they are; else each micro-batch's gradients cast to
    ``acc_dtype`` and summed in it, the sum divided by ``accum``, the
    losses' float32 sums divided likewise. grads: a list in
    :func:`tree_leaves` order of ``params``."""
    if accum == 1:
        return value_and_grad(cfg, moe_impl, params, batch)
    gsum = lsum = asum = None
    for m in _split(batch, accum):
        loss, aux, g = value_and_grad(cfg, moe_impl, params, m)
        if gsum is None:
            gsum = [torch.zeros(t.shape, dtype=acc_dtype, device=t.device)
                    for t in g]
            lsum = torch.zeros((), dtype=torch.float32, device=loss.device)
            asum = torch.zeros_like(lsum)
        for a, b in zip(gsum, g):
            a.add_(b.to(acc_dtype))
        del g
        lsum, asum = lsum + loss, asum + aux
    return lsum / accum, asum / accum, [g.div_(accum) for g in gsum]


def make_train_step(cfg, moe_impl: str = "gshard",
                    schedule=cosine_schedule):
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``.

    ``params``: the float32 masters, marked trainable
    (:func:`repro_torch.models.trainable`); ``opt_state``:
    :func:`repro_torch.optim.opt_init`'s; ``batch``: tensors with the
    global batch as leading dim ("tokens", "targets", "positions"). With
    ``effective_accum`` > 1 the batch is split into that many
    micro-batches, whose gradients are cast to ``acc_dtype`` (bf16 where
    ``cfg.opt_state_dtype`` is bf16, else float32) and summed in it, then
    divided by their number, as the reference does. The optimizer then
    updates params and state in place (``repro_torch.optim.opt_update``)
    at ``schedule(count)``. ``metrics``: "loss" and "aux_loss" (the
    micro-batches' means), "lr" and "step" (the new count), as 0-dim
    tensors.
    """
    accum = effective_accum(cfg)
    acc_dtype = (torch.bfloat16 if cfg.opt_state_dtype == "bfloat16"
                 else torch.float32)

    def train_step(params, opt_state, batch):
        step = opt_state["count"]
        loss, aux, grads = accumulate_grads(cfg, moe_impl, params, batch,
                                            accum, acc_dtype)
        lr = schedule(step)
        params, opt_state = opt_update(cfg, params,
                                       tree_unflatten(params, grads),
                                       opt_state, lr)
        metrics = {"loss": loss, "aux_loss": aux, "lr": lr,
                   "step": opt_state["count"]}
        return params, opt_state, metrics

    return train_step


def _greedy_ids(cfg, logits):
    """(B, 1, V) last-position logits -> (B,) int32 greedy token ids over
    the real vocab (the padded columns are never chosen). The argmax runs
    on the device, so serving moves B int32 ids to the host per step
    instead of the logits; ``torch.argmax`` takes the first maximum, as
    ``jnp.argmax`` does."""
    return torch.argmax(logits[:, -1, :cfg.vocab_size],
                        dim=-1).to(torch.int32)


def make_prefill_sample_step(cfg, max_len: Optional[int] = None,
                             moe_impl: str = "gshard"):
    """prefill_sample_step(params, batch, cache=None) -> (ids (B,), cache):
    prefill plus device-side greedy sampling of each row's first token.
    With ``cache=None`` a zeroed cache of (B, max_len or S) is made, as
    the reference does (bf16 KV rows, token shifts and conv rows, float32
    rwkv and mamba states); a given cache's rows are written in place.
    ``moe_impl`` goes to ``forward`` (the MoE layers' implementation)."""

    @torch.no_grad()
    def prefill_sample_step(params, batch, cache=None):
        if cache is None:
            B, S = batch["positions"].shape
            cache = zeros_from_specs(cache_specs(cfg, B, max_len or S),
                                     batch["positions"].device)
        x, cache, _ = forward(cfg, params, batch, cache=cache,
                              moe_impl=moe_impl)
        logits = logits_from_hidden(cfg, params, x, last_only=True)
        return _greedy_ids(cfg, logits), cache

    return prefill_sample_step


def make_decode_sample_step(cfg, moe_impl: str = "gshard"):
    """decode_sample_step(params, batch, cache) -> (ids (B,), hid (B, D),
    cache): one decode step plus device-side greedy sampling. The
    last-position hidden block ``hid`` rides along as the MoE-dispatch
    payload of ST-routed decode (the baseline ignores it). ``moe_impl``
    goes to ``forward``."""

    @torch.no_grad()
    def decode_sample_step(params, batch, cache):
        x, cache, _ = forward(cfg, params, batch, cache=cache,
                              moe_impl=moe_impl)
        logits = logits_from_hidden(cfg, params, x, last_only=True)
        return _greedy_ids(cfg, logits), x[:, -1, :], cache

    return decode_sample_step
