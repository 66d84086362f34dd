"""Serving steps: prefill and decode with device-side greedy sampling,
following the serving half of the JAX package's ``train/steps.py``
(training steps are ROADMAP Queue 1 item 9).

The reference's steps are pure (a prefill builds a new cache, a decode
returns an updated copy); the port's write the KV cache in place and
return it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import cache_specs, forward, logits_from_hidden
from repro_torch.models.params import zeros_from_specs


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

    def decode_sample_step(params, batch, cache):
        x, cache, _ = forward(cfg, params, batch, cache=cache,
                              moe_impl=moe_impl)
        logits = logits_from_hidden(cfg, params, x, last_only=True)
        return _greedy_ids(cfg, logits), x[:, -1, :], cache

    return decode_sample_step
