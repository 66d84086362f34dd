"""input_specs(): meta-tensor stand-ins for every model input, per
(arch, shape) cell — the JAX package's ``launch/specs.py`` with tensors
on ``torch.device("meta")`` in place of ``ShapeDtypeStruct``s: shapes
and dtypes only, no allocation.

The trees are the port's: params and caches keep one dict per layer
(``{"layers": [...]}``), where the reference stacks its repeated unit;
the leaves' shapes and dtypes are the reference's, layer by layer.
"""
from __future__ import annotations

import torch

from repro_torch.configs import ModelConfig, ShapeConfig
from repro_torch.models import cache_specs, model_specs
from repro_torch.models.params import META, abstract_params, param_pspecs


def _meta(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Abstract input batch for a (cfg, shape) cell."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        d = {"tokens": _meta((B, 1), torch.int32),
             "positions": _meta((B, 1), torch.int32)}
        if cfg.family == "vlm":
            d["vision"] = _meta((B, cfg.vision.num_tokens,
                                 cfg.vision.raw_dim), torch.bfloat16)
        return d
    d = {"positions": _meta((B, S), torch.int32)}
    if cfg.family == "audio":
        d["frames"] = _meta((B, S, cfg.vision.raw_dim), torch.bfloat16)
    else:
        d["tokens"] = _meta((B, S), torch.int32)
    if cfg.family == "vlm":
        d["vision"] = _meta((B, cfg.vision.num_tokens, cfg.vision.raw_dim),
                            torch.bfloat16)
    if shape.kind == "train":
        d["targets"] = _meta((B, S), torch.int32)
    return d


BATCH_AXES = {
    "tokens": ("batch", None),
    "targets": ("batch", None),
    "positions": ("batch", None),
    "frames": ("batch", None, None),
    "vision": ("batch", None, None),
}


def batch_pspecs(cfg: ModelConfig, shape: ShapeConfig, rules) -> dict:
    return {k: rules.pspec(BATCH_AXES[k]) for k in batch_specs(cfg, shape)}


def abstract_cache(cfg: ModelConfig, shape: ShapeConfig):
    return abstract_params(
        cache_specs(cfg, shape.global_batch, shape.seq_len), dtype=None)


def cache_pspecs(cfg: ModelConfig, shape: ShapeConfig, rules):
    return param_pspecs(
        cache_specs(cfg, shape.global_batch, shape.seq_len), rules)


def abstract_model(cfg: ModelConfig):
    """The model's params, every leaf in ``cfg.param_dtype``, as the
    reference's. The port's trainer holds float32 masters whatever
    ``param_dtype`` says, and the accounting counts those."""
    return abstract_params(model_specs(cfg),
                           dtype=getattr(torch, cfg.param_dtype))


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """All abstract inputs for the cell's step function (sans params)."""
    out = {"batch": batch_specs(cfg, shape)}
    if shape.kind == "decode":
        out["cache"] = abstract_cache(cfg, shape)
    return out
