"""Mamba (selective SSM) mixer — jamba-style interleaved layers,
following the JAX package's ``models/mamba.py``.

Projections and the depthwise causal conv are plain PyTorch around the
selective scan, which ``cfg.attn_impl`` routes as it routes attention:
``"kernel"`` calls :func:`..kernels.mamba_scan.mamba_scan` (the
hand-written CUDA kernel for CUDA tensors, its plain version for CPU
tensors), ``"plain"`` calls :func:`..kernels.mamba_scan.mamba_scan_ref`
on any device. The reference's chunked, checkpointed ``_ssm_scan`` is
for training and is not ported: it computes the plain version's
function.

``a_log`` arrives in float32 (:mod:`.params`), as the reference's scan
reads it; the other leaves cast to the compute dtype at use, as there.
With a cache, the layer's ``conv`` rows (the last d_conv - 1 inputs of
the conv, in the cache dtype) and ``ssm`` state (float32) are written IN
PLACE (the reference returns a new cache); each is read before it is
written.

``cfg.mamba.inner_norms`` (Jamba's block; the JAX package has no such
switch) applies an RMSNorm with a learned scale (``dt_norm``,
``b_norm``, ``c_norm``) and ``cfg.norm_eps`` to the dt_rank slice, B and
C of the ``x_proj`` output before ``dt_proj`` and the scan, on every
route: the kernel, the plain version and a decode step. Each norm is
:func:`.layers.add_norm` without a residual: the rmsnorm kernel, reading
its slice in place, where ``layers.kernel_route`` allows.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba_scan import mamba_scan, mamba_scan_ref
from repro_torch.models.layers import add_norm
from repro_torch.models.params import ParamSpec


def _dims(cfg):
    mb = cfg.mamba
    d_inner = mb.expand * cfg.d_model
    dt_rank = mb.dt_rank or -(-cfg.d_model // 16)
    return d_inner, dt_rank


def mamba_specs(cfg) -> dict:
    mb, d = cfg.mamba, cfg.d_model
    di, dtr = _dims(cfg)
    s = {
        "in_proj":  ParamSpec((d, 2 * di), ("embed", "mlp")),
        "conv_w":   ParamSpec((mb.d_conv, di), ("conv", "mlp"), scale=0.1),
        "conv_b":   ParamSpec((di,), ("mlp",), init="zeros"),
        "x_proj":   ParamSpec((di, dtr + 2 * mb.d_state), ("mlp", None)),
        "dt_proj":  ParamSpec((dtr, di), (None, "mlp"), scale=0.1),
        "dt_bias":  ParamSpec((di,), ("mlp",), init="zeros"),
        "a_log":    ParamSpec((di, mb.d_state), ("mlp", "state"),
                              init="zeros"),
        "d_skip":   ParamSpec((di,), ("mlp",), init="ones"),
        "out_proj": ParamSpec((di, d), ("mlp", "embed")),
    }
    if mb.inner_norms:
        s["dt_norm"] = ParamSpec((dtr,), (None,), init="ones")
        s["b_norm"] = ParamSpec((mb.d_state,), ("state",), init="ones")
        s["c_norm"] = ParamSpec((mb.d_state,), ("state",), init="ones")
    return s


def mamba_cache_specs(cfg, batch: int):
    """Returns {name: (shape, logical_axes)}: no sequence axis, the
    state of each sequence."""
    mb = cfg.mamba
    di, _ = _dims(cfg)
    return {
        "conv": ((batch, mb.d_conv - 1, di), ("batch", None, "mlp")),
        "ssm":  ((batch, di, mb.d_state), ("batch", "mlp", "state")),
    }


def _causal_conv(params, x, conv_state):
    """x: (B,S,di); depthwise causal conv as d_conv shifted
    multiply-adds. Returns (y, the last d_conv - 1 inputs)."""
    B, S, di = x.shape
    dc = params["conv_w"].shape[0]
    if conv_state is None:
        pad = torch.zeros((B, dc - 1, di), dtype=x.dtype, device=x.device)
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                       # (B, S+dc-1, di)
    w = params["conv_w"].to(x.dtype)
    y = sum(xp[:, j:j + S, :] * w[j] for j in range(dc))
    y = y + params["conv_b"].to(x.dtype)
    return y, xp[:, -(dc - 1):, :]


def mamba(cfg, params, x, *, cache=None):
    """Pre-norm'd x (B,S,D) -> (mixer output, cache)."""
    if cfg.attn_impl not in ("kernel", "plain"):
        raise ValueError(f"attn_impl {cfg.attn_impl!r}: the port has "
                         "'kernel' and 'plain'")
    mb = cfg.mamba
    dt_ = x.dtype
    B, S, _ = x.shape
    di, dtr = _dims(cfg)

    xz = torch.matmul(x, params["in_proj"].to(dt_))
    xi, z = xz[..., :di], xz[..., di:]
    xc, new_conv = _causal_conv(params, xi,
                                cache["conv"] if cache is not None else None)
    xc = F.silu(xc)

    xdb = torch.matmul(xc, params["x_proj"].to(dt_))
    dt_low = xdb[..., :dtr]
    b_ssm = xdb[..., dtr:dtr + mb.d_state]             # strided views
    c_ssm = xdb[..., dtr + mb.d_state:]
    if mb.inner_norms:
        _, dt_low = add_norm(cfg, {"scale": params["dt_norm"]}, dt_low)
        _, b_ssm = add_norm(cfg, {"scale": params["b_norm"]}, b_ssm)
        _, c_ssm = add_norm(cfg, {"scale": params["c_norm"]}, c_ssm)
    dt = F.softplus(torch.matmul(dt_low, params["dt_proj"].to(dt_))
                    + params["dt_bias"].to(dt_))

    if cache is None:
        h0 = torch.zeros((B, di, mb.d_state), dtype=torch.float32,
                         device=x.device)
    else:
        h0 = cache["ssm"]
    if cfg.attn_impl == "plain":
        y, hT = mamba_scan_ref(params["a_log"], dt, b_ssm, c_ssm, xc, h0)
        if cache is not None:
            cache["ssm"].copy_(hT)
    else:
        y, _ = mamba_scan(params["a_log"], dt, b_ssm, c_ssm, xc, h0,
                          inplace=cache is not None)
    y = y + params["d_skip"].to(dt_) * xc
    y = y * F.silu(z)
    out = torch.matmul(y, params["out_proj"].to(dt_))
    if cache is not None:
        cache["conv"].copy_(new_conv)
    return out, cache
