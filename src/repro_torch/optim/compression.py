"""Gradient compression with error feedback, following the JAX
package's ``optim/compression.py``.

int8 per-block quantization: g -> (int8 codes, float32 scale per block
of ``BLOCK`` values). Compressing before a gradient all-reduce cuts its
bytes 4x (float32) or 2x (bf16); the error fed back into the next
gradient keeps the sum of what is sent unbiased. Nothing in the port
calls it yet, as nothing in the reference does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

BLOCK = 1024


def compress_grad(g, error=None):
    """g: a float tensor of any shape -> (codes int8 (n_blocks, BLOCK),
    scales float32 (n_blocks,), new_error float32 of g's shape)."""
    gf = g.float()
    if error is not None:
        gf = gf + error
    flat = gf.reshape(-1)
    n = flat.numel()
    blocks = F.pad(flat, (0, (-n) % BLOCK)).view(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
    codes = torch.clamp(torch.round(blocks / scale), -127, 127).to(
        torch.int8)
    recon = (codes.float() * scale).reshape(-1)[:n].reshape(g.shape)
    return codes, scale[:, 0], gf - recon


def decompress_grad(codes, scales, shape):
    flat = (codes.float() * scales[:, None]).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(shape)
