"""llama-3.2-vision-90b [vlm] — 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256, cross-attn image layers (1 per 5).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]

The modality frontend is a STUB: the caller provides precomputed patch
embeddings (num_tokens x raw_dim); a learned projection maps them to d_model.

87.67 B params: no single card holds it. A caller that serves it on one
card cuts depth, never width, in whole 5-layer periods, with
``dataclasses.replace(CONFIG, num_layers=20)``: 4 x (4 attn, 1 cross),
19.21 B params.
"""
from repro_torch.configs.base import ModelConfig, VisionStub

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    head_dim=128,
    rope_theta=500_000.0,
    cross_attn_period=5,          # 80 self-attn + 20 cross-attn layers
    vision=VisionStub(num_tokens=1600, raw_dim=1280),
    opt_state_dtype="bfloat16",
    grad_accum=16,
    remat="full",
)
