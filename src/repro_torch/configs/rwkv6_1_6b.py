"""rwkv6-1.6b [ssm] — 24L d_model=2048 (attn-free) d_ff=7168 vocab=65536.
Finch: data-dependent decay. [arXiv:2404.05892; unverified]

Attention-free; time-mix (WKV6) + channel-mix blocks. head_size=64 ->
32 heads. Sub-quadratic -> runs long_500k.
"""
from repro_torch.configs.base import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,            # d_model / head_size
    num_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    head_dim=64,
    rwkv=RWKVConfig(head_size=64),
    subquadratic=True,
    grad_accum=2,
    remat="dots",
)
