"""minitron-4b [dense] — 32L d_model=3072 24H (GQA kv=8) d_ff=9216
vocab=256000 (pruned nemotron). [arXiv:2407.14679; hf]

The reference's ``sharding_overrides`` come with the launch and
analysis tooling (ROADMAP Queue 1 item 10).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=9216,
    vocab_size=256000,
    head_dim=128,
    rope_theta=10_000.0,
    grad_accum=8,
    remat="dots",
)
