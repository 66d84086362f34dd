"""minitron-4b [dense] — 32L d_model=3072 24H (GQA kv=8) d_ff=9216
vocab=256000 (pruned nemotron). [arXiv:2407.14679; hf]"""
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
    # 24 q-heads / 8 kv-heads don't divide the 16-way model axis: run this
    # (small) arch ZeRO-3 style — params sharded over data*model, batch over
    # ("pod","data","model") when divisible, heads replicated.
    sharding_overrides=(
        ("heads", None),
        ("kv_heads", None),
    ),
    grad_accum=8,
    remat="dots",
)
