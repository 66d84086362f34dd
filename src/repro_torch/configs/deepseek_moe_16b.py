"""deepseek-moe-16b [moe] — 28L d_model=2048 16H (MHA kv=16) d_ff=1408(expert)
vocab=102400, 2 shared + 64 routed top-6, fine-grained. [arXiv:2401.06066; hf]

First layer dense FFN (width 10944) per the HF config; layers 1..27 MoE.
16.38 B params, 32.8 GB in bf16: one card holds it whole.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    head_dim=128,
    rope_theta=10_000.0,
    moe=MoEConfig(num_experts=64, top_k=6, expert_ff=1408,
                  num_shared=2, shared_ff=2816),
    first_dense_ff=10944,
    grad_accum=2,
    remat="dots",
)
