"""deepseek-v2-236b [moe] — 60L d_model=5120 128H d_ff=1536(expert)
vocab=102400, MLA kv_lora=512, 2 shared + 160 routed top-6.
[arXiv:2405.04434; hf]

First layer uses a dense FFN (width 12288) per the HF config; layers 1..59
are MoE. MLA: q_lora 1536, kv_lora 512, nope 128 / rope 64 per head,
v_head_dim 128, so a prefill's attention runs at (hd, hdv) = (192, 128).

235.7 B params: no single card holds it. A caller that serves it on one
card cuts depth, never width, with ``dataclasses.replace(CONFIG,
num_layers=4)``: (mla, dense), then 3 x (mla, moe), 13.30 B params.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    d_ff=1536,
    vocab_size=102400,
    head_dim=128,
    rope_theta=10_000.0,
    moe=MoEConfig(num_experts=160, top_k=6, expert_ff=1536,
                  num_shared=2, shared_ff=3072),
    first_dense_ff=12288,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    param_dtype="bfloat16",
    opt_state_dtype="bfloat16",
    grad_accum=8,
    remat="full",
)
