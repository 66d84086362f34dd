"""jamba-1.5-large-398b [hybrid] — 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16e top-2, Mamba+attn 1:7 interleave.
[arXiv:2403.19887; hf]

Layer pattern: every 8-layer block = 1 attention + 7 Mamba layers
(mamba_attn_period=8); MoE FFN every other layer (moe_every=2).
398B total / ~94B active: no single card holds it. A caller that serves
it on one card cuts depth, never width, with
``dataclasses.replace(CONFIG, num_layers=4)``: (attn, dense), (mamba,
moe), (mamba, dense), (mamba, moe), 23.0 B params.

The reference's ``subquadratic`` flag comes with the launch and
analysis tooling (ROADMAP Queue 1 item 10).
"""
from repro_torch.configs.base import MambaConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    head_dim=128,
    rope_theta=10_000.0,
    moe=MoEConfig(num_experts=16, top_k=2, expert_ff=24576),
    moe_every=2,
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    mamba_attn_period=8,
    optimizer="adafactor",
    opt_state_dtype="bfloat16",
    grad_accum=16,
    remat="full",
)
