"""jamba2-mini [hybrid] — AI21-Jamba2-Mini (the Jamba 1.5/1.6/1.7 Mini
family, 52B total / 12B active): 32L d_model=4096 32H (GQA kv=8,
head_dim 128) MoE 16e top-2 of width 14336, Mamba+attn 1:7, vocab
65536, untied head. [hf: ai21labs/AI21-Jamba2-Mini config.json]

Layer pattern, as published: in every 8-layer block one attention layer
at index 4 (``attn_layer_period`` 8, ``attn_layer_offset`` 4), Mamba-1
mixers elsewhere (d_state 16, d_conv 4, expand 2, dt_rank 256, conv
bias, no projection bias); the MoE FFN on the odd layers
(``expert_layer_period`` 2, ``expert_layer_offset`` 1), the dense
SwiGLU FFN (the same width, ``intermediate_size``) on the even ones.

What the published block has that jamba-1.5-large-398b's port config
leaves at its defaults:

  * no RoPE in the attention layers (the Mamba layers carry position);
  * RMSNorms with learned scales on the dt_rank slice, B and C of the
    Mamba ``x_proj`` output (``dt_layernorm``, ``b_layernorm``,
    ``c_layernorm`` in the published modelling code);
  * top-2 gates that are the softmax probabilities as they are, not
    renormalized to sum 1.

The config gives no head dim (4096 / 32 = 128) and no width of its own
for an expert: ``intermediate_size`` is read as it. One card holds one
whole period (8 layers, 13.3 B parameters): a caller that serves it on
one card cuts depth, never width, with
``dataclasses.replace(CONFIG, num_layers=8)``.
"""
from repro_torch.configs.base import MambaConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="jamba2-mini",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    head_dim=128,
    norm_eps=1e-6,
    tie_embeddings=False,
    use_rope=False,
    moe=MoEConfig(num_experts=16, top_k=2, expert_ff=14336,
                  renormalize=False),
    moe_every=2,
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2, dt_rank=256,
                      inner_norms=True),
    mamba_attn_period=8,
    attn_layer_offset=4,
    subquadratic=True,
    param_dtype="bfloat16",
)
