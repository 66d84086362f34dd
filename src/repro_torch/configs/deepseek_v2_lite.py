"""deepseek-v2-lite [moe] — DeepSeek-V2-Lite (15.7B total, 2.4B active):
27L d_model=2048 16H, MLA without query compression (kv_lora 512, nope
128 + rope 64 per head, v 128), YaRN RoPE, 2 shared + 64 routed experts
of width 1408, top-6, vocab 102400, untied head. [arXiv:2405.04434; hf:
deepseek-ai/DeepSeek-V2-Lite config.json]

Layer 0 has a dense SwiGLU FFN of width 10944 (``first_k_dense_replace``
1); layers 1..26 are MoE. What the published block has that
deepseek-v2-236b's port config leaves at its defaults:

  * no query compression (``q_lora_rank`` null): q is one projection
    (d, H, 192) of the normed input (``MLAConfig.q_lora_rank`` 0);
  * YaRN RoPE (factor 40 over 4096 original positions, beta_fast 32,
    beta_slow 1, mscale = mscale_all_dim = 0.707): the rope part's
    frequencies blended between the original and the interpolated ones,
    and the softmax scale multiplied by (1 + 0.1 x 0.707 x ln 40)^2 =
    1.58963;
  * top-6 gates that are the softmax probabilities as they are
    (``norm_topk_prob`` false, ``routed_scaling_factor`` 1).

The rope part's pairs are (i, i + 32), the port's half-split layout;
the published code rotates interleaved pairs (2i, 2i + 1) of its
weights' rope columns, a fixed permutation of those columns.

15.71 B params, 31.4 GB in bf16: one card holds it whole.
"""
from repro_torch.configs.base import (MLAConfig, ModelConfig, MoEConfig,
                                      YaRNConfig)

CONFIG = ModelConfig(
    name="deepseek-v2-lite",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    head_dim=128,
    rope_theta=10_000.0,
    rope_scaling=YaRNConfig(factor=40.0,
                            original_max_position_embeddings=4096,
                            beta_fast=32.0, beta_slow=1.0, mscale=0.707,
                            mscale_all_dim=0.707),
    norm_eps=1e-6,
    moe=MoEConfig(num_experts=64, top_k=6, expert_ff=1408,
                  num_shared=2, shared_ff=2816, renormalize=False),
    first_dense_ff=10944,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    param_dtype="bfloat16",
)
