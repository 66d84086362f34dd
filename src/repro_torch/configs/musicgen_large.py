"""musicgen-large [audio] — 48L d_model=2048 32H (MHA: kv=32) d_ff=8192
vocab=2048, decoder-only over EnCodec tokens. [arXiv:2306.05284; hf]

Modality frontend is a STUB: the caller provides precomputed EnCodec
frame embeddings; the decoder backbone is what we build (the transformer
operates on frame embeddings and predicts codebook tokens, vocab=2048).
"""
from repro_torch.configs.base import ModelConfig, VisionStub

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    head_dim=64,
    rope_theta=10_000.0,
    # EnCodec frame embeddings arrive precomputed (stub frontend): raw_dim
    # is the frame-embedding width, projected to d_model by one matmul.
    # The assigned spec is the decoder backbone only, so no cross-attn.
    vision=VisionStub(num_tokens=0, raw_dim=128),
    grad_accum=2,
    remat="dots",
)
