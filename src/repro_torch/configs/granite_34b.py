"""granite-34b [dense] — 88L d_model=6144 48H (GQA kv=1, i.e. MQA)
d_ff=24576 vocab=49152 (llama-arch, code). [arXiv:2405.04324; hf]

MQA: the 48 query heads of a decode step share one KV head (G = 48)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    head_dim=128,
    rope_theta=10_000.0,
    grad_accum=4,
    remat="full",
)
