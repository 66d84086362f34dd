"""Config system of the port: model configs + arch registry.

A copy of the JAX package's ``configs/base.py`` (pure Python; the port
keeps its own copy and imports nothing of that package). Every ported
architecture provides a module in ``repro_torch.configs`` exposing
``CONFIG: ModelConfig``; ``get_config(arch_id)`` resolves them. Reduced
configs (for CPU tests) are derived with ``ModelConfig.reduced()``.

Differences from the copy's original:

  * ``attn_impl`` names the port's attention routes: ``"kernel"`` (the
    default: the hand-written CUDA kernels for CUDA tensors, their plain
    PyTorch versions for CPU tensors) or ``"plain"`` (the plain versions
    on any device, the reference a run on the card is held against);
  * of the reference's training knobs only those a step reads are kept
    (``optimizer``, ``opt_state_dtype``, ``remat``, ``grad_accum``), with
    the reference's defaults and each arch's values; ``reduced()`` sets
    them as the reference's does, but keeps ``attn_impl``. The port
    trains float32 masters, as the reference's launcher makes them, so
    ``param_dtype`` is not kept; ``seq_shard_activations`` and
    ``overlap_grad_reduce`` shape the reference's sharding and gradient
    reduction and come with sharding (ROADMAP Queue 1 item 10);
  * the dry-run knobs (``subquadratic``, ``sharding_overrides``,
    ``unroll_inner``), ``param_counts()`` and the input-shape sets
    (``SHAPES``) come with the launch and analysis tooling (ROADMAP
    Queue 1 item 10).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence

# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int          # routed experts
    top_k: int
    expert_ff: int            # d_ff of each routed expert
    num_shared: int = 0       # shared (always-on) experts
    shared_ff: int = 0        # total d_ff of the shared expert block
    router_aux_coef: float = 0.01
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0          # 0 -> ceil(d_model/16)


@dataclass(frozen=True)
class RWKVConfig:
    head_size: int = 64


@dataclass(frozen=True)
class VisionStub:
    """VLM/audio modality frontend stub: input_specs() provides precomputed
    patch/frame embeddings; a single projection maps them to d_model."""
    num_tokens: int = 1600    # patch/frame tokens per example
    raw_dim: int = 1280       # pre-projection embedding dim


# ---------------------------------------------------------------------------
# Layer pattern
# ---------------------------------------------------------------------------

# A block spec is (mixer, ffn):
#   mixer in {"attn", "mla", "cross", "mamba", "rwkv"}
#   ffn   in {"dense", "moe", "rwkv"}  ("rwkv" = channel-mix)
BlockSpec = tuple


@dataclass(frozen=True)
class LayerGroups:
    """Model body = [unique prefix blocks] + repeating unit * repeats."""
    prefix: tuple            # tuple[BlockSpec]
    unit: tuple              # tuple[BlockSpec]
    repeats: int

    @property
    def num_layers(self) -> int:
        return len(self.prefix) + len(self.unit) * self.repeats

    def all_specs(self) -> list:
        return list(self.prefix) + list(self.unit) * self.repeats


def group_layers(specs: Sequence[BlockSpec], max_unit: int = 8) -> LayerGroups:
    """Compress a per-layer spec list into prefix + repeated unit (for scan)."""
    n = len(specs)
    best = LayerGroups(prefix=tuple(specs), unit=(), repeats=0)
    best_unique = n
    for u in range(1, max_unit + 1):
        if u > n:
            break
        k = 0
        # count repeats of the final u-length unit walking backwards
        unit = tuple(specs[n - u:n])
        i = n - u
        k = 1
        while i - u >= 0 and tuple(specs[i - u:i]) == unit:
            i -= u
            k += 1
        unique = i + u  # prefix length + one unit's params
        if k >= 2 and unique < best_unique:
            best_unique = unique
            best = LayerGroups(prefix=tuple(specs[:i]), unit=unit, repeats=k)
    return best


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str               # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0         # 0 -> d_model // num_heads
    qk_norm: bool = False
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # layer-pattern knobs
    moe: Optional[MoEConfig] = None
    moe_every: int = 1            # apply MoE FFN every k-th layer
    first_dense_ff: int = 0       # deepseek: first layer dense FFN width
    mla: Optional[MLAConfig] = None
    mamba: Optional[MambaConfig] = None
    mamba_attn_period: int = 0    # jamba: 1 attn per k layers
    rwkv: Optional[RWKVConfig] = None
    cross_attn_period: int = 0    # vlm: 1 cross-attn layer per k layers
    vision: Optional[VisionStub] = None

    # memory / numerics policy, and the attention route
    compute_dtype: str = "bfloat16"
    optimizer: str = "adamw"          # adamw | adafactor
    opt_state_dtype: str = "float32"  # moments dtype
    remat: str = "full"               # none | dots | comm | full
    grad_accum: int = 1               # microbatch accumulation steps
    attn_impl: str = "kernel"         # kernel | plain (see module doc)

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 256 so the embedding shards over any mesh
        axis (granite-3-2b's 49155 is otherwise indivisible)."""
        return -(-self.vocab_size // 256) * 256

    # -- layer pattern ------------------------------------------------------
    def layer_specs(self) -> list:
        specs = []
        for i in range(self.num_layers):
            # mixer
            if self.rwkv is not None:
                mixer = "rwkv"
            elif self.mamba_attn_period:
                mixer = "attn" if i % self.mamba_attn_period == 0 else "mamba"
            elif self.cross_attn_period:
                # cross-attn layer at the END of each period group
                mixer = ("cross" if (i % self.cross_attn_period
                                     == self.cross_attn_period - 1) else "attn")
            elif self.mla is not None:
                mixer = "mla"
            else:
                mixer = "attn"
            # ffn
            if self.rwkv is not None:
                ffn = "rwkv"
            elif self.moe is not None:
                if i == 0 and self.first_dense_ff:
                    ffn = "dense"
                elif i % self.moe_every == (self.moe_every - 1):
                    ffn = "moe"
                else:
                    ffn = "dense"
            else:
                ffn = "dense"
            specs.append((mixer, ffn))
        return specs

    def layer_groups(self) -> LayerGroups:
        return group_layers(self.layer_specs())

    def dense_ff_for(self, layer_idx: int) -> int:
        if layer_idx == 0 and self.first_dense_ff:
            return self.first_dense_ff
        return self.d_ff

    # -- reduced config for CPU smoke tests ---------------------------------
    def reduced(self) -> "ModelConfig":
        changes: dict = dict(
            num_layers=max(2, min(4, len(self.layer_groups().unit) or 2)),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 4) if self.num_kv_heads > 1 else 1,
            d_ff=256,
            vocab_size=512,
            head_dim=32,
            first_dense_ff=64 if self.first_dense_ff else 0,
            grad_accum=1,
            remat="none",
            opt_state_dtype="float32",
            optimizer="adamw",
        )
        if self.moe is not None:
            changes["moe"] = dataclasses.replace(
                self.moe, num_experts=min(self.moe.num_experts, 8),
                top_k=min(self.moe.top_k, 2), expert_ff=64,
                shared_ff=64 if self.moe.num_shared else 0)
        if self.mla is not None:
            changes["mla"] = MLAConfig(kv_lora_rank=32, q_lora_rank=48,
                                       qk_nope_head_dim=32, qk_rope_head_dim=16,
                                       v_head_dim=32)
        if self.mamba is not None:
            changes["mamba"] = MambaConfig(d_state=8, d_conv=4, expand=2, dt_rank=8)
        if self.rwkv is not None:
            changes["rwkv"] = RWKVConfig(head_size=32)
            changes["num_heads"] = 4
        if self.mamba_attn_period:
            changes["num_layers"] = min(self.mamba_attn_period, 8)
        if self.cross_attn_period:
            changes["num_layers"] = self.cross_attn_period
        if self.vision is not None:
            changes["vision"] = VisionStub(num_tokens=16, raw_dim=64)
        return dataclasses.replace(self, **changes)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

# every architecture of the JAX package
ARCH_IDS = [
    "llama-3.2-vision-90b",
    "granite-3-2b",
    "qwen3-32b",
    "minitron-4b",
    "granite-34b",
    "musicgen-large",
    "jamba-1.5-large-398b",
    "deepseek-v2-236b",
    "deepseek-moe-16b",
    "rwkv6-1.6b",
]

_MODULES = {
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
    "granite-3-2b": "granite_3_2b",
    "qwen3-32b": "qwen3_32b",
    "minitron-4b": "minitron_4b",
    "granite-34b": "granite_34b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "musicgen-large": "musicgen_large",
    "rwkv6-1.6b": "rwkv6_1_6b",
}


def get_config(arch: str) -> ModelConfig:
    import importlib
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG
