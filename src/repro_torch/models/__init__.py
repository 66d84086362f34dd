"""Models of the port: attention, cross-attention, MLA, mamba and rwkv
mixers; dense, MoE and rwkv FFNs; the modality frontend stub."""
from repro_torch.models.model import (cache_specs, forward,
                                      logits_from_hidden, model_specs)
from repro_torch.models.params import (ParamSpec, from_reference,
                                       init_params, param_count,
                                       stack_specs, zeros_from_specs)

__all__ = [
    "model_specs", "cache_specs", "forward", "logits_from_hidden",
    "ParamSpec", "from_reference", "init_params", "param_count",
    "stack_specs", "zeros_from_specs",
]
