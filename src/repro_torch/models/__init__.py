"""Models of the port: attention, cross-attention, MLA, mamba and rwkv
mixers; dense, MoE and rwkv FFNs; the modality frontend stub."""
from repro_torch.models.model import (cache_specs, forward, lm_loss,
                                      lm_loss_fused, logits_from_hidden,
                                      model_specs)
from repro_torch.models.params import (ParamSpec, from_reference,
                                       init_params, opt_state_from_reference,
                                       param_count, stack_specs, trainable,
                                       zeros_from_specs)

__all__ = [
    "model_specs", "cache_specs", "forward", "logits_from_hidden",
    "lm_loss", "lm_loss_fused", "ParamSpec", "from_reference",
    "init_params", "opt_state_from_reference", "param_count",
    "stack_specs", "trainable", "zeros_from_specs",
]
