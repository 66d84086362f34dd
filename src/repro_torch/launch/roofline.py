"""Roofline terms from the accounting's records (``launch/dryrun_lib.py``),
as the JAX package's ``launch/roofline.py``, with the constants of one
NVIDIA H100 SXM 80GB (NVIDIA's data sheet):

  peak bf16 compute  : 989 TFLOP/s (dense tensor cores)
  HBM bandwidth      : 3.35 TB/s (HBM3)
  NVLink bandwidth   : 450 GB/s a direction (NVLink 4, 900 GB/s both)
  memory             : 80 GB

Terms (seconds, per executed step, per device):

  compute    = flops_per_device / PEAK_FLOPS
  memory     = bytes_per_device / HBM_BW
  collective = collective_bytes_per_device / LINK_BW

The port counts no collective bytes (no XLA to read them from), so its
records give the collective term 0 and say so.
"""
from __future__ import annotations

from dataclasses import dataclass

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 450e9
HBM_PER_CHIP = 80e9


@dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Perfect-overlap step-time lower bound."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the bound step spent on useful math."""
        if self.step_s == 0:
            return 0.0
        return self.compute_s / self.step_s

    def to_dict(self):
        return {"compute_s": self.compute_s, "memory_s": self.memory_s,
                "collective_s": self.collective_s, "dominant": self.dominant,
                "step_s": self.step_s,
                "roofline_fraction": self.roofline_fraction}


def terms_from(flops_per_device: float, bytes_per_device: float,
               collective_bytes_per_device: float) -> RooflineTerms:
    return RooflineTerms(
        compute_s=flops_per_device / PEAK_FLOPS,
        memory_s=bytes_per_device / HBM_BW,
        collective_s=collective_bytes_per_device / LINK_BW,
    )


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N_active*D (train) / 2*N_active*D (fwd-only), where
    D = tokens processed per step."""
    n_active = cfg.param_counts()["active"]
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch
