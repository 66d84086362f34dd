"""Input pipelines of the port."""
from repro_torch.data.pipeline import SyntheticTokens, make_batch_iterator

__all__ = ["SyntheticTokens", "make_batch_iterator"]
