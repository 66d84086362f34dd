from repro_torch.kernels.counter_bump.ops import (counter_bump,
                                                  put_multicast, put_signal)
from repro_torch.kernels.counter_bump.ref import (counter_bump_ref,
                                                  put_multicast_ref,
                                                  put_signal_ref)

__all__ = ["counter_bump", "counter_bump_ref", "put_multicast",
           "put_multicast_ref", "put_signal", "put_signal_ref"]
