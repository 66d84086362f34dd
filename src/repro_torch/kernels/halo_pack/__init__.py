from repro_torch.kernels.halo_pack.ops import (halo_pack, halo_pack_split,
                                               halo_unpack,
                                               halo_unpack_split)
from repro_torch.kernels.halo_pack.ref import (halo_pack_ref,
                                               halo_unpack_ref)

__all__ = ["halo_pack", "halo_pack_split", "halo_unpack",
           "halo_unpack_split", "halo_pack_ref", "halo_unpack_ref"]
