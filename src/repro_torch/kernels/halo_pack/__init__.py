from repro_torch.kernels.halo_pack.ops import (faces_increment, halo_pack,
                                               halo_pack_split, halo_unpack,
                                               halo_unpack_split)
from repro_torch.kernels.halo_pack.ref import (faces_increment_ref,
                                               halo_pack_ref,
                                               halo_unpack_ref)

__all__ = ["faces_increment", "halo_pack", "halo_pack_split", "halo_unpack",
           "halo_unpack_split", "faces_increment_ref", "halo_pack_ref",
           "halo_unpack_ref"]
