"""Plain PyTorch versions of the counter bump and of the puts (unicast and
multicast) that carry their completion signal: the CPU path, and the
yardsticks the CUDA kernels (csrc/counter_bump.cu) are held to."""
from __future__ import annotations


def counter_bump_ref(sig, upd):
    """int32 ``sig + upd``, a new tensor."""
    return sig + upd


def put_signal_ref(x, perm, sig=None, upd=None):
    """Row ``dst`` of a new tensor is row ``perm[dst]`` of ``x``, zeros
    where ``perm[dst]`` is -1 (the zero-filled scatter of a non-periodic
    put); with ``sig``/``upd`` also the new counter buffer ``sig + upd``.
    Both forms are index work on the device: no host sync."""
    out = x.index_select(0, perm.clamp(min=0))
    out.masked_fill_((perm < 0).view((-1,) + (1,) * (x.dim() - 1)), 0)
    if sig is None:
        return out
    return out, sig + upd


def put_multicast_ref(x, perms, sig=None, upd=None):
    """One ``put_signal_ref`` per branch: entry ``b`` of the returned tuple
    takes row ``perms[b, dst]`` of ``x`` into row ``dst``, zeros where
    -1; with ``sig``/``upd`` also the new counter buffer ``sig + upd``."""
    outs = tuple(put_signal_ref(x, p) for p in perms)
    if sig is None:
        return outs
    return outs, sig + upd
