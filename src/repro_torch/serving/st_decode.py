"""ST decode router: the serving engine's per-step collectives on the
triggered-op pipeline.

Every decode step of a continuously-batched engine moves (per active
slot) one KV-cache row, one sampled token id, and — for MoE models —
one hidden block to the replica's peers. The router runs that movement
through a scheduled ``TriggeredProgram`` of the ``"serve"`` pattern
(repro_torch.core.serve_decode) instead of per-step host-orchestrated
transfers:

  * programs are built and scheduled ONCE per power-of-two active-slot
    bucket (``autotune.slot_bucket``) and cached — ragged decode
    batches reuse the cached schedule, and the tuned-config cache is
    consulted per bucket under the ``("serve", grid, rpn, "b<bucket>")``
    key when ``config="auto"``;
  * each dispatch stages the payloads into the persistent window state,
    runs ONE ``synchronize`` (mode ``"st"``: the program replayed as one
    CUDA graph on the card; ``"host"``: the per-descriptor baseline;
    ``"fused"``: the progress engine, one graph per segment), and reads
    the engine's sampled token ids back from the COMMITTED ``outtok``
    buffer — the transport is load-bearing, so a schedule or delivery
    defect changes served tokens and the bit-identity tests catch it;
  * payloads are replicated across ranks (each serving replica stands
    for one rank of the decode collective), so the committed buffers
    are bit-identical to the staged ones by construction — the
    ST-vs-baseline equality the tests pin down.

Differences from the JAX package's router, none visible in the tokens:

  * ranks are virtual: the JAX package's rank count defaults to its
    device count (1 on one device); here ``ndev`` ranks (default 1) live
    on one ``device``, as every port stream's do;
  * staging stays on the device: a payload (a tensor on the device, or
    a numpy array) is copied into rows ``:A`` of every rank's window
    buffer and rows ``A:bucket`` are zeroed, in place; the counters are
    zeroed in place before each epoch.

``stats()`` exposes the scheduled program meta per bucket (descriptor
counts, puts/epoch, segments, config label, dispatch count) — this is
what surfaces in ``ServingEngine`` serving stats, with
``payload_bytes()``, the bytes staged by payload.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.core.autotune import (ScheduleConfig, resolve_config,
                                       slot_bucket)
from repro_torch.core.compat import resolve_device
from repro_torch.core.patterns import get_pattern
from repro_torch.core.spans import span
from repro_torch.core.stream import STStream

_MODES = ("st", "host", "fused")


@dataclasses.dataclass
class _BucketEntry:
    """One cached scheduled program + persistent window state."""
    stream: STStream
    win: object
    state: dict
    config: Optional[ScheduleConfig]
    meta: dict
    staged: dict            # bytes one dispatch stages, by payload
    dispatches: int = 0


class STDecodeRouter:
    """Routes decode-step payloads through scheduled serve programs,
    one cached entry per active-slot bucket, on ``ndev`` virtual ranks
    of ``device`` (CUDA by default; ``"cpu"`` for the plain path)."""

    def __init__(self, *, kv_dim: int, d_model: int = 0, moe: bool = False,
                 slot_cap: int = 0, mode: str = "st", config="auto",
                 tuned_path: Optional[str] = None, ndev: int = 1,
                 ranks_per_node: Optional[int] = None,
                 dtype: str = "float32", device="cuda"):
        if mode not in _MODES:
            raise ValueError(f"st_mode must be one of {_MODES}, got {mode!r}")
        if int(ndev) < 1:
            raise ValueError(f"ndev must be >= 1, got {ndev}")
        self.device = resolve_device(device)
        if self.device is None:
            raise ValueError("STDecodeRouter needs a device ('cuda' or "
                             "'cpu')")
        self.kv_dim = int(kv_dim)
        self.d_model = int(d_model)
        self.slot_cap = int(slot_cap)
        self.mode = mode
        self.config = config
        self.tuned_path = tuned_path
        self.ranks_per_node = ranks_per_node
        self.dtype = dtype
        self.ndev = int(ndev)
        # the builder degrades moe to the plain KV ring on one rank
        self.moe = bool(moe) and self.d_model > 0
        self.moe_on = self.moe and self.ndev > 1
        self._entries: Dict[int, _BucketEntry] = {}

    # -- program cache --------------------------------------------------------
    def _resolve(self, bucket: int) -> Optional[ScheduleConfig]:
        spec = resolve_config(self.config, "serve", grid=(self.ndev,),
                              ranks_per_node=self.ranks_per_node,
                              size=f"b{bucket}", path=self.tuned_path,
                              slots=bucket, kv_dim=self.kv_dim,
                              d_model=self.d_model, moe=self.moe)
        if spec is not None and self.mode == "fused" and not spec.fused:
            # mode="fused" implies fused scheduling; a tuned config that
            # predates (or pruned) the knob must not undo it
            spec = dataclasses.replace(spec, fused=True)
        return spec

    def _entry(self, bucket: int) -> _BucketEntry:
        e = self._entries.get(bucket)
        if e is not None:
            return e
        spec = self._resolve(bucket)
        stream = STStream(self.device, ("data",), grid_shape=(self.ndev,))
        build_kw = dict(slots=bucket, kv_dim=self.kv_dim,
                        d_model=self.d_model, moe=self.moe,
                        dtype=self.dtype,
                        ranks_per_node=self.ranks_per_node)
        if spec is not None:
            ov = spec.build_overrides()
            ov.pop("multicast", None)       # serve has no multicast knob
            build_kw.update(ov)
        win, _ = get_pattern("serve").build(stream, 1, **build_kw)
        state = stream.allocate()
        sched_kw = spec.sched_kwargs() if spec is not None else {}
        if self.mode == "fused":
            sched_kw["fused"] = True
        progs = stream.scheduled_programs(**sched_kw)
        meta = dict(progs[0].stats(), bucket=bucket, mode=self.mode,
                    ndev=self.ndev, moe=self.moe_on,
                    config=spec.label() if spec is not None else "default")
        bufs = {"kv": "kv", "ids": "tok"}
        if self.moe_on:
            bufs["hid"] = "hid"
        staged = {k: state[win.qual(b)].numel()
                  * state[win.qual(b)].element_size()
                  for k, b in bufs.items()}
        e = _BucketEntry(stream=stream, win=win, state=state, config=spec,
                         meta=meta, staged=staged)
        self._entries[bucket] = e
        return e

    # -- dispatch -------------------------------------------------------------
    def _stage(self, e: _BucketEntry, name: str, x) -> None:
        """Land an (A, ...) payload in rows ``:A`` of every rank's
        ``name`` buffer (converted to its dtype) and zero the rows past
        it, in place on the device."""
        buf = e.state[e.win.qual(name)]           # (R, bucket, ...)
        x = torch.as_tensor(x)
        A = x.shape[0]
        buf[:, :A].copy_(x)                        # broadcast over ranks
        buf[:, A:].zero_()

    def dispatch(self, kv_rows, tok_ids, hid=None):
        """Run one decode access epoch. ``kv_rows`` (A, kv_dim) is the
        step's new KV-cache rows, ``tok_ids`` (A,) int32 the device-
        sampled token ids, ``hid`` (A, d_model) the hidden block for
        MoE dispatch (required when the router was built with moe on a
        multi-rank grid): tensors on the router's device, or numpy
        arrays. Returns ``(tok, mirror, hmir)`` on the host (numpy), read
        back from the COMMITTED window buffers of rank 0, truncated to A
        rows (hmir is None without MoE dispatch)."""
        A = int(tok_ids.shape[0])
        bucket = slot_bucket(A, self.slot_cap)
        e = self._entry(bucket)
        with span("repro_torch.router.stage"):
            self._stage(e, "kv", kv_rows)
            self._stage(e, "tok", tok_ids)
            if self.moe_on:
                if hid is None:
                    raise ValueError("dispatch: hid payload required "
                                     "with moe")
                self._stage(e, "hid", hid)
            # the persistent counters accumulate across dispatches; reset
            # them so every epoch starts from the program's expected zeros
            for cname in e.win.counter_names():
                e.state[cname].zero_()
        sync_kw = dict(mode=self.mode)
        if e.config is not None:
            sync_kw["config"] = e.config
        e.state = e.stream.synchronize(e.state, **sync_kw)
        e.dispatches += 1
        q = e.win.qual

        def host(name):
            return e.state[q(name)][0, :A].cpu().numpy().copy()

        with span("repro_torch.router.readback"):
            return (host("outtok"), host("mirror"),
                    host("hmir") if self.moe_on else None)

    # -- reporting ------------------------------------------------------------
    def stats(self) -> dict:
        return {"pattern": "serve", "mode": self.mode, "ndev": self.ndev,
                "moe": self.moe_on,
                "buckets": {b: dict(e.meta, dispatches=e.dispatches)
                            for b, e in sorted(self._entries.items())}}

    def payload_bytes(self) -> dict:
        """The bytes the dispatches staged, by payload ("kv", "ids",
        "hid"): each dispatch stages every rank's whole bucket of each."""
        total = {k: 0 for k in ("kv", "ids", "hid")}
        for e in self._entries.values():
            for k, n in e.staged.items():
                total[k] += n * e.dispatches
        return total


__all__ = ["STDecodeRouter"]
