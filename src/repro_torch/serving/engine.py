"""Continuously-batched prefill/decode serving engine (the baseline,
following the JAX package's ``serving/engine.py`` with ``st_mode=None``).

Requests queue up (FIFO deque); the engine fills a fixed batch of decode
slots and recycles a slot as soon as its sequence finishes (EOS, max
tokens or a full cache), keeping the decode batch full under churn.
Admission is continuous and batched: every engine step takes as many
queued requests as there are free slots, groups them by prompt length,
and prefills each length group in ONE dispatch. Sampling is device-side
— the steps return (B,) greedy token ids, so a decode step moves B int32
ids to the host instead of the logits. Per-slot positions support ragged
sequence lengths inside one batch.

Differences from the reference, none visible in the tokens:

  * a prefill runs on the group's rows only (the reference runs all B
    slots, mostly padding) and writes into the slots' cache rows IN
    PLACE: the slots' rows of every layer's cache as one view when the
    slots are consecutive, else gathered and written back after the
    dispatch — the first L rows of a leaf with a sequence axis (KV), a
    state leaf (rwkv's token shifts and WKV state, mamba's conv rows
    and SSM state) whole. The reference builds a whole new zeroed (B,
    max_len) cache and merges the group's rows. Stale KV rows past the
    prompt are masked by the valid length, but a recurrent state is
    read whole, so the group's state leaves are zeroed before the
    dispatch (a recycled slot would otherwise start from the previous
    request's state: for mamba, its last 3 conv inputs and its SSM
    state);
  * a vlm's prefill gets the reference's zero vision inputs, its
    decode step none: the cross layers read the vision K/V their
    prefill wrote into the cache (the reference builds zero vision at
    decode too, which no layer reads);
  * the decode step updates the cache in place (the reference donates
    it to a jitted step). On a CUDA device the (batch_slots, 1) decode
    step is replayed as one CUDA graph, the counterpart of the
    reference's jitted step (:class:`repro_torch.core.graphs.StepGraph`):
    the first decode step runs eagerly and is the warm-up, the second is
    captured, and every later step copies the tokens and positions into
    the graph's static buffers and replays it. The graph reads the
    weights and reads and writes the cache at their addresses, which
    prefill, eager, writes between replays. Prefill stays eager: its
    shapes change with every length group. On the CPU the decode step
    runs eagerly.

``st_mode`` ("st", "host" or "fused") routes the decode step's
collectives — the new KV-cache row, the sampled token ids and (for MoE
models) the hidden block — through scheduled triggered-op programs of
the ``"serve"`` pattern (:class:`repro_torch.serving.st_decode.
STDecodeRouter`): one cached schedule per power-of-two active-slot
bucket, resolved through the tuner when ``st_config="auto"``, the token
ids committed back THROUGH the transport (bit-identical to the baseline
by construction), program meta surfaced in :meth:`stats`. On the card
a step is then two graphs replayed in turn, the decode step's and the
router's program (st; fused: one per segment; host mode stays eager),
never one captured inside the other. The reference's rank count is its
device count; here ``st_ranks`` virtual ranks share the engine's device.
``st_mode=None`` is the baseline.

Requests carry the timestamps: ``submitted_at`` (queue entry),
``admitted_at`` (prefill dispatch), ``first_token_at`` (TTFT),
``done_at`` (completion). ``stats()`` adds the host seconds spent in
prefill and decode dispatches, each ending when its ids reach the host,
and in ST mode the host seconds of the router's dispatches
(``st_dispatch_seconds``: payload gather and staging, the program, the
committed ids back on the host) and the bytes it staged by payload
(``st_payload_bytes``). For a model with MoE layers it counts, on the
host from each dispatch's shape, the expert rows computed
(``moe_rows_computed``: under "dense" every expert on every row of the
batch, idle decode slots included) and the rows routed to
(``moe_rows_routed``: ``top_k`` a real token), over all MoE layers.
For a model with MLA layers it counts, on the host from each decode
step's slots, ``max_len`` and positions, the latent cache rows the
absorbed decode scored (``mla_rows_scored``: every slot's ``max_len``
rows, idle slots included, the mask made on the device) and the valid
ones among them (``mla_rows_valid``: position + 1 an active slot), over
all MLA layers.
"""
from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import graphs
from repro_torch.core.compat import resolve_device
from repro_torch.core.spans import span
from repro_torch.models import cache_specs
from repro_torch.models.params import zeros_from_specs
from repro_torch.train.steps import (make_decode_sample_step,
                                     make_prefill_sample_step)

_req_ids = itertools.count()


@dataclass
class Request:
    prompt: np.ndarray                  # (prompt_len,) int32
    max_new_tokens: int = 16
    eos_id: int = -1                    # -1: never stop early
    req_id: int = field(default_factory=lambda: next(_req_ids))
    out_tokens: List[int] = field(default_factory=list)
    submitted_at: float = field(default_factory=time.monotonic)
    admitted_at: Optional[float] = None
    first_token_at: Optional[float] = None
    done_at: Optional[float] = None


class ServingEngine:
    """``params``: the port's param tree (``init_params`` /
    ``from_reference``) on ``device``. ``device`` defaults to CUDA and
    raises without a card; pass ``"cpu"`` for the plain path on the
    CPU. ``moe_impl`` is the MoE layers' implementation ("dense", the
    reference engine's default, "gshard", or "a2a": the gather-based
    expert-parallel MoE on one shard).

    ``st_mode``, ``st_config`` (``"auto"``, a ``ScheduleConfig`` or its
    dict), ``tuned_path`` and ``ranks_per_node`` are the reference's
    ST-routed decode arguments; ``st_ranks`` is the number of virtual
    ranks of the decode collective (the reference's device count). A
    model without a KV cache (rwkv) has no payload to route: ``st_mode``
    raises ``ValueError`` there, as in the reference."""

    def __init__(self, cfg, params, *, batch_slots: int = 4,
                 max_len: int = 256, moe_impl: str = "dense",
                 st_mode: Optional[str] = None, st_config="auto",
                 tuned_path: Optional[str] = None,
                 ranks_per_node: Optional[int] = None, st_ranks: int = 1,
                 device="cuda"):
        self.device = resolve_device(device)
        if self.device is None:
            raise ValueError("ServingEngine needs a device ('cuda' or "
                             "'cpu')")
        self.cfg = cfg
        self.params = params
        self.B = batch_slots
        self.max_len = max_len
        self._prefill_sample = make_prefill_sample_step(
            cfg, max_len=max_len, moe_impl=moe_impl)
        self._decode_sample = make_decode_sample_step(cfg, moe_impl=moe_impl)
        if graphs.applies(self.device):
            # (params, batch, cache): the batch is copied, the rest held
            self._decode_sample = graphs.StepGraph(
                self._decode_sample, f"the {cfg.name} decode step",
                copied=(1,))
        specs = cache_specs(cfg, batch_slots, max_len)
        self.cache = zeros_from_specs(specs, self.device)
        # per layer, the cache leaves without a sequence axis: a
        # sequence's state, replaced whole at its prefill
        self._state_keys = [{k for k, sp in layer.items()
                             if "kv_seq" not in sp.axes}
                            for layer in specs["layers"]]
        self.slot_req: List[Optional[Request]] = [None] * batch_slots
        self.slot_pos = np.zeros(batch_slots, np.int32)
        self.queue: Deque[Request] = deque()
        self.completed: List[Request] = []
        self.prefill_dispatches = 0
        self.decode_steps = 0
        self.tokens_generated = 0
        self.prefill_seconds = 0.0
        self.decode_seconds = 0.0
        self.st_dispatch_seconds = 0.0
        # expert rows the MoE layers computed and the rows routed to
        # (top_k a token), added on the host from each dispatch's shape
        self.moe_impl = moe_impl
        self._moe_layers = sum(f == "moe" for _, f in cfg.layer_specs())
        self.moe_rows_computed = self.moe_rows_routed = 0
        # latent rows the absorbed MLA decode scored, and the valid ones
        self._mla_layers = sum(m == "mla" for m, _ in cfg.layer_specs())
        self.mla_rows_scored = self.mla_rows_valid = 0
        self.st_mode = st_mode
        self._router = None
        if st_mode is not None:
            from repro_torch.serving.st_decode import STDecodeRouter
            self._kv_leaf = self._find_kv_leaf(specs)
            self._router = STDecodeRouter(
                kv_dim=self._kv_leaf[2], d_model=cfg.d_model,
                moe=getattr(cfg, "moe", None) is not None,
                slot_cap=batch_slots, mode=st_mode, config=st_config,
                tuned_path=tuned_path, ndev=st_ranks,
                ranks_per_node=ranks_per_node, device=self.device)

    # -- ST payload extraction ------------------------------------------------
    @staticmethod
    def _find_kv_leaf(specs):
        """(layer, leaf name, flattened row width) of the first KV-cache
        leaf with a sequence axis (the first layer's ``k``, where the
        reference's search lands too); ValueError when the model keeps
        no KV rows (rwkv)."""
        for i, layer in enumerate(specs["layers"]):
            for name in sorted(layer):
                sp = layer[name]
                if "kv_seq" in sp.axes:
                    width = int(np.prod(sp.shape[sp.axes.index("kv_seq")
                                                 + 1:]))
                    return i, name, max(width, 1)
        raise ValueError("serving: st_mode needs a KV-cache leaf with a "
                         "sequence axis, and this model has none")

    def _extract(self, idx):
        """(A, width) float32 on the device: the cache rows the last
        decode step wrote, ``idx`` = (2, A) device tensor of the active
        slots and the positions they wrote, flattened — the per-slot KV
        payload the serve program mirrors to the replica's peers."""
        layer, name, _ = self._kv_leaf
        x = self.cache["layers"][layer][name]          # (B, max_len, ...)
        return x[idx[0], idx[1]].reshape(idx.shape[1], -1).float()

    # -- admission ------------------------------------------------------------
    def submit(self, req: Request):
        """Queue a request; its prompt must leave the cache room for at
        least one generated token (an out-of-range cache row would fault
        on the card instead of raising)."""
        if not 0 < len(req.prompt) < self.max_len:
            raise ValueError(f"prompt of {len(req.prompt)} tokens; the "
                             f"engine takes 1 to {self.max_len - 1}")
        self.queue.append(req)

    def _free_slots(self):
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def _prefill_group(self, slots: List[int], toks: np.ndarray):
        """One prefill dispatch of (len(slots), L) prompt tokens into the
        cache rows ``slots``; returns the first token ids on the host."""
        n, L = toks.shape
        batch = {"tokens": torch.as_tensor(toks, device=self.device),
                 "positions": torch.arange(L, dtype=torch.int32,
                                           device=self.device).expand(n, L)}
        if self.cfg.family == "vlm":    # the reference's zero patches
            vis = self.cfg.vision
            batch["vision"] = torch.zeros((n, vis.num_tokens, vis.raw_dim),
                                          dtype=torch.float32,
                                          device=self.device)
        s0 = slots[0]
        layers = list(zip(self.cache["layers"], self._state_keys))
        scattered = slots != list(range(s0, s0 + n))
        with span("repro_torch.engine.gather"):
            if not scattered:                       # one view, in place
                view = {"layers": [{k: c[k][s0:s0 + n] for k in c}
                                   for c, _ in layers]}
                for vc, (_, state) in zip(view["layers"], layers):
                    for k in state:
                        vc[k].zero_()
            else:                                   # gather, write back
                idx = torch.as_tensor(slots, device=self.device)
                view = {"layers": [
                    {k: (c[k].new_zeros((n,) + c[k].shape[1:])
                         if k in state else c[k][idx, :L]) for k in c}
                    for c, state in layers]}
        with span("repro_torch.engine.forward"):
            ids, _ = self._prefill_sample(self.params, batch, view)
        if scattered:
            with span("repro_torch.engine.scatter"):
                for vc, (c, state) in zip(view["layers"], layers):
                    for k in c:
                        if k in state:
                            c[k][idx] = vc[k]
                        else:
                            c[k][idx, :L] = vc[k]
        with span("repro_torch.engine.readback"):
            return ids.cpu().numpy()

    def _admit(self):
        """Fill free slots from the queue: take requests FIFO, group by
        prompt length, and prefill each length group in ONE dispatch."""
        free = self._free_slots()
        if not free or not self.queue:
            return
        take: List[Request] = []
        while self.queue and len(take) < len(free):
            take.append(self.queue.popleft())
        groups: Dict[int, List[Request]] = {}
        for req in take:
            groups.setdefault(len(req.prompt), []).append(req)
        free_iter = iter(free)
        for L in sorted(groups):
            reqs = groups[L]
            slots = [next(free_iter) for _ in reqs]
            toks = np.stack([np.asarray(r.prompt, np.int32) for r in reqs])
            t0 = time.perf_counter()
            with span("repro_torch.engine.prefill"):
                ids_np = self._prefill_group(slots, toks)
            self.prefill_seconds += time.perf_counter() - t0
            self.prefill_dispatches += 1
            self._count_moe_rows(*toks.shape, toks.size)
            now = time.monotonic()
            for row, (slot, req) in enumerate(zip(slots, reqs)):
                req.out_tokens.append(int(ids_np[row]))
                req.admitted_at = now
                req.first_token_at = now
                self.slot_req[slot] = req
                self.slot_pos[slot] = L
                self.tokens_generated += 1
                # a one-token (or instant-EOS) request completes at
                # admission — don't hold a decode slot for it
                if (len(req.out_tokens) >= req.max_new_tokens
                        or req.out_tokens[-1] == req.eos_id
                        or self.slot_pos[slot] >= self.max_len - 1):
                    req.done_at = now
                    self.completed.append(req)
                    self.slot_req[slot] = None

    # -- decode loop ----------------------------------------------------------
    def _active(self):
        return [i for i, r in enumerate(self.slot_req) if r is not None]

    def step(self):
        """One engine step: admit, batched decode, recycle finished slots."""
        with span("repro_torch.engine.step"):
            with span("repro_torch.engine.admit"):
                self._admit()
            active = self._active()
            if not active:
                return 0
            with span("repro_torch.engine.decode"):
                with span("repro_torch.engine.upload"):
                    batch = self._decode_batch(active)
                t0 = time.perf_counter()
                ids, hid, self.cache = self._decode_sample(
                    self.params, batch, self.cache)
                with span("repro_torch.engine.readback"):
                    ids_np = ids.cpu().numpy()
                self.decode_seconds += time.perf_counter() - t0
                self.decode_steps += 1
                self._count_moe_rows(self.B, 1, len(active))
                if self._mla_layers:
                    self.mla_rows_scored += (self._mla_layers * self.B
                                             * self.max_len)
                    self.mla_rows_valid += self._mla_layers * int(
                        (self.slot_pos[active].astype(np.int64) + 1).sum())
            if self._router is not None:
                with span("repro_torch.router.dispatch"):
                    t0 = time.perf_counter()
                    # the active slots and the rows this decode wrote
                    # (their positions advance in _record_decode), in one
                    # upload
                    idx = torch.as_tensor(
                        np.stack([np.asarray(active, np.int64),
                                  self.slot_pos[active]]),
                        device=self.device)
                    act = idx[0]
                    committed, _, _ = self._router.dispatch(
                        self._extract(idx), ids[act],
                        hid=hid[act] if self._router.moe_on else None)
                    # the transported ids are authoritative: serving reads
                    # its tokens off the committed window buffer
                    ids_np[active] = committed
                    self.st_dispatch_seconds += time.perf_counter() - t0
            with span("repro_torch.engine.record"):
                self._record_decode(active, ids_np)
            return len(active)

    def _count_moe_rows(self, batch: int, seq: int, tokens: int):
        """Add a dispatch of a (batch, seq) input holding ``tokens`` real
        tokens (a decode step's idle slots are computed, not routed) to
        the MoE row counters."""
        if self._moe_layers:
            from repro_torch.models.moe import rows_computed
            self.moe_rows_computed += self._moe_layers * rows_computed(
                self.cfg, self.moe_impl, batch, seq)
            self.moe_rows_routed += (self._moe_layers
                                     * self.cfg.moe.top_k * tokens)

    def _decode_batch(self, active):
        """The (B, 1) decode batch: each active slot's last token at its
        position (idle slots decode token 0 and are ignored)."""
        toks = np.zeros((self.B, 1), np.int32)
        for i in active:
            toks[i, 0] = self.slot_req[i].out_tokens[-1]
        return {"tokens": torch.as_tensor(toks, device=self.device),
                "positions": torch.as_tensor(self.slot_pos[:, None],
                                             device=self.device)}

    def _record_decode(self, active, ids_np):
        """Append each active slot's new token; recycle finished slots."""
        for i in active:
            req = self.slot_req[i]
            nxt = int(ids_np[i])
            req.out_tokens.append(nxt)
            self.tokens_generated += 1
            self.slot_pos[i] += 1
            done = (len(req.out_tokens) >= req.max_new_tokens
                    or nxt == req.eos_id
                    or self.slot_pos[i] >= self.max_len - 1)
            if done:
                req.done_at = time.monotonic()
                self.completed.append(req)
                self.slot_req[i] = None

    def run_until_drained(self, max_steps: int = 10_000):
        steps = 0
        while (self.queue or self._active()) and steps < max_steps:
            self.step()
            steps += 1
        return steps

    # -- reporting ------------------------------------------------------------
    def stats(self) -> dict:
        d = {"batch_slots": self.B, "max_len": self.max_len,
             "queued": len(self.queue), "active": len(self._active()),
             "completed": len(self.completed),
             "prefill_dispatches": self.prefill_dispatches,
             "decode_steps": self.decode_steps,
             "tokens_generated": self.tokens_generated,
             "prefill_seconds": self.prefill_seconds,
             "decode_seconds": self.decode_seconds,
             "st_mode": self.st_mode}
        if self._moe_layers:
            d["moe_rows_computed"] = self.moe_rows_computed
            d["moe_rows_routed"] = self.moe_rows_routed
        if self._mla_layers:
            d["mla_rows_scored"] = self.mla_rows_scored
            d["mla_rows_valid"] = self.mla_rows_valid
        if self._router is not None:
            d["st_dispatch_seconds"] = self.st_dispatch_seconds
            d["st"] = self._router.stats()
            d["st_payload_bytes"] = self._router.payload_bytes()
        return d
