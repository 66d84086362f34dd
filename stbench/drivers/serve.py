"""Served-LM cells: the program's ``ServingEngine`` (continuous batching,
ST-routed decode) driven by a closed loop of clients.

The configuration file gives the model in Hugging Face names (``model``)
and the deployment (``serving``: slots, cache length, ST mode and ranks);
the port's registered architecture ``arch`` is run with the file's
sizes. Set-up makes the weights on the device from the seed (one draw of
normal bf16 values for all weight matrices, each scaled by its init's
std; norm scales ones), builds the engine, serves the mix's warm-up
requests (every active-slot count, so every ST bucket's program and the
decode graph exist before the window), then admits each client's first
request in one step. The window steps the engine until ``seconds`` have
passed; a client sends its next request as soon as its last one
completes.

Every token is delivered at the end of the engine step that produced
it; times are the host clock at the end of each step (``step()`` ends
with the step's ids on the host):

  * inter-token gaps: for each request that got a decode token in a
    step, the time since the end of the step that gave its previous one
    (the decode token of a request's admission step follows its first
    token in the same step and makes no gap);
  * TTFT: for each request sent in the window, from its sending to the
    end of the step that gave its first token.

Correctness: the reference (``stbench/reference/granite.py``) recomputes
in float32, over each prompt and its served tokens, the logits at every
position that chose a served token; ``max_logit_gap`` is the widest gap
by which a served token's logit lies below the best, over a sample of
the requests finished in the window (``check_requests``: the longest
and more drawn by the seed).

``rec`` keys: ``setup_s``, ``window_s``, ``tokens``, ``itl_s`` (every
gap), ``ttft_s`` (every request's), ``stats`` (the engine's counters
over the window: decode_steps, decode_seconds, prefill_dispatches,
prefill_seconds, st_dispatch_seconds), ``decode_flops``,
``prefill_flops``, ``occupancy`` (active slots per decode step, summed);
traced runs add ``attention`` ({kernel group:
{"names", "bound_s", "launches"}} over the traced steps).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from stbench import counts, traffic
from stbench.harness import Record
from stbench.reference import granite as ref

ATTENTION = {"decode": ("decode_split_mma", "decode_merge"),
             "flash": ("flash_fwd_mma",)}


def port_config(arch: str, m: dict):
    """The port's registered ``arch`` at the file's sizes; refuses what
    the port's decoder cannot run (multipliers, untied embeddings)."""
    from repro_torch.configs import get_config
    neutral = {"embedding_multiplier": 1.0, "residual_multiplier": 1.0,
               "logits_scaling": 1.0,
               "attention_multiplier": m["head_dim"] ** -0.5}
    for k, v in neutral.items():
        if abs(m[k] - v) > 1e-12:
            raise ValueError(f"serve: the program has no {k} ({m[k]}); "
                             f"it runs {v}")
    if not m["tie_word_embeddings"]:
        raise ValueError("serve: the reference takes tied embeddings")
    return dataclasses.replace(
        get_config(arch), num_layers=m["num_hidden_layers"],
        d_model=m["hidden_size"], num_heads=m["num_attention_heads"],
        num_kv_heads=m["num_key_value_heads"], head_dim=m["head_dim"],
        d_ff=m["intermediate_size"], vocab_size=m["vocab_size"],
        rope_theta=m["rope_theta"], norm_eps=m["rms_norm_eps"],
        tie_embeddings=True, compute_dtype=m["torch_dtype"])


def make_weights(specs, seed: int, device):
    """The param tree of ``specs`` (the port's ``model_specs``): every
    weight matrix a view of one normal bf16 draw, scaled by its std
    (its spec's, else 1/sqrt(fan in)); vectors float32 ones or zeros."""
    import torch
    from repro_torch.models.params import tree_leaves, tree_unflatten
    leaves = tree_leaves(specs)
    mats = [s for s in leaves if len(s.shape) >= 2]
    total = sum(int(np.prod(s.shape)) for s in mats)
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.bfloat16)
    out, off = [], 0
    for s in leaves:
        if len(s.shape) < 2:
            if s.init not in ("ones", "zeros"):
                raise ValueError(f"serve: a drawn vector leaf {s}")
            fill = torch.ones if s.init == "ones" else torch.zeros
            out.append(fill(s.shape, dtype=torch.float32, device=device))
            continue
        k = int(np.prod(s.shape))
        std = s.scale if s.scale is not None else \
            float(np.prod(s.shape[:-1])) ** -0.5
        out.append(flat[off:off + k].view(s.shape).mul_(std))
        off += k
    return tree_unflatten(specs, out)


def reference_weights(params, m: dict) -> dict:
    """The same tensors under the reference's names and layout."""
    d, H, KV, hd = (m["hidden_size"], m["num_attention_heads"],
                    m["num_key_value_heads"], m["head_dim"])
    layers = [{"input_norm": p["norm1"]["scale"],
               "q": p["mixer"]["wq"].reshape(d, H * hd),
               "k": p["mixer"]["wk"].reshape(d, KV * hd),
               "v": p["mixer"]["wv"].reshape(d, KV * hd),
               "o": p["mixer"]["wo"].reshape(H * hd, d),
               "post_norm": p["norm2"]["scale"],
               "gate": p["ffn"]["w_gate"], "up": p["ffn"]["w_up"],
               "down": p["ffn"]["w_down"]} for p in params["layers"]]
    return {"embed": params["embed"]["tok"],
            "final_norm": params["final_norm"]["scale"], "layers": layers}


class _Client:
    __slots__ = ("stream", "req", "sent", "prompt_len", "last", "got")

    def __init__(self, stream):
        self.stream = stream
        self.req = None


class ClosedLoop:
    """Clients, each with one request in the engine at a time, and the
    per-step bookkeeping of what each step delivered."""

    def __init__(self, eng, Request, mix, seed, vocab, m):
        self.eng, self.Request, self.m = eng, Request, m
        self.clients = [_Client(traffic.client_requests(mix, seed, c, vocab))
                        for c in range(mix["clients"])]
        self.finished = []          # (prompt, served) in completion order
        self.window_open = None     # perf_counter at the window's start
        self.sent = 0
        self.tokens, self.itl, self.ttft = 0, [], []
        self.decode_flops = self.prefill_flops = 0
        self.occupancy = 0
        self.steps = []             # per step: (decode kv lens, prefills)

    def send(self, c: _Client):
        prompt, new = next(c.stream)
        c.req = self.Request(prompt=prompt, max_new_tokens=new)
        c.sent, c.prompt_len, c.last, c.got = (time.perf_counter(),
                                               len(prompt), None, 0)
        self.eng.submit(c.req)
        if self.window_open is not None:
            self.sent += 1

    def step(self, record: bool) -> float:
        self.eng.step()
        t = time.perf_counter()
        kv_lens, admitted = [], {}
        for c in self.clients:
            n1 = len(c.req.out_tokens)
            new = n1 - c.got
            if new <= 0:
                continue
            if c.got == 0:
                admitted.setdefault(c.prompt_len, []).append(c)
                if record and c.sent >= self.window_open:
                    self.ttft.append(t - c.sent)
            elif record:
                self.itl.append(t - c.last)
            if new == 2 or c.got > 0:
                kv_lens.append(c.prompt_len + n1 - 1)
            c.got, c.last = n1, t
            if record:
                self.tokens += new
        if record:
            self.decode_flops += sum(counts.decode_token_flops(self.m, k)
                                     for k in kv_lens)
            self.prefill_flops += sum(
                counts.prefill_flops(self.m, len(g), L)
                for L, g in admitted.items())
            self.occupancy += len(kv_lens)
            self.steps.append((kv_lens, [(len(g), L) for L, g in
                                         admitted.items()]))
        for c in self.clients:
            if c.req.done_at is not None:
                self.finished.append((np.asarray(c.req.prompt),
                                      np.asarray(c.req.out_tokens)))
                self.send(c)
        return t


def run(ctx) -> Record:
    import torch
    from repro_torch.models import model_specs
    from repro_torch.serving.engine import Request, ServingEngine
    from stbench.devtrace import Trace

    m, S, mix, dev = ctx.config["model"], ctx.config["serving"], ctx.mix, \
        ctx.device
    cfg = port_config(ctx.config["arch"], m)
    params = make_weights(model_specs(cfg), ctx.seed, dev)
    eng = ServingEngine(cfg, params, batch_slots=S["slots"],
                        max_len=S["max_len"], st_mode=S["st_mode"],
                        st_config=S["st_config"], st_ranks=S["st_ranks"],
                        device=dev)
    for prompt, new in traffic.warmup_requests(mix, ctx.seed, S["slots"],
                                               m["vocab_size"]):
        eng.submit(Request(prompt=prompt, max_new_tokens=new))
    eng.run_until_drained()
    tracer = Trace(dev) if ctx.trace else None
    if tracer:
        tracer.warm()
    loop = ClosedLoop(eng, Request, mix, ctx.seed, m["vocab_size"], m)
    for c in loop.clients:
        loop.send(c)
    t0 = loop.step(record=False)
    loop.finished.clear()
    loop.window_open = t0
    base = eng.stats()
    setup_s = t0 - ctx.t_start
    first = last = None             # the traced steps: loop.steps[first:last]
    while True:
        if tracer and first is None and \
                time.perf_counter() - t0 >= mix["trace_after_s"]:
            tracer.start()
            first, t_trace = len(loop.steps), time.perf_counter()
        t = loop.step(record=True)
        if first is not None and last is None and \
                t - t_trace >= mix["trace_seconds"]:
            tracer.stop()
            last = len(loop.steps)
        if t - t0 >= ctx.seconds:
            break
    window_s = t - t0
    if tracer and last is None:
        if first is None:
            raise RuntimeError("serve: the window closed before the trace "
                               "began; lengthen --seconds")
        tracer.stop()
        last = len(loop.steps)
    end = eng.stats()
    stats = {k: end[k] - base[k] for k in
             ("decode_steps", "decode_seconds", "prefill_dispatches",
              "prefill_seconds", "st_dispatch_seconds") if k in end}
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    red = tracer.reduce() if tracer else None

    # the reference, with the engine's cache freed
    finished = loop.finished
    attempted = loop.sent + len(loop.clients)
    del eng, loop.eng
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    wref = reference_weights(params, m)
    pick = traffic.check_sample([len(s) for _, s in finished],
                                mix["check_requests"], ctx.seed)
    gap = None
    if pick:
        gap = max(float(ref.served_gaps(wref, m, *finished[i]).max())
                  for i in pick)
    rec = {"setup_s": setup_s, "window_s": window_s, "tokens": loop.tokens,
           "itl_s": loop.itl, "ttft_s": loop.ttft, "stats": stats,
           "decode_flops": loop.decode_flops,
           "prefill_flops": loop.prefill_flops,
           "occupancy": loop.occupancy}
    if tracer:
        L = m["num_hidden_layers"]
        dec = [kv for kv, _ in loop.steps[first:last] if kv]
        pre = [p for _, ps in loop.steps[first:last] for p in ps]
        rec["attention"] = {
            "decode": {"names": ATTENTION["decode"],
                       "bound_s": L * sum(counts.decode_attention_bound(m, k)
                                          for k in dec),
                       "launches": 2 * L * len(dec)},
            "flash": {"names": ATTENTION["flash"],
                      "bound_s": L * sum(counts.flash_attention_bound(m, r, n)
                                         for r, n in pre),
                      "launches": L * len(pre)}}
    return Record(rec=rec, checks={"max_logit_gap": gap},
                  attempted=attempted, failed=0,
                  memory_peak_bytes=int(peak), trace=red,
                  extra={"weights": wref, "model": m,
                         "checked": [finished[i] for i in pick]})
