"""Served Jamba cells: the program's ``ServingEngine`` with ST-routed
decode and dense MoE, driven by the closed loop of ``drivers/serve.py``
(its ``ClosedLoop`` and its request bookkeeping, timing and sampling as
there).

The configuration file gives the model in Hugging Face names at its top
level (the published ``config.json``'s keys, ``num_hidden_layers`` cut
to the layers one card holds, and ``head_dim``), and the deployment under
``serving`` (slots, cache length, ST mode and ranks, ``moe_impl``). The
port's registered architecture ``arch`` is run at the file's sizes; the
file's layer pattern, biases and head are checked against what the
port's block computes.

Weights are made on the device from the seed: every weight matrix a
view of one normal bf16 draw, scaled by its init's std, or by
1/sqrt(the size its product contracts over) (``fan_in``; the port's
init counts an expert stack's expert axis and a projection's head axis
in the fan in, which would leave the experts' outputs 1/64 of their
scale and the attention scores near zero); vectors keep
their init (norm scales and ``d_skip`` ones, biases zero), and ``a_log``
takes the published Mamba init, A_n = n for n = 1 .. d_state in every
channel, and ``dt_bias`` and ``dt_proj`` Mamba's dt init (arXiv:
2312.00752: dt log-uniform in [1e-3, 1e-1], the projection uniform
within +-dt_rank^-1/2, here normal with its std), so the SSM decays are
the model's and not noise.

Correctness, after the window:

  * ``mean_logit_gap``: the reference (``stbench/reference/jamba.py``)
    recomputes in float32, over each checked request's prompt and served
    tokens (prefill, then decode through the cache, in the program), the
    logits at every position that chose a served token; the mean, over
    every served token of the longest finished request and of more drawn
    by the seed (``check_requests``), of the gap by which its logit lies
    below the best. Not the widest gap, as granite's cells take: a
    router's bf16 logits put a near-tied expert second where the float32
    reference puts another, and where that swap lands the widest gap of
    a sound run (1.1 to 2.5 logits at full width) reaches the float8
    control's (2.8 to 3.0), while the mean stays 20 times apart
    (PERF.md, §6);
  * ``payload_mismatches``: the router's committed buffers of the
    window's last dispatch against what was staged: the mirrored KV rows
    and the token ids equal, and the hidden block's combine equal to the
    staged block summed over the ranks in the commit's order (every
    value exact in float32). The engine serves its tokens off the
    committed ids; the hidden blocks reach no token, so this is what
    holds the MoE dispatch's puts.

``rec`` keys: those of ``drivers/serve.py`` (``setup_s``, ``window_s``,
``tokens``, ``itl_s``, ``ttft_s``, ``stats``, ``occupancy``,
``decode_flops`` and ``prefill_flops``, here Jamba's, each MoE layer at
its routed experts: ``stbench/counts_jamba.py``), with ``stats`` adding
the engine's ``moe_rows_computed`` and ``moe_rows_routed`` and
``st_payload_bytes`` ({"kv", "ids", "hid"}) over the window; traced
runs add ``kernels`` ({"mamba_step", "router_put": {"names", "bound_s",
"launches"}} over the traced decode steps).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from stbench import counts_jamba, traffic
from stbench.drivers.serve import ClosedLoop
from stbench.harness import Record
from stbench.reference import jamba as ref

KERNELS = {"mamba_step": ("mamba_scan_step",),
           "router_put": ("put_signal_kernel",)}


def port_config(arch: str, m: dict):
    """The port's registered ``arch`` at the file's sizes; refuses a
    file whose block the port does not compute."""
    from repro_torch.configs import get_config
    base = get_config(arch)
    needs = {"hidden_act": "silu", "mamba_conv_bias": True,
             "mamba_proj_bias": False, "sliding_window": None,
             "expert_layer_offset": m["expert_layer_period"] - 1}
    for k, v in needs.items():
        if m[k] != v:
            raise ValueError(f"serve_jamba: the program's block has "
                             f"{k} = {v}, the file {m[k]}")
    return dataclasses.replace(
        base, num_layers=m["num_hidden_layers"], d_model=m["hidden_size"],
        num_heads=m["num_attention_heads"],
        num_kv_heads=m["num_key_value_heads"], head_dim=m["head_dim"],
        d_ff=m["intermediate_size"], vocab_size=m["vocab_size"],
        norm_eps=m["rms_norm_eps"],
        tie_embeddings=m["tie_word_embeddings"],
        mamba_attn_period=m["attn_layer_period"],
        attn_layer_offset=m["attn_layer_offset"],
        moe_every=m["expert_layer_period"],
        mamba=dataclasses.replace(base.mamba, d_state=m["mamba_d_state"],
                                  d_conv=m["mamba_d_conv"],
                                  expand=m["mamba_expand"],
                                  dt_rank=m["mamba_dt_rank"]),
        moe=dataclasses.replace(base.moe, num_experts=m["num_experts"],
                                top_k=m["num_experts_per_tok"],
                                expert_ff=m["intermediate_size"]),
        compute_dtype=m["torch_dtype"])


def _named(tree, name=None):
    """(leaf name, leaf) in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _named(tree[k], k)]
    if isinstance(tree, list):
        return [x for v in tree for x in _named(v, name)]
    return [(name, tree)]


# Mamba's dt init (arXiv:2312.00752): dt log-uniform in [1e-3, 1e-1]
DT_LOG_RANGE = (float(np.log(1e-3)), float(np.log(1e-1)))


def fan_in(name: str, shape) -> int:
    """The size a weight's product contracts over: d_model for the q, k,
    v projections (d, heads, head dim) and for an expert stack's gate and
    up (experts, d, f), f for its down (experts, f, d), else every axis
    but the last."""
    if name in ("wq", "wk", "wv"):
        return shape[0]
    if name in ("w_gate", "w_up", "w_down") and len(shape) == 3:
        return shape[1]
    if name == "dt_proj":           # Mamba's U(+-dt_rank^-1/2): std^-2
        return 3 * shape[0]
    return int(np.prod(shape[:-1]))


def make_weights(specs, seed: int, device):
    """The param tree of ``specs`` (the port's ``model_specs``): every
    weight matrix a view of one normal bf16 draw, scaled by its std (its
    spec's, else 1/sqrt(:func:`fan_in`), so that each expert's output
    and each attention score keep unit scale; ``dt_proj`` at Mamba's
    init); vectors float32 ones or zeros; ``a_log`` float32 log(1 ..
    d_state) in every channel; ``dt_bias`` Mamba's softplus^-1(dt), dt
    log-uniform in [1e-3, 1e-1], drawn after the matrices."""
    import torch
    from repro_torch.models.params import tree_unflatten
    leaves = _named(specs)
    mats = [s for n, s in leaves if len(s.shape) >= 2 and n != "a_log"]
    total = sum(int(np.prod(s.shape)) for s in mats)
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.bfloat16)
    out, off = [], 0
    for name, s in leaves:
        if name == "a_log":
            a = torch.arange(1, s.shape[1] + 1, dtype=torch.float32,
                             device=device).log()
            out.append(a.expand(s.shape).contiguous())
            continue
        if name == "dt_bias":
            u = torch.rand(s.shape, generator=gen, device=device)
            dt = torch.exp(DT_LOG_RANGE[0]
                           + u * (DT_LOG_RANGE[1] - DT_LOG_RANGE[0]))
            out.append(dt + torch.log(-torch.expm1(-dt)))   # softplus^-1
            continue
        if len(s.shape) < 2:
            if s.init not in ("ones", "zeros"):
                raise ValueError(f"serve_jamba: a drawn vector leaf {s}")
            fill = torch.ones if s.init == "ones" else torch.zeros
            out.append(fill(s.shape, dtype=torch.float32, device=device))
            continue
        k = int(np.prod(s.shape))
        std = (fan_in(name, s.shape) ** -0.5 if s.scale is None
               or name == "dt_proj" else s.scale)
        out.append(flat[off:off + k].view(s.shape).mul_(std))
        off += k
    return tree_unflatten(specs, out)


def reference_weights(params, m: dict) -> dict:
    """The same tensors under the reference's names and layout."""
    d = m["hidden_size"]
    layers = []
    for (mixer, ffn), p in zip(ref.layer_kinds(m), params["layers"]):
        x, f = p["mixer"], p["ffn"]
        if mixer == "attn":
            mw = {"q": x["wq"].reshape(d, -1), "k": x["wk"].reshape(d, -1),
                  "v": x["wv"].reshape(d, -1), "o": x["wo"].reshape(-1, d)}
        else:
            mw = dict(x)
        fw = {"gate": f["w_gate"], "up": f["w_up"], "down": f["w_down"]}
        if ffn == "moe":
            fw["router"] = f["router"]
        layers.append({"input_norm": p["norm1"]["scale"],
                       "pre_ff_norm": p["norm2"]["scale"],
                       "mixer": mw, "ffn": fw})
    return {"embed": params["embed"]["tok"],
            "unembed": params["embed"]["unembed"],
            "final_norm": params["final_norm"]["scale"], "layers": layers}


class LastDispatch:
    """Stands in for the router's ``dispatch``: calls it, and keeps the
    last call's staged payloads and committed rows."""

    def __init__(self, router):
        self.inner = router.dispatch
        self.ranks = router.ndev if router.moe_on else 1
        self.last = None

    def __call__(self, kv_rows, tok_ids, hid=None):
        out = self.inner(kv_rows, tok_ids, hid=hid)
        self.last = (kv_rows, tok_ids, hid, out)
        return out

    def mismatches(self) -> int:
        """Elements of the last dispatch's committed buffers that differ
        from the staged payloads' expected combine."""
        import torch
        kv, tok, hid, (outtok, mirror, hmir) = self.last
        bad = int((np.asarray(mirror)
                   != kv.float().cpu().numpy()).sum())
        bad += int((np.asarray(outtok) != tok.cpu().numpy()).sum())
        if hid is not None:
            h = hid.to(torch.float32)
            want = h
            for _ in range(self.ranks - 1):
                want = want + h
            bad += int((np.asarray(hmir) != want.cpu().numpy()).sum())
        return bad


def run(ctx) -> Record:
    import torch
    from repro_torch.core.autotune import slot_bucket
    from repro_torch.models import model_specs
    from repro_torch.serving.engine import Request, ServingEngine
    from stbench.devtrace import Trace

    m, S, mix, dev = ctx.config, ctx.config["serving"], ctx.mix, ctx.device
    cfg = port_config(ctx.config["arch"], m)
    params = make_weights(model_specs(cfg), ctx.seed, dev)
    eng = ServingEngine(cfg, params, batch_slots=S["slots"],
                        max_len=S["max_len"], moe_impl=S["moe_impl"],
                        st_mode=S["st_mode"], st_config=S["st_config"],
                        st_ranks=S["st_ranks"], device=dev)
    router = eng._router
    last = router.dispatch = LastDispatch(router)
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
    first = last_step = None        # the traced steps
    while True:
        if tracer and first is None and \
                time.perf_counter() - t0 >= mix["trace_after_s"]:
            tracer.start()
            first, t_trace = len(loop.steps), time.perf_counter()
        t = loop.step(record=True)
        if first is not None and last_step is None and \
                t - t_trace >= mix["trace_seconds"]:
            tracer.stop()
            last_step = len(loop.steps)
        if t - t0 >= ctx.seconds:
            break
    window_s = t - t0
    if tracer and last_step is None:
        if first is None:
            raise RuntimeError("serve_jamba: the window closed before the "
                               "trace began; lengthen --seconds")
        tracer.stop()
        last_step = len(loop.steps)
    end = eng.stats()
    stats = {k: end[k] - base[k] for k in
             ("decode_steps", "decode_seconds", "prefill_dispatches",
              "prefill_seconds", "st_dispatch_seconds", "moe_rows_computed",
              "moe_rows_routed")}
    stats["st_payload_bytes"] = {k: v - base["st_payload_bytes"][k]
                                 for k, v in end["st_payload_bytes"].items()}
    payload_bad = last.mismatches()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    red = tracer.reduce() if tracer else None
    decode_flops = counts_jamba.decode_flops(
        m, [k for kv, _ in loop.steps for k in kv])
    prefill_flops = sum(counts_jamba.prefill_flops(m, n, L)
                        for _, groups in loop.steps for n, L in groups)

    # the reference, with the engine's cache freed
    finished = loop.finished
    attempted = loop.sent + len(loop.clients)
    ranks, moe_on = router.ndev, router.moe_on
    del eng, router, last, loop.eng
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    wref = reference_weights(params, m)
    pick = traffic.check_sample([len(s) for _, s in finished],
                                mix["check_requests"], ctx.seed)
    gap = None
    if pick:
        gap = float(np.concatenate([ref.served_gaps(wref, m, *finished[i])
                                    for i in pick]).mean())
    rec = {"setup_s": setup_s, "window_s": window_s, "tokens": loop.tokens,
           "itl_s": loop.itl, "ttft_s": loop.ttft, "stats": stats,
           "occupancy": loop.occupancy, "decode_flops": decode_flops,
           "prefill_flops": prefill_flops}
    if tracer:
        n_mamba = sum(k == "mamba" for k, _ in ref.layer_kinds(m))
        dec = [len(kv) for kv, _ in loop.steps[first:last_step] if kv]
        puts = [counts_jamba.router_put_bounds(
            m, ranks, slot_bucket(a, S["slots"]), moe_on) for a in dec]
        rec["kernels"] = {
            "mamba_step": {"names": KERNELS["mamba_step"],
                           "bound_s": n_mamba * sum(
                               counts_jamba.mamba_step_bound(m, a)
                               for a in dec),
                           "launches": n_mamba * len(dec)},
            "router_put": {"names": KERNELS["router_put"],
                           "bound_s": sum(sum(p) for p in puts),
                           "launches": sum(len(p) for p in puts)}}
    return Record(rec=rec, checks={"mean_logit_gap": gap,
                                   "payload_mismatches": payload_bad},
                  attempted=attempted, failed=0,
                  memory_peak_bytes=int(peak), trace=red,
                  extra={"weights": wref, "model": m,
                         "checked": [finished[i] for i in pick]})
