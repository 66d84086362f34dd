"""Served DeepSeek-V2 cells: the program's ``ServingEngine`` with ST-routed
decode and dense MoE, driven by the closed loop of ``drivers/serve.py``
(its ``ClosedLoop`` and its request bookkeeping, timing and sampling as
there), checked as ``drivers/serve_jamba.py`` checks (its router stand-in
``LastDispatch``).

The configuration file gives the model in Hugging Face names at its top
level (the published ``config.json``'s keys: multi-head latent attention
with ``q_lora_rank`` null or a rank, YaRN ``rope_scaling``, the MoE's
routed and shared experts), and the deployment under ``serving`` (slots,
cache length, ST mode and ranks, ``moe_impl``). The port's registered
architecture ``arch`` is run at the file's sizes; the file's router,
biases and layer pattern are checked against what the port's block
computes.

Weights are made on the device from the seed: every weight matrix a
view of one normal bf16 draw, scaled by its init's std, or by
1/sqrt(the size its product contracts over) (:func:`fan_in`: the latent
rank for the latent's up-projections ``wk_b``, ``wv_b`` and ``wq_b``,
and ``serve_jamba.fan_in`` otherwise, which counts neither an expert
stack's expert axis nor a projection's head axis); vectors keep their
init (norm scales one).

Correctness, after the window, as in ``drivers/serve_jamba.py``:

  * ``mean_logit_gap``: the reference (``stbench/reference/
    deepseek_v2.py``) recomputes in float32, over each checked request's
    prompt and served tokens (prefill, then decode through the latent
    cache, in the program), the logits at every position that chose a
    served token; the mean, over every served token of the longest
    finished request and of more drawn by the seed (``check_requests``),
    of the gap by which its logit lies below the best. A router's bf16
    logits put a near-tied expert among the 6 of 64 where the float32
    reference puts another, so the widest gap of a sound run is a
    routing flip's;
  * ``payload_mismatches``: the router's committed buffers of the
    window's last dispatch against what was staged: the mirrored latent
    rows (layer 0's ``ckv``, ``kv_lora_rank`` wide) and the token ids
    equal, and the hidden block's combine equal to the staged block
    summed over the ranks in the commit's order.

``rec`` keys: those of ``drivers/serve_jamba.py`` (``setup_s``,
``window_s``, ``tokens``, ``itl_s``, ``ttft_s``, ``stats``,
``occupancy``, ``decode_flops`` and ``prefill_flops``, here DeepSeek's:
``stbench/counts_deepseek.py``), with ``stats`` adding the engine's
``moe_rows_computed``, ``moe_rows_routed``, ``mla_rows_scored`` and
``mla_rows_valid`` and ``st_payload_bytes`` ({"kv", "ids", "hid"}) over
the window; traced runs add ``kernels`` ({"router_put": {"names",
"bound_s", "launches"}} over the traced decode steps).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from stbench import counts_deepseek, traffic
from stbench.drivers.serve import ClosedLoop
from stbench.drivers.serve_jamba import LastDispatch, _named
from stbench.drivers.serve_jamba import fan_in as _fan_in
from stbench.harness import Record
from stbench.reference import deepseek_v2 as ref

KERNELS = {"router_put": ("put_signal_kernel",)}
STATS = ("decode_steps", "decode_seconds", "prefill_dispatches",
         "prefill_seconds", "st_dispatch_seconds", "moe_rows_computed",
         "moe_rows_routed", "mla_rows_scored", "mla_rows_valid")


def port_config(arch: str, m: dict):
    """The port's registered ``arch`` at the file's sizes; refuses a
    file whose block the port does not compute."""
    from repro_torch.configs import (MLAConfig, YaRNConfig, get_config)
    base = get_config(arch)
    needs = {"hidden_act": "silu", "attention_bias": False,
             "scoring_func": "softmax", "topk_method": "greedy",
             "n_group": 1, "topk_group": 1, "moe_layer_freq": 1,
             "routed_scaling_factor": 1, "first_k_dense_replace": 1,
             "num_key_value_heads": m["num_attention_heads"]}
    for k, v in needs.items():
        if m[k] != v:
            raise ValueError(f"serve_deepseek: the program's block has "
                             f"{k} = {v}, the file {m[k]}")
    y = m["rope_scaling"]
    if y is not None and y["type"] != "yarn":
        raise ValueError(f"serve_deepseek: the program has YaRN RoPE "
                         f"scaling, the file {y['type']}")
    return dataclasses.replace(
        base, num_layers=m["num_hidden_layers"], d_model=m["hidden_size"],
        num_heads=m["num_attention_heads"],
        num_kv_heads=m["num_key_value_heads"],
        d_ff=m["moe_intermediate_size"], vocab_size=m["vocab_size"],
        rope_theta=float(m["rope_theta"]),
        rope_scaling=None if y is None else YaRNConfig(
            factor=float(y["factor"]),
            original_max_position_embeddings=int(
                y["original_max_position_embeddings"]),
            beta_fast=float(y["beta_fast"]), beta_slow=float(y["beta_slow"]),
            mscale=float(y["mscale"]),
            mscale_all_dim=float(y["mscale_all_dim"])),
        norm_eps=m["rms_norm_eps"],
        tie_embeddings=m["tie_word_embeddings"],
        first_dense_ff=m["intermediate_size"],
        moe=dataclasses.replace(
            base.moe, num_experts=m["n_routed_experts"],
            top_k=m["num_experts_per_tok"],
            expert_ff=m["moe_intermediate_size"],
            num_shared=m["n_shared_experts"],
            shared_ff=m["n_shared_experts"] * m["moe_intermediate_size"],
            renormalize=m["norm_topk_prob"]),
        mla=MLAConfig(kv_lora_rank=m["kv_lora_rank"],
                      q_lora_rank=m["q_lora_rank"] or 0,
                      qk_nope_head_dim=m["qk_nope_head_dim"],
                      qk_rope_head_dim=m["qk_rope_head_dim"],
                      v_head_dim=m["v_head_dim"]),
        compute_dtype=m["torch_dtype"])


def fan_in(name: str, shape) -> int:
    """The size a weight's product contracts over: the latent's rank for
    its up-projections (``wq_b``, ``wk_b``, ``wv_b``: (rank, heads,
    head dim)), else ``serve_jamba.fan_in``'s."""
    if name in ("wq_b", "wk_b", "wv_b"):
        return shape[0]
    return _fan_in(name, shape)


def make_weights(specs, seed: int, device):
    """The param tree of ``specs`` (the port's ``model_specs``): every
    weight matrix a view of one normal bf16 draw, scaled by its std (its
    spec's, else 1/sqrt(:func:`fan_in`), so that each expert's output and
    each attention score keep unit scale); vectors float32 ones or
    zeros."""
    import torch
    from repro_torch.models.params import tree_unflatten
    leaves = _named(specs)
    total = sum(int(np.prod(s.shape)) for _, s in leaves
                if len(s.shape) >= 2)
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.bfloat16)
    out, off = [], 0
    for name, s in leaves:
        if len(s.shape) < 2:
            if s.init not in ("ones", "zeros"):
                raise ValueError(f"serve_deepseek: a drawn vector leaf {s}")
            fill = torch.ones if s.init == "ones" else torch.zeros
            out.append(fill(s.shape, dtype=torch.float32, device=device))
            continue
        k = int(np.prod(s.shape))
        std = fan_in(name, s.shape) ** -0.5 if s.scale is None else s.scale
        out.append(flat[off:off + k].view(s.shape).mul_(std))
        off += k
    return tree_unflatten(specs, out)


def reference_weights(params, m: dict) -> dict:
    """The same tensors under the reference's names and published layout
    (``kv_b`` each head's k_nope columns then its v columns: a copy of
    ``wk_b`` and ``wv_b`` side by side, the only copy made)."""
    import torch
    d = m["hidden_size"]
    layers = []
    for kind, p in zip(ref.layer_kinds(m), params["layers"]):
        x, f = p["mixer"], p["ffn"]
        rank = x["wk_b"].shape[0]
        attn = {"kv_a": x["wkv_a"], "kv_norm": x["kv_norm"],
                "kv_b": torch.cat([x["wk_b"], x["wv_b"]], dim=-1)
                .reshape(rank, -1),
                "o": x["wo"].reshape(-1, d)}
        if "wq" in x:
            attn["q"] = x["wq"].reshape(d, -1)
        else:
            attn.update(q_a=x["wq_a"], q_norm=x["q_norm"],
                        q_b=x["wq_b"].reshape(x["wq_b"].shape[0], -1))
        fw = {"gate": f["w_gate"], "up": f["w_up"], "down": f["w_down"]}
        if kind == "moe":
            s = f["shared"]
            fw.update(router=f["router"], shared={
                "gate": s["w_gate"], "up": s["w_up"], "down": s["w_down"]})
        layers.append({"input_norm": p["norm1"]["scale"],
                       "post_norm": p["norm2"]["scale"], "attn": attn,
                       "ffn": fw})
    return {"embed": params["embed"]["tok"],
            "lm_head": params["embed"]["unembed"],
            "final_norm": params["final_norm"]["scale"], "layers": layers}


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
    # ClosedLoop also adds up a GQA decoder's closed form from these keys
    # (head_dim: the attention's query width); this driver replaces both
    # of its counts with counts_deepseek's
    loop = ClosedLoop(eng, Request, mix, ctx.seed, m["vocab_size"], dict(
        m, head_dim=m["qk_nope_head_dim"] + m["qk_rope_head_dim"]))
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
            raise RuntimeError("serve_deepseek: the window closed before "
                               "the trace began; lengthen --seconds")
        tracer.stop()
        last_step = len(loop.steps)
    end = eng.stats()
    stats = {k: end[k] - base[k] for k in STATS}
    stats["st_payload_bytes"] = {k: v - base["st_payload_bytes"][k]
                                 for k, v in end["st_payload_bytes"].items()}
    payload_bad = last.mismatches()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    red = tracer.reduce() if tracer else None
    decode_flops = counts_deepseek.decode_flops(
        m, [k for kv, _ in loop.steps for k in kv])
    prefill_flops = sum(counts_deepseek.prefill_flops(m, n, L)
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
        dec = [len(kv) for kv, _ in loop.steps[first:last_step] if kv]
        puts = [counts_deepseek.router_put_bounds(
            m, ranks, slot_bucket(a, S["slots"]), moe_on) for a in dec]
        rec["kernels"] = {
            "router_put": {"names": KERNELS["router_put"],
                           "bound_s": sum(sum(p) for p in puts),
                           "launches": sum(len(p) for p in puts)}}
    return Record(rec=rec, checks={"mean_logit_gap": gap,
                                   "payload_mismatches": payload_bad},
                  attempted=attempted, failed=0,
                  memory_peak_bytes=int(peak), trace=red,
                  extra={"weights": wref, "model": m,
                         "checked": [finished[i] for i in pick]})
