"""The Jamba cell at a tiny size on the CPU: a sound run reads correct,
and each fault planted under the timed path reads not correct: the
Mamba state left unwritten at decode, the router's hidden-block puts
zeroed, the MoE gates renormalized."""
import pytest
import torch

import stbench_tiny as tiny

# float32 weights, compute and cache (the fixtures below): a sound run's
# mean gap reads 0.0 on four seeds of 3-s windows, its float8 control
# 0.046 to 0.060, the planted faults 0.106 to 0.140
TINY_JAMBA_GAP_LIMIT = 0.01


def jamba_overrides():
    config = tiny._load("stbench/configs/jamba2-mini.json")
    config.update(hidden_size=128, intermediate_size=64,
                  num_attention_heads=4, num_key_value_heads=2, head_dim=32,
                  vocab_size=512, mamba_dt_rank=8, num_experts=8,
                  torch_dtype="float32")
    config["serving"] = dict(config["serving"], slots=4, max_len=64)
    mix = dict(tiny._load("stbench/traffic/reasoning-decode.json"),
               clients=4, prompt_tokens={"uniform": [4, 12]},
               output_tokens={"uniform": [8, 24]}, check_requests=64,
               trace_after_s=0.0, trace_seconds=0.5)
    return {"config": config, "mix": mix,
            "limits": {"mean_logit_gap": TINY_JAMBA_GAP_LIMIT,
                       "payload_mismatches": 0}}


@pytest.fixture(autouse=True)
def peaked_router(monkeypatch):
    """The router drawn at std 1/sqrt(d) instead of its init's 0.02: at
    d = 128 the init's router is near uniform, so every token's top-2
    gates sum alike and renormalizing them only scales the MoE output,
    which the next norm undoes."""
    import dataclasses
    from repro_torch.models import moe
    real = moe.moe_specs

    def specs(cfg):
        s = real(cfg)
        s["router"] = dataclasses.replace(s["router"], scale=None)
        return s
    monkeypatch.setattr(moe, "moe_specs", specs)


@pytest.fixture(autouse=True)
def float32_cache(monkeypatch):
    """The engine's cache in float32 (bf16 as served). A bf16 cache
    row's rounding flips some near-tied top-2 choices (one expert's
    output swapped for another's), and at d = 128 a sound run's widest
    gap then read 0.12 to 0.58 on six seeds against 0.7 to 1.2 for the
    faults. In float32 throughout, the program's logits are the
    reference's to ~1e-5, and a fault stands out by orders."""
    import functools
    from repro_torch.models import cache_specs
    from repro_torch.serving import engine
    monkeypatch.setattr(engine, "cache_specs", functools.partial(
        cache_specs, cache_dtype=torch.float32))


def _run():
    return tiny.run_tiny("jamba2-mini-decode", jamba_overrides(),
                         seconds=3.0)


def test_jamba_tiny_cell_is_correct():
    result, checks = _run()
    assert result["correct"] is True
    assert checks["payload_mismatches"][0] == 0
    assert set(result["metrics"]) == {"setup_s", "tokens_per_s",
                                      "itl_p95_ms"}


def _stale_mamba_state(monkeypatch):
    # a decode step's scan leaves the cache's SSM state as it was
    from repro_torch.models import mamba
    real = mamba.mamba_scan

    def keep(a_log, dt, b, c, xc, h0, *, inplace=False):
        return real(a_log, dt, b, c, xc, h0,
                    inplace=inplace and dt.shape[1] > 1)
    monkeypatch.setattr(mamba, "mamba_scan", keep)


def _zeroed_hidden_puts(monkeypatch):
    # the puts of the hidden block (d_model wide) land zeros
    from repro_torch.core import engine
    real = engine.put_signal
    width = jamba_overrides()["config"]["hidden_size"]

    def zeroed(x, perm, sig=None, upd=None):
        out = real(x, perm, sig, upd)
        if x.shape[-1] != width:
            return out
        if sig is None:
            return torch.zeros_like(out)
        return torch.zeros_like(out[0]), out[1]
    monkeypatch.setattr(engine, "put_signal", zeroed)


def _renormalized_gates(monkeypatch):
    from repro_torch.models import moe
    real = moe._router

    def renorm(cfg, params, x):
        gates, sel, aux = real(cfg, params, x)
        return gates / gates.sum(-1, keepdim=True), sel, aux
    monkeypatch.setattr(moe, "_router", renorm)


@pytest.mark.parametrize("fault", [_stale_mamba_state, _zeroed_hidden_puts,
                                   _renormalized_gates])
def test_jamba_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    result, checks = _run()
    assert result["correct"] is False
    assert any(v > lim for v, lim in checks.values() if v is not None)


def _tiny_model():
    return jamba_overrides()["config"]


def test_counts_against_hand_counts():
    from stbench import counts_jamba as cj
    m = _tiny_model()          # d 128, di 256, ds 16, dt_rank 8, 8 layers
    d, di, ds, dtr, dc, f, V = 128, 256, 16, 8, 4, 64, 512
    mamba = 2 * (d * 2 * di + di * (dtr + 2 * ds) + dtr * di + di * d) \
        + 2 * dc * di + 7 * di * ds + 3 * di
    attn0 = 2 * (2 * d * 4 * 32 + 2 * d * 2 * 32)
    dense, moe = 2 * 3 * d * f, 2 * 2 * 3 * d * f + 2 * d * 8
    per_key = 4 * 4 * 32
    token0 = 2 * V * d + 7 * mamba + attn0 + 4 * dense + 4 * moe
    assert cj.decode_token_flops(m, 0) == token0
    assert cj.decode_token_flops(m, 10) == token0 + 10 * per_key
    assert cj.decode_flops(m, [3, 10]) == \
        cj.decode_token_flops(m, 3) + cj.decode_token_flops(m, 10)
    assert cj.prefill_flops(m, 2, 5) == 2 * (
        2 * V * d + 5 * (7 * mamba + attn0 + 4 * dense + 4 * moe)
        + per_key * 15)
    # per slot: the float32 state read and written, dt, x, y, B, C
    assert cj.mamba_step_bytes(m, 3) == 3 * (2 * di * ds * 4 + 3 * di * 2
                                             + 2 * ds * 2) + di * ds * 4
    # KV rows, ids, the hidden block to each of 3 peer shifts: each
    # staged float32 or int32 row read and written once on 4 ranks
    from stbench.counts import HBM_BYTES_PER_S
    got = cj.router_put_bounds(m, 4, 8, True)
    cells = [8 * 2 * 32, 8] + [8 * d] * 3
    assert got == [4 * (2 * 4 * c + 8) / HBM_BYTES_PER_S for c in cells]
    assert len(cj.router_put_bounds(m, 4, 8, False)) == 2


def test_jamba_readers_on_a_tiny_record():
    """The cell's metric readers on an untraced tiny record: the
    device-trace ones find nothing, the others read the engine's
    counters and the closed-form counts."""
    import time
    from stbench import harness
    from stbench.drivers import serve_jamba
    ov = jamba_overrides()
    ctx = harness.Context(workload="jamba2-mini-decode", config=ov["config"],
                          mix=ov["mix"], seed=5, seconds=1.5, trace=False,
                          device=torch.device("cpu"),
                          t_start=time.perf_counter())
    rec = serve_jamba.run(ctx).rec
    names = [m["name"] for m in harness.cell_metrics(
        harness.load_benchmark(), "jamba2-mini-decode", True)]
    got = {n: harness.read_metric(n, rec) for n in names}
    assert len(names) == 7
    for n in ("mamba_step_roofline.jamba", "router_put_roofline.jamba",
              "idle_share.jamba"):
        assert got[n] is None
    # 8 experts computed a token for 2 routed, idle decode slots more
    assert got["moe_rows_per_route.jamba"] >= 4.0
    assert got["mfu.jamba"] > 0 and got["decode_step_ms.jamba"] > 0
    assert got["router_ms_per_step.jamba"] > 0
    assert rec["prefill_flops"] > 0
    assert sum(rec["stats"]["st_payload_bytes"].values()) > 0
