"""The DeepSeek-V2-Lite cell at a tiny size on the CPU: a sound run reads
correct, and each fault planted under the timed path reads not correct:
YaRN's softmax factor dropped, the rope part of the absorbed decode's
scores zeroed, the shared experts skipped, the MoE gates renormalized,
the router's hidden-block puts zeroed."""
import pytest
import torch

import stbench_tiny as tiny

# float32 weights, compute and cache (the fixtures below): a sound run's
# mean gap reads 0.0 on four seeds of 3-s windows, its float8 control
# 0.0120 to 0.0149; the planted faults on two seeds 0.0122 to 0.0150
# (the gates renormalized), 0.067 to 0.071 (no YaRN softmax factor),
# 0.138 to 0.148 (no shared experts), 0.168 to 0.170 (no rope scores)
TINY_DEEPSEEK_GAP_LIMIT = 0.004
CELL = "deepseek-v2-lite-decode"


def deepseek_overrides():
    """Every width cut, the block kept: 3 layers (the dense one, two
    MoE), no query compression, YaRN at the published factor, 64 routed
    experts top-6 beside 2 shared."""
    config = tiny._load("stbench/configs/deepseek-v2-lite.json")
    config.update(hidden_size=128, intermediate_size=64,
                  moe_intermediate_size=32, num_attention_heads=4,
                  num_key_value_heads=4, kv_lora_rank=32,
                  qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
                  n_routed_experts=64, num_hidden_layers=3, vocab_size=512,
                  torch_dtype="float32")
    config["serving"] = dict(config["serving"], slots=4, max_len=64)
    mix = dict(tiny._load("stbench/traffic/reasoning-decode.json"),
               clients=4, prompt_tokens={"uniform": [4, 12]},
               output_tokens={"uniform": [8, 24]}, check_requests=64,
               trace_after_s=0.0, trace_seconds=0.5)
    return {"config": config, "mix": mix,
            "limits": {"mean_logit_gap": TINY_DEEPSEEK_GAP_LIMIT,
                       "payload_mismatches": 0}}


@pytest.fixture(autouse=True)
def peaked_router(monkeypatch):
    """The router drawn at std 1/sqrt(d) instead of its init's 0.02: at
    d = 128 the init's router is near uniform, so every token's gates sum
    alike and renormalizing them only scales the routed output."""
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
    """The engine's latent cache in float32 (bf16 as served): a bf16
    cache row's rounding flips near-tied top-k choices, and in float32
    throughout the program's logits are the reference's to ~1e-5, so a
    fault stands out by orders."""
    import functools
    from repro_torch.models import cache_specs
    from repro_torch.serving import engine
    monkeypatch.setattr(engine, "cache_specs", functools.partial(
        cache_specs, cache_dtype=torch.float32))


def _run(seed=20260101):
    return tiny.run_tiny(CELL, deepseek_overrides(), seed=seed, seconds=3.0)


def test_deepseek_tiny_cell_is_correct():
    result, checks = _run()
    assert result["correct"] is True
    assert checks["payload_mismatches"][0] == 0
    assert set(result["metrics"]) == {"setup_s", "tokens_per_s",
                                      "itl_p95_ms"}


def _no_yarn_softmax_factor(monkeypatch):
    # both MLA paths scale the scores by (nope + rope)^-1/2 alone
    import dataclasses
    from repro_torch.models import mla
    real = mla.softmax_scale
    monkeypatch.setattr(mla, "softmax_scale", lambda cfg: real(
        dataclasses.replace(cfg, rope_scaling=None)))


def _zeroed_rope_scores(monkeypatch):
    # the absorbed decode scores the latent rows without their rope part
    from repro_torch.models import mla
    real = mla._absorbed_decode

    def no_rope(cfg, params, q_nope, q_rope, ckv, krope, positions, dt):
        return real(cfg, params, q_nope, q_rope, ckv, torch.zeros_like(krope),
                    positions, dt)
    monkeypatch.setattr(mla, "_absorbed_decode", no_rope)


def _skipped_shared_experts(monkeypatch):
    from repro_torch.models import moe
    monkeypatch.setattr(moe, "_shared", lambda params, x, dt:
                        torch.zeros_like(x))


def _renormalized_gates(monkeypatch):
    from repro_torch.models import moe
    real = moe._router

    def renorm(cfg, params, x):
        gates, sel, aux = real(cfg, params, x)
        return gates / gates.sum(-1, keepdim=True), sel, aux
    monkeypatch.setattr(moe, "_router", renorm)


def _zeroed_hidden_puts(monkeypatch):
    # the puts of the hidden block (d_model wide) land zeros
    from repro_torch.core import engine
    real = engine.put_signal
    width = deepseek_overrides()["config"]["hidden_size"]

    def zeroed(x, perm, sig=None, upd=None):
        out = real(x, perm, sig, upd)
        if x.shape[-1] != width:
            return out
        if sig is None:
            return torch.zeros_like(out)
        return torch.zeros_like(out[0]), out[1]
    monkeypatch.setattr(engine, "put_signal", zeroed)


@pytest.mark.parametrize("fault", [
    _no_yarn_softmax_factor, _zeroed_rope_scores, _skipped_shared_experts,
    _renormalized_gates, _zeroed_hidden_puts])
def test_deepseek_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    result, checks = _run()
    assert result["correct"] is False
    assert any(v > lim for v, lim in checks.values() if v is not None)


def test_deepseek_hidden_puts_fault_reads_payload_mismatches(monkeypatch):
    _zeroed_hidden_puts(monkeypatch)
    _, checks = _run()
    assert checks["payload_mismatches"][0] > 0


@pytest.mark.parametrize("seed", [20260101, 2])
def test_deepseek_fp8_control_is_over_the_limit(seed):
    """The reference in float8 e4m3 products in the program's place, on
    the tokens a sound tiny run served and checked: its mean gap passes
    the limit the program's own reading stays under."""
    import time
    import numpy as np
    from stbench import harness
    from stbench.drivers import serve_deepseek
    from stbench.reference import deepseek_v2 as ref
    ov = deepseek_overrides()
    ctx = harness.Context(workload=CELL, config=ov["config"], mix=ov["mix"],
                          seed=seed, seconds=3.0, trace=False,
                          device=torch.device("cpu"),
                          t_start=time.perf_counter())
    out = serve_deepseek.run(ctx)
    w, m = out.extra["weights"], out.extra["model"]
    ctl = np.concatenate([ref.control_gaps(w, m, p, s)
                          for p, s in out.extra["checked"]]).mean()
    assert out.checks["mean_logit_gap"] <= TINY_DEEPSEEK_GAP_LIMIT < ctl


def test_counts_against_hand_counts():
    from stbench import counts_deepseek as cd
    m = deepseek_overrides()["config"]
    d, H, nope, rope, vd, c, V = 128, 4, 32, 16, 32, 32, 512
    f, fd, E, K, NS = 32, 64, 64, 6, 2
    q = 2 * d * H * (nope + rope)
    mla_fixed = (q + 2 * d * (c + rope) + 2 * H * nope * c + 2 * H * c * vd
                 + 2 * H * vd * d)
    per_key = 2 * H * (c + c + rope)
    dense, moe = 2 * 3 * d * fd, 2 * d * E + 2 * 3 * d * f * (K + NS)
    token0 = 2 * V * d + 3 * mla_fixed + dense + 2 * moe
    assert cd.decode_token_flops(m, 0) == token0
    assert cd.decode_token_flops(m, 10) == token0 + 3 * 10 * per_key
    assert cd.decode_flops(m, [3, 10]) == \
        cd.decode_token_flops(m, 3) + cd.decode_token_flops(m, 10)
    pre_tok = q + 2 * d * (c + rope) + 2 * c * H * (nope + vd) + 2 * H * vd * d
    pairs = 15                                  # 5 causal positions
    mla5 = 5 * pre_tok + 2 * H * (nope + rope + vd) * pairs
    assert cd.prefill_flops(m, 2, 5) == 2 * (
        2 * V * d + 3 * mla5 + 5 * dense + 2 * 5 * moe)
    # a compressed query: two products through the rank
    assert cd._q_flops(dict(m, q_lora_rank=24)) == 2 * (
        d * 24 + 24 * H * (nope + rope))
    # latent rows (kv_lora wide), ids, the hidden block to each of 3 peer
    # shifts: each staged float32 or int32 row read and written once on
    # 4 ranks
    from stbench.counts import HBM_BYTES_PER_S
    got = cd.router_put_bounds(m, 4, 8, True)
    cells = [8 * c, 8] + [8 * d] * 3
    assert got == [4 * (2 * 4 * n + 8) / HBM_BYTES_PER_S for n in cells]
    assert len(cd.router_put_bounds(m, 4, 8, False)) == 2


def test_deepseek_readers_on_a_tiny_record():
    """The cell's metric readers on an untraced tiny record: the
    device-trace ones find nothing, the others read the engine's
    counters and the closed-form counts."""
    import time
    from stbench import harness
    from stbench.drivers import serve_deepseek
    ov = deepseek_overrides()
    ctx = harness.Context(workload=CELL, config=ov["config"], mix=ov["mix"],
                          seed=5, seconds=1.5, trace=False,
                          device=torch.device("cpu"),
                          t_start=time.perf_counter())
    rec = serve_deepseek.run(ctx).rec
    names = [m["name"] for m in harness.cell_metrics(
        harness.load_benchmark(), CELL, True)]
    got = {n: harness.read_metric(n, rec) for n in names}
    assert len(names) == 7
    for n in ("router_put_roofline.dsv2lite", "idle_share.dsv2lite"):
        assert got[n] is None
    # 64 experts computed a token for 6 routed, idle decode slots more
    assert got["moe_rows_per_route.dsv2lite"] >= 64 / 6
    # 64 latent rows a slot scored against at most 36 valid ones
    assert got["mla_rows_per_valid.dsv2lite"] >= 64 / 36
    assert got["mfu.dsv2lite"] > 0 and got["decode_step_ms.dsv2lite"] > 0
    assert got["router_ms_per_step.dsv2lite"] > 0
    assert rec["prefill_flops"] > 0
    assert sum(rec["stats"]["st_payload_bytes"].values()) > 0


def test_port_config_refuses_what_the_block_does_not_compute():
    from stbench.drivers import serve_deepseek
    m = deepseek_overrides()["config"]
    for key, value in (("topk_method", "group_limited_greedy"),
                       ("first_k_dense_replace", 3),
                       ("scoring_func", "sigmoid"),
                       ("routed_scaling_factor", 16)):
        with pytest.raises(ValueError, match=key):
            serve_deepseek.port_config("deepseek-v2-lite",
                                       dict(m, **{key: value}))
    with pytest.raises(ValueError, match="YaRN"):
        serve_deepseek.port_config("deepseek-v2-lite", dict(
            m, rope_scaling=dict(m["rope_scaling"], type="linear")))


def test_the_reference_loads_nothing_of_the_program():
    """``stbench/reference/deepseek_v2.py`` imports neither JAX, nor the
    JAX package, nor any module of the program."""
    import os
    import subprocess
    import sys
    code = (f"import sys; sys.path[:0] = [{tiny.ROOT!r}]; "
            "import stbench.reference.deepseek_v2; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    loaded = eval(p.stdout.strip().splitlines()[-1])
    assert "torch" in loaded
    assert not {"repro_torch", "repro", "jax", "jaxlib"} & set(loaded)
