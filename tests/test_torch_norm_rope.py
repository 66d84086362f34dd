"""The norm and RoPE kernels' wrappers (``kernels/norm_rope``) and their
route through the model layers, on the CPU.

The plain versions (``ref.py``) are the model's own composition: the
model layers call them wherever the kernels do not run, and the
wrappers' CPU route is them. The card's route is checked here for what
the wrappers hand the kernels (a faked launch on meta tensors) and what
they refuse; the kernels themselves are held to the plain versions on
the card (``tests/test_torch_cuda.py``).

The route: the kernels run where ``layers.kernel_route`` says so (CUDA
tensors, no gradient needed, ``attn_impl`` not "plain"). A faked card
(``kernel_route`` seeing every tensor on the card, each wrapper counting
its calls and running its plain version) shows which calls a forward
makes on each route, and that the sample steps of a reduced granite and
a reduced jamba2-mini serve the same ids and leave the same caches as on
the plain route, bit for bit.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build, norm_rope  # noqa: E402
from repro_torch.kernels.norm_rope import ops  # noqa: E402
from repro_torch.kernels.norm_rope import (rmsnorm_ref,  # noqa: E402
                                           rope_cache_ref)
from repro_torch.models import (cache_specs, forward,  # noqa: E402
                                init_params, model_specs)
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.params import (tree_leaves,  # noqa: E402
                                       zeros_from_specs)
from repro_torch.train.steps import (make_decode_sample_step,  # noqa: E402
                                     make_prefill_sample_step)

DTYPES = [torch.float32, torch.bfloat16, torch.float16]


def _bits(t):
    return t.view({4: torch.int32, 2: torch.int16}[t.element_size()])


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        _bits(a.contiguous()), _bits(b.contiguous()))


def _as_card(t):
    """What ``layers.kernel_route`` reads of ``t``, as if it were on the
    card."""
    return types.SimpleNamespace(is_cuda=True, dtype=t.dtype,
                                 requires_grad=t.requires_grad)


def _randn(shape, dtype, seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to(dtype)


def _within(got, want, dtype, spread=None):
    """|got - want| (want float64) at most one unit in the last place of
    want in ``dtype`` (16 for float32, whose value went through several
    float32 roundings; at least the dtype's spacing of subnormals), plus
    2^-22 of ``spread`` where given (the size of the terms a difference
    cancelled)."""
    bits, units = {torch.float32: (24, 16), torch.bfloat16: (8, 1),
                   torch.float16: (11, 1)}[dtype]
    _, e = torch.frexp(want)
    fi = torch.finfo(dtype)
    tol = units * torch.ldexp(torch.ones_like(want), e - bits).clamp(
        min=fi.tiny * fi.eps)                   # subnormals' spacing
    if spread is not None:
        tol = tol + spread * 2.0 ** -22
    return bool(((got.double() - want).abs() <= tol).all())


# ---------------------------------------------------------------------------
# the plain versions against float64 arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_delta", [False, True], ids=["norm", "add"])
@pytest.mark.parametrize("D", [16, 256, 2048])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_rmsnorm_ref_is_rmsnorm(dtype, D, with_delta):
    """rmsnorm_ref, and the wrapper's CPU route: s bit for bit x + delta
    in x's dtype (x itself without delta), y the float64 RMSNorm of s
    times the scale within one unit in the last place of x's dtype (16
    in float32); a float32 scale and one in x's dtype, rows of a column
    slice of a wider tensor too."""
    wide = _randn((3, 5, D + 24), dtype, 0, 3.0)
    for x in (wide[..., :D].contiguous(), wide[..., 8:D + 8]):
        delta = _randn(x.shape, dtype, 1) if with_delta else None
        s = x if delta is None else x + delta
        for scale in (_randn((D,), torch.float32, 2),
                      _randn((D,), dtype, 2)):
            s64 = s.double()
            want = s64 * torch.rsqrt((s64 * s64).mean(-1, keepdim=True)
                                     + 1e-5) * scale.double()
            for got_s, got_y in (rmsnorm_ref(x, scale, 1e-5, delta),
                                 norm_rope.rmsnorm(x, scale, 1e-5, delta)):
                assert _same(got_s, s) and got_y.dtype == dtype
                assert (got_s is x) == (delta is None)
                assert _within(got_y, want, dtype)


@pytest.mark.parametrize("use_rope", [True, False], ids=["rope", "no_rope"])
@pytest.mark.parametrize("S,start", [(1, [3, 0, 17]), (9, [0, 0, 20])],
                         ids=["decode", "prefill"])
@pytest.mark.parametrize("dtype,cache_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
    (torch.float16, torch.float16), (torch.float32, torch.bfloat16)],
    ids=["bf16", "f32", "f16", "f32_bf16_cache"])
def test_rope_cache_ref_rotates_and_writes_the_rows(dtype, cache_dtype, S,
                                                    start, use_rope):
    """rope_cache_ref, and the wrapper's CPU route: q and k rotated by the
    table's angles (the two halves of the head dim together) as float64
    arithmetic on the same cos and sin gives them, within one unit in the
    last place of their dtype (k of the cache's); k and v in the rows
    ``cache_index`` names, in the cache's dtype; every other row as it was, bit for bit."""
    B, H, KV, hd = 3, 4, 2, 16
    q, k, v = (_randn((B, S, n, hd), dtype, 3 + i)
               for i, n in enumerate((H, KV, KV)))
    positions = (torch.as_tensor(start)[:, None] + torch.arange(S)).long()
    caches = [_randn((B + 1, 32, KV, hd), cache_dtype, 6 + i)
              for i in range(2)]
    table = L.rope_table(positions, hd, 1e4) if use_rope else None
    index = attn_mod.cache_index(positions)

    def rotated(x):
        if table is None:
            return x.double(), None
        cos, sin = (t.double() for t in table)
        x1, x2 = x.double().chunk(2, dim=-1)
        out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
        size = torch.cat([(x1 * cos).abs() + (x2 * sin).abs(),
                          (x1 * sin).abs() + (x2 * cos).abs()], -1)
        return out, size

    written = torch.zeros((B + 1, 32), dtype=torch.bool)
    written[index] = True
    for fn in (rope_cache_ref, norm_rope.rope_cache):
        ck, cv = (c.clone() for c in caches)
        got = fn(q, k, v, table, ck[:B], cv[:B], index)
        want_q, size = rotated(q)
        assert got.dtype == dtype and _within(got, want_q, dtype, size)
        if table is None:
            assert got is q
        want_k, size = rotated(k)
        k_rows = ck[:B][index]
        assert k_rows.dtype == cache_dtype
        assert _within(k_rows, want_k, cache_dtype, size)
        assert _same(cv[:B][index], v.to(cache_dtype))
        for c, c0 in ((ck, caches[0]), (cv, caches[1])):
            assert _same(c[~written], c0[~written])


# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------

@pytest.fixture
def counted(monkeypatch):
    """The faked card: ``layers.kernel_route`` sees every tensor on the
    card, and each kernel wrapper the model layers call counts its calls
    and runs its plain version. Yields the counts."""
    calls = {"rmsnorm": [], "rope_cache": []}
    real = L.kernel_route

    def on_card(cfg, *tensors):
        return real(cfg, *map(_as_card, tensors))

    def rmsnorm(x, scale, eps, delta=None):
        calls["rmsnorm"].append((tuple(x.shape), delta is not None))
        return rmsnorm_ref(x, scale, eps, delta)

    def rope_cache(q, k, v, table, cache_k, cache_v, index):
        calls["rope_cache"].append(table is not None)
        return rope_cache_ref(q, k, v, table, cache_k, cache_v, index)

    monkeypatch.setattr(L, "kernel_route", on_card)
    monkeypatch.setattr(attn_mod, "kernel_route", on_card)
    monkeypatch.setattr(L.norm_rope, "rmsnorm", rmsnorm)
    monkeypatch.setattr(attn_mod, "rope_cache", rope_cache)
    return calls


def _granite(**changes):
    cfg = dataclasses.replace(get_config("granite-3-2b").reduced(),
                              compute_dtype="float32", **changes)
    params = init_params(model_specs(cfg), torch.Generator().manual_seed(0),
                         "cpu", torch.float32)
    return cfg, params


@pytest.mark.parametrize("case,want", [
    ("cpu", False), ("card", True), ("plain", False), ("float64", False),
    ("grad", False), ("grad_mode_off", True)])
def test_kernel_route_is_the_card_without_gradients_or_plain(case, want):
    """kernel_route: never on the CPU; on the card for the three dtypes
    with no gradient needed, not under "plain", not for another dtype,
    not where a tensor needs a gradient (unless grad mode is off)."""
    cfg, _ = _granite()
    x = torch.zeros(2, 3)
    tensors = [x, x.bfloat16(), x.half()]
    if case == "plain":
        cfg = dataclasses.replace(cfg, attn_impl="plain")
    elif case == "float64":
        tensors.append(x.double())
    elif case.startswith("grad"):
        tensors.append(x.clone().requires_grad_())
    if case != "cpu":
        tensors = [_as_card(t) for t in tensors]
    with torch.set_grad_enabled(case != "grad_mode_off"):
        assert L.kernel_route(cfg, *tensors) is want


@pytest.mark.parametrize("route", ["kernel", "plain", "grad", "cpu"])
def test_forward_takes_the_kernels_only_on_their_route(monkeypatch, counted,
                                                       route):
    """On the faked card a no-grad forward with a cache makes 2 L + 1
    rmsnorm calls (norm1 of the first block alone, every other with the
    residual add before it) and L rope_cache calls; the "plain" route,
    a forward that needs gradients (trainable params, as training's) and
    the CPU make none. The hidden state is the same on every route."""
    if route == "cpu":
        monkeypatch.undo()
    cfg, params = _granite(attn_impl="plain" if route == "plain"
                           else "kernel")
    toks = torch.as_tensor(np.random.RandomState(0).randint(
        1, cfg.vocab_size, (2, 6)))
    batch = {"tokens": toks, "positions": torch.arange(6).expand(2, 6)}
    caches = [zeros_from_specs(cache_specs(cfg, 2, 16), "cpu")
              if route != "grad" else None for _ in range(2)]
    if route == "grad":
        for t in tree_leaves(params):
            t.requires_grad_(True)
        x, _, _ = forward(cfg, params, batch)
    else:
        with torch.no_grad():
            x, _, _ = forward(cfg, params, batch, cache=caches[0])
    n = cfg.num_layers
    if route == "kernel":
        assert len(counted["rmsnorm"]) == 2 * n + 1
        assert [d for _, d in counted["rmsnorm"]] == [False] + [True] * 2 * n
        assert counted["rope_cache"] == [True] * n
    else:
        assert counted["rmsnorm"] == [] and counted["rope_cache"] == []
    with torch.no_grad():
        plain_cfg = dataclasses.replace(cfg, attn_impl="plain")
        want, _, _ = forward(plain_cfg, params, batch, cache=caches[1])
    assert _same(x.detach(), want)
    if route != "grad":
        for a, b in zip(caches[0]["layers"], caches[1]["layers"]):
            assert _same(a["k"], b["k"]) and _same(a["v"], b["v"])


def _serve(cfg, params, steps=4):
    """A prefill of two prompts of 7 tokens, then ``steps`` decode steps:
    (every step's ids, the final cache's leaves)."""
    cache = zeros_from_specs(cache_specs(cfg, 2, 24), "cpu")
    toks = torch.as_tensor(np.random.RandomState(1).randint(
        1, cfg.vocab_size, (2, 7)))
    prefill = make_prefill_sample_step(cfg, moe_impl="dense")
    decode = make_decode_sample_step(cfg, moe_impl="dense")
    ids, cache = prefill(params, {"tokens": toks,
                                  "positions": torch.arange(7).expand(2, 7)},
                         cache)
    out = [ids]
    for t in range(7, 7 + steps):
        ids, _, cache = decode(params, {"tokens": ids[:, None].long(),
                                        "positions": torch.full((2, 1), t)},
                               cache)
        out.append(ids)
    return out, [leaf for layer in cache["layers"]
                 for _, leaf in sorted(layer.items())]


@pytest.mark.parametrize("arch", ["granite-3-2b", "jamba2-mini"])
def test_sample_steps_on_the_kernel_route_equal_the_plain_route(counted,
                                                                arch):
    """The reduced model's prefill and decode sample steps (float32) through
    the kernel wrappers serve the plain route's ids and leave its cache,
    bit for bit. Per forward: 2 L + 1 rmsnorm calls, 3 more a Mamba mixer
    (its dt, B and C norms, jamba2-mini's), and one rope_cache call a
    self-attention layer, with no table where RoPE is off (jamba)."""
    base = dataclasses.replace(get_config(arch).reduced(),
                               compute_dtype="float32")
    params = init_params(model_specs(base), torch.Generator().manual_seed(0),
                         "cpu", torch.float32)
    got = _serve(base, params)
    n_fwd = 5
    mixers = [m for m, _ in base.layer_specs()]
    n_mamba, n_attn = mixers.count("mamba"), mixers.count("attn")
    assert len(counted["rmsnorm"]) == n_fwd * (2 * base.num_layers + 1
                                               + 3 * n_mamba)
    assert counted["rope_cache"] == [base.use_rope] * (n_fwd * n_attn)
    seen = {k: len(v) for k, v in counted.items()}
    want = _serve(dataclasses.replace(base, attn_impl="plain"), params)
    assert {k: len(v) for k, v in counted.items()} == seen  # plain: none
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)
    for a, b in zip(got[1], want[1]):
        assert _same(a, b)


# ---------------------------------------------------------------------------
# the card's route on meta tensors
# ---------------------------------------------------------------------------

class _FakeLaunch:
    """The kernel library as the wrappers call it: records each launch's
    arguments and reports success."""

    def __init__(self):
        self.calls = []

    def rmsnorm_launch(self, *args):
        self.calls.append(("rmsnorm", args))
        return 0

    def rope_cache_launch(self, *args):
        self.calls.append(("rope_cache", args[:11] + (list(args[11]),)
                           + args[12:]))
        return 0


@pytest.fixture
def fake_card(monkeypatch):
    """The card's route on meta tensors: the device check bypassed, the
    launch faked."""
    lib = _FakeLaunch()
    monkeypatch.setattr(ops, "_on_card", lambda *a: None)
    monkeypatch.setattr(ops._build, "load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    _build.reset_launches()
    yield lib
    _build.reset_launches()


def _meta(shape, dtype=torch.bfloat16):
    return torch.zeros(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_rmsnorm_card_route_hands_the_kernel_rows_and_strides(fake_card,
                                                              dtype):
    """One launch a call: the dtype codes, each input's row stride (a
    column slice keeps its wider row), NULL delta and sum without a
    delta, the row count and width; fresh contiguous outputs, x itself
    as the sum without a delta."""
    wide = _meta((4, 3, 48), dtype)
    x = wide[..., 8:24]
    scale = _meta((16,), torch.float32)
    s, y = norm_rope.rmsnorm(x, scale, 1e-6)
    assert s is x and y.is_contiguous() and y.shape == x.shape
    delta = _meta((4, 3, 16), dtype)
    s2, y2 = norm_rope.rmsnorm(x, _meta((16,), dtype), 1e-6, delta)
    assert s2.is_contiguous() and s2.shape == x.shape
    (k1, a1), (k2, a2) = fake_card.calls
    assert k1 == k2 == "rmsnorm"
    # (dtype, scale dtype, x, x row stride, delta, its stride, sum, y,
    #  scale, rows, D, eps, stream)
    code = ops.DTYPES[dtype]
    assert (a1[0], a1[1], a1[3], a1[4], a1[5], a1[6]) == (code, 0, 48, None,
                                                          0, None)
    assert (a2[0], a2[1], a2[3], a2[5]) == (code, code, 48, 16)
    assert a1[9:11] == a2[9:11] == (12, 16) and a1[11] == 1e-6
    assert _build.LAUNCHES["rmsnorm"] == 2
    norm_rope.rmsnorm(x[:0], scale, 1e-6)                  # no row: none
    assert len(fake_card.calls) == 2


@pytest.mark.parametrize("use_rope", [True, False], ids=["rope", "no_rope"])
def test_rope_cache_card_route_hands_the_kernel_strides(fake_card, use_rope):
    """One launch: dtype codes, the tensors' strides in element units (q,
    k, v, the two caches' dims 0-2, the angles' and cols' dims 0-1), the
    shape and the cache length; a fresh q, or q itself and NULL angles
    without RoPE."""
    B, S, H, KV, hd = 3, 2, 4, 2, 16
    qkv = _meta((B, S, (H + 2 * KV) * hd))
    q = qkv[..., :H * hd].view(B, S, H, hd)
    k = qkv[..., H * hd:(H + KV) * hd].view(B, S, KV, hd)
    v = qkv[..., (H + KV) * hd:].view(B, S, KV, hd)
    ck, cv = _meta((5, 32, KV, hd), torch.float32), _meta((5, 32, KV, hd),
                                                         torch.float32)
    index = (torch.zeros((B, 1), dtype=torch.long, device="meta"),
             torch.zeros((B, S), dtype=torch.long, device="meta"))
    table = None
    if use_rope:
        table = (_meta((B, S, 1, hd // 2), torch.float32),
                 _meta((B, S, 1, hd // 2), torch.float32))
    out = norm_rope.rope_cache(q, k, v, table, ck[:B], cv[:B], index)
    (kind, a), = fake_card.calls
    assert kind == "rope_cache" and _build.LAUNCHES["rope_cache"] == 1
    assert a[:2] == (1, 0)
    row = S * (H + 2 * KV) * hd
    assert a[11] == [row, (H + 2 * KV) * hd, hd] * 3 + \
        [32 * KV * hd, KV * hd, hd] * 2 + \
        ([S * hd // 2, hd // 2] if use_rope else [0, 0]) + [S, 1]
    assert a[12:18] == (B, S, H, KV, hd, 32)
    if use_rope:
        assert out.is_contiguous() and out.shape == q.shape
    else:
        assert out is q and a[5] is None and a[8] is None and a[9] is None


@pytest.mark.parametrize("case", ["int_x", "f16_scale", "scale_shape",
                                  "delta_shape", "strided_last"])
def test_rmsnorm_card_route_refuses_what_the_kernel_does_not_take(fake_card,
                                                                  case):
    x, scale = _meta((4, 16)), _meta((16,))
    args, err = {
        "int_x": ((x.int(), scale.int(), 1e-5), TypeError),
        "f16_scale": ((x, scale.half(), 1e-5), TypeError),
        "scale_shape": ((x, _meta((8,)), 1e-5), ValueError),
        "delta_shape": ((x, scale, 1e-5, _meta((4, 8))), ValueError),
        "strided_last": ((_meta((16, 4)).t(), scale, 1e-5), ValueError),
    }[case]
    with pytest.raises(err):
        norm_rope.rmsnorm(*args)
    assert not fake_card.calls


@pytest.mark.parametrize("case", ["int32_cols", "cache_heads", "mixed",
                                  "strided_q", "f64_table"])
def test_rope_cache_card_route_refuses_what_the_kernel_does_not_take(
        fake_card, case):
    B, S, H, KV, hd = 2, 1, 4, 2, 8
    q, k, v = _meta((B, S, H, hd)), _meta((B, S, KV, hd)), _meta((B, S, KV,
                                                                  hd))
    cache = _meta((B, 16, KV, hd))
    rows = torch.zeros((B, 1), dtype=torch.long, device="meta")
    cols = torch.zeros((B, S), dtype=torch.long, device="meta")
    table = (_meta((B, S, 1, hd // 2), torch.float32),) * 2
    args = [q, k, v, table, cache, cache.clone(), (rows, cols)]
    err = ValueError
    if case == "int32_cols":
        args[6] = (rows, cols.int())
    elif case == "cache_heads":
        args[4] = _meta((B, 16, KV + 1, hd))
    elif case == "mixed":
        args[1], err = k.float(), TypeError
    elif case == "strided_q":
        args[0] = _meta((B, S, hd, H)).transpose(2, 3)
    else:
        args[3] = (table[0].double(), table[1].double())
    with pytest.raises(err):
        norm_rope.rope_cache(*args)
    assert not fake_card.calls
