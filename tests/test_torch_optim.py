"""The port's optimizers, LR schedule and gradient compression against
the JAX package's, on the CPU.

AdamW and Adafactor, with float32 and bf16 moments, take the same params
and the same gradients (numpy, in the reference's layout; the port gets
them through ``from_reference``) for three steps on granite's reduced
config (its 2 layers one unit stacked over 2 repeats) and the reduced
jamba (a prefix and stacked unit positions), where Adafactor's grouping
over the reference's stacked leaves decides its statistics and its clip.
Params within 1e-6; float32 moments within 1e-5 relative to their
largest value (Adafactor's row and column statistics are means over up
to ~1e4 float32 terms, summed in another order); bf16 moments within one bf16 spacing (at most 2^-7 of the largest:
the two frameworks round the same float32 value, which may sit on
either side of a rounding boundary). ``opt_state_from_reference`` carries
the reference's state across after the first step; with float32 moments
the port then carries its own state, with bf16 moments every step starts
from the reference's (a moment rounded to the other side of a bf16
boundary moves the next step's params by lr x b1 x one spacing, ~1e-4
here, which says nothing about the update's function).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_config
from repro.models import model_specs as j_specs
from repro.models.params import init_params as j_init_params
from repro.optim import compress_grad as j_compress
from repro.optim import cosine_schedule as j_cosine
from repro.optim import opt_init_specs as j_opt_init_specs
from repro.optim import opt_update as j_opt_update
from repro_torch.configs import get_config
from repro_torch.models import (from_reference, init_params, model_specs,
                                opt_state_from_reference)
from repro_torch.models.params import ParamSpec, tree_leaves, tree_paths
from repro_torch.optim import (compress_grad, cosine_schedule,
                               decompress_grad, opt_init, opt_update)
from _ref_params import ref_params

ARCHS = ["granite-3-2b", "jamba-1.5-large-398b"]


def _cfgs(arch, optimizer, dtype):
    kw = dict(optimizer=optimizer, opt_state_dtype=dtype)
    return (dataclasses.replace(jax_config(arch).reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


def _grads(p, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (0.3 * rng.standard_normal(a.shape)).astype(np.float32), p)


def _state_close(port, ref, bf16):
    for (path, a), (_, b) in zip(tree_paths(port), tree_paths(ref)):
        a, b = a.float(), b.float()
        scale = max(float(b.abs().max()), 1e-30)
        tol = 2.0 ** -7 * scale if bf16 else 1e-5 * scale
        assert float((a - b).abs().max()) <= tol, path


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_optimizer_matches_the_reference(arch, optimizer, dtype):
    jc, tc = _cfgs(arch, optimizer, dtype)
    specs = j_specs(jc)
    p = ref_params(specs, 0)
    jp = jax.tree.map(jnp.asarray, p)
    j_update = jax.jit(functools.partial(j_opt_update, jc))
    js = j_init_params(j_opt_init_specs(jc, specs), jax.random.PRNGKey(1),
                       dtype=None)
    tp = from_reference(tc, p, "cpu")
    ts = opt_init(tc, tp)
    bf16 = dtype == "bfloat16"
    for step in range(3):
        g = _grads(p, step)
        lr = 1e-2 * (step + 1)
        jp, js = j_update(jp, jax.tree.map(jnp.asarray, g), js,
                          jnp.float32(lr))
        tp, ts = opt_update(tc, tp, from_reference(tc, g, "cpu"), ts,
                            torch.tensor(lr, dtype=torch.float32))
        ref_p = from_reference(tc, jax.tree.map(np.asarray, jp), "cpu")
        for a, b in zip(tree_leaves(tp), tree_leaves(ref_p)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
        ref_s = opt_state_from_reference(tc, jax.tree.map(np.asarray, js),
                                         "cpu")
        assert set(ts) == set(ref_s)
        assert int(ts["count"]) == int(ref_s["count"]) == step + 1
        for k in ts:
            if k != "count":
                assert [t.shape for t in tree_leaves(ts[k])] == \
                    [t.shape for t in tree_leaves(ref_s[k])], k
                assert all(t.dtype == getattr(torch, dtype)
                           for t in tree_leaves(ts[k]))
                _state_close(ts[k], ref_s[k], bf16)
        if step == 0 or bf16:   # go on from the reference's state
            ts = ref_s
            tp = ref_p


def test_adafactor_groups_stacked_leaves_as_the_reference():
    """Reduced jamba: Adafactor's vr/vc have the reference's layout and
    shapes; a stacked (R, d) norm scale is factored (vr (R,), vc (d,)),
    where one layer's (d,) scale alone would not be."""
    jc, tc = _cfgs("jamba-1.5-large-398b", "adafactor", "float32")
    js = j_opt_init_specs(jc, j_specs(jc))
    ts = opt_init(tc, init_params(model_specs(tc), torch.Generator(),
                                  device="cpu"))
    for k in ("vr", "vc"):
        ref = jax.tree_util.tree_flatten_with_path(
            js[k], is_leaf=lambda x: hasattr(x, "shape"))[0]
        got = tree_paths(ts[k])
        assert [tuple(s.shape) for _, s in ref] == \
            [tuple(t.shape) for _, t in got]
    groups = tc.layer_groups()
    R = groups.repeats
    assert R >= 2
    assert tuple(ts["vr"]["unit"][0]["norm1"]["scale"].shape) == (R,)
    assert tuple(ts["vc"]["unit"][0]["norm1"]["scale"].shape) == \
        (tc.d_model,)


def test_schedule_equals_the_reference():
    steps = [0, 1, 7, 19, 20, 21, 999, 1999, 2000, 2001, 5000, 50_000,
             99_999, 100_000, 150_000]
    for s in steps:
        for kw in ({}, dict(peak_lr=1e-3, warmup=20, total=100)):
            a = cosine_schedule(torch.tensor(s, dtype=torch.int32), **kw)
            b = j_cosine(jnp.asarray(s, jnp.int32), **kw)
            assert a.dtype == torch.float32
            np.testing.assert_allclose(float(a), float(b), rtol=2e-7,
                                       atol=0)
            assert float(cosine_schedule(s, **kw)) == float(a)
    assert float(cosine_schedule(0)) == 0.0
    assert float(cosine_schedule(2000)) == pytest.approx(3e-4, rel=1e-3)


def test_grad_clip_bounds_the_update():
    _, tc = _cfgs("granite-3-2b", "adamw", "float32")
    specs = {"w": ParamSpec((8, 8), (None, None)),
             "b": ParamSpec((8,), (None,), init="zeros")}
    p = init_params(specs, torch.Generator().manual_seed(0), device="cpu")
    before = {k: v.clone() for k, v in p.items()}
    state = {"mu": {k: torch.zeros_like(v) for k, v in p.items()},
             "nu": {k: torch.zeros_like(v) for k, v in p.items()},
             "count": torch.zeros((), dtype=torch.int32)}
    huge = {k: torch.full_like(v, 1e6) for k, v in p.items()}
    opt_update(tc, p, huge, state, 1e-3)
    assert max(float((p[k] - before[k]).abs().max()) for k in p) < 1.0


@pytest.mark.parametrize("n,with_error", [(1000, False), (3000, True),
                                          (1024, True)])
def test_compress_grad_matches_the_reference(n, with_error):
    rng = np.random.RandomState(n)
    g = (rng.randn(n) * 3).astype(np.float32)
    e = (rng.randn(n) * 0.01).astype(np.float32) if with_error else None
    jc, js, je = j_compress(jnp.asarray(g),
                            None if e is None else jnp.asarray(e))
    tc, ts, te = compress_grad(torch.from_numpy(g),
                               None if e is None else torch.from_numpy(e))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1e-6)
    rec = decompress_grad(tc, ts, (n,))
    full = torch.from_numpy(g) + (0 if e is None else torch.from_numpy(e))
    np.testing.assert_allclose((full - rec).numpy(), te.numpy(), atol=1e-6)
