"""One train step of the port against the JAX package's, on the CPU.

For each of the ten archs' ``reduced()`` configs, computing in float32,
the same weights (``tests/_ref_params.py``, handed over through
``from_reference``) and the same numpy batch go through the reference's
``jax.value_and_grad`` of its ``_loss_fn`` and through the port's
(``repro_torch.train.steps.value_and_grad``): the loss and the MoE aux
loss within 1e-5, every gradient (the reference's stacked unit leaves
taken apart by ``from_reference``) within 1e-4 of the largest |grad|.
The reference runs its ``xla`` route for every arch and, for granite,
rwkv6 and jamba, also its ``pallas_interpret`` route, whose Pallas
kernels wear the ``custom_vjp`` that the port's autograd Functions
follow. The port runs its default route (on the CPU each kernel wrapper
runs its plain version, inside the Function where a gradient is
needed). MoE archs run the reference's default gshard MoE and the dense
one. The vlm's cross gates are redrawn nonzero (the reference inits
them to 0, which would cut the cross layers out of the gradient).

``lm_loss_fused`` is also held to the reference's with chunks of the
sequence and a padded vocab, tied and untied.
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
from repro.models.model import lm_loss_fused as j_lm_loss_fused
from repro.sharding.rules import make_rules
from repro.train.steps import _loss_fn as j_loss_fn
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import from_reference, lm_loss_fused, trainable
from repro_torch.models.params import tree_leaves, tree_unflatten
from repro_torch.train.steps import value_and_grad
from _ref_params import ref_params

LOSS_TOL = 1e-5
GRAD_RTOL = 1e-4
MOE_ARCHS = ("jamba-1.5-large-398b", "deepseek-v2-236b", "deepseek-moe-16b")
PALLAS_ARCHS = ("granite-3-2b", "rwkv6-1.6b", "jamba-1.5-large-398b")


def _redraw_gates(tree, rng):
    if isinstance(tree, dict):
        return {k: (rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32)
                    if k == "gate" else _redraw_gates(v, rng))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_redraw_gates(v, rng) for v in tree)
    return tree


def configs(arch, impl="xla", **kw):
    kw = dict(compute_dtype="float32", **kw)
    return (dataclasses.replace(jax_config(arch).reduced(), attn_impl=impl,
                                **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


def weights(jc, seed=0):
    return _redraw_gates(ref_params(j_specs(jc), seed),
                         np.random.RandomState(seed))


def batch(cfg, B=2, S=16, seed=0):
    """Seeded numpy batch: tokens, shifted targets, positions; vision
    patches for a vlm, frames (no tokens) for an audio model."""
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    out = {"targets": toks[:, 1:].copy(),
           "positions": np.broadcast_to(np.arange(S, dtype=np.int32),
                                        (B, S)).copy()}
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (B, S, cfg.vision.raw_dim)).astype(np.float32)
    else:
        out["tokens"] = toks[:, :-1].copy()
    if cfg.family == "vlm":
        out["vision"] = (4.0 * rng.standard_normal(
            (B, cfg.vision.num_tokens, cfg.vision.raw_dim))).astype(
                np.float32)
    return out


def reference_grads(jc, p, b, moe_impl):
    """(loss, aux, grads as a numpy tree in the reference's layout)."""
    f = functools.partial(j_loss_fn, jc, make_rules(jc, None, None),
                          moe_impl, False)
    (_, (loss, aux)), g = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jax.tree.map(jnp.asarray, p),
        {k: jnp.asarray(v) for k, v in b.items()})
    return float(loss), float(aux), jax.tree.map(np.asarray, g)


def port_grads(tc, p, b, moe_impl):
    tp = trainable(from_reference(tc, p, "cpu"))
    loss, aux, g = value_and_grad(
        tc, moe_impl, tp, {k: torch.from_numpy(v) for k, v in b.items()})
    return float(loss), float(aux), tree_unflatten(tp, g)


def assert_grads_close(tc, port, ref_tree):
    ref = tree_leaves(from_reference(tc, ref_tree, "cpu"))
    got = tree_leaves(port)
    assert len(ref) == len(got)
    scale = max(float(r.abs().max()) for r in ref)
    assert scale > 0
    worst = max(float((a.detach() - r).abs().max()) for a, r in zip(got, ref))
    assert worst <= GRAD_RTOL * scale, (worst, scale)


@pytest.mark.parametrize("arch,impl,moe_impl",
                         [(a, "xla", "gshard") for a in ARCH_IDS])
def test_train_step_loss_and_grads_match_the_reference(arch, impl,
                                                       moe_impl):
    jc, tc = configs(arch, impl)
    p = weights(jc)
    b = batch(jc)
    jl, ja, jg = reference_grads(jc, p, b, moe_impl)
    tl, ta, tg = port_grads(tc, p, b, moe_impl)
    assert abs(tl - jl) <= LOSS_TOL, (tl, jl)
    assert abs(ta - ja) <= LOSS_TOL, (ta, ja)
    if arch in MOE_ARCHS:
        assert ta > 0
    assert_grads_close(tc, tg, jg)


@pytest.mark.parametrize("tie", [True, False])
@pytest.mark.parametrize("S,chunk", [(24, 8), (20, 8)])
def test_lm_loss_fused_matches_the_reference(tie, S, chunk):
    """Chunks of 8 over 24 positions (three checkpointed chunks), and 20
    positions (8 does not divide them: one chunk), with a vocab of 500
    padded to 512 (the pad columns masked); the loss and its gradients
    in x and the unembedding."""
    jc, tc = configs("granite-3-2b", tie_embeddings=tie, vocab_size=500)
    rng = np.random.RandomState(1)
    D, Vp = jc.d_model, jc.padded_vocab
    x = rng.standard_normal((2, S, D)).astype(np.float32)
    t = rng.randint(0, jc.vocab_size, (2, S)).astype(np.int32)
    emb = {"tok": (0.05 * rng.standard_normal((Vp, D))).astype(np.float32)}
    if not tie:
        emb["unembed"] = (0.05 * rng.standard_normal((D, Vp))).astype(
            np.float32)
    rules = make_rules(jc, None, None)

    def jf(x_, e_):
        return j_lm_loss_fused(jc, {"embed": e_}, x_, jnp.asarray(t), rules,
                               chunk=chunk)
    jl, (jgx, jge) = jax.value_and_grad(jf, argnums=(0, 1))(
        jnp.asarray(x), jax.tree.map(jnp.asarray, emb))
    tx = torch.from_numpy(x).requires_grad_()
    te = {k: torch.from_numpy(v).requires_grad_() for k, v in emb.items()}
    tl = lm_loss_fused(tc, {"embed": te}, tx, torch.from_numpy(t),
                       chunk=chunk)
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= LOSS_TOL
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx),
                               atol=1e-6)
    for k in emb:                       # untied: "tok" takes no part
        g = te[k].grad if te[k].grad is not None else torch.zeros(Vp, D)
        np.testing.assert_allclose(g.numpy(), np.asarray(jge[k]), atol=1e-6)
