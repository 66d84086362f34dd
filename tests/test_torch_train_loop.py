"""The port's train step over several steps, on the CPU: the JAX
package's ``test_system.py`` analogues, gradient accumulation, the remat
modes, and the training launcher.

  * a 10-step loss curve on ``test_system.py``'s tiny granite (AdamW, lr
    1e-3) within 1e-4 of the reference's at every step, from the same
    weights (``tests/_ref_params.py``) and batches;
  * a full reference train step (Adafactor over the reference's stacked
    leaves, bf16 moments, ``grad_accum=4`` with its bf16 accumulator) on
    the reduced jamba: loss, aux, lr and count within 1e-5, the new
    params within 1e-6 but where the bf16 sum of a gradient rounded to
    the other side of a bf16 boundary (the two frameworks' float32
    gradients differ by ~1e-7): there, at most 0.1 % of a leaf, one
    spacing of u moves the param by lr (1 - b1) 2^-7 |u|, within
    ``BF16_SUM_TOL`` = 4e-6 at lr 1e-3 and |u| <= 3;
  * ``grad_accum`` 4 against 1 in float32: the same loss and gradients
    (1e-6 of the largest);
  * every remat mode gives the gradients of ``remat="none"`` bit for bit
    (float32, CPU: the recomputation repeats the same operations), and
    checkpoints only where a gradient is needed;
  * the loss falls by 0.5 in 30 steps, and a checkpoint restart
    repeats the trajectory exactly;
  * ``launch/train.py --device cpu --reduced``, run and then resumed.
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
from repro.optim import opt_init_specs as j_opt_init_specs
from repro.sharding.rules import make_rules
from repro.train.steps import make_train_step as j_make_train_step
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.data import SyntheticTokens
from repro_torch.models import (from_reference, init_params, model_specs,
                                trainable)
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.optim import opt_init
from repro_torch.train.steps import accumulate_grads, make_train_step
from _ref_params import ref_params

BF16_SUM_TOL = 4e-6


def _tiny(cfg):
    return dataclasses.replace(cfg.reduced(), num_layers=2, d_model=64,
                               num_heads=2, num_kv_heads=1, d_ff=128,
                               vocab_size=256, head_dim=32, grad_accum=1,
                               remat="none", compute_dtype="float32")


def _batch(ds, i):
    return {k: torch.from_numpy(v) for k, v in ds.batch_at(i).items()}


def _reference_run(jc, p, batches, lr, **kw):
    rules = make_rules(jc, None, None)
    step = jax.jit(j_make_train_step(jc, rules, schedule=lambda s: lr,
                                     **kw))
    params = jax.tree.map(jnp.asarray, p)
    opt = j_init_params(j_opt_init_specs(jc, j_specs(jc)),
                        jax.random.PRNGKey(1), dtype=None)
    metrics = []
    for b in batches:
        params, opt, m = step(params, opt,
                              {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append(m)
    return params, metrics


def _port_run(tc, p, batches, lr, **kw):
    params = trainable(from_reference(tc, p, "cpu"))
    opt = opt_init(tc, params)
    step = make_train_step(tc, schedule=lambda s: lr, **kw)
    metrics = []
    for b in batches:
        params, opt, m = step(params, opt,
                              {k: torch.from_numpy(v) for k, v in b.items()})
        metrics.append(m)
    return params, metrics


def test_loss_curve_matches_the_reference():
    jc, tc = _tiny(jax_config("granite-3-2b")), _tiny(
        get_config("granite-3-2b"))
    p = ref_params(j_specs(jc), 0)
    ds = SyntheticTokens(vocab_size=tc.vocab_size, seq_len=32,
                         global_batch=8, seed=0)
    batches = [ds.batch_at(i % 4) for i in range(10)]
    _, jm = _reference_run(jc, p, batches, 1e-3, moe_impl="dense")
    _, tm = _port_run(tc, p, batches, 1e-3, moe_impl="dense")
    jl = [float(m["loss"]) for m in jm]
    tl = [float(m["loss"]) for m in tm]
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)
    assert [int(m["step"]) for m in tm] == list(range(1, 11))
    assert tl[-1] < tl[0]


def test_adafactor_bf16_accumulated_step_matches_the_reference():
    kw = dict(compute_dtype="float32", optimizer="adafactor",
              opt_state_dtype="bfloat16", grad_accum=4)
    jc = dataclasses.replace(jax_config("jamba-1.5-large-398b").reduced(),
                             attn_impl="xla", **kw)
    tc = dataclasses.replace(get_config("jamba-1.5-large-398b").reduced(),
                             **kw)
    p = ref_params(j_specs(jc), 0)
    ds = SyntheticTokens(vocab_size=tc.vocab_size, seq_len=16,
                         global_batch=8, seed=2)
    batches = [ds.batch_at(0)]
    jp, jm = _reference_run(jc, p, batches, 1e-3)
    tp, tm = _port_run(tc, p, batches, 1e-3)
    for k in ("loss", "aux_loss", "lr"):
        assert abs(float(tm[0][k]) - float(jm[0][k])) <= 1e-5, k
    assert int(tm[0]["step"]) == int(jm[0]["step"]) == 1
    ref = from_reference(tc, jax.tree.map(np.asarray, jp), "cpu")
    for a, b in zip(tree_leaves(tp), tree_leaves(ref)):
        d = (a.detach() - b).abs()
        assert float(d.max()) <= BF16_SUM_TOL
        assert int((d > 1e-6).sum()) <= 1e-3 * d.numel()


def _grads(tc, params, batch, accum=1):
    loss, aux, g = accumulate_grads(tc, "gshard", params, batch, accum)
    return float(loss), [t.detach() for t in g]


def test_grad_accum_4_equals_1():
    tc = dataclasses.replace(get_config("granite-3-2b").reduced(),
                             compute_dtype="float32")
    params = trainable(init_params(model_specs(tc),
                                   torch.Generator().manual_seed(0),
                                   device="cpu"))
    ds = SyntheticTokens(vocab_size=tc.vocab_size, seq_len=16,
                         global_batch=8, seed=0)
    b = _batch(ds, 0)
    l1, g1 = _grads(tc, params, b, 1)
    l4, g4 = _grads(tc, params, b, 4)
    assert abs(l1 - l4) <= 1e-6
    scale = max(float(g.abs().max()) for g in g1)
    assert max(float((a - c).abs().max()) for a, c in zip(g1, g4)) \
        <= 1e-6 * scale


@pytest.mark.parametrize("arch", ["granite-3-2b", "rwkv6-1.6b",
                                  "jamba-1.5-large-398b"])
def test_every_remat_mode_gives_the_same_gradients(arch):
    base = dataclasses.replace(get_config(arch).reduced(),
                               compute_dtype="float32")
    params = trainable(init_params(model_specs(base),
                                   torch.Generator().manual_seed(0),
                                   device="cpu"))
    ds = SyntheticTokens(vocab_size=base.vocab_size, seq_len=16,
                         global_batch=2, seed=0)
    b = _batch(ds, 0)
    l0, g0 = _grads(dataclasses.replace(base, remat="none"), params, b)
    for mode in ("dots", "comm", "full"):
        l, g = _grads(dataclasses.replace(base, remat=mode), params, b)
        assert l == l0, mode
        for a, c in zip(g, g0):
            assert torch.equal(a, c), mode


def test_remat_only_where_a_gradient_is_needed(monkeypatch):
    """Under grad mode with params that need no gradient (a replay or an
    eval forward), a remat config runs each block as it is: no
    checkpoint, which would intercept every operation."""
    import torch.utils.checkpoint as ckpt
    tc = dataclasses.replace(get_config("granite-3-2b").reduced(),
                             compute_dtype="float32", remat="dots")
    params = init_params(model_specs(tc), torch.Generator().manual_seed(0),
                         device="cpu")
    ds = SyntheticTokens(vocab_size=tc.vocab_size, seq_len=16,
                         global_batch=2, seed=0)
    b = _batch(ds, 0)
    calls = []
    real = ckpt.checkpoint
    monkeypatch.setattr(ckpt, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    from repro_torch.models import forward
    forward(tc, params, b)
    assert calls == []
    forward(tc, trainable(params), b)
    assert len(calls) == tc.num_layers


def _tiny_port():
    tc = _tiny(get_config("granite-3-2b"))
    params = trainable(init_params(model_specs(tc),
                                   torch.Generator().manual_seed(0),
                                   device="cpu"))
    return tc, params, opt_init(tc, params)


def test_training_reduces_loss():
    tc, params, opt = _tiny_port()
    step = make_train_step(tc, moe_impl="dense", schedule=lambda s: 1e-3)
    ds = SyntheticTokens(vocab_size=tc.vocab_size, seq_len=32,
                         global_batch=8, seed=0)
    losses = []
    for i in range(30):
        params, opt, m = step(params, opt, _batch(ds, i % 4))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])


def test_checkpoint_restart_exact_trajectory(tmp_path):
    """Train 6 steps; against train 3 + save + restore + 3: identical
    params and optimizer state, bit for bit."""
    tc = _tiny(get_config("granite-3-2b"))
    step = make_train_step(tc, moe_impl="dense", schedule=lambda s: 1e-3)
    ds = SyntheticTokens(vocab_size=tc.vocab_size, seq_len=32,
                         global_batch=8, seed=0)

    def train(params, opt, steps, start=0):
        for i in range(start, start + steps):
            params, opt, _ = step(params, opt, _batch(ds, i))
        return params, opt

    _, pA, oA = _tiny_port()
    pA, oA = train(pA, oA, 6)
    _, pB, oB = _tiny_port()
    pB, oB = train(pB, oB, 3)
    save_checkpoint(str(tmp_path), 3, {"p": pB, "o": oB})
    like = tree_map(lambda t: torch.zeros_like(t).requires_grad_(
        t.requires_grad), {"p": pB, "o": oB})
    restored, s, _ = restore_checkpoint(str(tmp_path), like)
    assert s == 3
    pB, oB = train(restored["p"], restored["o"], 3, start=3)
    for a, b in zip(tree_leaves({"p": pA, "o": oA}),
                    tree_leaves({"p": pB, "o": oB})):
        assert torch.equal(a, b)


def test_launcher_runs_and_resumes(tmp_path, capsys):
    from repro_torch.launch.train import main
    args = ["--arch", "granite-3-2b", "--reduced", "--device", "cpu",
            "--seq", "16", "--batch", "2", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2", "--log-every", "1"]
    main(args + ["--steps", "3"])
    out = capsys.readouterr().out
    assert out.startswith("arch=granite-3-2b params=")
    assert "done: 3 steps" in out
    main(args + ["--steps", "5", "--resume"])
    out = capsys.readouterr().out
    assert "resumed at step 3" in out and "done: 2 steps" in out
    assert "step 4 " in out


def test_launcher_default_checkpoints_go_under_the_temp_dir(tmp_path,
                                                            monkeypatch,
                                                            capsys):
    """Without ``--ckpt-dir`` the checkpoints go under the temporary
    directory (``TMPDIR``), so two checkouts with temp dirs of their own
    never resume from each other's steps."""
    import tempfile
    from repro_torch.launch.train import main
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    args = ["--arch", "granite-3-2b", "--reduced", "--device", "cpu",
            "--seq", "16", "--batch", "2", "--log-every", "1"]
    main(args + ["--steps", "2"])
    ckpt = tmp_path / "repro_torch_ckpt"
    assert (ckpt / "step_00000001" / "manifest.json").is_file()
    main(args + ["--steps", "3", "--resume"])
    assert f"resumed at step 2 from {ckpt}" in capsys.readouterr().out
