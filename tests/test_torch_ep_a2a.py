"""The port's gather-based expert-parallel MoE on the CPU.

One MoE layer of the reduced jamba-1.5-large-398b (8 experts, top-2;
the reference's leaf rules drawn by ``tests/_ref_params.py``, handed to
both packages), float32:

  * ``moe_a2a`` on one shard against the JAX package's single-device
    ``moe_a2a``, with every expert under capacity and with a router that
    overflows two experts (drops), within 1e-5 (the reference's own
    single-device tolerance, ``tests/test_ring_a2a.py``), the aux loss
    within the router's 1e-3 of ``tests/test_torch_mamba.py``;
  * ``moe_a2a`` against the port's ``moe_dense`` oracle at capacity
    factor 8 (no drops), within 1e-5;
  * four shards against one: the same partials summed in shard order;
  * ``moe_a2a_st`` in st, host and fused mode against ``moe_a2a`` at
    four shards: 1e-5 for the output, 1e-6 for the aux loss; the three
    modes bit for bit;
  * ``moe.moe(impl="a2a")`` is the one-shard ``moe_a2a``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_config
from repro.core.ep_a2a import moe_a2a as j_moe_a2a
from repro.models import model_specs as j_specs
from repro.sharding.rules import make_rules
from repro_torch.configs import get_config
from repro_torch.core import ep_a2a
from repro_torch.models import from_reference, moe
from _ref_params import ref_params

ARCH = "jamba-1.5-large-398b"
TOL = 1e-5
AUX_RTOL = 1e-3


def _layer(capacity_factor=None, skew_router=False):
    """(jax cfg, port cfg, jax weights, port weights) of the reduced
    jamba's layer 3, an MoE layer (the reference's unit 1, repeat 0)."""
    jc, tc = jax_config(ARCH).reduced(), get_config(ARCH).reduced()
    if capacity_factor is not None:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(
            jc.moe, capacity_factor=capacity_factor))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(
            tc.moe, capacity_factor=capacity_factor))
    jp = ref_params(j_specs(jc), 0)
    tp = from_reference(tc, jp, "cpu", dtype=torch.float32)
    jw = {k: np.asarray(v[0]) for k, v in jp["unit"][1]["ffn"].items()}
    tw = dict(tp["layers"][3]["ffn"])
    if skew_router:
        # experts 0 and 1 favoured by a shared input direction: each is
        # sent more tokens than its capacity
        jw["router"] = jw["router"].copy()
        jw["router"][:, 0] += 0.5
        jw["router"][:, 1] += 0.4
        tw["router"] = torch.from_numpy(jw["router"])
    return jc, tc, {k: jnp.asarray(v) for k, v in jw.items()}, tw


def _x(tc, B, S, seed=4, skew=0.0):
    rng = np.random.RandomState(seed)
    return rng.randn(B, S, tc.d_model).astype(np.float32) + skew


@pytest.mark.parametrize("case", ["balanced", "drops"])
def test_single_shard_matches_jax(case):
    drops = case == "drops"
    jc, tc, jw, tw = _layer(skew_router=drops)
    B, S = 2, (64 if drops else 16)
    x = _x(tc, B, S, skew=3.0 if drops else 0.0)
    jo, jaux = j_moe_a2a(jc, jw, jnp.asarray(x), make_rules(jc, None, None))
    to, taux = ep_a2a.moe_a2a(tc, tw, torch.from_numpy(x))
    assert to.shape == x.shape and taux.dtype == torch.float32
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=AUX_RTOL)
    # the drops case really drops: the capacity dispatch differs from the
    # dense oracle there, and only there
    dense, _ = moe.moe_dense(tc, tw, torch.from_numpy(x))
    assert bool((dense - to).abs().max() > 1e-4) == drops


def test_matches_dense_without_drops():
    _, tc, _, tw = _layer(capacity_factor=8.0)
    x = torch.from_numpy(_x(tc, 2, 16) * 0.3)
    ya, aa = ep_a2a.moe_a2a(tc, tw, x)
    yd, ad = moe.moe_dense(tc, tw, x)
    np.testing.assert_allclose(ya.numpy(), yd.numpy(), atol=TOL)
    assert torch.equal(aa, ad)


@pytest.mark.parametrize("case", ["balanced", "drops"])
def test_four_shards_equal_one(case):
    drops = case == "drops"
    _, tc, _, tw = _layer(skew_router=drops)
    x = torch.from_numpy(_x(tc, 2, 32, skew=3.0 if drops else 0.0))
    one, a1 = ep_a2a.moe_a2a(tc, tw, x)
    four, a4 = ep_a2a.moe_a2a(tc, tw, x, n_shards=4)
    np.testing.assert_allclose(four.numpy(), one.numpy(), atol=TOL)
    np.testing.assert_allclose(float(a4), float(a1), rtol=1e-6)
    with pytest.raises(ValueError, match="divide"):
        ep_a2a.moe_a2a(tc, tw, x, n_shards=3)


def test_st_matches_direct_in_every_mode():
    _, tc, _, tw = _layer()
    x = torch.from_numpy(_x(tc, 2, 16, seed=5))
    want, waux = ep_a2a.moe_a2a(tc, tw, x, n_shards=4)
    outs = {}
    for mode in ("st", "host", "fused"):
        out, aux = ep_a2a.moe_a2a_st(tc, tw, x, ranks=4, mode=mode)
        np.testing.assert_allclose(out.numpy(), want.numpy(), atol=TOL,
                                   err_msg=mode)
        np.testing.assert_allclose(float(aux), float(waux), atol=1e-6)
        outs[mode] = (out, aux)
    for mode in ("host", "fused"):
        assert torch.equal(outs[mode][0], outs["st"][0])
        assert torch.equal(outs[mode][1], outs["st"][1])


def test_st_window_holds_views_of_the_weights():
    _, tc, _, tw = _layer()
    x = torch.from_numpy(_x(tc, 1, 8))
    _, win, state = ep_a2a.a2a_stream(tc, tw, x, ranks=4)
    for key, leaf in (("wg", "w_gate"), ("wu", "w_up"), ("wd", "w_down")):
        w = state[win.qual(key)]
        assert w.data_ptr() == tw[leaf].data_ptr()
        assert w.shape[:2] == (4, tc.moe.num_experts // 4)
    assert state[win.qual("x")].stride(0) == 0             # replicated


def test_moe_impl_a2a_is_one_shard():
    _, tc, _, tw = _layer()
    x = torch.from_numpy(_x(tc, 2, 8, seed=6))
    out, aux = moe.moe(tc, tw, x, impl="a2a")
    want, waux = ep_a2a.moe_a2a(tc, tw, x, n_shards=1)
    assert torch.equal(out, want) and torch.equal(aux, waux)
