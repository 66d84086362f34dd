"""The port's train step against the JAX package's on its other routes:
the reference's ``pallas_interpret`` route (its Pallas kernels in
interpret mode, under the ``custom_vjp`` that the port's autograd
Functions follow: flash attention for granite, WKV6 for rwkv6, the
selective scan and flash attention for jamba) and the dense and
expert-parallel (a2a, one shard) MoEs with the aux loss. Same weights,
batch and bounds as ``test_torch_train.py``."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_train import (LOSS_TOL, MOE_ARCHS, PALLAS_ARCHS,
                              assert_grads_close, batch, configs,
                              port_grads, reference_grads, weights)

CASES = ([(a, "pallas_interpret", "gshard") for a in PALLAS_ARCHS]
         + [(a, "xla", "dense") for a in MOE_ARCHS]
         + [(MOE_ARCHS[0], "xla", "a2a")])


@pytest.mark.parametrize("arch,impl,moe_impl", CASES)
def test_train_step_matches_the_reference_route(arch, impl, moe_impl):
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
