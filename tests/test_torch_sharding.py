"""The port's sharding rules, mesh shapes and micro-batch clamp against
the JAX package's: ``make_rules``' map and the pspecs of every parameter
and cache leaf for all ten archs x the four input shapes x the meshes
none, (16, 16) and (2, 16, 16); ``effective_accum``'s clamp. One mesh
stand-in (``repro_torch.launch.mesh.MeshShape``: axis names and sizes)
drives both packages' ``make_rules``, which read only
``mesh.axis_names`` and ``mesh.shape[axis]``."""
import dataclasses

import pytest

pytest.importorskip("torch")

import repro.configs as RC
from repro.models import cache_specs as ref_cache_specs
from repro.models import model_specs as ref_model_specs
from repro.models.params import param_pspecs as ref_param_pspecs
from repro.sharding.rules import make_rules as ref_make_rules
from repro.train.steps import effective_accum as ref_effective_accum
import repro_torch.configs as TC
from repro_torch.launch.mesh import MeshShape, make_mesh, \
    make_production_mesh
from repro_torch.models import cache_specs, model_specs
from repro_torch.models.params import (get_path, param_axes,
                                       param_pspecs, reference_groups,
                                       tree_leaves)
from repro_torch.sharding import (DEFAULT_RULES, constrain,
                                  logical_to_pspec, make_rules, pspec_tree)
from repro_torch.train.steps import effective_accum

MESHES = {"none": None, "16x16": make_production_mesh(),
          "2x16x16": make_production_mesh(multi_pod=True)}


def test_production_meshes_are_the_references_shapes():
    one, two = MESHES["16x16"], MESHES["2x16x16"]
    assert (one.axis_names, one.shape, one.size) == (
        ("data", "model"), {"data": 16, "model": 16}, 256)
    assert (two.axis_names, two.shape, two.size) == (
        ("pod", "data", "model"), {"pod": 2, "data": 16, "model": 16}, 512)
    assert make_mesh((2, 2, 2), ("px", "py", "pz")) == MeshShape(
        ("px", "py", "pz"), (2, 2, 2))
    with pytest.raises(ValueError):
        MeshShape(("a", "b"), (2,))


def _leaf_pspecs_equal(cfg, port_tree, ref_tree, rules, ref_rules):
    """Every leaf's pspec in the port's per-layer tree equals the
    reference's leaf it belongs to (a stacked unit leaf's pspec has the
    "layers" dim's entry first). Returns the leaves checked."""
    ref_p = ref_param_pspecs(ref_tree, ref_rules)
    port_p = param_pspecs(port_tree, rules)
    n = 0
    for path, port_paths, stacked in reference_groups(cfg, port_tree):
        want = tuple(get_path(ref_p, path))
        for q in port_paths:
            got = get_path(port_p, q)
            assert ((None,) if stacked else ()) + got == want, (path, q)
            n += 1
    return n


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_rules_and_pspecs_equal_the_reference(arch, mesh):
    """For each of the four shapes: the rules' map; the pspec of every
    parameter leaf and of every cache leaf (at the shape's batch and
    length), leaf by leaf through the reference's stacked layout."""
    cfg, jc = TC.get_config(arch), RC.get_config(arch)
    m = MESHES[mesh]
    specs, jspecs = model_specs(cfg), ref_model_specs(jc)
    for name in TC.SHAPES:
        shape, jshape = TC.SHAPES[name], RC.SHAPES[name]
        rules, jrules = make_rules(cfg, shape, m), ref_make_rules(
            jc, jshape, m)
        assert rules.map == jrules.map, name
        assert rules.mesh is m and rules.sharding(("batch",)) is None
        n = _leaf_pspecs_equal(cfg, specs, jspecs, rules, jrules)
        assert n == len(tree_leaves(specs))
        B, S = min(shape.global_batch, 4), min(shape.seq_len, 64)
        _leaf_pspecs_equal(cfg, cache_specs(cfg, B, S),
                           ref_cache_specs(jc, B, S), rules, jrules)


@pytest.mark.parametrize("arch", ["minitron-4b", "granite-34b"])
def test_overrides_and_pspec_dedup_match(arch):
    """The per-arch overrides (minitron's replicated heads, granite-34b's
    MQA kv head), a hillclimb override and the de-duplication of mesh
    axes (the first logical dim to claim an axis wins)."""
    cfg, jc = TC.get_config(arch), RC.get_config(arch)
    m = MESHES["2x16x16"]
    over = {"embed": ("data", "model"), "batch": ("pod",)}
    for name in TC.SHAPES:
        rules = make_rules(cfg, TC.SHAPES[name], m, overrides=over)
        jrules = ref_make_rules(jc, RC.SHAPES[name], m, overrides=over)
        assert rules.map == jrules.map
        for axes in [("embed", "mlp"), ("mlp", "embed"), ("batch", "embed"),
                     ("heads", "kv_heads", None), ("embed", "embed"), ()]:
            assert logical_to_pspec(axes, rules) == tuple(
                jrules.pspec(axes))


def test_default_rules_pspec_tree_and_constrain():
    from repro.sharding.rules import DEFAULT_RULES as REF_DEFAULT
    assert DEFAULT_RULES.map == REF_DEFAULT.map
    assert DEFAULT_RULES.mesh is None
    rules = make_rules(TC.get_config("qwen3-32b"), TC.SHAPES["train_4k"],
                       MESHES["16x16"])
    tree = {"a": ("embed", "mlp"), "b": [("vocab", "embed"), ()]}
    assert pspec_tree(tree, rules) == {
        "a": ("data", "model"), "b": [("model", "data"), ()]}
    x = object()
    assert constrain(x, ("batch", None), rules) is x
    specs = model_specs(TC.get_config("llama-3.2-vision-90b").reduced())
    assert pspec_tree(param_axes(specs), rules) == param_pspecs(specs, rules)


@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_effective_accum_clamp_equals_the_reference(arch):
    """The clamp to a mesh's batch shards, at the config's grad_accum and
    others, for every shape's rules and a spread of global batches."""
    meshes = list(MESHES.values()) + [make_mesh((4, 8), ("data", "model"))]
    for accum in (1, 3, 8, 16, 64):
        cfg = dataclasses.replace(TC.get_config(arch), grad_accum=accum)
        jc = dataclasses.replace(RC.get_config(arch), grad_accum=accum)
        for name in TC.SHAPES:
            for m in meshes:
                rules = make_rules(cfg, TC.SHAPES[name], m)
                jrules = ref_make_rules(jc, RC.SHAPES[name], m)
                for gb in (None, 1, 24, 96, 128, 256, 1000):
                    assert effective_accum(cfg, rules, gb) == \
                        ref_effective_accum(jc, jrules, gb), (accum, gb)
        assert effective_accum(cfg) == max(accum, 1)
