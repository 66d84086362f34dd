"""The port's launch and analysis tooling against the JAX package's:
``param_counts``, ``shape_applicable`` and ``model_flops`` for all ten
archs; the input specs (meta tensors) against the reference's
``ShapeDtypeStruct``s, leaf by leaf; ``recurrence_addendum``; the
dry-run record of a reduced config (argument bytes equal to the live
tensors' bytes, FLOPs at or above ``model_flops`` with the attention
term stated); the live-bytes tracker; the CLI and the dry-run tables."""
import dataclasses
import json

import pytest

pytest.importorskip("torch")

import torch

import repro.configs as RC
from repro.launch.roofline import model_flops as ref_model_flops
from repro.launch.specs import abstract_cache as ref_abstract_cache
from repro.launch.specs import abstract_model as ref_abstract_model
from repro.launch.specs import batch_pspecs as ref_batch_pspecs
from repro.launch.specs import batch_specs as ref_batch_specs
from repro.launch.specs import input_specs as ref_input_specs
from repro.sharding.rules import make_rules as ref_make_rules
import repro_torch.configs as TC
from repro_torch.launch import dryrun, dryrun_lib, report, roofline
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import (abstract_cache, abstract_model,
                                      batch_pspecs, batch_specs,
                                      input_specs)
from repro_torch.models import (cache_specs, init_params, model_specs,
                                trainable, zeros_from_specs)
from repro_torch.models.params import get_path, reference_groups, \
    tree_leaves
from repro_torch.optim import opt_init
from repro_torch.sharding import make_rules


def _sd(x):
    """(shape, dtype name) of a meta tensor or a ShapeDtypeStruct."""
    return tuple(x.shape), str(x.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_counts_applicability_and_model_flops_equal_the_reference(arch):
    cfg, jc = TC.get_config(arch), RC.get_config(arch)
    assert cfg.param_counts() == jc.param_counts()
    assert cfg.reduced().param_counts() == jc.reduced().param_counts()
    for name in TC.SHAPES:
        s, js = TC.SHAPES[name], RC.SHAPES[name]
        assert dataclasses.asdict(s) == dataclasses.asdict(js)
        assert TC.shape_applicable(cfg, s) == RC.shape_applicable(jc, js)
        assert roofline.model_flops(cfg, s) == ref_model_flops(jc, js)


def _tree_equal(cfg, port_tree, ref_tree):
    """Every leaf of the port's per-layer tree has the reference's leaf's
    shape (a stacked unit leaf with the repeats first) and dtype."""
    n = 0
    for path, port_paths, stacked in reference_groups(cfg, port_tree):
        want = _sd(get_path(ref_tree, path))
        for q in port_paths:
            shape, dt = _sd(get_path(port_tree, q))
            assert ((len(port_paths),) if stacked else ()) + shape == \
                want[0] and dt == want[1], (path, q)
            n += 1
    assert n == len(tree_leaves(port_tree))


@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_input_specs_equal_the_references_shape_dtype_structs(arch):
    """batch_specs, batch_pspecs (16x16), input_specs, abstract_cache at
    every applicable shape and abstract_model (param_dtype) on meta
    tensors: shapes and dtypes of the reference's ShapeDtypeStructs."""
    cfg, jc = TC.get_config(arch), RC.get_config(arch)
    model = abstract_model(cfg)
    assert all(t.device.type == "meta" for t in tree_leaves(model))
    _tree_equal(cfg, model, ref_abstract_model(jc))
    mesh = make_production_mesh()
    for name in TC.SHAPES:
        s, js = TC.SHAPES[name], RC.SHAPES[name]
        if not TC.shape_applicable(cfg, s):
            continue
        got, want = batch_specs(cfg, s), ref_batch_specs(jc, js)
        assert {k: _sd(v) for k, v in got.items()} == \
            {k: _sd(v) for k, v in want.items()}
        assert batch_pspecs(cfg, s, make_rules(cfg, s, mesh)) == {
            k: tuple(v) for k, v in ref_batch_pspecs(
                jc, js, ref_make_rules(jc, js, mesh)).items()}
        ins, jins = input_specs(cfg, s), ref_input_specs(jc, js)
        assert set(ins) == set(jins)
        if s.kind != "train":
            _tree_equal(cfg, abstract_cache(cfg, s),
                        ref_abstract_cache(jc, js))


def test_recurrence_addendum_equals_the_reference():
    from repro.launch.dryrun_lib import recurrence_addendum as ref_add
    for arch in TC.ARCH_IDS:
        for name in TC.SHAPES:
            for chips in (1, 256, 512):
                assert dryrun_lib.recurrence_addendum(
                    TC.get_config(arch), TC.SHAPES[name], chips) == ref_add(
                    RC.get_config(arch), RC.SHAPES[name], chips)


def test_shard_bytes_divides_sharded_dims_rounding_up():
    m = make_production_mesh(multi_pod=True)
    f32 = torch.float32
    assert dryrun_lib.shard_bytes((4096, 1000), f32, (("pod", "data"),
                                                      "model"), m) == \
        128 * 63 * 4
    assert dryrun_lib.shard_bytes((4096, 1000), f32, (None, None), m) == \
        4096 * 1000 * 4
    assert dryrun_lib.shard_bytes((3, 5), torch.bfloat16, ("data", None),
                                  m) == 1 * 5 * 2
    assert dryrun_lib.shard_bytes((), torch.int32, (), m) == 4


def test_tracked_bytes_count_storages_once_and_free_them():
    """The peak the accounting reads: MemTracker on fake tensors counts a
    storage once, views nothing, and frees a storage when it dies."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    mem = MemTracker()
    with FakeTensorMode():
        a = torch.empty(100, 10)                # 4000 bytes, tracked
        mem.track_external(a, a[3:])            # a view: one storage
        assert dryrun_lib.tracked_bytes(mem) == 4000
        with mem:
            b = a * 2                           # + 4000
            c = b[:50].sum()                    # + 4
            del b                               # the sum keeps no view
            d = a.view(10, 100)                 # a view: nothing
        assert (dryrun_lib.tracked_bytes(mem),
                dryrun_lib.tracked_bytes(mem, "peak")) == (4004, 8004)
        del c, d
    assert dryrun_lib.tracked_bytes(mem) == 4000


def test_kernel_standins_restore_the_wrappers():
    import repro_torch.kernels.flash_attention.ops as fa
    import repro_torch.kernels.rwkv6.ops as rw
    import repro_torch.models.attention as attn
    before = (fa._forward, attn.decode_attention, rw._forward,
              rw.WKV6.__dict__["backward"])
    tally = {}
    with dryrun_lib.kernel_standins(tally):
        assert fa._forward is not before[0]
        q = torch.zeros(2, 5, 4, 8)
        k = v = torch.zeros(2, 5, 2, 8)
        q_off = kvl = torch.zeros(2, dtype=torch.int32)
        assert fa._forward(q, k, v, q_off, kvl, True).shape == (2, 5, 4, 8)
    assert tally == {"flash_attention": 2 * 2 * 4 * 15 * 16}
    assert (fa._forward, attn.decode_attention, rw._forward,
            rw.WKV6.__dict__["backward"]) == before


def _nbytes(tree):
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


@pytest.mark.parametrize("arch", ["granite-3-2b", "jamba-1.5-large-398b",
                                  "rwkv6-1.6b"])
def test_state_bytes_equal_the_live_tensors(arch):
    """The spec-counted params, optimizer state, cache and batch of a
    train step and of a serving step equal the nbytes of the tensors the
    port makes for them (one device)."""
    # the trainer's float32 masters, whatever param_dtype says (jamba's
    # is the reference's bf16)
    cfg = TC.get_config(arch).reduced()
    cfg = dataclasses.replace(cfg, optimizer="adafactor",
                              opt_state_dtype="bfloat16")
    gen = torch.Generator().manual_seed(0)
    rules = make_rules(cfg, None, None)
    params = trainable(init_params(model_specs(cfg), gen, "cpu"))
    st = dryrun_lib.state_bytes(cfg, "train", 4, 16, rules)
    assert st["params"] == _nbytes(params)
    assert st["opt_state"] == _nbytes(opt_init(cfg, params))
    assert st["batch"] == 3 * 4 * 16 * 4
    served = init_params(model_specs(cfg), gen, "cpu", torch.bfloat16)
    st = dryrun_lib.state_bytes(cfg, "decode", 4, 1, rules, cache_len=32)
    assert st["params"] == _nbytes(served)
    assert st["cache"] == _nbytes(zeros_from_specs(cache_specs(cfg, 4, 32),
                                                   "cpu"))
    assert st["opt_state"] == 0


def test_reduced_record_exact_bytes_and_flops_above_model_flops():
    """A reduced granite train_4k record on one card: argument bytes are
    the live tensors' (params and AdamW state at float32, the batch);
    FLOPs are at or above model_flops, the flash kernel's term stated as
    its closed form; what XLA would give is named as not counted."""
    red = lambda c: dataclasses.replace(c.reduced(), grad_accum=4)
    rec = dryrun_lib.run_cell("granite-3-2b", "train_4k", mesh="none",
                              cfg_edit=red, moe_impl="dense")
    assert rec["status"] == "ok", rec.get("traceback")
    cfg = red(TC.get_config("granite-3-2b"))
    params = trainable(init_params(model_specs(cfg),
                                   torch.Generator().manual_seed(0), "cpu"))
    mem = rec["memory"]
    assert mem["params_bytes"] == _nbytes(params)
    assert mem["opt_state_bytes"] == _nbytes(opt_init(cfg, params))
    assert mem["batch_bytes"] == 3 * 256 * 4096 * 4
    assert mem["argument_bytes"] == (mem["params_bytes"]
                                     + mem["opt_state_bytes"]
                                     + mem["batch_bytes"])
    assert mem["peak_bytes_est"] > mem["argument_bytes"]
    assert rec["chips"] == 1 and rec["accum_scale"] == 4
    assert rec["collective_bytes_per_device"] is None
    assert any("cost_analysis" in s for s in rec["not_counted"])
    shape = TC.SHAPES["train_4k"]
    mf = roofline.model_flops(cfg, shape)
    assert rec["model_flops_global"] == mf
    assert rec["flops_per_device"] >= mf
    assert 0 < rec["useful_flops_ratio"] <= 1
    S, B = shape.seq_len, shape.global_batch
    assert rec["kernel_flops_global"] == {"flash_attention": float(
        cfg.num_layers * 2 * B * cfg.num_heads * (S * (S + 1) // 2)
        * 2 * cfg.head_dim)}
    assert rec["roofline"]["collective_s"] == 0.0


def test_reduced_records_on_the_meshes_and_the_recurrences():
    """rwkv6 reduced at decode_32k and long_500k: per-device cache bytes
    shrink with the mesh's kv_seq split, the recurrence is stood in for
    and its closed form stated; a skipped cell says why."""
    red = lambda c: c.reduced()
    recs = {m: dryrun_lib.run_cell("rwkv6-1.6b", "decode_32k", mesh=m,
                                   cfg_edit=red)
            for m in ("none", "16x16")}
    for r in recs.values():
        assert r["status"] == "ok", r.get("traceback")
        assert r["recurrence_addendum"]["flops"] > 0 and r["recurrences"]
    assert recs["16x16"]["chips"] == 256
    assert recs["16x16"]["memory"]["argument_bytes"] < \
        recs["none"]["memory"]["argument_bytes"]
    assert recs["16x16"]["flops_per_device"] < recs["none"][
        "flops_per_device"]
    skip = dryrun_lib.run_cell("granite-3-2b", "long_500k", mesh="none")
    assert skip["status"] == "skipped"


def test_dryrun_cli_writes_a_record_and_the_tables_render(tmp_path,
                                                          capsys):
    """One full-width cell through the CLI (--mesh none); the record's
    file name and keys; report's dry-run and roofline tables on it."""
    rc = dryrun.main(["--arch", "granite-3-2b", "--shape", "decode_32k",
                      "--mesh", "none", "--out", str(tmp_path)])
    assert rc == 0
    path = tmp_path / "granite-3-2b__decode_32k__none.json"
    rec = json.loads(path.read_text())
    assert rec["status"] == "ok" and rec["mesh"] == "none"
    cache = 40 * 2 * 128 * 32768 * 8 * 64 * 2
    assert rec["memory"]["cache_bytes"] == cache
    assert rec["memory"]["fits_80gb"] is False      # 85.9 GB of cache
    assert "-> " in capsys.readouterr().out
    recs = report.load_records(str(tmp_path))
    table = report.dryrun_table(recs).splitlines()
    assert "fits 80G" in table[0]
    assert table[-1].startswith("| granite-3-2b | decode_32k | none | ok")
    assert "| NO | — | — |" in table[-1]
    roof = report.roofline_table(recs, "none").splitlines()
    assert len(roof) == 3 and "| memory |" in roof[-1]
