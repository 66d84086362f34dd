"""The port's alpha-beta calibration (``core/calibrate.py``) against the
JAX package's: the fit recovers planted constants, clamps, leaves
unsampled links at the seed constants and round-trips through its file,
as ``tests/test_autotune.py`` holds the reference; the samples, fits and
files equal the reference's on the same records; ``simulate_pattern``
with ``cm="calibrated"`` prices as the reference's with and without a
calibration file (tests/test_torch_ir.py)."""
import dataclasses
import json

import pytest

pytest.importorskip("torch")

from repro.core import calibrate as ref_cal
from repro.core.throttle import CostModel as RefCostModel
from repro_torch.core import calibrate as cal
from repro_torch.core.calibrate import (calibrated_cost_model,
                                        fit_cost_model, fit_link,
                                        load_calibration, save_calibration,
                                        samples_from_records,
                                        synthetic_records)
from repro_torch.core.throttle import CostModel


def test_calibration_recovers_planted_constants():
    """Fitting on synthetic timings generated from KNOWN constants
    recovers every alpha-beta within 5%."""
    planted = CostModel(put_base=3.3, put_per_kb=0.07,
                        inter_base=11.0, inter_per_kb=0.41)
    cm, fits = fit_cost_model(synthetic_records(planted))
    for field in ("put_base", "put_per_kb", "inter_base", "inter_per_kb"):
        want, got = getattr(planted, field), getattr(cm, field)
        assert abs(got - want) / want < 0.05, (field, want, got)
    assert set(fits) == {"intra", "inter"}
    for fit in fits.values():
        assert fit.residual < 1e-6 and fit.nsamples == 5


def test_fit_clamps_negative_constants():
    fit = fit_link([(1024.0, 0.1), (4096.0, 2.0)], "intra")
    assert fit.alpha == 0.0 and fit.beta > 0.0
    solo = fit_link([(2048.0, 5.0)], "inter")
    assert solo.alpha == 5.0 and solo.beta == 0.0
    with pytest.raises(ValueError, match="no samples"):
        fit_link([], "intra")
    with pytest.raises(ValueError, match="unknown link"):
        fit_cost_model([("nvlink", 1024.0, 1.0)])


def test_fit_untouched_links_keep_seed_constants():
    cm, fits = fit_cost_model([("intra", 1024.0, 7.0)])
    assert set(fits) == {"intra"}
    seed = CostModel()
    assert cm.inter_base == seed.inter_base
    assert cm.inter_per_kb == seed.inter_per_kb
    assert cm.put_base == 7.0 and cm.put_per_kb == 0.0


def test_calibration_save_load_roundtrip(tmp_path):
    path = str(tmp_path / "calibration.json")
    planted = CostModel(put_base=2.5, inter_per_kb=0.5)
    cm, fits = fit_cost_model(synthetic_records(planted))
    save_calibration(path, cm, fits, {"source": "test"})
    assert calibrated_cost_model(path) == cm
    rec = load_calibration(path)
    assert rec["meta"]["source"] == "test"
    assert set(rec["fits"]) == {"intra", "inter"}
    missing = str(tmp_path / "nope.json")
    assert calibrated_cost_model(missing) == CostModel()
    assert load_calibration(missing) is None


def _records(cm):
    """Noise-free worker records, single- and two-node, at two sizes."""
    recs = []
    for nbytes in (1024.0, 8192.0):
        stats = dict(puts_per_epoch=4.0, bytes_per_epoch=4 * nbytes,
                     epochs=2, inter_puts=0)
        recs.append(dict(name="sn", ranks_per_node=None, stats=stats,
                         us_per_iter=4 * cm.t_put("intra", nbytes)))
        mstats = dict(stats, inter_puts=4)
        recs.append(dict(name="mn", ranks_per_node=2, stats=mstats,
                         us_per_iter=2 * cm.t_put("intra", nbytes)
                         + 2 * cm.t_put("inter", nbytes)))
    recs.append(dict(name="x", ranks_per_node=None, us_per_iter=5.0,
                     stats=dict(puts_per_epoch=0.0, bytes_per_epoch=0.0)))
    return recs


def test_samples_from_records_two_stage_attribution():
    cm = CostModel()
    samples = samples_from_records(_records(cm))
    by_link = {}
    for link, nbytes, t in samples:
        by_link.setdefault(link, []).append((nbytes, t))
    assert len(by_link["intra"]) == 2 and len(by_link["inter"]) == 2
    for nbytes, t in by_link["inter"]:
        assert t == pytest.approx(cm.t_put("inter", nbytes), rel=1e-9)
    fitted, _ = fit_cost_model(samples)
    assert fitted.inter_base == pytest.approx(cm.inter_base, rel=0.05)
    assert fitted.inter_per_kb == pytest.approx(cm.inter_per_kb, rel=0.05)


def test_samples_fits_and_files_equal_the_reference(tmp_path):
    planted = dict(put_base=3.3, put_per_kb=0.07, inter_base=11.0,
                   inter_per_kb=0.41)
    recs = _records(CostModel(**planted))
    assert samples_from_records(recs) == ref_cal.samples_from_records(
        _records(RefCostModel(**planted)))
    assert synthetic_records(CostModel(**planted)) == \
        ref_cal.synthetic_records(RefCostModel(**planted))
    for samples in (synthetic_records(CostModel(**planted)),
                    samples_from_records(recs),
                    [("intra", 1024.0, 0.1), ("intra", 4096.0, 2.0)]):
        cm, fits = fit_cost_model(samples)
        rcm, rfits = ref_cal.fit_cost_model(samples)
        assert dataclasses.asdict(cm) == dataclasses.asdict(rcm)
        assert {k: dataclasses.asdict(v) for k, v in fits.items()} == \
            {k: dataclasses.asdict(v) for k, v in rfits.items()}
    ours, theirs = tmp_path / "ours.json", tmp_path / "theirs.json"
    assert cal.main(["--synthetic", "--out", str(ours)]) == 0
    assert ref_cal.main(["--synthetic", "--out", str(theirs)]) == 0
    assert json.loads(ours.read_text()) == json.loads(theirs.read_text())


def test_measuring_needs_a_torch_worker_and_says_so(tmp_path):
    """The reference measures by running its JAX benchmark worker; the
    port has none yet, so measuring raises and names it."""
    with pytest.raises(NotImplementedError, match="faces_worker"):
        cal.measure_records()
    with pytest.raises(NotImplementedError, match="worker"):
        cal.main(["--out", str(tmp_path / "c.json")])
    assert not (tmp_path / "c.json").exists()
