"""Measured alpha-beta calibration for the cost model, as the JAX
package's ``core/calibrate.py`` (numpy over the port's
:class:`~repro_torch.core.throttle.CostModel`, no device).

The seed :class:`~repro_torch.core.throttle.CostModel` constants are
paper-shaped, not measured — fine for the figures' *relative* claims,
wrong for an autotuner that has to rank configurations on THIS machine.
This module closes the loop the calibrated-model methodology of the
CPU-Free MPI co-design (arXiv:2602.15356) and Lockhart et al.'s
node-aware performance modeling (arXiv:2209.06141) prescribes: fit the
per-link alpha-beta constants from MEASURED executor timings instead of
hardcoding them.

Pipeline:

  1. ``measure_records`` would run a torch benchmark worker over the
     sweep-section message-size grid and collect its timing records. The
     port has no such worker yet (the reference's runs
     ``benchmarks/faces_worker.py``, a JAX program): it raises and names
     the missing worker, and so does ``main`` without ``--synthetic``.
  2. ``samples_from_records`` attributes each record's per-iteration
     wall-clock to its puts — a two-stage fit: single-node records
     yield intra-link ``(nbytes, t)`` samples directly; multi-node
     records subtract the intra-calibrated cost of their on-node puts
     and attribute the residual to the off-node puts (the
     predict-from-memcpy-params method: fit the cheap link first, then
     explain the expensive one with what is left).
  3. ``fit_cost_model`` least-squares ``t = alpha + beta * KB`` per
     link over the samples and returns a :class:`CostModel` whose
     fitted links replace the seed constants (links with no samples
     keep their seed values).
  4. ``save_calibration`` serializes the fitted model + fit metadata to
     ``results/calibration.json``; ``calibrated_cost_model`` loads it
     back anywhere a ``cm=`` is accepted (``simulate_pattern``) and
     silently falls back to the seed constants when no calibration
     exists — derived numbers stay reproducible on a fresh checkout.

The fit itself is exact on noise-free samples (two sizes per link fix
alpha and beta), which is what the round-trip test pins: samples
generated from planted constants recover them within 5%.
"""
from __future__ import annotations

import json
import os
import sys
from dataclasses import asdict, dataclass, replace
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.throttle import CostModel

# seed-constant field names per link class
_LINK_FIELDS = {"intra": ("put_base", "put_per_kb"),
                "inter": ("inter_base", "inter_per_kb")}

DEFAULT_CALIBRATION = os.path.join("results", "calibration.json")


@dataclass(frozen=True)
class LinkFit:
    """Least-squares alpha-beta fit of one link class."""
    link: str
    alpha: float          # per-message latency                     [us]
    beta: float           # per-KB bandwidth term                   [us/KB]
    nsamples: int
    residual: float       # RMS of (t - alpha - beta*kb) over samples


def fit_link(samples: Sequence[Tuple[float, float]],
             link: str = "intra") -> LinkFit:
    """Least-squares ``t = alpha + beta * (nbytes/1024)`` over
    ``(nbytes, t_us)`` samples. One sample pins beta=0 (pure alpha);
    negative fitted constants clamp to zero (a latency model has no
    negative terms — noise can push the intercept below zero when the
    size grid is narrow)."""
    if not samples:
        raise ValueError(f"fit_link({link!r}): no samples to fit")
    kb = np.asarray([b / 1024.0 for b, _ in samples], dtype=np.float64)
    t = np.asarray([v for _, v in samples], dtype=np.float64)
    if len(samples) == 1 or np.allclose(kb, kb[0]):
        alpha, beta = float(t.mean()), 0.0
    else:
        A = np.stack([np.ones_like(kb), kb], axis=1)
        (alpha, beta), *_ = np.linalg.lstsq(A, t, rcond=None)
    alpha, beta = max(float(alpha), 0.0), max(float(beta), 0.0)
    rms = float(np.sqrt(np.mean((t - alpha - beta * kb) ** 2)))
    return LinkFit(link, alpha, beta, len(samples), rms)


def fit_cost_model(samples: Iterable[Tuple[str, float, float]],
                   base: Optional[CostModel] = None
                   ) -> Tuple[CostModel, Dict[str, LinkFit]]:
    """Fit per-link alpha-beta constants from ``(link, nbytes, t_us)``
    samples. Links with samples replace the base model's constants;
    links without keep the seed values (a single-node machine can still
    calibrate its intra link)."""
    base = base or CostModel()
    by_link: Dict[str, List[Tuple[float, float]]] = {}
    for link, nbytes, t in samples:
        if link not in _LINK_FIELDS:
            raise ValueError(f"unknown link class {link!r}; expected one "
                             f"of {sorted(_LINK_FIELDS)}")
        by_link.setdefault(link, []).append((float(nbytes), float(t)))
    fits: Dict[str, LinkFit] = {}
    updates: Dict[str, float] = {}
    for link, pts in by_link.items():
        fit = fit_link(pts, link)
        fits[link] = fit
        a_field, b_field = _LINK_FIELDS[link]
        updates[a_field] = fit.alpha
        updates[b_field] = fit.beta
    return replace(base, **updates), fits


# ---------------------------------------------------------------------------
# measured samples: faces_worker timing records -> per-link samples
# ---------------------------------------------------------------------------

def samples_from_records(records: Iterable[dict]
                         ) -> List[Tuple[str, float, float]]:
    """Two-stage attribution of worker timing records to per-put
    ``(link, nbytes, t_us)`` samples.

    Stage one: single-node records (``ranks_per_node`` unset — every
    put intra) split their measured per-iteration wall-clock evenly
    over the epoch's puts at the epoch's mean payload size. Stage two:
    multi-node records subtract the stage-one intra model's cost for
    their on-node puts and attribute the (non-negative) residual to the
    off-node puts — the intra fit explains what it can, the inter link
    gets what is left, exactly the predict-from-memcpy-params method.
    """
    records = list(records)
    intra: List[Tuple[float, float]] = []
    multi: List[dict] = []
    for rec in records:
        s = rec.get("stats", {})
        ppe = float(s.get("puts_per_epoch", 0.0))
        if ppe <= 0:
            continue
        bpp = float(s.get("bytes_per_epoch", 0.0)) / ppe
        if not rec.get("ranks_per_node"):
            intra.append((bpp, float(rec["us_per_iter"]) / ppe))
        else:
            multi.append(rec)
    samples: List[Tuple[str, float, float]] = \
        [("intra", b, t) for b, t in intra]
    if multi:
        intra_fit = (fit_link(intra, "intra") if intra
                     else LinkFit("intra", CostModel().put_base,
                                  CostModel().put_per_kb, 0, 0.0))
        for rec in multi:
            s = rec["stats"]
            epochs = max(int(s.get("epochs", 1)), 1)
            ppe = float(s["puts_per_epoch"])
            inter_ppe = float(s.get("inter_puts", 0)) / epochs
            if inter_ppe <= 0:
                continue
            bpp = float(s.get("bytes_per_epoch", 0.0)) / ppe
            intra_cost = (ppe - inter_ppe) * (
                intra_fit.alpha + intra_fit.beta * bpp / 1024.0)
            residual = max(float(rec["us_per_iter"]) - intra_cost, 0.0)
            samples.append(("inter", bpp, residual / inter_ppe))
    return samples


def measure_records() -> List[dict]:
    """The reference runs its benchmark worker over a message-size grid
    here. The port has no torch counterpart of that worker yet
    (``benchmarks/faces_worker.py`` is a JAX program, which the port
    never runs), so this raises; its options come with the worker."""
    raise NotImplementedError(
        "measure_records needs a torch benchmark worker with "
        "benchmarks/faces_worker.py's flags and JSON records, which the "
        "port does not have yet (ROADMAP item 3); fit from records "
        "given to samples_from_records, or run main with --synthetic")


def synthetic_records(cm: Optional[CostModel] = None
                      ) -> List[Tuple[str, float, float]]:
    """Noise-free samples generated from a cost model's own t_put over
    the measurement size grid — the deterministic fallback when
    wall-clock measurement is unavailable (and the round-trip test's
    input)."""
    cm = cm or CostModel()
    sizes = (256, 1024, 4096, 16384, 65536)
    return [(link, float(b), cm.t_put(link, b))
            for link in ("intra", "inter") for b in sizes]


# ---------------------------------------------------------------------------
# serialization: results/calibration.json
# ---------------------------------------------------------------------------

def save_calibration(path: str, cm: CostModel,
                     fits: Optional[Dict[str, LinkFit]] = None,
                     meta: Optional[dict] = None) -> dict:
    """Serialize a fitted cost model (+ per-link fit diagnostics) so
    the simulator, the autotuner, the benchmarks, and the trajectory
    checker can all load the same constants."""
    rec = {"cost_model": asdict(cm),
           "fits": {k: asdict(v) for k, v in (fits or {}).items()},
           "meta": meta or {}}
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def load_calibration(path: Optional[str] = None) -> Optional[dict]:
    """The raw calibration record, or None when the file is absent."""
    path = path or DEFAULT_CALIBRATION
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def calibrated_cost_model(path: Optional[str] = None,
                          default: Optional[CostModel] = None) -> CostModel:
    """The fitted CostModel from ``results/calibration.json`` (or
    ``path``), falling back to the seed constants when no calibration
    has been run — callers can always ask for the calibrated model."""
    rec = load_calibration(path)
    if rec is None:
        return default or CostModel()
    fields = {k: float(v) for k, v in rec["cost_model"].items()}
    return CostModel(**fields)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="fit per-link alpha-beta cost-model constants from "
                    "measured executor timings")
    ap.add_argument("--out", default=DEFAULT_CALIBRATION,
                    help="calibration record to write")
    ap.add_argument("--synthetic", action="store_true",
                    help="fit from model-generated samples (the only "
                         "source until a torch benchmark worker exists)")
    args = ap.parse_args(argv)

    if not args.synthetic:
        measure_records()       # raises: no torch worker yet
    samples = synthetic_records()
    meta = {"source": "synthetic"}
    cm, fits = fit_cost_model(samples)
    save_calibration(args.out, cm, fits, meta)
    for link, fit in sorted(fits.items()):
        print(f"calibrate: {link}: alpha={fit.alpha:.3f}us "
              f"beta={fit.beta:.4f}us/KB "
              f"({fit.nsamples} samples, rms={fit.residual:.3f})")
    print(f"calibrate: wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
