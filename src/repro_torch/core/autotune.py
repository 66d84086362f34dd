"""Simulator-guided schedule autotuner with a tuned-config cache.

The schedule's mechanisms make a real configuration space — nstreams x
double_buffer x throttle R x node_aware x pack x chunk_bytes x
multicast x topology — and the best point varies by pattern (packing
pays on faces and hardly on ring; chunking pays on ring/broadcast but
loses on a2a, where per-chunk completion signals dominate). The cost
simulator already prices every knob from the scheduled DAG's structure.
So: enumerate a pruned candidate space per (pattern, topology, message
size), score each candidate with ``simulate_program`` over the SAME
``pattern_programs`` pipeline the executors consume, and cache the
winner.

Guarantees:

  * the caller's default configuration is ALWAYS candidate zero, so
    ``best.derived <= default_derived`` holds by construction — the
    ``tuned <= default`` benchmark invariant can never flake;
  * unbounded throttle policies ("none", "application") are NOT in the
    space: they have no slot edges, so they would trivially win every
    search while ignoring the finite-slot hardware model the paper's
    runtime actually schedules against (Fig. 13's adaptive <= static
    ordering is the structural law the tuner works within);
  * a candidate whose simulation raises scores ``inf`` and is recorded
    in ``AutotuneResult.errors`` instead of aborting the search.

The tuned cache (``results/tuned_torch.json``, override via
``REPRO_TORCH_TUNED``) is keyed by ``(pattern, grid, ranks_per_node,
size-token)``. The size token is an explicit label (e.g. ``"b4"`` for
block=4, ``"b8"`` for a serving bucket of 8 slots) rather than a hash of
build kwargs, so callers that spell the same program with different
kwarg subsets agree on the key.

Scoring config: ``ScheduleConfig`` separates schedule-time knobs
(``sched_kwargs`` — re-schedulable on an existing queue) from
BUILD-time knobs (``build_overrides`` — double_buffer ping/pong windows
and the broadcast multicast/unicast choice change the enqueued program
itself and need a rebuild). Everything downstream that accepts a
``config=`` threads both through the right stage.

This module needs no device (the device-free stream + simulator path).
It is the JAX package's ``core/autotune.py`` with two differences:

  * ``search_space`` always enumerates ``fused`` in (False, True). The
    JAX package asks its ``compat.supports_fused()``, which is True
    there; the port's fused executor runs on the CPU and on the card
    alike, so the two spaces are the same and the leaderboards equal.
  * The cache has its own path (``results/tuned_torch.json``,
    ``REPRO_TORCH_TUNED``), so the two packages never read each other's
    entries.
"""
from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass, field
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.throttle import CostModel, simulate_pipeline

DEFAULT_TUNED = os.path.join("results", "tuned_torch.json")
TUNED_ENV = "REPRO_TORCH_TUNED"


@dataclass(frozen=True)
class ScheduleConfig:
    """One point of the schedule configuration space.

    ``multicast=None`` means "builder default" (only the broadcast
    builder consumes the knob at all); ``double_buffer`` and
    ``multicast`` are build-time — they are excluded from
    ``sched_kwargs()`` and surfaced via ``build_overrides()``.

    ``fused`` selects the device-resident progress engine (segment
    planner + fused per-segment emission; the simulator charges host
    dispatch per segment). Tuned-cache entries persisted before the
    knob existed simply lack the key and default to False through
    :meth:`from_dict` — no cache migration needed.
    """
    throttle: str = "adaptive"
    resources: int = 16
    merged: bool = True
    ordered: bool = False
    nstreams: int = 1
    double_buffer: bool = False
    node_aware: bool = False
    coalesce: bool = False
    pack: bool = False
    chunk_bytes: int = 0
    multicast: Optional[bool] = None
    fused: bool = False

    def sched_kwargs(self) -> dict:
        """The schedule-pass knobs (STStream.scheduled_programs kwargs)."""
        return dict(throttle=self.throttle, resources=self.resources,
                    merged=self.merged, ordered=self.ordered,
                    nstreams=self.nstreams, node_aware=self.node_aware,
                    coalesce=self.coalesce, pack=self.pack,
                    chunk_bytes=self.chunk_bytes, fused=self.fused)

    def build_overrides(self) -> dict:
        """The build-time knobs (require re-enqueueing the program)."""
        kw = dict(double_buffer=self.double_buffer)
        if self.multicast is not None:
            kw["multicast"] = self.multicast
        return kw

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ScheduleConfig":
        allowed = {f for f in cls.__dataclass_fields__}
        unknown = set(d) - allowed
        if unknown:
            raise ValueError(
                f"ScheduleConfig: unknown field(s) {sorted(unknown)}")
        return cls(**d)

    def label(self) -> str:
        """Compact human-readable tag for leaderboards."""
        bits = [self.throttle[:2], f"R{self.resources}",
                f"s{self.nstreams}"]
        if self.double_buffer:
            bits.append("db")
        if self.node_aware:
            bits.append("na")
        if self.pack:
            bits.append("pack")
        if self.chunk_bytes:
            bits.append(f"c{self.chunk_bytes}")
        if self.multicast is not None:
            bits.append("mc" if self.multicast else "uni")
        if self.fused:
            bits.append("fused")
        return "+".join(bits)


def search_space(pattern: str, ranks_per_node: Optional[int] = None, *,
                 max_resources: int = 16,
                 full: bool = False) -> List[ScheduleConfig]:
    """The pruned candidate enumeration for one (pattern, topology).

    Pruning rules (each cuts points that are no-ops or nonsensical):

      * throttle in {adaptive, static} only — "none"/"application" are
        unbounded and would trivially win (see module docstring);
      * double_buffer only with nstreams > 1 (ping/pong windows exist
        to make alternating epochs conflict-free ACROSS streams; on one
        stream the rebuild buys nothing);
      * node_aware / pack / chunk_bytes only with a node mapping — on a
        single node every put is intra and all three passes are no-ops;
      * multicast only enumerated for the broadcast pattern (the only
        builder with the knob); elsewhere it stays None;
      * coalesce stays off — pack materializes the same aggregation as
        real descriptors, which both executors honor;
      * fused (the device-resident progress engine) is always
        enumerated: the port's fused executor runs everywhere.
    """
    fuseds = (False, True)
    throttles = ("adaptive", "static")
    res = tuple(r for r in ((4, 8, 16) if full else (8, 16))
                if r <= max_resources) or (max_resources,)
    streams = (1, 2, 3) if full else (1, 2)
    chunks = ((0, 512, 1024, 4096) if full else (0, 1024)) \
        if ranks_per_node else (0,)
    bools = (False, True) if ranks_per_node else (False,)
    mcasts = (True, False) if pattern == "broadcast" else (None,)
    out: List[ScheduleConfig] = []
    for throttle in throttles:
        for r in res:
            for ns in streams:
                for db in ((False, True) if ns > 1 else (False,)):
                    for na in bools:
                        for pk in bools:
                            for cb in chunks:
                                for mc in mcasts:
                                    for fu in fuseds:
                                        out.append(ScheduleConfig(
                                            throttle=throttle, resources=r,
                                            nstreams=ns, double_buffer=db,
                                            node_aware=na, pack=pk,
                                            chunk_bytes=cb, multicast=mc,
                                            fused=fu))
    return out


@dataclass
class AutotuneResult:
    """Search outcome: winner + ranked leaderboard + diagnostics."""
    pattern: str
    grid: Tuple[int, ...]
    ranks_per_node: Optional[int]
    size: Optional[str]
    best: ScheduleConfig
    best_derived: float
    default_config: ScheduleConfig
    default_derived: float
    leaderboard: List[Tuple[ScheduleConfig, float]]
    evaluated: int = 0
    errors: List[Tuple[ScheduleConfig, str]] = field(default_factory=list)

    @property
    def improvement(self) -> float:
        """Fractional win of tuned over default (0.0 = tie)."""
        if self.default_derived <= 0:
            return 0.0
        return 1.0 - self.best_derived / self.default_derived

    def to_dict(self, top: int = 10) -> dict:
        return {
            "pattern": self.pattern, "grid": list(self.grid),
            "ranks_per_node": self.ranks_per_node, "size": self.size,
            "best": self.best.to_dict(), "best_derived": self.best_derived,
            "default": self.default_config.to_dict(),
            "default_derived": self.default_derived,
            "improvement": self.improvement, "evaluated": self.evaluated,
            "leaderboard": [{"config": c.to_dict(), "label": c.label(),
                             "derived": d}
                            for c, d in self.leaderboard[:top]],
            "errors": [{"config": c.to_dict(), "error": e}
                       for c, e in self.errors],
        }


def score_config(pattern: str, cfg: ScheduleConfig, niter: int, *,
                 grid=None, ranks_per_node: Optional[int] = None,
                 cm: Optional[CostModel] = None, **build_kw) -> float:
    """Derived per-iteration latency of one candidate — the identical
    ``pattern_programs`` pipeline the executors consume, priced by the
    simulator."""
    from repro_torch.core.patterns import pattern_programs

    kw = dict(build_kw)
    kw.update(cfg.build_overrides())
    db = kw.pop("double_buffer", False)
    progs = pattern_programs(pattern, niter, grid=grid,
                             ranks_per_node=ranks_per_node,
                             double_buffer=db, **cfg.sched_kwargs(), **kw)
    return simulate_pipeline(progs, cm) / max(niter, 1)


def autotune(pattern: str, niter: int = 2, *, grid=None,
             ranks_per_node: Optional[int] = None,
             cm: Optional[CostModel] = None,
             default: Optional[ScheduleConfig] = None,
             candidates: Optional[Sequence[ScheduleConfig]] = None,
             full: bool = False, max_resources: int = 16,
             size: Optional[str] = None, **build_kw) -> AutotuneResult:
    """Search the (pruned) schedule space for one (pattern, topology,
    size) point and return the winner plus the ranked leaderboard.

    The ``default`` config (seed defaults when omitted) is always
    scored as candidate zero, so ``best_derived <= default_derived``
    holds by construction. ``candidates`` overrides the enumerated
    space (hillclimb-style callers); ``full`` switches to the
    untruncated enumeration.
    """
    from repro_torch.core.patterns import get_pattern

    grid = tuple(grid) if grid is not None \
        else get_pattern(pattern).default_grid
    default = default or ScheduleConfig()
    space = list(candidates) if candidates is not None else search_space(
        pattern, ranks_per_node, max_resources=max_resources, full=full)
    seen = {default}
    ordered = [default] + [c for c in space
                           if not (c in seen or seen.add(c))]

    scored: List[Tuple[ScheduleConfig, float]] = []
    errors: List[Tuple[ScheduleConfig, str]] = []
    for cfg in ordered:
        try:
            derived = score_config(pattern, cfg, niter, grid=grid,
                                   ranks_per_node=ranks_per_node, cm=cm,
                                   **build_kw)
        except Exception as e:          # noqa: BLE001 — record, keep going
            errors.append((cfg, f"{type(e).__name__}: {e}"))
            derived = float("inf")
        scored.append((cfg, derived))
    default_derived = scored[0][1]
    leaderboard = sorted(scored, key=lambda cd: cd[1])
    best, best_derived = leaderboard[0]
    return AutotuneResult(pattern=pattern, grid=grid,
                          ranks_per_node=ranks_per_node, size=size,
                          best=best, best_derived=best_derived,
                          default_config=default,
                          default_derived=default_derived,
                          leaderboard=leaderboard, evaluated=len(scored),
                          errors=errors)


# ---------------------------------------------------------------------------
# tuned-config cache: results/tuned_torch.json
# ---------------------------------------------------------------------------

def slot_bucket(active: int, cap: int = 0) -> int:
    """Power-of-two slot bucket for schedule-cache keying: the serving
    engine builds one scheduled program per bucket (size token
    ``f"b{bucket}"``) so ragged decode batches reuse cached schedules
    instead of compiling per active-slot count. ``cap`` clamps to the
    engine's slot capacity (0 = uncapped)."""
    if active < 1:
        raise ValueError(f"slot_bucket: active must be >= 1, got {active}")
    b = 1
    while b < active:
        b *= 2
    return min(b, cap) if cap else b


def tuned_key(pattern: str, grid, ranks_per_node: Optional[int],
              size: Optional[str] = None) -> str:
    """Cache key of one (pattern, topology, message size) point. The
    size token is an explicit caller-chosen label (``"b4"``) so callers
    spelling the same program with different kwarg subsets agree."""
    g = "x".join(str(int(x)) for x in (grid or ()))
    return f"{pattern}|{g}|rpn{int(ranks_per_node or 0)}|{size or '-'}"


def tuned_path(path: Optional[str] = None) -> str:
    return path or os.environ.get(TUNED_ENV) or DEFAULT_TUNED


def load_tuned(path: Optional[str] = None) -> dict:
    p = tuned_path(path)
    if not os.path.exists(p):
        return {}
    with open(p) as f:
        return json.load(f)


def save_tuned(cache: dict, path: Optional[str] = None) -> str:
    p = tuned_path(path)
    d = os.path.dirname(os.path.abspath(p))
    os.makedirs(d, exist_ok=True)
    with open(p, "w") as f:
        json.dump(cache, f, indent=1, sort_keys=True)
    return p


def tuned_record(result: AutotuneResult) -> dict:
    """The cache entry one search result serializes to."""
    return {"config": result.best.to_dict(),
            "derived": result.best_derived,
            "default_derived": result.default_derived,
            "improvement": result.improvement,
            "evaluated": result.evaluated}


def tuned_config(pattern: str, *, grid=None,
                 ranks_per_node: Optional[int] = None,
                 size: Optional[str] = None, path: Optional[str] = None,
                 cm: Optional[CostModel] = None, niter: int = 2,
                 autotune_missing: bool = True, save: bool = True,
                 full: bool = False, **build_kw) -> ScheduleConfig:
    """The cached tuned config for one (pattern, topology, size) point,
    searching (and persisting the winner) on a cache miss."""
    from repro_torch.core.patterns import get_pattern

    grid = tuple(grid) if grid is not None \
        else get_pattern(pattern).default_grid
    key = tuned_key(pattern, grid, ranks_per_node, size)
    cache = load_tuned(path)
    hit = cache.get(key)
    if hit is not None:
        return ScheduleConfig.from_dict(hit["config"])
    if not autotune_missing:
        raise KeyError(
            f"no tuned config for {key!r} in {tuned_path(path)!r} "
            "(autotune_missing=False)")
    # plain-name call: resolves through module globals, so tests can
    # monkeypatch `autotune` and observe cache hits skipping the search
    result = autotune(pattern, niter, grid=grid,
                      ranks_per_node=ranks_per_node, cm=cm, full=full,
                      size=size, **build_kw)
    if save:
        cache = load_tuned(path)        # re-read: another point may have
        cache[key] = tuned_record(result)  # landed while we searched
        save_tuned(cache, path)
    return result.best


def resolve_config(config, pattern: str, *, grid=None,
                   ranks_per_node: Optional[int] = None,
                   size: Optional[str] = None, path: Optional[str] = None,
                   cm: Optional[CostModel] = None,
                   **build_kw) -> Optional[ScheduleConfig]:
    """Normalize a ``config=`` argument: None passes through (caller
    keeps its explicit kwargs), a :class:`ScheduleConfig` or dict is
    used as-is, and ``"auto"`` consults the tuned cache (searching on a
    miss)."""
    if config is None:
        return None
    if isinstance(config, ScheduleConfig):
        return config
    if isinstance(config, dict):
        return ScheduleConfig.from_dict(config)
    if config == "auto":
        return tuned_config(pattern, grid=grid,
                            ranks_per_node=ranks_per_node, size=size,
                            path=path, cm=cm, **build_kw)
    raise TypeError(
        f"config must be None, 'auto', a ScheduleConfig, or a dict; "
        f"got {config!r}")


__all__ = [
    "ScheduleConfig", "AutotuneResult", "search_space", "score_config",
    "autotune", "slot_bucket",
    "tuned_key", "tuned_path", "load_tuned", "save_tuned",
    "tuned_record", "tuned_config", "resolve_config",
]
