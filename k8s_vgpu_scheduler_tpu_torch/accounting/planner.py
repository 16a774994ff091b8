"""Capacity planning over the demand forecasts (the port's copy of the JAX
package's ``accounting/planner.py``).

Three faces, all fed by :mod:`forecast`:

- the **live assessment** behind ``GET /capacityz`` / ``vgpu-report``:
  :class:`CapacityTracker` samples per-queue demand on a tick and
  :func:`assess` turns the forecasts into the operator-facing answers —
  starvation ETA per queue, a fleet scale recommendation, and
  forecast-vs-actual drift.  This path is *analytic* (forecast demand
  compared against each queue's admissible capacity); the replay-backed
  what-if planner is the simulator's ``capacity`` section
  (``cmd/simulate.py``), where the same arrival processes run through the
  real admission loop;
- **arrival synthesis**: the named arrival patterns (bursty, diurnal,
  flash-crowd; ``examples/vgpu-capacity-scenarios.json`` holds full
  scenarios on them) are generated here so the simulator and the tests
  share one deterministic definition;
- **trace capture**: :func:`scenario_from_capacityz` converts a live
  scheduler's ``/capacityz`` export (which carries each queue's recent
  demand series) into a replayable capacity-scenario workload.

Every function here is deterministic and clock-free: time comes in as
arguments, randomness does not exist (integerization of fractional
arrival rates uses error diffusion, not sampling).  Arrival entries are
written in the port's workload names (``gpu``, ``gpumem``, ``gpucores``).
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional

from .forecast import DemandForecaster, ForecastConfig

#: Hard cap on forecast buckets one assessment may compute: /capacityz
#: takes ``?horizon=`` from unauthenticated HTTP, and an unbounded value
#: would size O(horizon) allocations per queue per request.  1440
#: buckets = a full day at the 60s default.
MAX_HORIZON_BUCKETS = 1440

#: /capacityz JSON field ↔ Prometheus metric, the single source of truth
#: the exporter, the dashboard's "Capacity" row and the consistency tests
#: all read.  Per-queue fields live on each row of ``doc["queues"]``
#: (metric labeled ``{queue=...}``); fleet fields on the doc root.
CAPACITY_FIELD_METRICS: Dict[str, str] = {
    # per-queue row fields
    "demand_chips": "vtpu_capacity_queue_demand_chips",
    "forecast_demand_chips": "vtpu_capacity_forecast_demand_chips",
    "forecast_upper_chips": "vtpu_capacity_forecast_upper_chips",
    "starvation_eta_s": "vtpu_capacity_queue_starvation_eta_seconds",
    "forecast_error_ratio": "vtpu_capacity_forecast_error_ratio",
    # doc-root fields
    "nodes_current": "vtpu_capacity_nodes_current",
    "nodes_recommended": "vtpu_capacity_nodes_recommended",
}
#: The doc-root subset of CAPACITY_FIELD_METRICS.
CAPACITY_ROOT_FIELDS = ("nodes_current", "nodes_recommended")


class CapacityTracker:
    """Live per-queue demand forecasting for the scheduler process.

    ``observe_queues`` is called on a tick (vgpu-scheduler's capacity
    thread; the simulator and tests drive it on their own clocks) with
    one demand sample per queue: cards the tenant wants *right now* —
    held (admitted, placed) plus pending (queued, unplaced requests).
    """

    def __init__(self, cfg: Optional[ForecastConfig] = None,
                 starve_after_s: float = 300.0,
                 retention_s: float = 7200.0) -> None:
        self.cfg = cfg or ForecastConfig()
        self.starve_after_s = starve_after_s
        #: A key absent from the samples for this long is dropped
        #: entirely (forecaster, gauges, /capacityz row).  Governed
        #: queues appear in every sample (quota stats list all
        #: configured queues), so this only retires churned ungoverned
        #: namespaces — without it, per-namespace sampling would grow
        #: one forecaster and one metric row per namespace EVER seen.
        self.retention_s = retention_s
        self._last_seen: Dict[str, float] = {}
        self.demand = DemandForecaster(self.cfg)
        #: Last observed per-queue sample (doc's ``demand_chips``).
        self.last: Dict[str, float] = {}
        self.last_observed_at: Optional[float] = None
        #: Serializes forecaster mutation/reads: the sampling thread,
        #: every /capacityz request and every Prometheus scrape all
        #: reach the same SeriesForecaster objects, and observe()'s
        #: bucket-close loop is a multi-step read-modify-write.
        self.lock = threading.Lock()

    def observe_queues(self, samples: Dict[str, float],
                       now: float) -> None:
        with self.lock:
            for key, chips in samples.items():
                self.demand.observe(key, now, float(chips))
                self._last_seen[key] = now
            # A queue that stopped appearing still has a forecaster;
            # feed it zero so its demand decays instead of freezing at
            # the last nonzero sample — until the retention horizon,
            # after which the key is retired outright.
            for key in self.demand.keys():
                if key in samples:
                    continue
                if now - self._last_seen.get(key, now) > self.retention_s:
                    self.demand.series.pop(key, None)
                    self._last_seen.pop(key, None)
                else:
                    self.demand.observe(key, now, 0.0)
            self.last = dict(samples)
            self.last_observed_at = now


def _starvation_eta(points, demand_now: float, admissible_chips: float,
                    starve_after_s: float = 0.0) -> Optional[float]:
    """Seconds until the queue STARVES: demand's UPPER band crossing
    what the queue can admit (conservative: pages early, not late),
    plus ``starve_after_s`` — a pod only counts as starving once it has
    waited that long unplaced, so the ETA is crossing + wait threshold
    (the same definition the simulator replays measure).  0 when
    current demand already exceeds admissible (pods may have been
    waiting for an unknown time already); None when the horizon stays
    clear."""
    if demand_now > admissible_chips:
        return 0.0
    for p in points:
        if p.upper > admissible_chips:
            return p.at_s + starve_after_s
    return None


def assess(tracker: CapacityTracker, *, fleet_chips: int,
           free_chips: int, chips_per_node: int, nodes_current: int,
           queue_rows: List[dict], now: float,
           horizon_s: Optional[float] = None,
           detail: bool = True) -> dict:
    """The ``/capacityz`` document.  ``queue_rows`` carry each queue's
    entitlement ({"queue", "nominal_chips", "borrow_limit_chips"});
    rows for keys the tracker has observed but quota no longer governs
    (or ungoverned per-namespace keys) default to fleet-wide
    admissibility.  ``detail=False`` omits the per-bucket forecast
    curve and history series from the rows — the metrics collector
    reads only the scalars, and building the full curves per scrape
    (while holding the tracker lock) would be waste."""
    cfg = tracker.cfg
    horizon = float(horizon_s) if horizon_s else \
        cfg.bucket_s * max(1, cfg.season_buckets)
    # Clamped BEFORE anything sizes on it: horizon arrives from an
    # unauthenticated query parameter, and every queue allocates
    # O(n_buckets) forecast points that also serialize into the reply.
    n_buckets = max(1, min(int(math.ceil(horizon / cfg.bucket_s)),
                           MAX_HORIZON_BUCKETS))
    horizon = n_buckets * cfg.bucket_s
    ent = {r["queue"]: r for r in queue_rows}

    rows = []
    peak_upper_total = [0.0] * n_buckets
    with tracker.lock:
        keys = sorted(set(tracker.demand.keys()) | set(ent))
        for key in keys:
            row_ent = ent.get(key, {})
            nominal = int(row_ent.get("nominal_chips", 0) or 0)
            borrow = int(row_ent.get("borrow_limit_chips", 0) or 0)
            # Entitlement capped at physical capacity: a queue whose
            # quota exceeds the deployed fleet starves on HARDWARE, and
            # an uncapped admissible would keep its ETA "horizon clear"
            # while its pods already pend.  Governance is "has an
            # entitlement row", NOT nominal > 0 — a borrow-only queue
            # (zero nominal, everything borrowed) is capped at its
            # borrow limit by quota admission and must starve-forecast
            # against that, not against the whole fleet.
            admissible = min((nominal + borrow) if key in ent
                             else fleet_chips, fleet_chips)
            points = tracker.demand.forecast(key, n_buckets)
            series = tracker.demand.series.get(key)
            demand_now = float(tracker.last.get(key, 0.0))
            eta = _starvation_eta(points, demand_now, admissible,
                                  tracker.starve_after_s)
            rows.append({
                "queue": key,
                "demand_chips": round(demand_now, 3),
                "admissible_chips": admissible,
                "nominal_chips": nominal,
                "forecast_demand_chips": round(points[-1].mean, 3),
                "forecast_upper_chips": round(points[-1].upper, 3),
                "starvation_eta_s": (round(eta, 3)
                                     if eta is not None else None),
                "forecast_error_ratio": (
                    round(series.error_ratio(), 4)
                    if series is not None
                    and series.error_ratio() is not None else None),
            })
            if detail:
                rows[-1]["forecast"] = [p.as_dict() for p in points]
                rows[-1]["series"] = (series.history_rows()
                                      if series is not None else [])
            for i, p in enumerate(points):
                peak_upper_total[i] += p.upper

    peak = max(peak_upper_total) if peak_upper_total else 0.0
    cpn = max(1, int(chips_per_node))
    nodes_recommended = max(1, int(math.ceil(peak / cpn))) \
        if peak > 0 else max(1, nodes_current)
    return {
        "generated_at": round(now, 3),
        "bucket_s": cfg.bucket_s,
        "horizon_s": horizon,
        "starve_after_s": tracker.starve_after_s,
        "fleet": {"nodes": nodes_current, "chips": fleet_chips,
                  "free_chips": free_chips, "chips_per_node": cpn},
        "nodes_current": nodes_current,
        "nodes_recommended": nodes_recommended,
        "nodes_to_add": max(0, nodes_recommended - nodes_current),
        "peak_forecast_demand_chips": round(peak, 3),
        "queues": rows,
        # The live answers are analytic (forecast vs admissible cards);
        # replay-verified answers come from vgpu-simulate's capacity
        # section.
        "method": "analytic",
    }


# -- named arrival patterns ----------------------------------------------------

#: Baseline parameter sets; a scenario spec overrides any of them.  The
#: three NAMED scenarios (fleet + queues + these patterns) are in
#: examples/vgpu-capacity-scenarios.json.
PATTERN_DEFAULTS: Dict[str, dict] = {
    "bursty": {"base_chips": 1.0, "burst_chips": 6.0,
               "period_buckets": 8, "burst_buckets": 2},
    "diurnal": {"base_chips": 1.0, "amplitude_chips": 6.0,
                "period_buckets": 24},
    "flash-crowd": {"base_chips": 1.0, "surge_chips": 10.0,
                    "surge_at_bucket": 20, "ramp_buckets": 4},
}


def synth_demand(pattern: str, params: dict, buckets: int) -> List[float]:
    """Cards of new demand arriving per bucket, for ``buckets`` buckets.
    Deterministic closed forms — no RNG anywhere in a scenario."""
    p = dict(PATTERN_DEFAULTS.get(pattern, {}))
    p.update(params or {})
    out: List[float] = []
    if pattern == "bursty":
        period = max(1, int(p["period_buckets"]))
        width = max(1, int(p["burst_buckets"]))
        for b in range(buckets):
            burst = p["burst_chips"] if (b % period) < width else 0.0
            out.append(p["base_chips"] + burst)
    elif pattern == "diurnal":
        period = max(1, int(p["period_buckets"]))
        for b in range(buckets):
            phase = 2.0 * math.pi * (b % period) / period
            out.append(p["base_chips"]
                       + p["amplitude_chips"]
                       * (1.0 - math.cos(phase)) / 2.0)
    elif pattern == "flash-crowd":
        at = int(p["surge_at_bucket"])
        ramp = max(1, int(p["ramp_buckets"]))
        for b in range(buckets):
            if b < at:
                surge = 0.0
            elif b < at + ramp:
                surge = p["surge_chips"] * (b - at + 1) / ramp
            else:
                surge = p["surge_chips"]
            out.append(p["base_chips"] + surge)
    else:
        raise ValueError(f"unknown arrival pattern {pattern!r} "
                         f"(known: {sorted(PATTERN_DEFAULTS)})")
    return out


def integerize(series: List[float], chips_per_pod: int) -> List[int]:
    """Cards-per-bucket → whole pods-per-bucket by error diffusion: the
    fractional remainder carries into the next bucket, so the cumulative
    pod count tracks the cumulative demand exactly (a plain round would
    systematically under- or over-admit a fractional rate)."""
    out: List[int] = []
    carry = 0.0
    per = max(1, int(chips_per_pod))
    for chips in series:
        carry += max(0.0, float(chips)) / per
        n = int(math.floor(carry + 1e-9))
        carry -= n
        out.append(n)
    return out


def arrival_entries(stream: dict, series: List[float],
                    bucket_s: float, t0_s: float = 0.0) -> List[dict]:
    """Per-bucket pod counts → simulator arrival entries (the
    ``_arrival_schedule`` shape of cmd/simulate.py).  Pods within a
    bucket spread evenly across it."""
    counts = integerize(series, int(stream.get("gpu", 1)))
    entries: List[dict] = []
    for b, n in enumerate(counts):
        if n <= 0:
            continue
        entries.append({
            "name": f"{stream['name']}-b{b}",
            "namespace": stream.get("namespace", "sim"),
            "gpu": int(stream.get("gpu", 1)),
            "gpumem": stream.get("gpumem"),
            "gpucores": stream.get("gpucores"),
            "count": n,
            "at_s": t0_s + b * bucket_s,
            "every_s": bucket_s / n,
            "runtime_s": float(stream.get("runtime_s", 60.0)),
        })
    # Drop None resource keys (spec_pod treats presence as declaration).
    for e in entries:
        for k in ("gpumem", "gpucores"):
            if e[k] is None:
                del e[k]
    return entries


def scenario_from_capacityz(doc: dict, *, runtime_s: float = 60.0,
                            chips_per_pod: int = 1) -> dict:
    """A live ``/capacityz`` export → replayable capacity workload spec.
    Each queue's recent demand series becomes an explicit trace stream;
    queue entitlements carry over so the replay contends the same
    quotas."""
    streams = []
    queues = []
    for row in doc.get("queues", []):
        series = row.get("series") or []
        if not series:
            continue
        t0 = series[0][0]
        streams.append({
            "name": row["queue"],
            "namespace": row["queue"],
            "gpu": chips_per_pod,
            "runtime_s": runtime_s,
            "series": [[round(t - t0, 3), v] for t, v in series],
        })
        if row.get("nominal_chips"):
            queues.append({
                "name": row["queue"],
                "namespaces": [row["queue"]],
                "cohort": "captured",
                "weight": 1,
                "quota": {"chips": int(row["nominal_chips"])},
                "borrow_limit_chips": max(
                    0, int(row.get("admissible_chips", 0))
                    - int(row["nominal_chips"])),
            })
    # Size the replay window to the CAPTURED trace: without explicit
    # bucket counts the simulator's 48+16 defaults would silently drop
    # any tail beyond 64 buckets — the newest demand, usually the ramp
    # that motivated the capture.  ~3:1 history:horizon split.
    bucket_s = float(doc.get("bucket_s", 60.0)) or 60.0
    n = max((int(math.ceil((s["series"][-1][0]) / bucket_s)) + 1
             for s in streams if s["series"]), default=0)
    horizon = max(1, n // 4)
    return {
        "capacity": {
            "source": "capacityz-snapshot",
            "captured_at": doc.get("generated_at"),
            "bucket_s": bucket_s,
            "history_buckets": max(1, n - horizon),
            "horizon_buckets": horizon,
            "streams": streams,
            "queues": queues,
        }
    }
