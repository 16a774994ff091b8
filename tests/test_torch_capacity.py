"""The port's capacity planner (``accounting/forecast.py``'s
``DemandForecaster``, ``accounting/planner.py``, ``Scheduler.
observe_capacity``/``export_capacity``, ``GET /capacityz``, the seven
``vtpu_capacity_*`` families, ``vgpu-report``'s capacity section and
``vgpu-simulate``'s ``capacity`` section) against the JAX package's, on
the CPU, on the same inputs.

The behaviours pinned are those of the JAX package's
``tests/test_capacity.py`` and ``tests/test_forecast.py``; here each is
also held to the JAX answer.  Both schedulers run the same script under
the port's resource names (``tests/test_torch_scheduler.Side``); the JAX
simulator runs serially with its snapshot in registry order (the
``serial`` fixture of ``tests/test_torch_simulate.py``).

The name map: workload and arrival keys ``gpu``/``tpu``, ``gpumem``/
``tpumem``, ``gpucores``/``tpucores``; card ids ``-gpu-``/``-chip-``.

Both replays drain each tick's unplaced pods through their batched
``filter_many``; on every scenario here the section is also the one a
per-pod drain gives (each package's ``filter_many`` rebound to a Filter a
pod), so no joint decision differs from a sequential one.

A ``replica_loss`` what-if (the cost of losing a replica, through the
simulator's ``ha`` run of the shard layer) is replayed by both simulators
with equal answers, and its report's bytes are pinned for the card
(``chip_smoke.HA_SHA256``).
"""

import copy
import functools
import hashlib
import json
import math
import random
import urllib.error
import urllib.request
from pathlib import Path

import pytest

import chip_smoke
import k8s_vgpu_scheduler_tpu.cmd.simulate as jsim
from k8s_vgpu_scheduler_tpu.accounting import forecast as jforecast
from k8s_vgpu_scheduler_tpu.accounting import planner as jplanner
from k8s_vgpu_scheduler_tpu.cmd import vtpu_report as jreport
from k8s_vgpu_scheduler_tpu.scheduler import metrics as jcluster
from k8s_vgpu_scheduler_tpu.scheduler.routes import \
    ExtenderServer as JServer
from k8s_vgpu_scheduler_tpu_torch import accounting
from k8s_vgpu_scheduler_tpu_torch.accounting import forecast as tforecast
from k8s_vgpu_scheduler_tpu_torch.accounting import planner as tplanner
from k8s_vgpu_scheduler_tpu_torch.cmd import simulate as tsim
from k8s_vgpu_scheduler_tpu_torch.cmd import vgpu_report as treport
from k8s_vgpu_scheduler_tpu_torch.quota.queues import (
    QUEUE_ANNOTATION,
    QUEUE_STATE_ANNOTATION,
    STATE_HELD,
)
from k8s_vgpu_scheduler_tpu_torch.scheduler import metrics as tcluster
from k8s_vgpu_scheduler_tpu_torch.scheduler.routes import \
    ExtenderServer as TServer
from k8s_vgpu_scheduler_tpu_torch.util import exposition as expo
from tests.test_torch_metrics import families, jax_text, samples
from tests.test_torch_scheduler import Side, fixture
from tests.test_torch_simulate import as_port, serial  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"
KEYS = {"gpu": "tpu", "gpumem": "tpumem", "gpucores": "tpucores"}
BACK = {v: k for k, v in KEYS.items()}
QUEUES = ({"name": "tenant-a", "namespaces": ["tenant-a"],
           "quota": {"chips": 4}},)
CAPACITY_CFG = dict(capacity_bucket_s=30.0, capacity_season_buckets=1,
                    capacity_horizon_s=300.0, capacity_starve_after_s=60.0)
BUCKET = 30.0
FAMILIES = tuple(tplanner.CAPACITY_FIELD_METRICS.values())


# -- the forecasters ------------------------------------------------------------

def feed(fc, series, bucket_s=BUCKET) -> None:
    for b, v in enumerate(series):
        fc.observe(b * bucket_s, v)
    fc.observe(len(series) * bucket_s, 0.0)  # closes the last bucket


def state(fc, horizon=24) -> dict:
    return {"forecast": [p.as_dict() for p in fc.forecast(horizon)],
            "error_ratio": fc.error_ratio(),
            "history": fc.history_rows(),
            "observed": fc.buckets_observed,
            "level": fc.level, "trend": fc.trend}


def series_case(name: str) -> tuple:
    """(ForecastConfig kwargs, series) of one forecaster case."""
    if name.startswith("random"):
        rng = random.Random(int(name[-1]))
        return (dict(season_buckets=8, beta=0.3),
                [max(0.0, rng.uniform(-2.0, 8.0)) for _ in range(40)]
                + [0.0] * 10)
    if name == "constant":
        return dict(season_buckets=8), [5.0] * 60
    if name == "noisy":
        rng = random.Random(3)
        return (dict(season_buckets=1),
                [max(0.0, 4.0 + rng.gauss(0.0, 2.4)) for _ in range(80)])
    if name == "diurnal":
        return (dict(season_buckets=16, alpha=0.05, gamma=0.7, beta=0.0),
                tplanner.synth_demand("diurnal", {
                    "base_chips": 0.5, "amplitude_chips": 3.0,
                    "period_buckets": 16}, 48))
    if name == "bursty":
        return (dict(season_buckets=8, alpha=0.05, gamma=0.7, beta=0.0),
                tplanner.synth_demand("bursty", {
                    "base_chips": 0.5, "burst_chips": 2.0,
                    "period_buckets": 8, "burst_buckets": 2}, 40))
    if name == "rising":
        return (dict(season_buckets=1, alpha=0.3, beta=0.3, phi=0.9),
                [float(i) for i in range(30)])
    assert name == "short_ring"
    return dict(history_len=8), [1.0] * 40


SERIES_CASES = ("random0", "random1", "random2", "constant", "noisy",
                "diurnal", "bursty", "rising", "short_ring")


@pytest.mark.parametrize("name", SERIES_CASES)
def test_the_series_forecaster_equals_the_jax_one(name):
    """The same series into both packages' SeriesForecaster: the same
    forecast points, drift ratio, history ring and state, bit for bit;
    and the JAX property tests' bars (bands bracket the mean and are
    never negative; a constant converges; the damped trend is bounded;
    the ring is bounded)."""
    kw, series = series_case(name)
    fcs = [mod.SeriesForecaster(mod.ForecastConfig(bucket_s=BUCKET, **kw))
           for mod in (tforecast, jforecast)]
    for fc in fcs:
        feed(fc, series)
    port, ref = (state(fc, 500 if name == "rising" else 24) for fc in fcs)
    assert port == ref
    for p in fcs[0].forecast(24):
        assert 0.0 <= p.lower <= p.mean <= p.upper
    if name == "constant":
        assert all(abs(p["mean"] - 5.0) < 1e-6 for p in port["forecast"])
        assert port["error_ratio"] < 0.01
    if name == "rising":
        cfg = fcs[0].cfg
        bound = fcs[0].level + fcs[0].trend * cfg.phi / (1 - cfg.phi)
        assert port["forecast"][-1]["mean"] <= bound + 1e-4
    if name == "short_ring":
        assert len(port["history"]) == 8


def test_the_demand_forecaster_is_keyed_as_in_jax():
    """Independent keyed series, a zero forecast for an unknown key, gap
    buckets closed as zero demand and within-bucket samples averaged:
    every answer the JAX DemandForecaster gives."""
    out = []
    for mod in (tforecast, jforecast):
        d = mod.DemandForecaster(mod.ForecastConfig(bucket_s=BUCKET,
                                                    season_buckets=1,
                                                    alpha=0.5))
        for b in range(20):
            d.observe("a", b * BUCKET, 4.0)
            d.observe("b", b * BUCKET, 1.0)
            d.observe("b", b * BUCKET + 1.0, 3.0)   # averaged in-bucket
        d.observe("a", 20 * BUCKET, 0.0)
        d.observe("b", 20 * BUCKET, 0.0)
        d.observe("gap", 0.0, 6.0)
        d.observe("gap", 10 * BUCKET, 0.0)          # 9 empty buckets
        out.append({
            "keys": d.keys(),
            "a": [p.as_dict() for p in d.forecast("a", 3)],
            "b": [p.as_dict() for p in d.forecast("b", 3)],
            "gap": [p.as_dict() for p in d.forecast("gap", 1)],
            "gap_observed": d.series["gap"].buckets_observed,
            "b_history": d.series["b"].history_rows()[:2],
            "never": [p.mean for p in d.forecast("never-seen", 3)]})
    port, ref = out
    assert port == ref
    assert port["keys"] == ["a", "b", "gap"]
    assert port["a"][0]["mean"] > 2.0 and port["b"][0]["mean"] > 1.5
    assert port["b_history"][0] == [0.0, 2.0]
    assert port["gap_observed"] == 10 and port["gap"][0]["mean"] < 1.0
    assert port["never"] == [0.0, 0.0, 0.0]
    assert accounting.DemandForecaster is tforecast.DemandForecaster
    assert accounting.CapacityTracker is tplanner.CapacityTracker


# -- the planner ------------------------------------------------------------------

def test_the_planner_constants_are_the_jax_ones():
    assert tplanner.CAPACITY_FIELD_METRICS == jplanner.CAPACITY_FIELD_METRICS
    assert tplanner.CAPACITY_ROOT_FIELDS == jplanner.CAPACITY_ROOT_FIELDS
    assert tplanner.MAX_HORIZON_BUCKETS == jplanner.MAX_HORIZON_BUCKETS
    assert tplanner.PATTERN_DEFAULTS == jplanner.PATTERN_DEFAULTS
    assert set(tplanner.CAPACITY_ROOT_FIELDS) <= set(
        tplanner.CAPACITY_FIELD_METRICS)


@pytest.mark.parametrize("demand,admissible,wait,want", [
    (1.0, 6.0, 0.0, 300.0),     # 240's band touches 6.0: not starving
    (1.0, 5.5, 0.0, 240.0),
    (1.0, 5.5, 60.0, 300.0),    # crossing + the unplaced-wait threshold
    (9.0, 6.0, 0.0, 0.0),       # over already: starving now
    (1.0, 100.0, 0.0, None),    # the horizon stays clear
])
def test_the_starvation_eta_reads_the_upper_band_as_jax(demand, admissible,
                                                        wait, want):
    got = []
    for fmod, pmod in ((tforecast, tplanner), (jforecast, jplanner)):
        pts = [fmod.ForecastPoint(at_s=60.0 * (h + 1), mean=2.0 + h,
                                  lower=1.0, upper=3.0 + h)
               for h in range(5)]
        got.append(pmod._starvation_eta(pts, demand, admissible, wait))
    assert got == [want, want]


def assess_both(observe, *, tracker_kw=None, cfg_kw=None, **assess_kw):
    """The same observations into both packages' CapacityTracker, then
    both ``assess`` documents (equal) and the port's tracker."""
    docs, trackers = [], []
    cfg_kw = {"bucket_s": BUCKET, **(cfg_kw or {})}
    for fmod, pmod in ((tforecast, tplanner), (jforecast, jplanner)):
        tracker = pmod.CapacityTracker(fmod.ForecastConfig(**cfg_kw),
                                       **(tracker_kw or {}))
        observe(tracker)
        docs.append(pmod.assess(tracker, **assess_kw))
        trackers.append(tracker)
    assert docs[0] == docs[1]
    return docs[0], trackers[0]


def steady(key, chips, buckets=12):
    def observe(tracker):
        for b in range(buckets):
            tracker.observe_queues({key: chips}, b * BUCKET)
    return observe


def test_the_scale_recommendation_is_peak_over_cards_per_node_as_jax():
    doc, _ = assess_both(
        steady("q", 9.0), cfg_kw=dict(season_buckets=1), fleet_chips=4,
        free_chips=0, chips_per_node=4, nodes_current=1,
        queue_rows=[{"queue": "q", "nominal_chips": 0,
                     "borrow_limit_chips": 0}],
        now=12 * BUCKET, horizon_s=120.0)
    assert doc["nodes_recommended"] >= 3
    assert doc["nodes_to_add"] == doc["nodes_recommended"] - 1
    assert doc["method"] == "analytic"


def test_admissible_cards_are_clamped_to_the_fleet_as_jax():
    doc, _ = assess_both(
        steady("serve", 10.0), cfg_kw=dict(season_buckets=1),
        fleet_chips=8, free_chips=0, chips_per_node=4, nodes_current=2,
        queue_rows=[{"queue": "serve", "nominal_chips": 20,
                     "borrow_limit_chips": 0}],
        now=12 * BUCKET, horizon_s=300.0)
    (row,) = doc["queues"]
    assert row["admissible_chips"] == 8 and row["starvation_eta_s"] == 0.0


def test_a_borrow_only_queue_is_governed_as_jax():
    doc, _ = assess_both(
        steady("batch", 10.0), cfg_kw=dict(season_buckets=1),
        fleet_chips=64, free_chips=54, chips_per_node=8, nodes_current=8,
        queue_rows=[{"queue": "batch", "nominal_chips": 0,
                     "borrow_limit_chips": 4}],
        now=12 * BUCKET, horizon_s=300.0)
    (row,) = doc["queues"]
    assert row["admissible_chips"] == 4 and row["starvation_eta_s"] == 0.0


def test_the_horizon_is_clamped_as_jax():
    def observe(tracker):
        tracker.observe_queues({"q": 1.0}, 0.0)
        tracker.observe_queues({"q": 1.0}, 60.0)

    doc, _ = assess_both(
        observe, cfg_kw=dict(bucket_s=60.0, season_buckets=1),
        fleet_chips=4, free_chips=4, chips_per_node=4, nodes_current=1,
        queue_rows=[], now=120.0, horizon_s=1e9)
    assert doc["horizon_s"] == tplanner.MAX_HORIZON_BUCKETS * 60.0
    (row,) = doc["queues"]
    assert len(row["forecast"]) == tplanner.MAX_HORIZON_BUCKETS


def test_a_vanished_queue_decays_as_jax():
    def observe(tracker):
        for b in range(6):
            tracker.observe_queues({"gone": 4.0}, b * BUCKET)
        for b in range(6, 30):
            tracker.observe_queues({}, b * BUCKET)  # the tenant left

    doc, tracker = assess_both(
        observe, cfg_kw=dict(season_buckets=1, alpha=0.5), fleet_chips=4,
        free_chips=4, chips_per_node=4, nodes_current=1, queue_rows=[],
        now=30 * BUCKET, horizon_s=60.0, detail=False)
    assert tracker.demand.forecast("gone", 1)[0].mean < 0.5
    assert "forecast" not in doc["queues"][0]


def test_a_vanished_key_is_retired_after_retention_as_jax():
    def observe(tracker):
        tracker.observe_queues({"ci-job-123": 2.0}, 0.0)
        tracker.observe_queues({}, 60.0)        # inside retention
        assert "ci-job-123" in tracker.demand.keys()
        tracker.observe_queues({}, 200.0)       # past it: retired

    doc, tracker = assess_both(
        observe, cfg_kw=dict(season_buckets=1),
        tracker_kw=dict(retention_s=120.0), fleet_chips=4, free_chips=4,
        chips_per_node=4, nodes_current=1, queue_rows=[], now=200.0,
        horizon_s=60.0)
    assert "ci-job-123" not in tracker.demand.keys()
    assert doc["queues"] == []


@pytest.mark.parametrize("pattern,params", [
    ("bursty", {}), ("bursty", {"burst_chips": 2.0, "period_buckets": 5}),
    ("diurnal", {}), ("diurnal", {"amplitude_chips": 3.0,
                                  "period_buckets": 16}),
    ("flash-crowd", {}), ("flash-crowd", {"surge_at_bucket": 40,
                                          "ramp_buckets": 4}),
])
def test_the_arrival_patterns_equal_the_jax_ones(pattern, params):
    got = tplanner.synth_demand(pattern, params, 64)
    assert got == jplanner.synth_demand(pattern, params, 64)
    assert got == tplanner.synth_demand(pattern, params, 64) and \
        len(got) == 64


def test_an_unknown_pattern_is_refused_as_in_jax():
    for mod in (tplanner, jplanner):
        with pytest.raises(ValueError, match="tsunami"):
            mod.synth_demand("tsunami", {}, 8)


@pytest.mark.parametrize("seed", range(3))
def test_integerize_conserves_demand_as_jax(seed):
    rng = random.Random(seed)
    series = [rng.uniform(0.0, 3.0) for _ in range(50)]
    for per in (1, 2):
        pods = tplanner.integerize(series, per)
        assert pods == jplanner.integerize(series, per)
        acc, got = 0.0, 0
        for chips, n in zip(series, pods):
            acc += chips / per
            got += n
            assert abs(got - acc) < 1.0


def test_arrival_entries_equal_the_jax_ones_under_the_name_map():
    for stream in ({"name": "s", "namespace": "ns", "gpu": 1,
                    "runtime_s": 10},
                   {"name": "m", "gpu": 2, "gpumem": 4000, "gpucores": 30}):
        port = tplanner.arrival_entries(stream, [2.0, 0.0, 1.0, 3.5], 30.0,
                                        t0_s=5.0)
        ref = jplanner.arrival_entries(
            {KEYS.get(k, k): v for k, v in stream.items()},
            [2.0, 0.0, 1.0, 3.5], 30.0, t0_s=5.0)
        assert port == [{BACK.get(k, k): v for k, v in e.items()}
                        for e in ref]
    entries = tplanner.arrival_entries(
        {"name": "s", "namespace": "ns", "gpu": 1, "runtime_s": 10},
        [2.0, 0.0, 1.0], 30.0)
    assert [e["at_s"] for e in entries] == [0.0, 60.0]
    assert entries[0]["count"] == 2 and entries[0]["every_s"] == 15.0
    assert "gpumem" not in entries[0]


# -- the scheduler: observe_capacity, export_capacity, /capacityz, /metrics -----

def governed_pod(i: int, chips: int = 1, ns: str = "tenant-a") -> dict:
    return {"metadata": {"name": f"p{i}", "namespace": ns,
                         "uid": f"uid-p{i}",
                         "annotations": {QUEUE_ANNOTATION: ns,
                                         QUEUE_STATE_ANNOTATION: STATE_HELD}},
            "spec": {"containers": [{"name": "main", "resources": {
                "limits": {"nvidia.com/gpu": str(chips)}}}]}}


def capacity_side(port: bool, **cfg) -> Side:
    cfg = {"quota_queues": QUEUES, **CAPACITY_CFG, **cfg}
    return Side(port, fleet={"node-a": fixture("node-a", ["h100"] * 4)},
                **cfg)


def drive_demand(side: Side, buckets: int = 8) -> None:
    """One held governed pod arriving a 30 s bucket: a rising demand ramp
    the tracker samples every bucket."""
    for b in range(buckets):
        side.kube.create_pod(governed_pod(b))
        side.s.observe_capacity()
        side.clock.advance(30.0)
    side.s.observe_capacity()


@pytest.fixture
def sides():
    out = [capacity_side(port) for port in (True, False)]
    for side in out:
        drive_demand(side)
    yield out
    for side in out:
        side.s.close()


def test_capacityz_fields_follow_the_mapping_and_equal_the_jax_export(sides):
    docs = [side.s.export_capacity() for side in sides]
    assert docs[0] == docs[1]
    doc = docs[0]
    for field in tplanner.CAPACITY_ROOT_FIELDS:
        assert field in doc
    (row,) = doc["queues"]
    assert row["queue"] == "tenant-a" and row["demand_chips"] == 8.0
    for field in tplanner.CAPACITY_FIELD_METRICS:
        if field not in tplanner.CAPACITY_ROOT_FIELDS:
            assert field in row
    assert doc["fleet"] == {"nodes": 1, "chips": 4, "free_chips": 4,
                            "chips_per_node": 4}
    assert doc["horizon_s"] == 300.0 and row["series"]
    # detail=False drops the curves and nothing else.
    lean = sides[0].s.export_capacity(detail=False)
    assert lean["queues"][0] == {k: v for k, v in row.items()
                                 if k not in ("forecast", "series")}


def collector_texts(sides) -> tuple:
    return (expo.render(tcluster.ClusterCollector(sides[0].s).collect()),
            jax_text(jcluster.ClusterCollector(sides[1].s)))


@pytest.mark.parametrize("family", FAMILIES)
def test_each_capacity_family_reads_as_the_jax_collector(sides, family):
    """Each family of CAPACITY_FIELD_METRICS, emitted with the JAX
    collector's help, type, labels and values on the same script, and
    equal to the /capacityz field it maps (+Inf for a clear horizon)."""
    port, ref = (families(t) for t in collector_texts(sides))
    assert (port[family].documentation, port[family].type) == \
        (ref[family].documentation, ref[family].type)
    assert samples(port[family]) == samples(ref[family])
    assert port[family].samples, family
    doc = sides[0].s.export_capacity(detail=False)
    field = {v: k for k, v in tplanner.CAPACITY_FIELD_METRICS.items()}[
        family]
    want = doc[field] if field in tplanner.CAPACITY_ROOT_FIELDS else \
        doc["queues"][0][field]
    got = port[family].samples[0]
    assert got.value == (math.inf if want is None else want)
    if field not in tplanner.CAPACITY_ROOT_FIELDS:
        assert got.labels == {"queue": "tenant-a"}
    assert family not in tcluster.A5_FAMILIES


def test_every_capacity_family_is_emitted_empty_on_a_bare_stub():
    """A collector stub without the capacity surface emits the families
    empty, as the JAX collector does."""
    texts = []
    for port in (True, False):
        side = capacity_side(port)

        class Stub:
            def __getattr__(self, name, s=side.s):
                if name == "export_capacity":
                    raise AttributeError(name)
                return getattr(s, name)

        try:
            texts.append(
                expo.render(tcluster.ClusterCollector(Stub()).collect())
                if port else jax_text(jcluster.ClusterCollector(Stub())))
        finally:
            side.s.close()
    port, ref = (families(t) for t in texts)
    for family in FAMILIES:
        assert family in port and not port[family].samples
        assert not ref[family].samples


def http_get(base: str, path: str):
    try:
        with urllib.request.urlopen(base + path, timeout=10) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def test_capacityz_round_trips_over_http_as_the_jax_endpoint(sides,
                                                             monkeypatch):
    """``?horizon=120`` answers the JAX document; every malformed horizon
    is a 400, never a 500 deep in the assessment; an export that fails is
    a 500 with the error, on both extenders."""
    servers = [TServer(sides[0].s, sides[0].s.cfg, host="127.0.0.1",
                       port=0),
               JServer(sides[1].s, sides[1].s.cfg, host="127.0.0.1",
                       port=0)]
    for srv in servers:
        srv.start()
    try:
        bases = [f"http://127.0.0.1:{srv.port}" for srv in servers]
        got = [http_get(b, "/capacityz?horizon=120") for b in bases]
        assert got[0] == got[1]
        code, doc = got[0]
        assert code == 200 and doc["horizon_s"] == 120.0
        assert doc["queues"][0]["queue"] == "tenant-a"
        assert http_get(bases[0], "/capacityz")[1]["horizon_s"] == 300.0
        for bad in ("bogus", "nan", "inf", "-60", "0"):
            answers = [http_get(b, f"/capacityz?horizon={bad}")
                       for b in bases]
            assert answers[0] == answers[1], bad
            assert answers[0][0] == 400, bad
            assert answers[0][1]["error"].startswith("bad horizon"), bad

        def broken(*a, **k):
            raise RuntimeError("tracker gone")

        for side in sides:
            monkeypatch.setattr(side.s, "export_capacity", broken)
        answers = [http_get(b, "/capacityz") for b in bases]
        assert answers[0] == answers[1] == (
            500, {"error": "RuntimeError: tracker gone"})
    finally:
        for srv in servers:
            srv.stop()


def test_an_ungoverned_fleet_samples_namespace_demand_as_jax():
    out = []
    for port in (True, False):
        side = Side(port, fleet={"node-a": fixture("node-a", ["h100"] * 4)})
        try:
            for i, ns in enumerate(("team-x", "team-x", "team-y")):
                p = governed_pod(i, ns=ns)
                p["metadata"]["annotations"] = {}
                side.kube.create_pod(p)
                assert side.s.filter(p, ["node-a"]).node == "node-a"
            out.append((side.s.observe_capacity(),
                        side.s.export_capacity(detail=False)))
        finally:
            side.s.close()
    assert out[0] == out[1]
    samples_, doc = out[0]
    assert samples_ == {"team-x": 2.0, "team-y": 1.0}
    assert [r["admissible_chips"] for r in doc["queues"]] == [4, 4]


def test_a_captured_trace_replays_in_both_simulators(sides, serial):
    """``scenario_from_capacityz`` of the same export: the JAX spec under
    the name map, sized to the whole captured trace; its series feed the
    simulator's resampler; the replay's capacity section equals the JAX
    one, with no card overbooked."""
    docs = [side.s.export_capacity() for side in sides]
    spec = tplanner.scenario_from_capacityz(docs[0])
    ref = jplanner.scenario_from_capacityz(docs[1])
    ref["capacity"]["streams"] = [{BACK.get(k, k): v for k, v in s.items()}
                                  for s in ref["capacity"]["streams"]]
    assert spec == ref
    cap = spec["capacity"]
    assert cap["source"] == "capacityz-snapshot"
    n_rows = max(len(st["series"]) for st in cap["streams"])
    assert cap["history_buckets"] + cap["horizon_buckets"] >= n_rows
    (stream,) = cap["streams"]
    assert stream["name"] == "tenant-a" and stream["series"][0][0] == 0.0
    (queue,) = cap["queues"]
    assert queue["quota"]["chips"] == 4
    series = tsim._capacity_demand_series(cap, stream, 8, cap["bucket_s"])
    assert series == jsim._capacity_demand_series(
        ref["capacity"], stream, 8, cap["bucket_s"])
    assert len(series) == 8 and max(series) > 0
    fleet = dict(nodes=1, chips=4, hbm=16384, mesh=(4, 1))
    port = tsim.run_simulation(copy.deepcopy(spec), **fleet)
    jspec = copy.deepcopy(spec)
    jspec["capacity"]["streams"] = [{KEYS.get(k, k): v for k, v in s.items()}
                                    for s in jspec["capacity"]["streams"]]
    want = as_port(json.loads(json.dumps(jsim.run_simulation(
        jspec, generation="h100", **fleet))))
    assert port == want
    assert port["capacity"]["verdict"]["no_overbooking"]


@pytest.mark.parametrize("which", ["live", "fixed"])
def test_the_report_capacity_section_renders_as_jax(sides, which):
    doc = sides[0].s.export_capacity() if which == "live" else {
        "method": "analytic", "horizon_s": 1800.0, "bucket_s": 60.0,
        "nodes_current": 2, "nodes_recommended": 4, "nodes_to_add": 2,
        "peak_forecast_demand_chips": 11.5,
        "queues": [
            {"queue": "serve", "demand_chips": 6.0,
             "forecast_demand_chips": 10.0, "forecast_upper_chips": 11.5,
             "starvation_eta_s": 540.0, "forecast_error_ratio": 0.07},
            {"queue": "batch", "demand_chips": 2.0,
             "forecast_demand_chips": 2.0, "forecast_upper_chips": 2.4,
             "starvation_eta_s": None, "forecast_error_ratio": None}]}
    text = treport.format_capacity(doc)
    assert text == jreport.format_capacity(doc)
    if which == "fixed":
        assert "2 node(s) now, 4 recommended (+2)" in text
        assert "540s" in text and "never" in text and "7%" in text
    else:
        assert "tenant-a" in text


# -- the simulator's capacity section ---------------------------------------------

SCENARIOS = json.loads((EXAMPLES / "vgpu-capacity-scenarios.json")
                       .read_text())
FLEET = SCENARIOS["fleet"]
EXAMPLE = json.loads((EXAMPLES / "vgpu-workload-capacity.json").read_text())
CASES = {**{name: {"capacity": spec}
            for name, spec in SCENARIOS["scenarios"].items()},
         "example": EXAMPLE}


def jax_capacity(workload: dict) -> dict:
    out = copy.deepcopy(workload)
    out["capacity"]["streams"] = [{KEYS.get(k, k): v for k, v in s.items()}
                                  for s in out["capacity"]["streams"]]
    return out


def fleet_kw(fleet=FLEET) -> dict:
    return dict(nodes=fleet["nodes"], chips=fleet["chips"],
                hbm=fleet["hbm"], mesh=tuple(fleet["mesh"]))


def per_pod_filter_many(self, items):
    """A ``filter_many`` that drains per pod: ``filter`` a pod, in the
    order given."""
    return [self.filter(pod, names) for pod, names in items]


def test_the_named_scenarios_are_the_jax_ones_in_the_ports_names():
    """examples/vgpu-capacity-scenarios.json is the JAX package's
    ARRIVAL_SCENARIOS (benchmarks/scenarios.py, read here as text: the
    module is not imported) in the port's names, less flash-crowd's
    replica_loss; the example is the JAX example less the same key."""
    src = (ROOT / "benchmarks" / "scenarios.py").read_text()
    assert SCENARIOS["fleet"] == {"nodes": 2, "chips": 4, "hbm": 16384,
                                  "mesh": [4, 1]}
    assert 'CAPACITY_FLEET = {"nodes": 2, "chips": 4, "hbm": 16384, ' \
        '"mesh": (4, 1)}' in src
    assert list(SCENARIOS["scenarios"]) == ["bursty", "diurnal",
                                            "flash-crowd"]
    for name in SCENARIOS["scenarios"]:
        assert f'    "{name}": {{\n        "pattern": "{name}",' in src
    jax_example = json.loads((EXAMPLES / "workload-capacity.json")
                             .read_text())
    assert jax_example["capacity"].pop("replica_loss") == {
        "replicas": 3, "kill_after": 8}
    assert jax_capacity(EXAMPLE) == jax_example
    assert SCENARIOS["scenarios"]["flash-crowd"] == EXAMPLE["capacity"]


@pytest.mark.parametrize("name", sorted(CASES))
def test_the_capacity_section_equals_the_jax_section(name, serial,
                                                     monkeypatch):
    """Each named scenario and the example on the 2 x 4 fleet: the port's
    section equals the JAX section (serial, both drained through
    ``filter_many``), and each package's section with its drain rebound
    to a Filter a pod equals it too; the verdict passes."""
    port = tsim.run_simulation(copy.deepcopy(CASES[name]), **fleet_kw())
    want = as_port(json.loads(json.dumps(jsim.run_simulation(
        jax_capacity(CASES[name]), generation="h100", **fleet_kw()))))
    assert port == want
    monkeypatch.setattr(jsim.Scheduler, "filter_many", per_pod_filter_many)
    monkeypatch.setattr(tsim.Scheduler, "filter_many", per_pod_filter_many)
    per_pod = as_port(json.loads(json.dumps(jsim.run_simulation(
        jax_capacity(CASES[name]), generation="h100", **fleet_kw()))))
    assert per_pod == want
    assert tsim.run_simulation(copy.deepcopy(CASES[name]),
                               **fleet_kw()) == want
    cp = port["capacity"]
    assert cp["verdict"]["ok"] and port["fits"]
    assert cp["replica_loss"] is None and cp["elastic_whatif"] is None
    if name in ("bursty", "diurnal"):
        (row,) = cp["starvation"]
        assert row["within_one_bucket"] and row["actual_eta_s"] is not None
    else:
        rec = cp["recommendation"]
        assert rec["nodes_recommended"] > rec["nodes_current"]
        assert "serve" not in rec["applied"]["starved_at"]


class _OrderedBatchScheduler(jsim.Scheduler):
    """The JAX scheduler with both its snapshot reads in registry order
    (the batch engine reads ``snapshot_for_batch``)."""

    def _ordered(self, snap):
        return {n: snap[n] for n in self.nodes.list_nodes() if n in snap}

    def snapshot(self):
        return self._ordered(super().snapshot())

    def snapshot_for_batch(self):
        snap, changed = super().snapshot_for_batch()
        return self._ordered(snap), changed


@pytest.mark.parametrize("name", sorted(CASES))
def test_the_default_path_capacity_section_equals_the_jax_one(name,
                                                              monkeypatch):
    """On the default (optimistic) path both replays decide each tick's
    drain in batched cycles: with the JAX snapshot in registry order the
    port's section equals the JAX section (what chip_smoke.py's
    CAPACITY_SHA256_OPTIMISTIC pins on the card's host)."""
    monkeypatch.setattr(jsim, "Scheduler", _OrderedBatchScheduler)
    port = tsim.run_simulation(copy.deepcopy(CASES[name]), **fleet_kw())
    want = as_port(json.loads(json.dumps(jsim.run_simulation(
        jax_capacity(CASES[name]), generation="h100", **fleet_kw()))))
    assert port == want
    assert port["capacity"]["verdict"]["ok"]


def cli_json(capsys, workload: dict, tmp_path, fleet=FLEET) -> str:
    wl = tmp_path / "wl.json"
    wl.write_text(json.dumps(workload))
    mesh = "x".join(str(d) for d in fleet["mesh"])
    rc = tsim.main(["--workload", str(wl), "--nodes", str(fleet["nodes"]),
                    "--chips", str(fleet["chips"]), "--hbm",
                    str(fleet["hbm"]), "--mesh", mesh, "--json"])
    assert rc == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("path", ["serial", "optimistic"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_the_capacity_report_is_bit_identical_and_pinned(name, path,
                                                         tmp_path, capsys,
                                                         monkeypatch):
    """``vgpu-simulate --json`` twice: the same bytes (SimClock and closed
    forms, no RNG), whose sha256 is pinned for each decision path: the
    serial one (``Config`` rebound to ``optimistic_commit=False``,
    ``CAPACITY_SHA256``) and the default optimistic one
    (``CAPACITY_SHA256_OPTIMISTIC``, which chip_smoke.py holds the card
    machine's run to)."""
    if path == "serial":
        monkeypatch.setattr(tsim, "Config", functools.partial(
            tsim.Config, optimistic_commit=False))
    pins = (chip_smoke.CAPACITY_SHA256 if path == "serial"
            else chip_smoke.CAPACITY_SHA256_OPTIMISTIC)
    first = cli_json(capsys, CASES[name], tmp_path)
    assert cli_json(capsys, CASES[name], tmp_path) == first
    assert hashlib.sha256(first.encode()).hexdigest() == pins[name]
    assert json.loads(first)["capacity"]["verdict"]["ok"]


def test_the_example_prints_the_capacity_report_as_jax(serial, tmp_path,
                                                       capsys):
    wl = tmp_path / "wl.json"
    wl.write_text(json.dumps(EXAMPLE))
    assert tsim.main(["--workload", str(wl), "--nodes", "2", "--chips",
                      "4", "--hbm", "16384", "--mesh", "4x1"]) == 0
    out = capsys.readouterr().out
    ref = jsim.run_simulation(jax_capacity(EXAMPLE), generation="h100",
                              **fleet_kw())
    assert out.rstrip("\n") == jsim.format_report(ref)
    assert "capacity planning (flash-crowd pattern" in out
    assert "scale recommendation: 2 → 4 node(s)" in out
    assert "verdict: PASS" in out


def replica_loss_workload() -> dict:
    """The port's example with the JAX example's replica_loss what-if."""
    workload = copy.deepcopy(EXAMPLE)
    workload["capacity"]["replica_loss"] = {"replicas": 3, "kill_after": 8}
    return workload


def test_the_replica_loss_whatif_equals_the_jax_one(serial, tmp_path,
                                                    capsys):
    """The JAX example (examples/workload-capacity.json, replica_loss
    included) on the 2 x 4 fleet: the port's section, the what-if's ha
    run through the shard layer included, equals the JAX section; the
    protocol holds; ``vgpu-simulate`` prints the JAX report."""
    jax_example = json.loads((EXAMPLES / "workload-capacity.json")
                             .read_text())
    workload = replica_loss_workload()
    assert jax_capacity(workload) == jax_example
    port = tsim.run_simulation(copy.deepcopy(workload), **fleet_kw())
    ref = as_port(json.loads(json.dumps(jsim.run_simulation(
        jax_example, generation="h100", **fleet_kw()))))
    assert port == ref
    cp = port["capacity"]
    rl = cp["replica_loss"]
    assert rl["protocol_ok"] and cp["verdict"]["replica_loss_protocol_ok"]
    assert (rl["replicas"], rl["shard_rebalances"]) == (3, 2)
    assert cp["verdict"]["ok"] and port["fits"]
    wl = tmp_path / "wl.json"
    wl.write_text(json.dumps(workload))
    assert tsim.main(["--workload", str(wl), "--nodes", "2", "--chips", "4",
                      "--hbm", "16384", "--mesh", "4x1"]) == 0
    out = capsys.readouterr().out
    assert out.rstrip("\n") == jsim.format_report(ref)
    assert "losing a replica costs: " in out


def test_the_replica_loss_report_is_bit_identical_and_pinned(tmp_path,
                                                             capsys):
    """``vgpu-simulate --json`` twice on the default decision path (the
    card's): the same bytes, whose sha256 chip_smoke.py holds the card
    machine's run to (``HA_SHA256["replica_loss"]``)."""
    first = cli_json(capsys, replica_loss_workload(), tmp_path)
    assert cli_json(capsys, replica_loss_workload(), tmp_path) == first
    assert hashlib.sha256(first.encode()).hexdigest() == \
        chip_smoke.HA_SHA256["replica_loss"]
    assert json.loads(first)["capacity"]["replica_loss"]["protocol_ok"]


def test_the_elastic_whatif_equals_the_jax_one(serial):
    """The example's capacity section with an ``elastic_whatif`` built
    from examples/vgpu-workload-elastic.json, on that example's fleet (2
    x 16, mesh 4x4): the whole section, the elastic A/B included, equals
    the JAX one, and the what-if resolves with no card overbooked."""
    elastic = json.loads((EXAMPLES / "vgpu-workload-elastic.json")
                         .read_text())["elastic"]
    workload = copy.deepcopy(EXAMPLE)
    workload["capacity"]["elastic_whatif"] = elastic
    workload["capacity"]["max_extra_nodes"] = 2
    fleet = dict(nodes=2, chips=16, hbm=16384, mesh=(4, 4))
    port = tsim.run_simulation(copy.deepcopy(workload), **fleet)
    jwl = jax_capacity(workload)
    jel = jwl["capacity"]["elastic_whatif"]
    jel["gang"] = {KEYS.get(k, k): v for k, v in jel["gang"].items()}
    jel["arrivals"] = [{KEYS.get(k, k): v for k, v in a.items()}
                       for a in jel["arrivals"]]
    want = as_port(json.loads(json.dumps(jsim.run_simulation(
        jwl, generation="h100", **fleet))))
    assert port == want
    ew = port["capacity"]["elastic_whatif"]
    assert port["capacity"]["verdict"]["elastic_whatif_resolved"]
    assert ew["ab"]["verdict"]["ok"] and ew["choice"] == "shrink-elastic"
    assert ew["kills_avoided"] >= 1
    assert "shrink elastic jobs vs" in tsim.format_report(port)
