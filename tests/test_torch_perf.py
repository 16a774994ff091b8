"""The port's performance observatory (``util/perf.py``) and its seams in the
extender (the phases and locks the scheduler records, ``GET /perfz``, the
Prometheus families) against the JAX package's, on the CPU:
``tests/test_perf.py``'s cases, each run on both packages.

What is compared: the rings' and locks' arithmetic exactly; of a
scheduler run, the deterministic counts (each phase's records, each lock's
acquires, the decision writer's batches and writes) and the structure of
``export()``/``export_perf()`` (keys, phase and lock names), never a
duration.  The registry is process-global in each package: ``fresh`` gives
each case a new registry on both (its GC watcher installed, and
uninstalled at the end).

The batched-cycle cases are here too: a cycle's phase decomposition
(snapshot, columnar-rebuild then columnar-refresh, vector-eval, solve,
group-commit, fallback, cycle-total, the drain and the tick journal), the
drain age's reset, the drain left disjoint from inline decisions, a
cycle's phases summing to its total, and ``/perfz``'s batch counters and
solve-worker section against the JAX document.

Left out, and why: the debugz journal's pagination and the tombstone
prune's threshold belong to ``util/debugz.py`` and the informer, not to
the observatory.
"""

import gc
import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from k8s_vgpu_scheduler_tpu.scheduler import metrics as jmetrics
from k8s_vgpu_scheduler_tpu.scheduler.routes import \
    ExtenderServer as JServer
from k8s_vgpu_scheduler_tpu.util import perf as jperf
from k8s_vgpu_scheduler_tpu.util import trace as jtrace
from k8s_vgpu_scheduler_tpu_torch.scheduler import metrics as tmetrics
from k8s_vgpu_scheduler_tpu_torch.scheduler.routes import \
    ExtenderServer as TServer
from k8s_vgpu_scheduler_tpu_torch.util import exposition as expo
from k8s_vgpu_scheduler_tpu_torch.util import perf as tperf
from k8s_vgpu_scheduler_tpu_torch.util import trace as ttrace
from tests.test_torch_concurrency import PKGS, make_env

MODS = {"port": tperf, "jax": jperf}
SIDES = tuple(MODS)


@pytest.fixture
def fresh(monkeypatch):
    """A new process-global registry in each package for the case."""
    regs = {}
    for side, mod in MODS.items():
        reg = mod.PerfRegistry()
        reg.gc.install()
        monkeypatch.setattr(mod, "_GLOBAL", reg)
        regs[side] = reg
    yield regs
    for reg in regs.values():
        reg.gc.uninstall()


@pytest.fixture
def built():
    made = []
    yield made
    for s in made:
        s.close()


def both(fn):
    got = {side: fn(side) for side in SIDES}
    assert got["port"] == got["jax"], got
    return got["port"]


# -- PhaseRing -----------------------------------------------------------------
def test_window_quantiles_and_lifetime(fresh):
    def run(side):
        ring = MODS[side].PhaseRing("x", capacity=16)
        for ms in (1, 2, 3, 4, 100):
            ring.record(ms / 1000.0)
        return ring.window(), ring.count, ring.lifetime_max_s

    w, count, lifetime = both(run)
    assert w["n"] == 5 and count == 5
    assert w["max_s"] == pytest.approx(0.1)
    assert w["p50_s"] == pytest.approx(0.003)
    assert lifetime == pytest.approx(0.1)


def test_ring_is_bounded_and_window_forgets(fresh):
    def run(side):
        ring = MODS[side].PhaseRing("x", capacity=8)
        ring.record(9.0)
        for _ in range(64):
            ring.record(0.001)
        return ring.window(), ring.lifetime_max_s

    w, lifetime = both(run)
    assert w["n"] == 8 and w["max_s"] == pytest.approx(0.001)
    assert lifetime == pytest.approx(9.0)


def test_prom_buckets_cumulative_with_inf(fresh):
    def run(side):
        ring = MODS[side].PhaseRing("x", bounds=(0.001, 0.01))
        for v in (0.0005, 0.005, 5.0):
            ring.record(v)
        return ring.prom()

    buckets, sum_s = both(run)
    assert buckets == [("0.001", 1), ("0.01", 2), ("+Inf", 3)]
    assert sum_s == pytest.approx(5.0055)


def test_negative_durations_clamp(fresh):
    def run(side):
        ring = MODS[side].PhaseRing("x")
        ring.record(-1.0)
        return ring.window()["max_s"]

    assert both(run) == 0.0


def test_the_tables_are_the_jax_ones():
    assert tperf.PHASE_BUCKETS == jperf.PHASE_BUCKETS
    assert tperf.PHASE_BUCKETS == ttrace.DEFAULT_BUCKETS[:-1]
    assert tperf.LOCK_BUCKETS == jperf.LOCK_BUCKETS
    assert tperf.INFORMER_SAMPLE_EVERY == jperf.INFORMER_SAMPLE_EVERY == 8
    assert tperf.INFORMER_LAG_HORIZON_S == jperf.INFORMER_LAG_HORIZON_S
    assert tperf.PerfRegistry.TICK_RING == jperf.PerfRegistry.TICK_RING


# -- TimedLock -------------------------------------------------------------------
def contended(side):
    lk = MODS[side].TimedLock("t-contend")
    with lk:
        pass
    st = lk.stats
    first = (st.acquires, st.contended, st.wait.count, st.hold.count)
    holding, release = threading.Event(), threading.Event()

    def holder():
        with lk:
            holding.set()
            release.wait(5.0)

    th = threading.Thread(target=holder)
    th.start()
    holding.wait(5.0)
    got = lk.acquire(timeout=0.001)
    release.set()
    th.join()
    return first, got, st.contended, st.wait.count


def test_wait_recorded_only_when_contended(fresh):
    assert both(contended) == ((1, 0, 0, 1), False, 1, 1)


def test_hold_sampling_shift(fresh):
    def run(side):
        lk = MODS[side].TimedLock("t-sample", sample_shift=2)
        for _ in range(8):
            with lk:
                pass
        return lk.stats.acquires, lk.stats.hold.count

    assert both(run) == (8, 2)


def test_sampled_acquires_rounds_up(fresh):
    def run(side):
        lk = MODS[side].TimedLock("t-ceil", sample_shift=2)
        with lk:
            pass
        st = lk.stats
        out = [st.acquires, st.hold.count, st.sampled_acquires(),
               fresh[side].export()["locks"]["t-ceil"]["sampled_1_in"]]
        st.contended = 1
        out.append(fresh[side].export()["locks"]["t-ceil"][
            "contention_ratio"])
        for _ in range(7):
            with lk:
                pass
        return out + [st.sampled_acquires()]

    assert both(run) == [1, 1, 1, 4, 1.0, 2]


def test_disabled_registry_bypasses_telemetry(fresh):
    def run(side):
        fresh[side].enabled = False
        lk = MODS[side].TimedLock("t-off")
        with lk:
            pass
        return lk.stats.acquires, lk.stats.hold.count

    assert both(run) == (0, 0)


def test_nonblocking_contended_returns_false(fresh):
    def run(side):
        lk = MODS[side].TimedLock("t-nb")
        out = [lk.acquire(), lk.acquire(blocking=False)]
        lk.release()
        return out

    assert both(run) == [True, False]


def test_locked_passthrough(fresh):
    def run(side):
        lk = MODS[side].TimedLock("t-locked")
        before = lk.locked()
        with lk:
            return before, lk.locked()

    assert both(run) == (False, True)


# -- PerfRegistry -------------------------------------------------------------------
def test_note_tick_and_slow_ticks_ranked(fresh):
    def run(side):
        reg = fresh[side]
        reg.note_tick("batch-cycle", 0.002, {"solve": 0.001}, pods=3)
        reg.note_tick("batch-cycle", 0.050, {"solve": 0.049}, pods=9)
        top = reg.slow_ticks(top=1)
        return [{k: v for k, v in t.items() if k != "age_s"} for t in top]

    [top] = both(run)
    assert top["pods"] == 9 and top["total_ms"] == pytest.approx(50.0)
    assert top["phases_ms"]["solve"] == pytest.approx(49.0)


def test_tick_journal_bounded(fresh):
    def run(side):
        reg = fresh[side]
        for i in range(reg.TICK_RING * 3):
            reg.note_tick("t", 0.001, {}, i=i)
        return len(reg.slow_ticks(top=1000))

    assert both(run) == tperf.PerfRegistry.TICK_RING


def test_export_shape(fresh):
    def run(side):
        reg = fresh[side]
        reg.record("cycle-total", 0.01)
        reg.set_gauge("pending_queue_depth", 7)
        MODS[side].TimedLock("t-export").acquire()
        doc = reg.export()
        return dict(
            keys=sorted(doc), informer=sorted(doc["informer"]),
            queue=doc["queue"], gc=sorted(doc["gc"]),
            tracemalloc=doc["gc"]["tracemalloc_top"],
            phases=sorted(doc["phases"]),
            phase_keys=sorted(doc["phases"]["cycle-total"]),
            window=sorted(doc["phases"]["cycle-total"]["window"]),
            p99=doc["phases"]["cycle-total"]["window"]["p99_s"],
            lock=sorted(doc["locks"]["t-export"]),
            acquires=doc["locks"]["t-export"]["acquires"],
            enabled=doc["enabled"])

    got = both(run)
    assert got["p99"] == pytest.approx(0.01)
    assert "gc-pause" in got["phases"] and got["acquires"] == 1
    assert got["queue"]["pending_depth"] == 7 and got["tracemalloc"] is None
    assert got["enabled"] is True


def test_informer_lag_is_window_p99(fresh):
    def run(side):
        reg = fresh[side]
        for _ in range(10):
            reg.record("informer-apply", 0.001)
        reg.record("informer-apply", 0.2)
        return reg.informer_lag_s()

    assert both(run) == pytest.approx(0.2)


def test_informer_lag_decays_when_stale(fresh):
    def run(side):
        reg = fresh[side]
        reg.record("informer-apply", 0.3)
        out = [reg.informer_lag_s()]
        ring = reg.phase_rings()["informer-apply"]
        ring.last_at = (time.monotonic() - MODS[side].INFORMER_LAG_HORIZON_S
                        - 1)
        out.append(reg.informer_lag_s())
        reg.record("informer-apply", 0.1)
        return out + [reg.informer_lag_s()]

    assert both(run) == pytest.approx([0.3, 0.0, 0.3])


def test_informer_export_names_sampled_count(fresh):
    def run(side):
        reg = fresh[side]
        for _ in range(3):
            reg.record("informer-apply", 0.001)
        inf = reg.export()["informer"]
        return (inf["apply_sampled_count"], inf["apply_sample_1_in"],
                "apply_count" in inf)

    assert both(run) == (3, 8, False)


def test_gc_pause_ring_survives_collection(fresh):
    gc.collect()
    for reg in fresh.values():
        assert reg.gc.collections[2] >= 1
        assert reg.gc.pause.count >= 1


def test_tracemalloc_switch_lists_allocation_sites(fresh):
    import tracemalloc

    was = tracemalloc.is_tracing()
    try:
        for side, reg in fresh.items():
            reg.enable_tracemalloc(frames=2)
            top = reg.export()["gc"]["tracemalloc_top"]
            assert isinstance(top, list) and top, side
            assert set(top[0]) == {"site", "size_kib", "count"}
    finally:
        if not was:
            tracemalloc.stop()


def test_reset_keeps_lock_tables_and_drops_samples(fresh):
    def run(side):
        reg = fresh[side]
        lk = MODS[side].TimedLock("t-reset")
        with lk:
            pass
        reg.record("x", 0.1)
        reg.set_gauge("g", 1.0)
        reg.reset()
        return (sorted(reg.export()["phases"]), lk.stats.acquires,
                "t-reset" in reg.lock_tables(), reg.gauge("g"))

    assert both(run) == (["gc-pause"], 0, True, 0.0)


# -- the scheduler's phases and locks ------------------------------------------------------
def counts(doc) -> dict:
    """A /perfz document's deterministic part: each phase's records (the
    gc pause's excepted), each lock's acquires, the writer's counters."""
    return dict(
        phases={n: p["count"] for n, p in doc["phases"].items()
                if n != "gc-pause"},
        locks={n: lk["acquires"] for n, lk in doc["locks"].items()},
        writer={k: doc["decision_writer"][k] for k in ("batches", "writes")},
        counters=doc["counters"])


def optimistic_run(side, built):
    pkg = PKGS[side]
    kube, s, names = make_env(pkg, built, n_nodes=2)
    p = pkg.pod("o1", "ou1", mem="500")
    kube.create_pod(p)
    assert s.filter(p, names).node
    return counts(s.export_perf())


def test_optimistic_path_records_phases_and_locks(fresh, built):
    """One optimistic Filter: one opt-evaluate and one opt-commit record,
    one sampled decision write and its flush, the commit and registry
    locks taken; the same counts on both (the "nodes" lock aside: the
    JAX package's shard layer also reads the registry)."""
    got = {side: optimistic_run(side, built) for side in SIDES}
    for c in got.values():
        c["locks"].pop("nodes")
    assert got["port"] == got["jax"]
    c = got["port"]
    assert c["phases"]["opt-evaluate"] == c["phases"]["opt-commit"] == 1
    assert c["phases"]["decision-write"] == 1
    assert c["phases"]["decision-flush"] >= 1
    assert c["locks"]["commit"] >= 1 and c["locks"]["pods"] >= 1
    assert c["writer"]["writes"] >= 1


def resync_register(side, built):
    pkg = PKGS[side]
    kube, s, names = make_env(pkg, built, n_nodes=2)
    s.resync_from_apiserver()
    s.observe_registration("node-0", s.nodes.get_node("node-0"))
    doc = s.export_perf()
    return dict(resync=doc["phases"]["informer-resync"]["count"],
                register=doc["phases"]["register-apply"]["count"],
                last=doc["informer"]["resync_last_s"] >= 0.0)


def test_resync_and_register_timed(fresh, built):
    assert both(lambda side: resync_register(side, built)) == dict(
        resync=1, register=1, last=True)


def background(side, built):
    pkg = PKGS[side]
    kube, s, names = make_env(pkg, built, n_nodes=2)
    s.admission.tick()
    s.defrag.tick()
    s.elastic.tick()
    s.observe_capacity()
    phases = s.export_perf()["phases"]
    return {n: phases[n]["count"] for n in
            ("quota-tick", "defrag-tick", "elastic-tick", "capacity-tick")}


def test_background_ticks_timed(fresh, built):
    """The quota, defrag and elastic ticks and the capacity sample are
    each timed once (the quota tick with no quota config too)."""
    assert both(lambda side: background(side, built)) == {
        "quota-tick": 1, "defrag-tick": 1, "elastic-tick": 1,
        "capacity-tick": 1}


def informer_sampling(side, built):
    pkg = PKGS[side]
    kube, s, names = make_env(pkg, built, n_nodes=2)
    for i in range(20):
        kube.create_pod(pkg.pod(f"i{i}", f"iu{i}"))
    return s.export_perf()["informer"]["apply_sampled_count"]


def test_informer_apply_is_one_event_in_eight(fresh, built):
    """Twenty informer events (the pods' ADDED): events 0, 8 and 16 are
    timed."""
    assert both(lambda side: informer_sampling(side, built)) == 3


def no_perf(side, built):
    pkg = PKGS[side]
    kube, s, names = make_env(pkg, built, n_nodes=2, perf_enabled=False)
    p = pkg.pod("d1", "du1", mem="500")
    kube.create_pod(p)
    assert s.filter(p, names).node
    doc = s.export_perf()
    # The GC watcher may record a collection that ran before the
    # scheduler switched the registry off.
    return doc["enabled"], all(ph["count"] == 0
                               for n, ph in doc["phases"].items()
                               if n != "gc-pause")


def test_no_perf_config_disables_instrumentation(fresh, built):
    assert both(lambda side: no_perf(side, built)) == (False, True)


def perf_doc(side, built):
    pkg = PKGS[side]
    kube, s, names = make_env(pkg, built, n_nodes=2)
    for i in range(3):
        p = pkg.pod(f"h{i}", f"hu{i}", mem="500")
        kube.create_pod(p)
        assert s.filter(p, names).node
    doc = s.export_perf()
    return dict(keys=sorted(doc), counters=sorted(doc["counters"]),
                workers=doc["solve_workers"], queue=sorted(doc["queue"]),
                pending=doc["queue"]["pending_depth"],
                writer=sorted(doc["decision_writer"]),
                phases=sorted(doc["phases"]), locks=sorted(doc["locks"]),
                batch=[doc["counters"][k] for k in (
                    "batch_cycles", "batch_fallbacks",
                    "columnar_full_rebuilds", "columnar_rows_reloaded",
                    "columnar_rows_patched", "class_evals_full",
                    "class_rows_patched", "class_evals_offloaded")],
                rebuilds=doc["counters"]["snapshot_usage_rebuilds"],
                writethroughs=doc["counters"][
                    "snapshot_usage_writethroughs"])


def test_export_perf_is_the_jax_document(fresh, built):
    """``export_perf`` after three optimistic Filters: the same keys,
    phase and lock names, counters and the no-batch sections as JAX's
    before any batched cycle (zero counters, pending depth 0, no solve
    workers)."""
    got = both(lambda side: perf_doc(side, built))
    assert got["batch"] == [0] * 8 and got["pending"] == 0
    assert got["workers"] == {"configured": 0, "workers": 0,
                              "restarts_total": 0, "evals_offloaded": 0,
                              "eval_fallbacks": 0, "per_worker": []}
    assert {"opt-evaluate", "opt-commit", "decision-flush",
            "informer-apply", "snapshot-refresh"} <= set(got["phases"])
    assert set(got["locks"]) == {"commit", "snapshot-cache", "nodes",
                                 "pods", "quota", "leases"}


# -- /perfz over HTTP ------------------------------------------------------------------------
def perfz(side, built):
    pkg = PKGS[side]
    kube, s, names = make_env(pkg, built, n_nodes=2)
    p = pkg.pod("h1", "hu1", mem="500")
    kube.create_pod(p)
    assert s.filter(p, names).node
    srv = (TServer if side == "port" else JServer)(
        s, s.cfg, host="127.0.0.1", port=0)
    srv.start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(f"{base}/perfz?ticks=2") as r:
            doc = json.load(r)
        codes = []
        for bad in ("nope", "65", "-1"):
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(f"{base}/perfz?ticks={bad}")
            codes.append((ei.value.code,
                          sorted(json.loads(ei.value.read()))))
        return dict(enabled=doc["enabled"], commit="commit" in doc["locks"],
                    ticks=len(doc["slow_ticks"]) <= 2, keys=sorted(doc),
                    codes=codes)
    finally:
        srv.stop()


def test_perfz_roundtrip_over_real_server(fresh, built):
    got = both(lambda side: perfz(side, built))
    assert got["enabled"] and got["commit"] and got["ticks"]
    assert got["codes"] == [(400, ["error"])] * 3


def test_perfz_export_error_answers_500(fresh, built):
    def run(side):
        pkg = PKGS[side]
        kube, s, names = make_env(pkg, built, n_nodes=1)

        def broken(ticks=8):
            raise RuntimeError("boom")

        s.export_perf = broken
        srv = (TServer if side == "port" else JServer)(
            s, s.cfg, host="127.0.0.1", port=0)
        srv.start()
        try:
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}/perfz")
            return ei.value.code, json.loads(ei.value.read())
        finally:
            srv.stop()

    assert both(run) == (500, {"error": "RuntimeError: boom"})


# -- the Prometheus families --------------------------------------------------------------------
FAMILIES = ("vtpu_cycle_phase_seconds", "vtpu_lock_wait_seconds",
            "vtpu_lock_hold_seconds", "vtpu_lock_acquires",
            "vtpu_lock_sampled_acquires", "vtpu_informer_lag_seconds",
            "vtpu_informer_resync_seconds", "vtpu_gc_collections",
            "vtpu_filter_commit_conflicts", "vtpu_filter_worker_pool_size",
            "vtpu_filter_workers_busy_peak", "vtpu_decision_write_failures")


def family_shapes(side, built, monkeypatch, filters=1):
    from prometheus_client import CollectorRegistry, generate_latest
    from prometheus_client.parser import text_string_to_metric_families

    for mod in (ttrace, jtrace):
        monkeypatch.setattr(mod, "_GLOBAL", mod.Tracer())
    pkg = PKGS[side]
    kube, s, names = make_env(pkg, built, n_nodes=2)
    for i in range(filters):
        p = pkg.pod(f"m{i}", f"mu{i}", mem="500")
        kube.create_pod(p)
        assert s.filter(p, names).node
    if side == "port":
        text = expo.render(tmetrics.ClusterCollector(s).collect())
    else:
        registry = CollectorRegistry()
        registry.register(jmetrics.ClusterCollector(s))
        text = generate_latest(registry).decode()
    fams = {f.name: f for f in text_string_to_metric_families(text)}
    return {name: dict(
        type=fams[name].type, doc=fams[name].documentation,
        samples=sorted((x.name, tuple(sorted(x.labels.items())))
                       for x in fams[name].samples))
        for name in FAMILIES}, text


@pytest.mark.parametrize("filters", [0, 1])
def test_the_families_read_as_the_jax_collector(fresh, built, monkeypatch,
                                                filters):
    """Cold (no Filter) and after one: each family's name, type, help and
    samples' names and labels (phases, locks, generations, reasons, the
    bucket bounds) equal JAX's; the values are timings and are not
    compared."""
    got = {}
    for side in SIDES:
        got[side], text = family_shapes(side, built, monkeypatch, filters)
        assert 'vtpu_gc_collections_total{generation="2"}' in text
        assert 'vtpu_lock_acquires_total{lock="commit"}' in text
        assert "vtpu_informer_lag_seconds" in text
        if filters:
            assert 'vtpu_lock_hold_seconds_count{lock="pods"}' in text
    assert got["port"] == got["jax"]


# -- the batched cycles --------------------------------------------------------------------------
def batch_cycle(side, built, n=6):
    pkg = PKGS[side]
    kube, s, names = make_env(pkg, built, n_nodes=2, filter_batch=True)
    items = []
    for i in range(n):
        p = pkg.pod(f"p{i}", f"u{i}", mem="500")
        kube.create_pod(p)
        items.append((p, names))
    assert all(r.node for r in s.filter_many(items))
    return s, names


def cycle_phases(side, built):
    s, names = batch_cycle(side, built)
    doc = s.export_perf()
    first = {n: doc["phases"][n]["count"] for n in (
        "cycle-total", "snapshot", "columnar-rebuild", "vector-eval",
        "solve", "group-commit", "drain")}
    ticks = [t for t in doc["slow_ticks"] if t["name"] == "batch-cycle"]
    pkg = PKGS[side]
    p = pkg.pod("w", "wu", mem="500")
    s.client.create_pod(p)
    assert s.filter_many([(p, names)])[0].node
    doc = s.export_perf()
    return dict(
        first=first, tick_pods=ticks[0]["pods"],
        tick_phases=sorted(ticks[0]["phases_ms"]),
        informer=doc["phases"]["informer-apply"]["count"] >= 1,
        writes=doc["phases"]["decision-write"]["count"],
        rebuilds=doc["phases"]["columnar-rebuild"]["count"],
        refreshes=doc["phases"]["columnar-refresh"]["count"],
        counters={k: doc["counters"][k] for k in (
            "batch_cycles", "batch_fallbacks", "columnar_full_rebuilds",
            "class_evals_full", "class_rows_patched")})


def test_batch_cycle_phase_decomposition(fresh, built):
    """Six pods in one cycle, then one more: each phase of the cycle
    recorded once a cycle, the first a full columnar rebuild and the
    second an incremental refresh, the tick journal holding the cycle's
    split, one decision-write sample a flush; equal on both."""
    got = both(lambda side: cycle_phases(side, built))
    assert got["first"] == {"cycle-total": 1, "snapshot": 1,
                            "columnar-rebuild": 1, "vector-eval": 1,
                            "solve": 1, "group-commit": 1, "drain": 1}
    assert got["tick_pods"] == 6
    assert got["tick_phases"] == ["columnar-rebuild", "group-commit",
                                  "snapshot", "solve", "vector-eval"]
    assert got["informer"] and got["writes"] == 2
    assert (got["rebuilds"], got["refreshes"]) == (1, 1)
    assert got["counters"]["batch_cycles"] == 2
    assert got["counters"]["columnar_full_rebuilds"] == 1


def fallback_phase(side, built):
    pkg = PKGS[side]
    kube, s, names = make_env(pkg, built, n_nodes=1, filter_batch=True)
    fat = pkg.pod("fat", "uf", mem="999999")
    kube.create_pod(fat)
    assert s.filter_many([(fat, names)])[0].node is None
    doc = s.export_perf()
    [tick] = [t for t in doc["slow_ticks"] if t["name"] == "batch-cycle"]
    return dict(fallback=doc["phases"]["fallback"]["count"],
                in_tick="fallback" in tick["phases_ms"],
                tick_fallbacks=tick["fallbacks"],
                counted=doc["counters"]["batch_fallbacks"])


def test_the_fallback_phase_is_recorded(fresh, built):
    assert both(lambda side: fallback_phase(side, built)) == dict(
        fallback=1, in_tick=True, tick_fallbacks=1, counted=1)


def drain_age(side, built):
    pkg = PKGS[side]
    kube, s, names = make_env(pkg, built, n_nodes=2, filter_batch=True)
    reg = MODS[side].registry()
    reg.set_gauge("drain_age_s", 4.2)
    p = pkg.pod("da1", "dau1", mem="500")
    kube.create_pod(p)
    assert s.filter(p, names).node
    gate = reg.gauge("drain_age_s")
    reg.set_gauge("drain_age_s", 4.2)
    p2 = pkg.pod("da2", "dau2", mem="500")
    kube.create_pod(p2)
    assert s.filter_many([(p2, names)])[0].node
    return gate, reg.gauge("drain_age_s"), reg.gauge("pending_queue_depth")


def test_drain_age_resets_when_queue_drains(fresh, built):
    """The drain age is a current wait: the gate's leader zeroes it when
    its queue drains, and filter_many once its backlog is decided."""
    assert both(lambda side: drain_age(side, built)) == (0.0, 0.0, 0)


def disjoint_drain(side, built):
    pkg = PKGS[side]
    res = pkg.res
    kube, s, names = make_env(pkg, built, n_nodes=2, filter_batch=True)
    multi = {"metadata": {"name": "mc", "namespace": "default",
                          "uid": "mcu", "annotations": {}},
             "spec": {"containers": [
                 {"name": c, "resources": {"limits": {
                     res: "1", f"{res}mem": "500"}}} for c in ("a", "b")]}}
    single = pkg.pod("sg", "usg", mem="500")
    for p in (multi, single):
        kube.create_pod(p)
    real = s.filter

    def slow_filter(pod, node_names):
        time.sleep(0.05)
        return real(pod, node_names)

    s.filter = slow_filter
    assert all(r.node for r in s.filter_many([(multi, names),
                                              (single, names)]))
    drain = MODS[side].registry().phase("drain").window()
    return drain["n"], drain["max_s"] < 0.05


def test_drain_excludes_inline_per_pod_decisions(fresh, built):
    """A multi-container pod decided inline in a drain records its own
    phases: its (slowed) time stays out of the drain ring."""
    assert both(lambda side: disjoint_drain(side, built)) == (1, True)


def phase_sums(side, built):
    s, _names = batch_cycle(side, built, n=12)
    ticks = [t for t in MODS[side].registry().slow_ticks(top=16)
             if t["name"] == "batch-cycle"]
    return len(ticks), all(sum(t["phases_ms"].values())
                           <= t["total_ms"] + 0.5 for t in ticks)


def test_batch_cycle_phases_sum_to_total(fresh, built):
    """A cycle's phase splits are disjoint: they sum to its total."""
    assert both(lambda side: phase_sums(side, built)) == (1, True)


def batch_perf_doc(side, built):
    s, _names = batch_cycle(side, built, n=4)
    doc = s.export_perf()
    return dict(keys=sorted(doc), counters=doc["counters"],
                workers=doc["solve_workers"],
                pending=doc["queue"]["pending_depth"],
                phases=sorted(n for n in doc["phases"] if n != "gc-pause"))


def test_export_perf_batch_sections_are_the_jax_ones(fresh, built):
    """``/perfz`` after one cycle: the batch counters from the live
    engine and the solve-worker section (the pool off) equal JAX's."""
    got = both(lambda side: batch_perf_doc(side, built))
    assert got["counters"]["batch_cycles"] == 1
    assert got["counters"]["class_evals_full"] == 1
    assert got["pending"] == 0
    assert got["workers"]["configured"] == 0
