"""The port's Prometheus surface against the JAX package's, on the CPU.

- **Node collector.**  The port's ``NodeCollector`` and the JAX one over the
  regions the workload children of ``tests/test_torch_monitor.py`` write
  through each native library, every tick by hand on a SimClock; both
  texts parsed with ``prometheus_client``'s parser must hold the same
  families, label sets and values.  The one exception is the wall-clock
  histogram ``vtpu_monitor_phase_latency_seconds``: its bucket bounds and
  counts are compared, not its sums.
- **Cluster collector.**  ``ClusterCollector`` against the JAX serial
  path (``optimistic_commit=False``) after the Filter, Bind, register,
  preempt, quarantine, rescue and usage scripts of
  ``tests/test_torch_scheduler.py`` and ``tests/test_torch_preempt.py``.
  Exceptions: ``vtpu_scheduling_phase_latency_seconds`` (wall clock:
  bounds and counts); the performance observatory's timed families
  (``OBSERVATORY_TIMED``: their samples' names and labels, not their
  values) and its lock counters (equal but for the "nodes" lock, which
  the JAX defrag tick takes more often), each side on a fresh registry; the
  families of ``A5_FAMILIES``, which the port emits zero-valued or
  empty, as the JAX collector does with the subsystem off; the rejection
  reasons read "GPU" for "TPU" (the name table of
  ``tests/test_torch_scheduler.py``).  The placement families
  (reserved cards, the defragmenter's counters) are compared by value,
  with the defragmenter off and with a plan in flight.
- **Writer.**  ``util/exposition.py`` writes what ``generate_latest``
  writes, escapes included.
- **vgpu-smi.**  ``tests/test_vtpu_cluster.py``'s ``cluster_info``,
  ``parse_prom`` and ``top`` cases on the port's own text, and
  ``tests/test_monitor.py``'s container and node views over a port region.
- **Forecast.**  ``tests/test_forecast.py``'s ``SeriesForecaster`` cases,
  each also held to the JAX forecaster on the same series
  (``DemandForecaster`` waits for ROADMAP A.5).
"""

import json
import math
import random
import subprocess
import sys
from pathlib import Path

import pytest
from prometheus_client import CollectorRegistry, generate_latest
from prometheus_client.core import (CounterMetricFamily as PCounter,
                                    GaugeMetricFamily as PGauge,
                                    HistogramMetricFamily as PHistogram)
from prometheus_client.parser import text_string_to_metric_families
from prometheus_client.registry import Collector

from chip_smoke import free_port
from k8s_vgpu_scheduler_tpu.accounting.forecast import \
    SeriesForecaster as JForecaster
from k8s_vgpu_scheduler_tpu.accounting.planner import synth_demand
from k8s_vgpu_scheduler_tpu.cmd import vtpu_smi as jsmi
from k8s_vgpu_scheduler_tpu.health.faults import SimClock
from k8s_vgpu_scheduler_tpu.monitor import metrics as jnode
from k8s_vgpu_scheduler_tpu.scheduler import metrics as jcluster
from k8s_vgpu_scheduler_tpu.tpulib import MockBackend as JMock
from k8s_vgpu_scheduler_tpu.util import perf as jperf
from k8s_vgpu_scheduler_tpu.util import trace as jtrace
from k8s_vgpu_scheduler_tpu_torch.accounting.forecast import (
    ForecastConfig, SeriesForecaster)
from k8s_vgpu_scheduler_tpu_torch.cmd import vgpu_smi
from k8s_vgpu_scheduler_tpu_torch.monitor import metrics as tnode
from k8s_vgpu_scheduler_tpu_torch.scheduler import metrics as tcluster
from k8s_vgpu_scheduler_tpu_torch.tpulib import MockBackend as TMock
from k8s_vgpu_scheduler_tpu_torch.util import exposition as expo
from k8s_vgpu_scheduler_tpu_torch.util import trace as ttrace
from k8s_vgpu_scheduler_tpu_torch.util import perf as tperf
from tests import test_torch_preempt as tp
from tests import test_torch_scheduler as ts
from tests.test_torch_monitor import (  # noqa: F401 — libs, workloads
    PORT, STACKS, TPU, UUIDS, libs, loop_for, workloads)

MIB = 1 << 20


@pytest.fixture
def tracers(monkeypatch):
    """Fresh process-global tracers on both sides."""
    out = {}
    for name, mod in (("port", ttrace), ("jax", jtrace)):
        out[name] = mod.Tracer()
        monkeypatch.setattr(mod, "_GLOBAL", out[name])
    return out


def jax_text(collector) -> str:
    class _C(Collector):
        def collect(self):
            return collector.collect()

    registry = CollectorRegistry()
    registry.register(_C())
    return generate_latest(registry).decode()


def families(text: str) -> dict:
    return {f.name: f for f in text_string_to_metric_families(text)}


def samples(fam, rename=lambda labels: labels) -> list:
    return sorted((s.name, tuple(sorted(rename(dict(s.labels)).items())),
                   s.value) for s in fam.samples)


def hist_shape(fam) -> list:
    """A wall-clock histogram's bucket bounds and counts: its samples
    without their ``_bucket`` counts and ``_sum`` values."""
    return sorted((s.name, tuple(sorted(s.labels.items())),
                   s.value if s.name.endswith("_count") else None)
                  for s in fam.samples if not s.name.endswith("_sum"))


#: The performance observatory's families whose values are timings: held
#: by their samples' names and labels (phases, locks, bucket bounds), not
#: by value.
OBSERVATORY_TIMED = ("vtpu_cycle_phase_seconds", "vtpu_lock_wait_seconds",
                     "vtpu_lock_hold_seconds", "vtpu_informer_lag_seconds",
                     "vtpu_informer_resync_seconds")


#: The lock counters: equal per lock but "nodes", which the JAX package
#: takes more often on a defrag tick (without the defragmenter the counts
#: are equal, the shard layer's scrape included).  There the JAX count is
#: at least the port's.
OBSERVATORY_LOCK_COUNTS = ("vtpu_lock_acquires", "vtpu_lock_sampled_acquires")


def labels_shape(fam) -> list:
    """A timing family's samples without their values."""
    return sorted((s.name, tuple(sorted(s.labels.items())))
                  for s in fam.samples)


def same_lock_counts(mine, fam) -> None:
    got = {s.labels["lock"]: s.value for s in mine.samples}
    want = {s.labels["lock"]: s.value for s in fam.samples}
    assert set(got) == set(want), (got, want)
    assert {k: v for k, v in got.items() if k != "nodes"} == \
        {k: v for k, v in want.items() if k != "nodes"}, (got, want)
    assert want["nodes"] >= got["nodes"], (got, want)


def same_families(port_text: str, jax_text_: str, wall=(), a5=(),
                  rename=None) -> dict:
    """Both texts hold the same families in the same order, with the
    same help and type; every family's samples equal, but the wall-clock
    ones by ``hist_shape``, the observatory's timings by
    ``labels_shape`` and the A.5 ones (port zero or empty)."""
    got, want = families(port_text), families(jax_text_)
    assert list(got) == list(want)
    for name, fam in want.items():
        mine = got[name]
        assert (mine.documentation, mine.type) == \
            (fam.documentation, fam.type), name
        if name in a5:
            assert all(s.value == 0 or s.name.endswith("_bucket")
                       and s.value == 0 for s in mine.samples), name
        elif name in wall:
            assert hist_shape(mine) == hist_shape(fam), name
        elif name in OBSERVATORY_TIMED:
            assert labels_shape(mine) == labels_shape(fam), name
        elif name in OBSERVATORY_LOCK_COUNTS:
            same_lock_counts(mine, fam)
        else:
            ren = (rename or {}).get(name, lambda labels: labels)
            assert samples(mine) == samples(fam, ren), name
    return got


# -- the node collector -------------------------------------------------------------

FIXTURE = {"generation": "h100", "mesh": [2], "hbm_mib": 81079,
           "chips": [{"coords": [i], "uuid": u, "type": "NVIDIA-h100"}
                     for i, u in enumerate(UUIDS)]}


def node_texts(flavor, libs, root, workloads):
    """Three pods (flat priority pair on card 0, a QoS pair on card 1),
    ticked by hand with launches in between; the node text after each."""
    pods = {
        "hi": workloads(flavor, libs, root, "uid1_hi", [UUIDS[0]], 0),
        "lo": workloads(flavor, libs, root, "uid2_lo", [UUIDS[0]], 1,
                        alloc_mib=300),
        "lc": workloads(flavor, libs, root, "uid3_lc", [UUIDS[1]], 0,
                        qos="latency-critical"),
        "be": workloads(flavor, libs, root, "uid4_be", [UUIDS[1]], 1,
                        qos="best-effort"),
    }
    reader, fb, sampler_mod = STACKS[flavor.name]
    loop = loop_for(flavor, libs, root)
    clock = SimClock()
    sampler = sampler_mod.UsageSampler(loop, clock=clock)
    if flavor is PORT:
        collector = tnode.NodeCollector(loop, TMock(FIXTURE), "node-x",
                                        now=clock, sampler=sampler)
        tracer = ttrace
    else:
        collector = jnode.NodeCollector(loop, JMock(FIXTURE), "node-x",
                                        now=clock, sampler=sampler)
        tracer = jtrace
    texts = []
    try:
        for step, active in enumerate((["lo"], ["hi", "lo"], ["lc", "be"],
                                       ["lc"], [], ["be"])):
            for name in active:
                pods[name].dispatch(2000 if name == "lc" else 0)
            with tracer.tracer().span("region-scan") as sp:
                loop.tick()
                sampler.sample()
                sp.set("containers", len(loop.containers))
            clock.advance(30.0)
            if step == 3:
                pods["hi"].stop()
            texts.append(expo.render(collector.collect())
                         if flavor is PORT else jax_text(collector))
    finally:
        loop.close()
        for w in pods.values():
            w.stop()
    return texts


def test_the_node_collector_reads_as_the_jax_one(tmp_path, libs, workloads,
                                                 tracers):
    port = node_texts(PORT, libs, tmp_path / "port", workloads)
    jax = node_texts(TPU, libs, tmp_path / "tpu", workloads)
    assert len(port) == len(jax) == 6
    for i, (p, j) in enumerate(zip(port, jax)):
        got = same_families(p, j, wall={"vtpu_monitor_phase_latency_seconds"})
        assert got["vtpu_monitor_phase_latency_seconds"].samples, i
    fams = families(port[-1])
    assert {s.labels["deviceuuid"]: s.value for s in
            fams["host_tpu_memory_total_mib"].samples} == {
        u: 81079 for u in UUIDS}
    switch = {s.labels["container"]: s.value
              for s in families(port[1])["vtpu_utilization_switch"].samples}
    assert switch["uid2_lo"] == 1 and switch["uid1_hi"] == 0
    weights = {s.labels["class"]: s.value for s in
               families(port[3])["vtpu_qos_duty_weight"].samples}
    assert set(weights) == {"latency-critical", "best-effort"}


def test_the_node_collector_without_a_backend_or_sampler(tmp_path, libs,
                                                         workloads, tracers):
    texts = {}
    for flavor in (PORT, TPU):
        root = tmp_path / flavor.name
        w = workloads(flavor, libs, root, "uid1_p", [UUIDS[0]], 0)
        loop = loop_for(flavor, libs, root)
        loop.tick()
        mod = tnode if flavor is PORT else jnode
        c = mod.NodeCollector(loop, None, "n")
        texts[flavor.name] = (expo.render(c.collect()) if flavor is PORT
                              else jax_text(c))
        loop.close()
        w.stop()
    same_families(texts["port"], texts["tpu"],
                  wall={"vtpu_monitor_phase_latency_seconds"})


def test_the_node_exporter_serves_on_a_free_port(tmp_path, libs, workloads):
    import urllib.request

    w = workloads(PORT, libs, tmp_path, "uid1_p", [UUIDS[0]], 0)
    loop = loop_for(PORT, libs, tmp_path)
    loop.tick()
    srv = tnode.start_metrics_server(loop, None, "n", port=0,
                                     host="127.0.0.1")
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/metrics", timeout=10) as r:
            text = r.read().decode()
            assert r.headers["Content-Type"].startswith("text/plain")
        assert 'vtpu_device_memory_limit_bytes{container="uid1_p",' in text
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/nope",
                                   timeout=10)
    finally:
        srv.stop()
        loop.close()
        w.stop()


def test_the_monitor_serves_its_surfaces_through_one_function(
        tmp_path, libs, workloads):
    """cmd/monitor.serve: the exporter, NodeTPUInfo and the debug server
    over one loop and sampler, each port its own, all stopped."""
    import urllib.request

    import grpc

    from k8s_vgpu_scheduler_tpu_torch.accounting import UsageSampler
    from k8s_vgpu_scheduler_tpu_torch.api import noderpc_pb2 as pb
    from k8s_vgpu_scheduler_tpu_torch.cmd import monitor
    from k8s_vgpu_scheduler_tpu_torch.monitor.noderpc import node_tpu_stub

    w = workloads(PORT, libs, tmp_path, "uid1_p", [UUIDS[0]], 0)
    loop = loop_for(PORT, libs, tmp_path)
    sampler = UsageSampler(loop)
    monitor.tick(loop, sampler)
    serving = monitor.serve(loop, sampler, TMock(FIXTURE), "node-x",
                            metrics_port=0, grpc_port=free_port(),
                            debug_port=free_port(), metrics_host="127.0.0.1")
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{serving.metrics.port}/metrics",
                timeout=10) as r:
            text = r.read().decode()
        assert 'host_tpu_memory_total_mib{deviceuuid="' + UUIDS[0] + \
            '",node="node-x"} 81079.0' in text
        channel = grpc.insecure_channel(f"127.0.0.1:{serving.rpc_port}")
        reply = node_tpu_stub(channel)(pb.GetNodeTPURequest(), timeout=10)
        channel.close()
        assert [u.ctrkey for u in reply.usages] == ["uid1_p"]
        assert [c.ctrkey for c in reply.usage.counters] == ["uid1_p"]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{serving.debug.port}/debug/vars",
                timeout=10) as r:
            assert json.loads(r.read())["pid"] > 0
    finally:
        serving.stop()
        loop.close()
        w.stop()
    off = monitor.serve(loop_for(PORT, libs, tmp_path / "x"), sampler, None,
                        "n", metrics_port=0, grpc_port=0, debug_port=0,
                        metrics_host="127.0.0.1")
    assert off.rpc is None and off.debug is None and off.rpc_port == 0
    off.stop()


# -- the cluster collector ---------------------------------------------------------


class MetricsSide(tp.PreemptSide):
    """The parity Side with the ops that move the collector's sources:
    usage rows over the register stream, a rescue sweep, a quarantine."""

    def report(self, node, rows):
        self.s.observe_registration(node, self.info(node), usage=rows)

    def sweep(self):
        self.s.rescuer.sweep()

    def quarantine(self, node, card):
        self.s.quarantine.quarantine(node, self.fixtures[node]["chips"][
            card]["uuid"], "flap")


def row(ctrkey, chip_seconds, hbm=0.0, chips=1, active=True, qos="",
        weight=100, wait=0.0, hist=()):
    return {"ctrkey": ctrkey, "chips": chips, "active": active,
            "oversubscribe": False, "chip_seconds": chip_seconds,
            "hbm_byte_seconds": hbm, "throttled_seconds": 0.0,
            "oversub_spill_seconds": 0.0, "window_s": 1.0,
            "qos_class": qos, "qos_weight_pct": weight,
            "qos_wait_seconds_total": wait, "qos_wait_hist": list(hist)}


F = "filter"
ACCOUNTING = (ts.FLEET, {"enable_preemption": True,
                         "efficiency_window_s": 60.0,
                         "idle_grant_grace_s": 20.0}, [
    ("create", ts.pod("a", ts.limits(mem=24000, cores=30),
                      anns={"vtpu.dev/qos": "latency-critical"})),
    ("create", ts.pod("b", ts.limits(nums=2, mem=20000))),
    (F, "a"), (F, "b", ["h100-1"]), ("bind", "b", "h100-1"),
    ("report", "h100-0", [row("uid-a_a", 1.0, 5e9, qos="latency-critical",
                              weight=130, wait=0.25, hist=[3, 1])]),
    ("advance", 30.0),
    ("report", "h100-0", [row("uid-a_a", 20.0, 9e9, qos="latency-critical",
                              weight=120, wait=0.5, hist=[5, 2])]),
    ("report", "h100-1", [row("uid-b_b", 0.0, 0.0, chips=2, active=False),
                          row("uid-gone_gone", 4.0, 1e9)]),
    ("advance", 30.0),
    ("report", "h100-1", [row("uid-b_b", 0.0, 0.0, chips=2, active=False)]),
    ("health", "h100-2", 1, False), ("quarantine", "mixed", 5),
    ("advance", 16.0), ("beat", "h100-0"), ("sweep",),
    ("create", ts.pod("c", ts.limits(nums=8, mem=1000))),
    (F, "c", ["h100-2", "ghost"])])


CLUSTER = {**{f"scheduler:{k}": (ts.FLEET, *v)
              for k, v in ts.SCENARIOS.items()},
           **{f"preempt:{k}": v for k, v in tp.SCENARIOS.items()},
           "accounting": ACCOUNTING}


def cluster_text(port: bool, fleet, cfg, script) -> str:
    side = MetricsSide(port, fleet, **cfg)
    for op, *args in script:
        getattr(side, op)(*args)
    try:
        if port:
            return expo.render(tcluster.ClusterCollector(side.s).collect())
        return jax_text(jcluster.ClusterCollector(side.s))
    finally:
        if hasattr(side.s, "close"):
            side.s.close()


def gpu_reasons(labels):
    return {k: v.replace("TPU", "GPU") for k, v in labels.items()}


@pytest.mark.parametrize("name", sorted(CLUSTER))
def test_the_cluster_collector_reads_as_the_jax_one(name, monkeypatch):
    fleet, cfg, script = CLUSTER[name]
    texts = {}
    for port in (True, False):
        fresh_tracers(monkeypatch)
        texts[port] = cluster_text(port, fleet, cfg, script)
    got = same_families(
        texts[True], texts[False],
        wall={"vtpu_scheduling_phase_latency_seconds"},
        a5=set(tcluster.A5_FAMILIES),
        rename={"vtpu_filter_rejections": gpu_reasons})
    if name == "accounting":
        values = {(s.name, tuple(sorted(s.labels.items()))): s.value
                  for f in got.values() for s in f.samples}
        assert values[("vtpu_usage_chip_seconds_total", (
            ("podname", "a"), ("podnamespace", "default")))] == 20.0
        assert values[("vtpu_usage_chip_seconds_total", (
            ("podname", "gone"), ("podnamespace", "(unresolved)")))] == 4.0
        assert values[("vtpu_idle_grants", ())] == 1.0
        assert values[("vtpu_chips_quarantined", ())] == 1.0
        assert values[("vtpu_pod_qos_duty_weight", (
            ("class", "latency-critical"), ("podname", "a"),
            ("podnamespace", "default")))] == 120.0


def fresh_tracers(monkeypatch):
    """Fresh process-global tracers and performance registries, so each
    side's text holds only its own run."""
    for mod in (ttrace, jtrace):
        monkeypatch.setattr(mod, "_GLOBAL", mod.Tracer())
    for mod in (tperf, jperf):
        monkeypatch.setattr(mod, "_GLOBAL", mod.PerfRegistry())


def test_the_fabric_fleet_reads_slice_availability_as_jax(monkeypatch):
    script = [("create", ts.pod("r", ts.limits(nums=4, mem=1000),
                                anns=ts.GUAR)), (F, "r", ts.RING),
              ("create", ts.pod("g", ts.limits(nums=2, mem=1000))),
              (F, "g", ts.GRID)]
    texts = {}
    for port in (True, False):
        fresh_tracers(monkeypatch)
        texts[port] = cluster_text(port, ts.TOPO_FLEET, {}, script)
    got = same_families(texts[True], texts[False],
                        wall={"vtpu_scheduling_phase_latency_seconds"},
                        a5=set(tcluster.A5_FAMILIES))
    avail = {s.labels["shape"]: s.value
             for s in got["vtpu_slice_availability"].samples}
    assert avail["2"] > 0 and set(avail) == {"2", "4", "8", "16", "32", "64"}
    assert got["vtpu_fleet_max_free_box"].samples[0].value > 0


A5_ITEMS = {
    "fleet audit": ["vtpu_audit_findings", "vtpu_audit_sweeps",
                    "vtpu_audit_sweep_seconds",
                    "vtpu_audit_last_clean_timestamp"],
    "SLO engine": ["vtpu_slo_attainment_ratio",
                   "vtpu_slo_error_budget_remaining_ratio",
                   "vtpu_slo_burn_rate", "vtpu_slo_burn_alerts"],
}

#: The families the extender's per-pod throughput machinery fills (ROADMAP
#: A.5 throughput): the optimistic commit, the candidate-evaluation pool,
#: the performance observatory and the decision writer.
THROUGHPUT_FAMILIES = (
    "vtpu_filter_commit_conflicts", "vtpu_filter_worker_pool_size",
    "vtpu_filter_workers_busy_peak", "vtpu_cycle_phase_seconds",
    "vtpu_lock_wait_seconds", "vtpu_lock_hold_seconds",
    "vtpu_lock_acquires", "vtpu_lock_sampled_acquires",
    "vtpu_informer_lag_seconds", "vtpu_informer_resync_seconds",
    "vtpu_gc_collections", "vtpu_decision_write_failures")


#: The placement families (ROADMAP A.5 placement): filled since the
#: reservations and the defragmenter came, read as the JAX collector reads
#: them.
PLACEMENT_FAMILIES = ("vtpu_reserved_chips", "vtpu_defrag_plans",
                      "vtpu_defrag_migrations", "vtpu_defrag_completed",
                      "vtpu_defrag_aborted")


@pytest.mark.parametrize("case", ["defrag_off", "plan_in_flight"])
def test_the_placement_families_read_as_the_jax_collector(case,
                                                          monkeypatch):
    """tests/test_torch_defrag.py's fragmented node and blocked 4-card
    pod, one tick, then both collectors: every family equal (the A.5 ones
    zero), the five placement families by value.  With the defragmenter
    off nothing is planned or reserved; with it on, the plan is in flight
    (4 cards reserved, one plan, its victims asked, none completed)."""
    from tests.test_torch_defrag import Side as DefragSide
    from tests.test_torch_defrag import exclusive_pod, fragment

    texts = {}
    for port in (True, False):
        fresh_tracers(monkeypatch)
        side = DefragSide(port, enable_defrag=case == "plan_in_flight")
        try:
            fragment(side, side.names[0])
            big = exclusive_pod("big", "ubig", gpu=4)
            side.create(big)
            assert side.filter(big)["node"] is None
            side.tick()
            texts[port] = (expo.render(
                tcluster.ClusterCollector(side.s).collect()) if port
                else jax_text(jcluster.ClusterCollector(side.s)))
        finally:
            side.close()
    got = same_families(texts[True], texts[False],
                        wall={"vtpu_scheduling_phase_latency_seconds"},
                        a5=set(tcluster.A5_FAMILIES),
                        rename={"vtpu_filter_rejections": gpu_reasons})
    values = {name: got[name].samples[0].value
              for name in PLACEMENT_FAMILIES}
    if case == "defrag_off":
        assert set(values.values()) == {0}
    else:
        assert values["vtpu_reserved_chips"] == 4
        assert values["vtpu_defrag_plans"] == 1
        assert values["vtpu_defrag_migrations"] >= 1
        assert values["vtpu_defrag_completed"] == 0
        assert values["vtpu_defrag_aborted"] == 0
    assert not set(PLACEMENT_FAMILIES) & set(tcluster.A5_FAMILIES)


#: The batched cycles' and the solve workers' families (ROADMAP A.5
#: throughput, its batch half): filled from the live batch engine.
BATCH_FAMILIES = ("vtpu_filter_batch_size", "vtpu_filter_batch_cycle_seconds",
                  "vtpu_filter_batch_fallbacks", "vtpu_pending_queue_depth",
                  "vtpu_solve_workers", "vtpu_solve_worker_restarts",
                  "vtpu_solve_worker_eval_seconds")


def batch_texts(monkeypatch) -> dict:
    """Each package's cluster text after real batched cycles: ten nodes,
    one solve worker (ten rows pass the pool's MIN_ROWS), a drain of
    twelve pods of two request classes and one pod of a third that fits
    nowhere, in chunks of five (three cycles, three offloaded
    evaluations), then one pod whose group commit loses to an informer
    add."""
    from tests.test_torch_batch import S, build_fleet

    texts = {}
    built = []
    try:
        for side in ("port", "jax"):
            fresh_tracers(monkeypatch)
            sd = S[side]
            pkg = sd.pkg
            kube, s, names = build_fleet(side, built, n_nodes=10,
                                         filter_batch=True, batch_max=5,
                                         solve_workers=1)
            items = []
            for i in range(12):
                p = pkg.pod(f"p{i}", f"u{i}", mem=("1000", "2000")[i % 2])
                kube.create_pod(p)
                items.append((p, names))
            fat = pkg.pod("fat", "ufat", mem="999999")
            kube.create_pod(fat)
            items.append((fat, names))
            assert [r.node is not None for r in s.filter_many(items)] == \
                [True] * 12 + [False]
            real = s.pods.add_pods_group
            fired = []

            def group(infos, node, expected_rev, s=s, real=real,
                      fired=fired, pkg=pkg, sd=sd):
                if not fired:
                    fired.append(node)
                    s.pods.add_pod(pkg.PodInfo(
                        uid="rival", name="rival", namespace="default",
                        node=node, devices=[[pkg.ContainerDevice(
                            uuid=f"{node}-chip-0", type=sd.types[0],
                            usedmem=500, usedcores=0)]]))
                return real(infos, node, expected_rev)

            s.pods.add_pods_group = group
            late = pkg.pod("late", "ulate", mem="1000")
            kube.create_pod(late)
            assert s.filter_many([(late, names)])[0].node
            texts[side] = (expo.render(tcluster.ClusterCollector(s)
                                       .collect()) if side == "port"
                           else jax_text(jcluster.ClusterCollector(s)))
    finally:
        for s in built:
            s.close()
    return texts


def test_the_batch_families_after_real_cycles(monkeypatch):
    """The seven families after real cycles: each one's name, type and
    help, and its samples' names and labels (the size and latency bucket
    bounds, the fallback reasons, the worker label) equal JAX's; the
    sizes, the fallbacks, the queue depth, the live workers and restarts
    and each worker's evaluation count by value (the latencies are
    timings)."""
    texts = batch_texts(monkeypatch)
    got, want = families(texts["port"]), families(texts["jax"])
    for name in BATCH_FAMILIES:
        assert (got[name].documentation, got[name].type) == \
            (want[name].documentation, want[name].type), name
        if name in ("vtpu_filter_batch_cycle_seconds",
                    "vtpu_solve_worker_eval_seconds"):
            assert hist_shape(got[name]) == hist_shape(want[name]), name
        else:
            assert samples(got[name]) == samples(want[name]), name
    values = {(s.name, tuple(sorted(s.labels.items()))): s.value
              for n in BATCH_FAMILIES for s in got[n].samples}
    assert values[("vtpu_filter_batch_size_count", ())] == 4
    assert values[("vtpu_filter_batch_size_sum", ())] == 14
    assert values[("vtpu_filter_batch_size_bucket", (("le", "4.0"),))] == 2
    assert values[("vtpu_filter_batch_cycle_seconds_count", ())] == 4
    assert values[("vtpu_filter_batch_fallbacks_total",
                   (("reason", "no-fit"),))] == 1
    assert values[("vtpu_filter_batch_fallbacks_total",
                   (("reason", "commit-conflict"),))] == 1
    assert values[("vtpu_pending_queue_depth", ())] == 0
    assert values[("vtpu_solve_workers", ())] == 1
    assert values[("vtpu_solve_worker_restarts_total", ())] == 0
    assert values[("vtpu_solve_worker_eval_seconds_count",
                   (("worker", "0"),))] == 3
    assert not set(BATCH_FAMILIES) & set(tcluster.A5_FAMILIES)


def test_every_a5_family_is_listed_with_the_item_that_fills_it(monkeypatch):
    assert tcluster.A5_FAMILIES == {name: item for item, names in
                                    A5_ITEMS.items() for name in names}
    fresh_tracers(monkeypatch)
    text = cluster_text(True, ts.FLEET, {}, [])
    fams = families(text)
    assert set(tcluster.A5_FAMILIES) <= set(fams)
    for name in tcluster.A5_FAMILIES:
        assert all(s.value == 0 for s in fams[name].samples), name
    assert not set(THROUGHPUT_FAMILIES) & set(tcluster.A5_FAMILIES)
    assert set(THROUGHPUT_FAMILIES) <= set(fams)
    # Filled: the fleet's registrations and the scrape itself took the
    # scheduler's locks.
    acquired = {s.labels["lock"] for s in fams["vtpu_lock_acquires"].samples
                if s.value > 0}
    assert {"nodes", "leases"} <= acquired, acquired
    # The fixed label sets the JAX collector keeps with the subsystem off.
    labels = {name: sorted(tuple(sorted(s.labels.items()))
                           for s in fams[name].samples)
              for name in ("vtpu_resizes", "vtpu_elastic_pods",
                           "vtpu_audit_sweeps", "vtpu_slo_burn_alerts",
                           "vtpu_decision_write_failures",
                           "vtpu_gc_collections")}
    assert len(labels["vtpu_resizes"]) == 8
    assert [dict(x)["state"] for x in labels["vtpu_elastic_pods"]] == \
        sorted(["at-max", "shrunk", "resizing", "pending"])
    assert [dict(x)["mode"] for x in labels["vtpu_audit_sweeps"]] == \
        ["delta", "full"]
    assert [dict(x)["severity"] for x in labels["vtpu_slo_burn_alerts"]] \
        == ["page", "ticket"]
    assert [dict(x)["reason"] for x in
            labels["vtpu_decision_write_failures"]] == \
        ["shard-cas", "shard-fence", "transport"]
    assert len(labels["vtpu_gc_collections"]) == 3


def test_the_extender_exporter_serves_on_a_free_port():
    import urllib.request

    side = MetricsSide(True, ts.FLEET)
    srv = tcluster.start_metrics_server(side.s, port=0, host="127.0.0.1")
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/metrics", timeout=10) as r:
            text = r.read().decode()
        assert "# TYPE tpu_device_memory_limit_mib gauge" in text
        assert 'vtpu_node_lease_state{node="h100-0"} 0.0' in text
    finally:
        srv.stop()


# -- the writer ------------------------------------------------------------------

NASTY = ['plain', 'quo"te', 'back\\slash', 'new\nline', 'all "\\\n" of it',
         'trailing\\', '', 'ünï']


@pytest.mark.parametrize("value", NASTY, ids=range(len(NASTY)))
def test_the_writer_escapes_as_prometheus_client(value):
    def build(g, c, h, text=False):
        out = [g("fam_g", f"help {value}", labels=["a", "b"]),
               c("fam_c", f"counter {value}", labels=["z"]),
               h("fam_h", f"hist {value}", labels=["q"])]
        out[0].add_metric([value, "x"], 1.5)
        out[0].add_metric(["x", value], -2.0)
        out[1].add_metric([value], 3)
        out[2].add_metric([value], [("0.5", 1), ("+Inf", 4)], 2.25)
        return out

    mine = expo.render(build(expo.GaugeMetricFamily, expo.CounterMetricFamily,
                             expo.HistogramMetricFamily))

    class _C(Collector):
        def collect(self):
            return build(PGauge, PCounter, PHistogram)

    registry = CollectorRegistry()
    registry.register(_C())
    assert mine == generate_latest(registry).decode()


@pytest.mark.parametrize("value", [0, 1, -1, 0.1, 1e-7, 123456789.0, 1e22,
                                   float("inf"), float("-inf"),
                                   float("nan")])
def test_the_writer_formats_values_as_go(value):
    from prometheus_client.utils import floatToGoString

    assert expo.go_float(value) == floatToGoString(value)


def test_the_counter_and_gauge_value_forms():
    text = expo.render([expo.CounterMetricFamily("x_total", "h", value=2),
                        expo.GaugeMetricFamily("y", "h", value=0.5)])
    assert text == ("# HELP x_total h\n# TYPE x_total counter\n"
                    "x_total 2.0\n# HELP y h\n# TYPE y gauge\ny 0.5\n")


# -- vgpu-smi (tests/test_vtpu_cluster.py on the port's text) ---------------------


class _Pods:
    def __init__(self, pods):
        self._pods = pods

    def list_pods(self):
        return self._pods


class SchedulerStub:
    """The JAX test's stub, on the port's components."""

    preemptions_requested = 3
    commit_conflicts = 2
    worker_pool_size = 8
    workers_busy_peak = 5

    def __init__(self):
        from k8s_vgpu_scheduler_tpu_torch.accounting import (EfficiencyConfig,
                                                             UsageLedger)
        from k8s_vgpu_scheduler_tpu_torch.health import (ChipQuarantine,
                                                         LeaseTracker,
                                                         Rescuer)
        from k8s_vgpu_scheduler_tpu_torch.scheduler.pods import PodInfo
        from k8s_vgpu_scheduler_tpu_torch.util.types import ContainerDevice

        self.leases = LeaseTracker()
        self.leases.beat("node-a")
        self.quarantine = ChipQuarantine()
        self.rescuer = Rescuer(self)
        self._now = [1000.0]
        self.ledger = UsageLedger(clock=lambda: self._now[0])
        self.efficiency_cfg = EfficiencyConfig(window_s=300.0,
                                               idle_grace_s=600.0)
        base = {"ctrkey": "u1_train-a", "chips": 1, "active": True,
                "oversubscribe": False, "chip_seconds": 90.0,
                "hbm_byte_seconds": 5.0e9, "throttled_seconds": 0.0,
                "oversub_spill_seconds": 0.0, "window_s": 120.0}
        self.ledger.record("node-a", [base])
        self._now[0] += 60.0
        self.ledger.record("node-a", [dict(
            base, chip_seconds=120.0, qos_class="latency-critical",
            qos_weight_pct=130, qos_wait_seconds_total=0.25,
            qos_wait_hist=[40, 0, 2])])
        dev = ContainerDevice
        self.pods = _Pods([
            PodInfo(uid="u1", name="train-a", namespace="default",
                    node="node-a",
                    devices=[[dev(uuid="chip-0", type="NVIDIA-h100",
                                  usedmem=3000, usedcores=30)]]),
            PodInfo(uid="u2", name="train-b", namespace="team",
                    node="node-a",
                    devices=[[dev(uuid="chip-0", type="NVIDIA-h100",
                                  usedmem=2000, usedcores=20),
                              dev(uuid="chip-1", type="NVIDIA-h100",
                                  usedmem=1000, usedcores=0)]])])

    def inspect_all_nodes_usage(self):
        from k8s_vgpu_scheduler_tpu_torch.scheduler.score import DeviceUsage

        def usage(id_, used_mem, used_cores, used_slots):
            return DeviceUsage(id=id_, type="NVIDIA-h100", health=True,
                               coords=(0, 0), total_slots=10,
                               used_slots=used_slots, total_mem=16384,
                               used_mem=used_mem, total_cores=100,
                               used_cores=used_cores)

        return {"node-a": {"chip-0": usage("chip-0", 5000, 50, 2),
                           "chip-1": usage("chip-1", 1000, 0, 1)},
                "node-b": {"chip-0": usage("chip-0", 0, 0, 0)}}

    def get_nodes_usage(self):
        """The same cards, on nodes that register no fabric (so no slice
        box is free)."""
        import types

        return {name: (types.SimpleNamespace(topology=None), usage)
                for name, usage in self.inspect_all_nodes_usage().items()}

    def grant_efficiency(self, now=None):
        from k8s_vgpu_scheduler_tpu_torch.accounting import efficiency

        return efficiency.grant_efficiency(
            self.pods.list_pods(), self.ledger, self.efficiency_cfg,
            now=self.ledger.now())


def exposition() -> str:
    return expo.render(tcluster.ClusterCollector(SchedulerStub()).collect())


def test_cluster_info_roundtrip():
    info = vgpu_smi.cluster_info(vgpu_smi.parse_prom(exposition()))
    a = info["nodes"]["node-a"]
    assert a["chips"]["chip-0"] == {"capacity_mib": 16384,
                                    "granted_mib": 5000, "sharers": 2,
                                    "cores": 50}
    assert a["chips"]["chip-1"]["granted_mib"] == 1000
    assert a["hbm_allocated_fraction"] == round(6000 / 32768, 4)
    assert info["nodes"]["node-b"]["chips"]["chip-0"]["granted_mib"] == 0
    assert info["preemption_requests"] == 3
    pods = {(p["namespace"], p["name"]): p["grants"] for p in info["pods"]}
    assert pods[("default", "train-a")] == [
        {"deviceuuid": "chip-0", "granted_mib": 3000, "cores": 30}]
    assert {g["deviceuuid"] for g in pods[("team", "train-b")]} == \
        {"chip-0", "chip-1"}
    text = vgpu_smi.format_cluster(info)
    assert "node-a" in text and "train-b" in text


def test_cluster_top_and_format_equal_the_jax_cli_on_the_port_text():
    # One text for both parsers: each scrape moves the lock counters.
    text = exposition()
    metrics = vgpu_smi.parse_prom(text)
    assert metrics == jsmi.parse_prom(text)
    for fn in ("cluster_info", "top_info"):
        assert getattr(vgpu_smi, fn)(metrics) == getattr(jsmi, fn)(metrics)
    assert vgpu_smi.format_top(vgpu_smi.top_info(metrics)) == \
        jsmi.format_top(jsmi.top_info(metrics))
    assert vgpu_smi.format_cluster(vgpu_smi.cluster_info(metrics)) == \
        jsmi.format_cluster(jsmi.cluster_info(metrics))


def test_parse_prom_tolerates_comments_and_escapes():
    metrics = vgpu_smi.parse_prom(
        '# HELP x a help line\n# TYPE x gauge\n'
        'x{podname="a\\"b",deviceuuid="c\\\\d"} 2.5\n\n')
    assert metrics == {"x": [({"podname": 'a"b', "deviceuuid": "c\\d"},
                              2.5)]}


def test_parse_prom_timestamps_and_spacey_labels():
    metrics = vgpu_smi.parse_prom(
        'a{ x = "1" , y="2"} 3.0 1700000000000\n'
        'b 4 1700000000000\n')
    assert metrics == {"a": [({"x": "1", "y": "2"}, 3.0)],
                       "b": [({}, 4.0)]}


def test_parse_prom_adversarial_label_values():
    metrics = vgpu_smi.parse_prom(
        'm{a="x,y=z",b="}{",c="with \\"quotes\\", and=equals",'
        'd="line\\nbreak"} 7\n'
        'm{unclosed="x" 8\n')
    assert metrics == {"m": [({"a": "x,y=z", "b": "}{",
                               "c": 'with "quotes", and=equals',
                               "d": "line\nbreak"}, 7.0)]}


@pytest.mark.parametrize("value", NASTY, ids=range(len(NASTY)))
def test_parse_prom_reads_back_what_the_writer_escaped(value):
    g = expo.GaugeMetricFamily("g", "h", labels=["v"])
    g.add_metric([value], 1.0)
    assert vgpu_smi.parse_prom(expo.render([g])) == {"g": [({"v": value},
                                                            1.0)]}


def test_top_view_joins_actual_against_granted():
    info = vgpu_smi.top_info(vgpu_smi.parse_prom(exposition()))
    rows = {(r["namespace"], r["name"]): r for r in info["pods"]}
    a = rows[("default", "train-a")]
    assert (a["chips"], a["granted_mib"], a["chip_seconds"]) == (1, 3000,
                                                                120.0)
    assert a["efficiency"] == 0.5 and a["waste_chips"] == 0.5
    assert (a["qos_class"], a["qos_duty_weight_pct"]) == \
        ("latency-critical", 130)
    b = rows[("team", "train-b")]
    assert b["chips"] == 2 and b["efficiency"] is None
    assert b["waste_chips"] is None
    assert [r["name"] for r in info["pods"]] == ["train-a", "train-b"]
    assert info["idle_grants"] == 0
    assert "train-a" in vgpu_smi.format_top(info)


def test_the_cli_reads_the_extender_over_http(capsys):
    from k8s_vgpu_scheduler_tpu_torch.util.exposition import MetricsServer

    srv = MetricsServer(tcluster.ClusterCollector(SchedulerStub()).collect,
                        host="127.0.0.1", port=0).start()
    url = f"127.0.0.1:{srv.port}"
    try:
        assert vgpu_smi.main(["top", "--cluster", url, "--json"]) == 0
        assert json.loads(capsys.readouterr().out)["pods"][0]["name"] == \
            "train-a"
        assert vgpu_smi.main(["--cluster", f"http://{url}/metrics"]) == 0
        assert "node-a" in capsys.readouterr().out
    finally:
        srv.stop()
    assert vgpu_smi.main(["top"]) == 2
    assert vgpu_smi.main(["--cluster", url]) == 2


# -- vgpu-smi in a container and on a node (tests/test_monitor.py) -------------


def test_container_view_reports_grant_as_total(tmp_path, libs, workloads,
                                               capsys, monkeypatch):
    w = workloads(PORT, libs, tmp_path, "podA_main", [UUIDS[0]], 1,
                  sm=30, alloc_mib=600)
    monkeypatch.setenv("CUDA_DEVICE_MEMORY_SHARED_CACHE", str(w.path))
    assert vgpu_smi.main(["--json", "--library", libs["port"]]) == 0
    info = json.loads(capsys.readouterr().out)["this container"]
    assert info["devices"] == [{
        "index": 0, "uuid": UUIDS[0], "memory_total_mib": 1000,
        "memory_used_mib": 600, "memory_used_pct": 60.0,
        "core_limit_pct": 30}]
    assert info["priority"] == 1 and info["processes"] == [w.pid]
    assert vgpu_smi.main(["--library", libs["port"]]) == 0
    assert "600 / 1000" in capsys.readouterr().out


def test_host_view_scans_container_dirs(tmp_path, libs, workloads, capsys):
    workloads(PORT, libs, tmp_path, "podA_main", [UUIDS[0]], 0)
    workloads(PORT, libs, tmp_path, "podB_main", [UUIDS[1]], 1,
              qos="best-effort")
    assert vgpu_smi.main(["--containers-dir", str(tmp_path), "--json",
                          "--library", libs["port"]]) == 0
    out = json.loads(capsys.readouterr().out)
    assert set(out) == {"podA_main", "podB_main"}
    assert out["podB_main"]["qos_class"] == "best-effort"


def test_the_container_view_equals_the_jax_view(tmp_path, libs, workloads):
    views = {}
    for flavor, mod in ((PORT, vgpu_smi), (TPU, jsmi)):
        w = workloads(flavor, libs, tmp_path / flavor.name, "p_m", UUIDS, 1,
                      qos="latency-critical")
        w.dispatch(3000)
        region = STACKS[flavor.name][0].RegionReader(
            libs[flavor.name]).open(str(w.path))
        try:
            info = mod.region_info(region)
        finally:
            region.close()
        assert info.pop("processes") == [w.pid]
        views[flavor.name] = info
    assert views["port"] == views["tpu"]
    views = {k: dict(v, processes=[1]) for k, v in views.items()}
    assert vgpu_smi.format_info(views["port"], "t") == \
        jsmi.format_info(views["tpu"], "t")


def test_no_region_is_a_loud_error(monkeypatch, libs):
    monkeypatch.delenv("CUDA_DEVICE_MEMORY_SHARED_CACHE", raising=False)
    assert vgpu_smi.main(["--library", libs["port"]]) == 2


def test_the_command_runs_under_a_grant_env_alone(tmp_path, libs, workloads):
    """``python -m ...vgpu_smi --json`` with the grant env and PATH only,
    as chip_smoke.py runs it under T's grant; torch is never imported."""
    import os

    w = workloads(PORT, libs, tmp_path, "podA_main", [UUIDS[0]], 0)
    code = ("import runpy, sys\n"
            "sys.argv = ['vgpu-smi', '--json', '--library', sys.argv[1]]\n"
            "try:\n"
            "    runpy.run_module('k8s_vgpu_scheduler_tpu_torch.cmd."
            "vgpu_smi', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "assert 'torch' not in sys.modules\n")
    res = subprocess.run(
        [sys.executable, "-c", code, libs["port"]],
        cwd=Path(__file__).resolve().parents[1], capture_output=True,
        text=True, timeout=120,
        env={"PATH": os.environ["PATH"],
             "CUDA_DEVICE_MEMORY_SHARED_CACHE": str(w.path)})
    assert res.returncode == 0, res.stderr
    [dev] = json.loads(res.stdout)["this container"]["devices"]
    assert dev["memory_total_mib"] == 1000 and dev["core_limit_pct"] == 30


# -- the forecaster (tests/test_forecast.py) ------------------------------------

BUCKET = 30.0


def feed(fc, series) -> None:
    for b, v in enumerate(series):
        fc.observe(b * fc.cfg.bucket_s, v)
    fc.observe(len(series) * fc.cfg.bucket_s, 0.0)


def both(cfg, series, horizon):
    """The port's and the JAX forecaster on one series: the port's, after
    holding its forecast, drift and history to the JAX one's."""
    from k8s_vgpu_scheduler_tpu.accounting.forecast import \
        ForecastConfig as JConfig

    mine = SeriesForecaster(cfg)
    ref = JForecaster(JConfig(**vars(cfg)))
    feed(mine, series)
    feed(ref, series)
    assert [p.as_dict() for p in mine.forecast(horizon)] == \
        [p.as_dict() for p in ref.forecast(horizon)]
    assert (mine.error_ratio(), mine.history_rows(), mine.level,
            mine.trend, mine.buckets_observed) == (
        ref.error_ratio(), ref.history_rows(), ref.level, ref.trend,
        ref.buckets_observed)
    return mine


def test_forecast_never_negative_on_random_series():
    for seed in range(8):
        rng = random.Random(seed)
        series = [max(0.0, rng.uniform(-2.0, 8.0)) for _ in range(40)]
        series += [0.0] * 10
        fc = both(ForecastConfig(bucket_s=BUCKET, season_buckets=8,
                                 beta=0.3), series, 24)
        for p in fc.forecast(24):
            assert p.mean >= 0.0 and p.lower >= 0.0 and p.upper >= 0.0


def test_bands_bracket_the_mean():
    rng = random.Random(3)
    fc = both(ForecastConfig(bucket_s=BUCKET, season_buckets=4),
              [2.0 + rng.random() for _ in range(30)], 12)
    for p in fc.forecast(12):
        assert p.lower <= p.mean <= p.upper


def test_constant_series_converges_to_the_constant():
    fc = both(ForecastConfig(bucket_s=BUCKET, season_buckets=8),
              [5.0] * 60, 16)
    assert all(abs(p.mean - 5.0) < 1e-6 for p in fc.forecast(16))
    assert fc.error_ratio() is not None and fc.error_ratio() < 0.01


def test_constant_series_bands_collapse():
    fc = both(ForecastConfig(bucket_s=BUCKET, season_buckets=1), [3.0] * 50,
              1)
    p = fc.forecast(1)[0]
    assert p.upper - p.lower < 0.1


def test_diurnal_signal_recovered_out_of_sample():
    period = 16
    series = synth_demand("diurnal", {"base_chips": 0.5,
                                      "amplitude_chips": 3.0,
                                      "period_buckets": period}, 4 * period)
    fc = both(ForecastConfig(bucket_s=BUCKET, season_buckets=period,
                             alpha=0.05, gamma=0.7, beta=0.0),
              series[:3 * period], period)
    pred = [p.mean for p in fc.forecast(period)]
    actual = series[3 * period:]
    assert sum(abs(p - a) for p, a in zip(pred, actual)) / sum(actual) < 0.10
    assert abs(pred.index(max(pred)) - actual.index(max(actual))) <= 1
    assert abs(pred.index(min(pred)) - actual.index(min(actual))) <= 1


def test_bursty_phase_alignment():
    period = 8
    series = synth_demand("bursty", {"base_chips": 0.5, "burst_chips": 2.0,
                                     "period_buckets": period,
                                     "burst_buckets": 2}, 6 * period)
    fc = both(ForecastConfig(bucket_s=BUCKET, season_buckets=period,
                             alpha=0.05, gamma=0.7, beta=0.0),
              series[:5 * period], period)
    pred = [p.mean for p in fc.forecast(period)]
    for b, a in enumerate(series[5 * period:]):
        assert pred[b] > 1.0 if a > 1.0 else pred[b] < 1.5


def test_drift_ratio_increases_with_noise():
    def mean_err(sigma: float) -> float:
        out = []
        for seed in range(6):
            rng = random.Random(seed)
            fc = both(ForecastConfig(bucket_s=BUCKET, season_buckets=1),
                      [max(0.0, 4.0 + rng.gauss(0.0, sigma))
                       for _ in range(80)], 1)
            out.append(fc.error_ratio())
        return sum(out) / len(out)

    e0, e1, e2 = mean_err(0.0), mean_err(0.8), mean_err(2.4)
    assert e0 < e1 < e2 and e0 < 0.01


def test_error_ratio_none_until_scored():
    fc = SeriesForecaster(ForecastConfig(bucket_s=BUCKET))
    assert fc.error_ratio() is None
    fc.observe(0.0, 1.0)
    assert fc.error_ratio() is None
    assert [p.mean for p in fc.forecast(3)] == [0.0, 0.0, 0.0]


def test_gap_buckets_close_as_zero_demand():
    fc = SeriesForecaster(ForecastConfig(bucket_s=BUCKET, season_buckets=1,
                                         alpha=0.5))
    fc.observe(0.0, 6.0)
    fc.observe(10 * BUCKET, 0.0)
    assert fc.buckets_observed == 10 and fc.forecast(1)[0].mean < 1.0


def test_within_bucket_samples_average():
    fc = SeriesForecaster(ForecastConfig(bucket_s=BUCKET, season_buckets=1))
    fc.observe(0.0, 2.0)
    fc.observe(1.0, 4.0)
    fc.observe(BUCKET, 0.0)
    assert fc.history_rows() == [[0.0, 3.0]]


def test_history_ring_bounded():
    fc = both(ForecastConfig(bucket_s=BUCKET, history_len=8), [1.0] * 40, 2)
    assert len(fc.history_rows()) == 8


def test_trend_is_damped_at_long_horizon():
    cfg = ForecastConfig(bucket_s=BUCKET, season_buckets=1, alpha=0.3,
                         beta=0.3, phi=0.9)
    fc = both(cfg, [float(i) for i in range(30)], 500)
    far = fc.forecast(500)[-1].mean
    assert far <= fc.level + fc.trend * cfg.phi / (1 - cfg.phi) + 1e-6
    assert not math.isinf(far)


def test_the_busy_card_forecast_gauge_reads_as_jax(tmp_path, libs,
                                                   workloads, tracers):
    """The node collector's busy-card forecast over scrapes two buckets
    apart (a closed bucket) and past three (the cold restart)."""
    texts = {}
    for flavor in (PORT, TPU):
        root = tmp_path / flavor.name
        w = workloads(flavor, libs, root, "uid1_p", [UUIDS[0]], 0)
        loop = loop_for(flavor, libs, root)
        clock = SimClock()
        sampler = STACKS[flavor.name][2].UsageSampler(loop, clock=clock)
        mod = tnode if flavor is PORT else jnode
        c = mod.NodeCollector(loop, None, "n", now=clock, sampler=sampler)
        got = []
        for dt in (0.0, 61.0, 62.0, 400.0):
            w.dispatch()
            loop.tick()
            sampler.sample()
            clock.advance(dt)
            fam = families(expo.render(c.collect()) if flavor is PORT
                           else jax_text(c))
            got.append(samples(fam["vtpu_capacity_node_busy_chips_forecast"]))
        texts[flavor.name] = got
        loop.close()
        w.stop()
    assert texts["port"] == texts["tpu"]
    assert any(v[0][2] > 0 for v in texts["port"])
