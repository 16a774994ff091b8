"""vgpu-simulate — capacity planning against the port's own scheduler (the
port's copy of the JAX package's ``cmd/simulate.py``).

Answers "will this workload fit on that fleet?" without a cluster: a
synthetic fleet of H100 nodes is registered with the port's Scheduler
(the same fit, score and topology code that runs in the extender, not a
model of it), a workload spec is replayed through Filter and Bind, and
the result is the placement map, each card's usage, and exactly which
pods did not fit and why.  The reference has no analog; its users
discover capacity by watching pods pend (README.md:128: "the task will
get stuck in pending").

Workload spec (JSON), in the port's resource names:

    {"pods": [
       {"name": "train", "count": 4, "gpu": 4, "gpumem": 40000,
        "gpucores": 100},
       {"name": "serve", "count": 10, "gpu": 1, "gpumem": 20000,
        "gpucores": 30, "priority": 1, "mesh": "2"}
     ]}

``gpu``, ``gpumem``, ``gpumem-percentage``, ``gpucores`` and ``priority``
become the pod's ``nvidia.com/*`` limits, ``mesh`` its ``vtpu.dev/mesh``.
A ``gang`` entry is written as the pod group it declares (total: its
count): its members are placed all or none by the scheduler's gang
manager, so every pod is created before Filter is replayed, with one
retry pass, as kube-scheduler re-queues an unschedulable pod.

A workload may also carry an ``accounting`` section — after placement,
the port's metering pipeline (``accounting/sampler.py`` over synthetic
regions → the scheduler's ledger → the efficiency join) replays each
pod's declared duty cycle on a virtual clock and reports metered against
simulated GPU-seconds (they must agree within 5%), each pod's
efficiency, and which pods surface as idle grants:

    {"pods": [{"name": "train", "count": 2, "gpu": 2, "duty": 0.9},
              {"name": "squatter", "count": 1, "gpu": 4, "duty": 0.0}],
     "accounting": {"runtime_s": 300, "tick_s": 5, "idle_grace_s": 120}}

A ``chaos`` section plays a seeded failure scenario against the placed
fleet through the port's health subsystem (``health/``: leases,
quarantine, rescuer) on a virtual clock, then re-places every rescued
pod on the survivors and audits that no card was ever overbooked:

    {"pods": [...],
     "chaos": {"seed": 7,
               "events": [{"at_s": 5, "kind": "partition-node",
                           "node": "sim-node-0"},
                          {"at_s": 8, "kind": "flap-chip",
                           "node": "sim-node-1",
                           "chip": "sim-node-1-gpu-0", "count": 4}],
               "random_events": 0, "settle_s": 60}}

A ``serving`` section is the flat-vs-tiered QoS A/B on ``shim/simlab.py``
(copies of ``libvgpu_torch.so`` on virtual clocks under the port's
monitor loop); no fleet is involved.

A ``queueing`` section is a contended multi-tenant scenario replayed
through the port's capacity queues (``quota/``) on a virtual clock, A/B
against FIFO with the admission layer off.  Arrivals create pods over
time, placed pods run for their declared runtime and exit, reclaim
victims checkpoint and exit after a delay, and the report answers the
fairness question: do admitted GPU-seconds converge to the configured
weights, does backfill keep utilization at the FIFO level, and did
reclaim ever touch an in-quota grant:

    {"queueing": {
       "queues": [{"name": "tenant-a", "namespaces": ["tenant-a"],
                   "cohort": "main", "weight": 3,
                   "quota": {"chips": 6}, "borrow_limit_chips": 2}, ...],
       "arrivals": [{"name": "a", "namespace": "tenant-a", "gpu": 2,
                     "count": 40, "at_s": 0, "runtime_s": 40}, ...],
       "horizon_s": 600, "tick_s": 5, "measure_from_s": 180}}

A ``fragmentation`` section is a defrag-on vs defrag-off A/B on the
virtual clock through the port's placement subsystem (``placement/``):
exclusive churn singles fill the fleet, a patterned subset exits
(scattered free cards, no contiguous box), a mesh-declared gang arrives
and blocks, and the defragmenter compacts by checkpoint-migrating
victims until the gang admits:

    {"fragmentation": {
       "churn": {"name": "churn", "gpu": 1, "gpumem": 4000,
                 "gpucores": 100, "priority": 1},
       "release_pattern": "checkerboard",
       "gang": {"name": "big", "count": 2, "gpu": 4, "gpumem": 4000,
                "gpucores": 100, "gang": "big", "mesh": "2x4"},
       "horizon_s": 300, "tick_s": 5, "checkpoint_delay_s": 5}}

An ``elastic`` section is an elastic-on vs elastic-off A/B on the
virtual clock through the port's admission, reclaim and resize loops
(``quota/``, ``elastic/``): an elastic gang borrows cards, a latency
burst of the entitled queue takes them back, by a rung shrink with
elastic on and by killing borrowers with it off, and the gang grows back
after the burst; its training trajectory is a hash chain that must
resume bit for bit at every resize (``examples/vgpu-workload-elastic.json``,
the JAX example in the port's names):

    {"elastic": {
       "queues": [...], "reclaim_grace_s": 30, "hysteresis_s": 60,
       "gang": {"name": "train", "namespace": "team-batch", "gpu": 4,
                "gpucores": 100, "mesh": "4x4", "mesh_min": "2x2",
                "mesh_max": "4x4", "at_s": 0},
       "arrivals": [...], "horizon_s": 720, "tick_s": 5,
       "checkpoint_delay_s": 5}}

A ``capacity`` section is predictive capacity planning
(``accounting/forecast.py`` + ``planner.py``): a named deterministic
arrival pattern (bursty / diurnal / flash-crowd;
``examples/vgpu-capacity-scenarios.json`` holds full scenarios on them) or
an explicit captured demand trace is split into history + horizon; the
forecaster learns the history, and both the forecast and the actual
horizon arrivals replay through the port's admission loop (quota gate,
a batched ``filter_many`` drain a tick, the defragmenter's tick) on the
virtual clock.  The report
answers "when does queue X starve?" (predicted against actual, within one
forecast bucket), "how many nodes does this demand need?" (a node sweep
replayed until the critical queue stays unstarved with no card
overbooked) and, with ``elastic_whatif`` (an ``elastic`` section's spec),
"shrink the elastic jobs or buy nodes?" (``examples/vgpu-workload-
capacity.json``, the JAX example in the port's names):

    {"capacity": {
       "pattern": "bursty", "pattern_params": {"burst_chips": 4},
       "streams": [{"name": "train", "namespace": "tenant-a", "gpu": 1,
                    "runtime_s": 100000}],
       "queues": [{"name": "tenant-a", "namespaces": ["tenant-a"],
                   "quota": {"chips": 8}}],
       "bucket_s": 30, "history_buckets": 48, "horizon_buckets": 16,
       "tick_s": 5, "starve_after_s": 60,
       "require_starvation": ["tenant-a"],
       "recommend": false}}

Each tick every unplaced pod is drained, in name order, through one
batched ``filter_many``, as in the JAX simulator.  A capacity spec's
``replica_loss`` what-if ("what does losing a replica cost?") replays the
``ha`` section below with a storm sized from the forecast's peak, and
reports the adoption latency, the pods pended through the orphan window,
their re-placements and the rebalances.

An ``ha`` section is a run of active extender replicas (``shard/``) on
the virtual clock with a seeded replica kill mid-storm: N replica
schedulers share one fake apiserver, converge on a shard map, place a pod
storm offered to each replica in turn as kube-scheduler's retries would
offer it, one replica is killed, the survivors bump the epoch and adopt
its nodes, and every pod that pended through the orphan window places
again.  The report carries the adoption latency, the re-placed pods and
the audits (no grant lost or duplicated, no card overbooked;
``examples/vgpu-workload-ha.json``):

    {"ha": {"replicas": 3, "seed": 7, "kill_after": 6,
            "storm": {"name": "train", "gpu": 1, "gpumem": 16384,
                      "count": 22},
            "storm_interval_s": 1, "settle_s": 120}}

An ``ha`` section with ``explain: true`` audits the explain timelines of
the JAX package's provenance store, which the port does not have yet: it
is refused by name, as are the JAX simulator's ``audit`` and ``slo``
sections (ROADMAP A.5), and the command exits 2.

Usage:
    vgpu-simulate --nodes 4 --chips 8 --hbm 81079 --mesh 8 \\
                  --workload workload.json [--policy binpack] [--json]
    vgpu-simulate --workload workload.json --chaos-seed 7 \\
                  --chaos-random-events 5   # seeded random fault schedule
    vgpu-simulate --workload workload.json --from-cluster http://sched:9443
                  # live fleet: the extender's /fleetz snapshot, existing
                  # grants included — answers for the REMAINING capacity

Exit codes: 0 the workload fits, 1 it does not, 2 bad input, an
unreachable cluster or a section the port does not simulate.

Control plane: imports no torch, grpc or protobuf; the serving section
imports ``shim/simlab.py`` inside its function.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import random
import sys
import threading
from typing import Dict, List, Optional

from ..accounting import efficiency as eff_mod
from ..accounting import planner as planner_mod
from ..accounting.forecast import ForecastConfig, SeriesForecaster
from ..accounting.sampler import UsageSampler
from ..health.faults import FaultEvent, FaultInjector, SimClock
from ..elastic.ranges import (
    MESH_ASSIGNED_ANNOTATION,
    MESH_MAX_ANNOTATION,
    MESH_MIN_ANNOTATION,
)
from ..k8s import FakeKube
from ..placement.mesh import mesh_volume, parse_mesh
from ..quota.queues import (
    QUEUE_ANNOTATION,
    QUEUE_STATE_ANNOTATION,
    RUNTIME_ESTIMATE_ANNOTATION,
    STATE_HELD,
    queue_for_namespace,
)
from ..scheduler import DeviceInfo, NodeInfo, Scheduler
from ..scheduler.pods import PodInfo
from ..scheduler.preempt import PREEMPT_ANNOTATION
from ..tpulib.types import TopologyDesc
from ..util import nodelock
from ..util.config import Config, ResourceNames
from ..util.types import (
    ASSIGNED_NODE_ANNOTATION,
    GANG_GROUP_ANNOTATION,
    GANG_TOTAL_ANNOTATION,
    MESH_ANNOTATION,
    ContainerDevice,
)

#: The JAX simulator's self-contained sections, in the order it tries
#: them: ``fragmentation``, ``elastic``, ``capacity``, ``serving``, ``ha``
#: and ``queueing`` run here, ``audit`` and ``slo`` are refused until
#: ROADMAP A.5 brings them.  True: a section is requested when present;
#: False: when it is not empty.
SECTIONS = (("fragmentation", False), ("elastic", True), ("capacity", True),
            ("serving", True), ("audit", True), ("slo", True),
            ("ha", False), ("queueing", False))

#: Workload keys → the pod's limits, under the port's resource names.
_NAMES = ResourceNames()
LIMIT_KEYS = (("gpu", _NAMES.count), ("gpumem", _NAMES.memory),
              ("gpumem-percentage", _NAMES.memory_percentage),
              ("gpucores", _NAMES.cores), ("priority", _NAMES.priority))


class SectionRefused(ValueError):
    """A workload section this port does not simulate (ROADMAP A.5)."""


def card_coords(i: int, mesh) -> tuple:
    """Card ``i``'s coordinates on ``mesh``, first axis fastest, one a
    mesh axis (the last not wrapped, as the JAX simulator's second)."""
    coords, rest = [], i
    for k, d in enumerate(mesh):
        if k == len(mesh) - 1:
            coords.append(rest)
        else:
            coords.append(rest % d)
            rest //= d
    return tuple(coords)


def build_fleet(s: Scheduler, kube: FakeKube, nodes: int, chips: int,
                hbm: int, mesh, generation: str) -> List[str]:
    names = [f"sim-node-{i}" for i in range(nodes)]
    for n in names:
        kube.add_node({"metadata": {"name": n, "annotations": {}}})
        devices = [
            DeviceInfo(id=f"{n}-gpu-{i}", count=10, devmem=hbm,
                       type=f"NVIDIA-{generation}", health=True,
                       coords=card_coords(i, mesh))
            for i in range(chips)
        ]
        s.nodes.add_node(n, NodeInfo(
            name=n, devices=devices,
            topology=TopologyDesc(generation=generation, mesh=tuple(mesh))))
    return names


def build_fleet_from_export(s: Scheduler, kube: FakeKube,
                            export: dict) -> List[str]:
    """Rebuild a LIVE scheduler's state from its ``/fleetz`` snapshot:
    the inventory with its fabric, plus every existing grant — so the
    replay answers "will this fit right NOW", not on an empty fleet."""
    names = []
    for n in export.get("nodes", []):
        kube.add_node({"metadata": {"name": n["name"], "annotations": {}}})
        devices = [
            DeviceInfo(id=c["id"], count=c["count"], devmem=c["devmem"],
                       type=c["type"], health=c["health"],
                       coords=tuple(c["coords"]),
                       cores=c.get("cores", 100))
            for c in n["chips"]
        ]
        topo = None
        if n.get("mesh"):
            topo = TopologyDesc(generation=n.get("generation") or "",
                                mesh=tuple(n["mesh"]),
                                wraparound=tuple(
                                    n.get("wraparound") or ()))
        s.nodes.add_node(n["name"], NodeInfo(
            name=n["name"], devices=devices, topology=topo))
        names.append(n["name"])
    for p in export.get("pods", []):
        s.pods.add_pod(PodInfo(
            uid=p["uid"], name=p["name"], namespace=p["namespace"],
            node=p["node"], priority=p.get("priority", 0),
            devices=[[ContainerDevice(uuid=d["uuid"], type=d["type"],
                                      usedmem=d["usedmem"],
                                      usedcores=d["usedcores"])
                      for d in container]
                     for container in p.get("devices", [])]))
    return names


def spec_pod(entry: dict, idx: int) -> dict:
    name = f"{entry['name']}-{idx}"
    limits = {_NAMES.count: str(entry.get("gpu", 1))}
    for key, resource in LIMIT_KEYS[1:]:
        if key in entry:
            limits[resource] = str(entry[key])
    anns = {}
    if entry.get("mesh"):
        anns[MESH_ANNOTATION] = str(entry["mesh"])
    if entry.get("gang"):
        anns[GANG_GROUP_ANNOTATION] = entry["gang"]
        anns[GANG_TOTAL_ANNOTATION] = str(entry.get("count", 1))
    return {
        "metadata": {"name": name, "namespace": "sim", "uid": f"uid-{name}",
                     "annotations": anns},
        "spec": {"containers": [{"name": "main",
                                 "resources": {"limits": limits}}]},
    }


def _requested(workload: dict, key: str, when_present: bool) -> bool:
    value = workload.get(key)
    return value is not None if when_present else bool(value)


def run_simulation(workload: dict, *, nodes: int = 0, chips: int = 0,
                   hbm: int = 0, mesh=(1,), generation: str = "h100",
                   policy: Optional[str] = None,
                   fleet_export: Optional[dict] = None) -> dict:
    """Raises :class:`SectionRefused` for a section of ROADMAP A.5."""
    # Policy resolution: explicit caller choice > the LIVE scheduler's
    # own config (a replay under different policies answers a different
    # question) > the spread default.
    live_cfg = (fleet_export or {}).get("config", {})
    policy = policy or live_cfg.get("node_scheduler_policy") or "spread"
    topology_policy = live_cfg.get("topology_policy", "best-effort")
    for key, when_present in SECTIONS:
        if not _requested(workload, key, when_present):
            continue
        if key == "serving":
            # A self-contained flat-vs-tiered QoS A/B through the native
            # limiters and the monitor loop on virtual clocks; no fleet.
            result = run_serving_phase(workload["serving"])
        elif key == "fragmentation":
            # A self-contained defrag-on/off A/B on the virtual clock:
            # churn fragments the fleet, a large slice/mesh gang arrives
            # and blocks, the defragmenter compacts, the gang admits.
            result = run_fragmentation_phase(
                workload["fragmentation"], nodes=nodes, chips=chips,
                hbm=hbm, mesh=mesh, generation=generation, policy=policy)
        elif key == "elastic":
            # A self-contained elastic-on/off A/B on the virtual clock: an
            # elastic gang shrinks for a latency burst instead of dying,
            # then grows back on the freed surplus.
            result = run_elastic_phase(
                workload["elastic"], nodes=nodes, chips=chips, hbm=hbm,
                mesh=mesh, generation=generation, policy=policy)
        elif key == "capacity":
            # A self-contained forecast-vs-actual replay on the virtual
            # clock; it builds its own schedulers per replay leg.
            result = run_capacity_phase(
                workload["capacity"], nodes=nodes, chips=chips, hbm=hbm,
                mesh=mesh, generation=generation, policy=policy)
        elif key == "queueing":
            # A self-contained time-stepped A/B: its own fair and FIFO
            # schedulers on the virtual clock (the plain replay below
            # would place its pods twice).
            result = run_queueing_phase(
                workload["queueing"], nodes=nodes, chips=chips, hbm=hbm,
                mesh=mesh, generation=generation, policy=policy)
        elif key == "ha":
            # A self-contained run of replica schedulers over one fake
            # apiserver on the virtual clock (the plain replay below is
            # one replica).
            result = run_ha_phase(
                workload["ha"], nodes=nodes, chips=chips, hbm=hbm,
                mesh=mesh, generation=generation, policy=policy)
        else:
            raise SectionRefused(
                f"the {key!r} section is not simulated by this port: its "
                f"subsystem comes with ROADMAP A.5")
        return {
            "fleet": {"nodes": nodes, "chips_per_node": chips,
                      "hbm_mib": hbm, "mesh": list(mesh), "policy": policy},
            "placed": [], "pending": [], "chips": {},
            "hbm_allocated_fraction": 0.0,
            "fits": bool(result["verdict"]["ok"]),
            key: result,
        }

    chaos = workload.get("chaos")
    accounting = workload.get("accounting")
    # A chaos or accounting scenario runs on a virtual clock so minutes of
    # lease decay / usage metering replay in microseconds — deterministically.
    clock = SimClock() if (chaos or accounting) else None
    kube = FakeKube()
    s = Scheduler(kube, Config(node_scheduler_policy=policy,
                               topology_policy=topology_policy),
                  clock=clock)
    if fleet_export is not None:
        names = build_fleet_from_export(s, kube, fleet_export)
    else:
        names = build_fleet(s, kube, nodes, chips, hbm, mesh, generation)
    kube.watch_pods(s.on_pod_event)

    placed, pending = [], []
    pods = []
    for entry in workload.get("pods", []):
        for i in range(int(entry.get("count", 1))):
            pods.append((entry, spec_pod(entry, i)))

    # Create every pod up front (a gang member must stay registered while
    # its peers arrive), then replay Filter with one retry pass, as
    # kube-scheduler re-queues unschedulable pods: the second resolves the
    # members whose gang reached its quorum in the first.
    for _, pod in pods:
        kube.create_pod(pod)
    queue = [(e, p, "") for e, p in pods]
    for _ in range(2):
        retry = []
        for entry, pod, _err in queue:
            r = s.filter(pod, names)
            name = pod["metadata"]["name"]
            if r.node:
                s.bind("sim", name, pod["metadata"]["uid"], r.node)
                nodelock.release_node(kube, r.node)
                placed.append({"pod": name, "node": r.node,
                               "chips": [
                                   {"uuid": d.uuid, "mem_mib": d.usedmem,
                                    "cores": d.usedcores}
                                   for c in (s.pods.get(
                                       pod["metadata"]["uid"]).devices or [])
                                   for d in c]})
            else:
                retry.append((entry, pod, r.error or "no fit"))
        queue = retry
        if not queue:
            break
    for _, pod, err in queue:
        pending.append({"pod": pod["metadata"]["name"], "reason": err})

    accounting_report = None
    if accounting:
        # Before chaos: the metering replay wants the placed fleet intact.
        accounting_report = run_accounting_phase(s, workload, accounting,
                                                 clock, placed)

    chaos_report = None
    if chaos:
        chaos_report = run_chaos_phase(s, kube, names, chaos, clock, placed)

    usage = s.inspect_all_nodes_usage()
    chips_out = {}
    total_mem = used_mem = 0
    for node, per_chip in usage.items():
        for u in per_chip.values():
            chips_out[f"{node}/{u.id}"] = {
                "mem_mib": [u.used_mem, u.total_mem],
                "cores_pct": u.used_cores,
                "sharers": u.used_slots,
            }
            total_mem += u.total_mem
            used_mem += u.used_mem
    s.close()
    result = {
        "fleet": (
            {"nodes": len(names), "source": "live /fleetz snapshot",
             "existing_pods": len(fleet_export.get("pods", [])),
             "policy": policy}
            if fleet_export is not None else
            {"nodes": nodes, "chips_per_node": chips, "hbm_mib": hbm,
             "mesh": list(mesh), "policy": policy}),
        "placed": placed,
        "pending": pending,
        "chips": chips_out,
        "hbm_allocated_fraction": round(used_mem / total_mem, 4)
        if total_mem else 0.0,
        "fits": not pending,
    }
    if accounting_report is not None:
        result["accounting"] = accounting_report
    if chaos_report is not None:
        result["chaos"] = chaos_report
    return result


class _SimRegion:
    """Duck-typed shared region for the accounting replay: exactly the
    surface UsageSampler reads (num_devices / used / switches)."""

    def __init__(self, chips: int, used_bytes_per_chip: int,
                 oversubscribe: bool) -> None:
        self.num_devices = chips
        self._used = used_bytes_per_chip
        self.utilization_switch = 0
        self.oversubscribe = 1 if oversubscribe else 0

    def used(self, _dev: int) -> int:
        return self._used


class _SimState:
    def __init__(self, region: _SimRegion) -> None:
        self.region = region
        self.active = False


class _SimLoop:
    """FeedbackLoop stand-in (lock + containers) the sampler runs over."""

    def __init__(self) -> None:
        self.lock = threading.RLock()
        self.containers: Dict[str, _SimState] = {}


def run_accounting_phase(s: Scheduler, workload: dict, spec: dict,
                         clock: SimClock, placed: List[dict]) -> dict:
    """Replay each placed pod's declared duty cycle through the metering
    pipeline: UsageSampler over synthetic regions → ledger (node-grouped
    counter reports, the register-stream shape) → efficiency join.  The
    report checks the accounting invariant — metered GPU-seconds within
    5% of simulated occupancy — and names the idle grants."""
    runtime = float(spec.get("runtime_s", 300.0))
    tick = float(spec.get("tick_s", 5.0))
    grace = float(spec.get("idle_grace_s", min(600.0, runtime / 2)))
    steps = max(1, int(round(runtime / tick)))

    duty_by_pod: Dict[str, float] = {}
    oversub_by_pod: Dict[str, bool] = {}
    for entry in workload.get("pods", []):
        for i in range(int(entry.get("count", 1))):
            duty_by_pod[f"{entry['name']}-{i}"] = float(
                entry.get("duty", 1.0))
            oversub_by_pod[f"{entry['name']}-{i}"] = bool(
                entry.get("oversubscribe", False))

    MIB = 1024 * 1024
    loop = _SimLoop()
    node_of: Dict[str, str] = {}
    meta: Dict[str, dict] = {}  # ctrkey -> pod metadata
    for p in placed:
        name = p["pod"]
        uid = f"uid-{name}"
        ctrkey = f"{uid}_{name}"
        chips = len(p["chips"])
        mem_bytes = (p["chips"][0]["mem_mib"] * MIB) if p["chips"] else 0
        loop.containers[ctrkey] = _SimState(_SimRegion(
            chips, mem_bytes, oversub_by_pod.get(name, False)))
        node_of[ctrkey] = p["node"]
        meta[ctrkey] = {"pod": name, "uid": uid, "node": p["node"],
                        "chips": chips,
                        "duty": duty_by_pod.get(name, 1.0),
                        "accumulator": 0.0}

    sampler = UsageSampler(loop, clock=clock)
    sampler.sample()  # t0 baseline: first sight credits nothing
    for _ in range(steps):
        # ``active`` describes the interval about to be credited (the
        # census semantics): set it, elapse one tick, sample.
        for ctrkey, m in meta.items():
            m["accumulator"] += m["duty"]
            active = m["accumulator"] >= 1.0 - 1e-9
            if active:
                m["accumulator"] -= 1.0
            loop.containers[ctrkey].active = active
        clock.advance(tick)
        sampler.sample()
        rows = sampler.snapshot()
        by_node: Dict[str, List[dict]] = {}
        for row in rows:
            by_node.setdefault(node_of[row["ctrkey"]], []).append(row)
        for node, node_rows in by_node.items():
            s.ledger.record(node, node_rows)

    pods_out = []
    max_err = 0.0
    ok = True
    for ctrkey, m in sorted(meta.items()):
        acct = s.ledger.get(m["uid"])
        metered = acct.chip_seconds if acct is not None else 0.0
        simulated = m["duty"] * runtime * m["chips"]
        if simulated > 0:
            err = 100.0 * abs(metered - simulated) / simulated
        else:
            # An idle pod must meter (close to) nothing: one tick of one
            # card is the discretization slack.
            err = 0.0 if metered <= tick * m["chips"] else float("inf")
        max_err = max(max_err, err)
        ok = ok and err <= 5.0
        pods_out.append({
            "pod": m["pod"], "node": m["node"], "chips": m["chips"],
            "duty": m["duty"],
            "simulated_chip_seconds": round(simulated, 3),
            "metered_chip_seconds": round(metered, 3),
            "error_pct": round(err, 3),
        })

    fleet = eff_mod.grant_efficiency(
        s.pods.list_pods(), s.ledger,
        eff_mod.EfficiencyConfig(window_s=runtime, idle_grace_s=grace),
        now=clock())
    return {
        "runtime_s": runtime,
        "tick_s": tick,
        "pods": pods_out,
        "max_error_pct": round(max_err, 3),
        "tolerance_pct": 5.0,
        "metering_ok": ok,
        "idle_grants": sorted(p.name for p in fleet.idle),
        "efficiency": {p.name: (round(p.efficiency, 4)
                                if p.efficiency is not None else None)
                       for p in fleet.pods},
        "fleet_efficiency": (round(fleet.fleet_efficiency, 4)
                             if fleet.fleet_efficiency is not None
                             else None),
    }


def run_serving_phase(spec: dict) -> dict:
    """The SLO-tiered co-residency A/B: a latency-critical serve-decode
    stream next to a best-effort training neighbor on one card, flat
    duty-cycle limiter against QoS tiers, through the native limiters on
    virtual clocks with the monitor's feedback loop re-weighting duty from
    the observed critical p99.  Deterministic (manual clocks, fixed
    schedule, no RNG).

    The flat baseline runs ``GPU_CORE_UTILIZATION_POLICY=force``, the only
    flat configuration that enforces both grants.  Verdict:

    - in every bursty phase, tiered critical dispatch-wait p99 beats flat
      by the configured factor;
    - in the overload phase, tiered MEAN wait beats flat by the same
      factor;
    - duty weights moved during overload AND returned to neutral by the
      end (hysteresis);
    - best-effort goodput within tolerance of flat;
    - no grant-limit violation in either leg.
    """
    import shutil as _shutil
    import tempfile

    from ..monitor.feedback import QosConfig
    from ..shim import simlab

    phases = spec.get("phases") or simlab.SERVING_PHASES
    interval = float(spec.get("monitor_interval_s", 0.25))
    base = simlab.serving_qos_config()
    q = spec.get("qos", {})
    qcfg = QosConfig(
        target_p99_us=int(q.get("target_p99_us", base.target_p99_us)),
        step_pct=int(q.get("step_pct", base.step_pct)),
        min_weight_pct=int(q.get("min_weight_pct",
                                 base.min_weight_pct)),
        max_weight_pct=int(q.get("max_weight_pct",
                                 base.max_weight_pct)),
        recover_ticks=int(q.get("recover_ticks", base.recover_ticks)),
        recover_frac=float(q.get("recover_frac", base.recover_frac)),
    )
    legs = {}
    for tiered in (False, True):
        root = tempfile.mkdtemp(prefix="vgpu-serving-")
        try:
            legs["tiered" if tiered else "flat"] = simlab.drive_serving(
                root, tiered, phases, qos_cfg=qcfg,
                monitor_interval_s=interval)
        finally:
            _shutil.rmtree(root, ignore_errors=True)
    flat, tiered_leg = legs["flat"], legs["tiered"]

    improve_min = float(spec.get("p99_improvement_min", 3.0))
    goodput_tol = float(spec.get("goodput_tolerance_pct", 15.0)) / 100.0
    checks = {"bursty_p99": True, "overload_mean": True}
    phase_compare = []
    for fp, tp in zip(flat["phases"], tiered_leg["phases"]):
        row = {"name": fp["name"],
               "flat_p99_us": fp["critical"]["wait_p99_us"],
               "tiered_p99_us": tp["critical"]["wait_p99_us"],
               "flat_mean_us": round(fp["critical"]["wait_mean_us"], 1),
               "tiered_mean_us": round(tp["critical"]["wait_mean_us"],
                                       1)}
        if fp["name"].startswith("bursty"):
            ok = (tp["critical"]["wait_p99_us"] * improve_min
                  <= fp["critical"]["wait_p99_us"]
                  or tp["critical"]["wait_p99_us"] == 0.0)
            row["ok"] = ok
            checks["bursty_p99"] = checks["bursty_p99"] and ok
        elif fp["name"] == "overload":
            ok = (tp["critical"]["wait_mean_us"] * improve_min
                  <= fp["critical"]["wait_mean_us"])
            row["ok"] = ok
            checks["overload_mean"] = checks["overload_mean"] and ok
        phase_compare.append(row)
    be_flat = flat["best_effort"]["admitted_device_s"]
    be_tiered = tiered_leg["best_effort"]["admitted_device_s"]
    goodput_ratio = be_tiered / be_flat if be_flat else 1.0
    dw = tiered_leg["duty_weights"]
    violations = {
        "flat": simlab.serving_violations(
            flat, max_weight_pct=qcfg.max_weight_pct),
        "tiered": simlab.serving_violations(
            tiered_leg, max_weight_pct=qcfg.max_weight_pct),
    }
    verdict = {
        "bursty_p99_improved": checks["bursty_p99"],
        "overload_mean_improved": checks["overload_mean"],
        "duty_shifted": (tiered_leg["reweights"] > 0
                         and dw["critical_max"] > 100
                         and dw["best_effort_min"] < 100),
        "duty_returned": (dw["critical_final"] == 100
                          and dw["best_effort_final"] == 100),
        "best_effort_goodput_ok": goodput_ratio >= 1.0 - goodput_tol,
        "no_violations": not (violations["flat"]
                              or violations["tiered"]),
    }
    verdict["ok"] = all(verdict.values())
    return {
        "p99_improvement_min": improve_min,
        "goodput_tolerance_pct": goodput_tol * 100.0,
        "monitor_interval_s": interval,
        "phase_compare": phase_compare,
        "best_effort_goodput_ratio": round(goodput_ratio, 4),
        "flat": flat,
        "tiered": tiered_leg,
        "violations": violations,
        "verdict": verdict,
    }


def overbooked_chips(s: Scheduler) -> List[str]:
    """Cards whose granted slots, memory or cores exceed what they
    advertise — the invariant a rescue must never break (empty =
    healthy)."""
    bad = []
    for node, per_chip in s.inspect_all_nodes_usage().items():
        for u in per_chip.values():
            if (u.used_slots > u.total_slots or u.used_mem > u.total_mem
                    or u.used_cores > u.total_cores):
                bad.append(f"{node}/{u.id}")
    return sorted(bad)


def run_chaos_phase(s: Scheduler, kube: FakeKube, names: List[str],
                    chaos: dict, clock: SimClock, placed: List[dict]) -> dict:
    """Play the failure scenario, let the rescuer contain it, then try to
    re-place every rescued pod on the surviving fleet — lease decay,
    quarantine, rescission and re-filter end to end, on virtual time."""
    inj = FaultInjector(s, clock, seed=int(chaos.get("seed", 0)))
    inj.attach()
    plan = [FaultEvent(**ev) for ev in chaos.get("events", [])]
    plan += inj.random_plan(int(chaos.get("random_events", 0)),
                            horizon_s=float(chaos.get("horizon_s", 60.0)))
    # Default settle: long enough for a partitioned node's lease to die
    # AND a quarantined card's probation to elapse.
    settle = float(chaos.get(
        "settle_s",
        s.leases.cfg.dead_after_s + 2 * s.quarantine.cfg.probation_s))
    actions = inj.run_plan(plan, sweep=s.rescuer.sweep, settle_s=settle)

    placed_uids = {f"uid-{p['pod']}": p["pod"] for p in placed}
    rescued = sorted(name for uid, name in placed_uids.items()
                     if s.pods.get(uid) is None)

    # Re-place pass over the survivors (the way kube-scheduler re-queues a
    # pod whose assignment was rescinded).
    survivors = [n for n in names if s.nodes.get_node(n) is not None]
    replaced, still_pending = [], []
    for pod_name_ in rescued:
        try:
            pod = kube.get_pod("sim", pod_name_)
        except Exception:  # noqa: BLE001 — deleted outright; its controller
            # would recreate it, which is outside this replay's scope
            still_pending.append({"pod": pod_name_, "reason": "pod gone"})
            continue
        r = s.filter(pod, survivors)
        if r.node:
            s.bind("sim", pod_name_, pod["metadata"]["uid"], r.node)
            nodelock.release_node(kube, r.node)
            replaced.append({"pod": pod_name_, "node": r.node})
        else:
            still_pending.append({"pod": pod_name_,
                                  "reason": r.error or "no fit"})
    return {
        "seed": int(chaos.get("seed", 0)),
        "injected": inj.log,
        "lease_states": {n: st.name
                         for n, st in sorted(s.leases.states().items())},
        "quarantined": {n: sorted(c)
                        for n, c in sorted(s.quarantine.active().items())},
        "rescued": rescued,
        "replaced": replaced,
        "still_pending": still_pending,
        "sweep_actions": len(actions),
        "overbooked_chips": overbooked_chips(s),
    }


# -- the capacity-queue A/B (quota/) -------------------------------------------

# --- fragmentation / defrag A/B (placement/) ---------------------------------

def _run_frag_sim(spec: dict, defrag_on: bool, *, nodes: int, chips: int,
                  hbm: int, mesh, generation: str, policy: str) -> dict:
    """One time-stepped fragmentation replay through the port's scheduler
    and defrag loop on a SimClock.  Churn pods (exclusive singles at
    preemptible priority) fill the fleet; a seeded/patterned subset
    exits, leaving scattered free cards; a mesh-declared gang arrives
    and is re-filtered every tick (kube-scheduler's retry of
    unschedulable pods).  With defrag on, the loop ticks alongside:
    victims get checkpoint requests, the harness plays the in-container
    watch (delete after ``checkpoint_delay_s``), their controllers
    recreate them, and the gang lands on the assembled boxes."""
    from ..placement import frag as frag_mod

    horizon = float(spec.get("horizon_s", 300.0))
    tick = float(spec.get("tick_s", 5.0))
    checkpoint_delay = float(spec.get("checkpoint_delay_s", tick))

    clock = SimClock()
    kube = FakeKube()
    cfg = Config(node_scheduler_policy=policy,
                 enable_defrag=defrag_on,
                 defrag_interval_s=tick,
                 defrag_demand_fresh_s=max(60.0, 6 * tick),
                 defrag_checkpoint_grace_s=float(
                     spec.get("checkpoint_grace_s",
                              4 * checkpoint_delay + 2 * tick)),
                 defrag_reservation_ttl_s=horizon)
    s = Scheduler(kube, cfg, clock=clock)
    names = build_fleet(s, kube, nodes, chips, hbm, mesh, generation)
    kube.watch_pods(s.on_pod_event)

    def place(pod) -> Optional[str]:
        r = s.filter(pod, names)
        if r.node:
            name = pod["metadata"]["name"]
            ns = pod["metadata"]["namespace"]
            s.bind(ns, name, pod["metadata"]["uid"], r.node)
            nodelock.release_node(kube, r.node)
        return r.node

    # 1. Churn fill: one exclusive, preemptible single per card.
    churn_entry = dict(spec.get("churn") or {})
    churn_entry.setdefault("name", "churn")
    churn_entry.setdefault("gpu", 1)
    churn_entry.setdefault("gpucores", 100)
    churn_entry.setdefault("priority", 1)
    total_chips = nodes * chips
    churn_pods = []
    for i in range(total_chips):
        p = spec_pod(churn_entry, i)
        kube.create_pod(p)
        if place(p) is not None:
            churn_pods.append(p)

    # 2. Fragment: the patterned subset exits.  "checkerboard" frees
    # every card whose coord parity is even — scattered singles, no
    # contiguous box anywhere; an explicit index list is also accepted.
    pattern = spec.get("release_pattern", "checkerboard")
    released = 0
    if isinstance(pattern, list):
        victims = {int(i) for i in pattern}
        for i, p in enumerate(churn_pods):
            if i in victims:
                kube.delete_pod(p["metadata"]["namespace"],
                                p["metadata"]["name"])
                released += 1
    else:
        for p in churn_pods:
            info = s.pods.get(p["metadata"]["uid"])
            if info is None:
                continue
            chip_ids = {d.uuid for c in info.devices for d in c}
            node_info = s.nodes.get_node(info.node)
            coords = [tuple(d.coords) for d in node_info.devices
                      if d.id in chip_ids]
            if coords and sum(coords[0]) % 2 == 0:
                kube.delete_pod(p["metadata"]["namespace"],
                                p["metadata"]["name"])
                released += 1

    views = frag_mod.fleet_views(s.snapshot())
    gang_entry = dict(spec.get("gang") or {})
    gang_entry.setdefault("name", "big")
    gang_entry.setdefault("gang", gang_entry["name"])
    gang_entry.setdefault("count", 1)
    gang_entry.setdefault("gpucores", 100)
    gang_chips = int(gang_entry.get("gpu", 4))
    before = {
        "slice_availability": frag_mod.slice_availability(
            views, [gang_chips]),
        "max_free_box": frag_mod.largest_free_box(views),
    }

    # 3. The blocked arrival: a mesh-declared gang.
    members = [spec_pod(gang_entry, i)
               for i in range(int(gang_entry["count"]))]
    for p in members:
        kube.create_pod(p)

    placed_at: Dict[str, float] = {}
    admitted_at: Optional[float] = None
    preempt_seen: Dict[str, float] = {}
    checkpoint_first: List[str] = []
    recreated: List[dict] = []
    victims_migrated: List[str] = []
    # uids the defrag loop's PLANS asked to migrate, vs uids observed
    # carrying the eviction flag before their exit: the verdict's
    # checkpoint-first proof compares the two.
    asked_uids: set = set()
    flagged_exited_uids: set = set()
    overbooked: List[str] = []
    t0 = clock()
    steps = int(round(horizon / tick))
    for _step in range(steps):
        now = clock() - t0
        # Gang members retry first (the pending queue the compaction
        # serves), then any recreated victims.
        for p in members + recreated:
            name = p["metadata"]["name"]
            if name in placed_at:
                continue
            try:
                kube.get_pod(p["metadata"]["namespace"], name)
            except Exception:  # noqa: BLE001 — deleted this tick
                continue
            if place(p) is not None:
                placed_at[name] = now
        if admitted_at is None and all(
                m["metadata"]["name"] in placed_at for m in members):
            admitted_at = now
        if defrag_on:
            for act in s.defrag.tick():
                if act["kind"] == "defrag-plan":
                    asked_uids.update(act["victims"])
        # The in-container watch's role: a flagged victim checkpoints
        # and exits after the delay; its controller recreates it.
        for pod in list(kube.list_pods()):
            anns = pod.get("metadata", {}).get("annotations", {})
            name = pod["metadata"]["name"]
            flag = anns.get(PREEMPT_ANNOTATION, "")
            if flag.startswith("rescue:defrag:"):
                first = preempt_seen.setdefault(name, now)
                if now - first >= checkpoint_delay:
                    checkpoint_first.append(name)
                    victims_migrated.append(name)
                    flagged_exited_uids.add(pod["metadata"]["uid"])
                    kube.delete_pod(pod["metadata"]["namespace"], name)
                    preempt_seen.pop(name, None)
                    replacement = {
                        "metadata": {
                            "name": f"{name}-r",
                            "namespace": pod["metadata"]["namespace"],
                            "uid": f"uid-{name}-r", "annotations": {}},
                        "spec": pod["spec"],
                    }
                    kube.create_pod(replacement)
                    recreated.append(replacement)
            elif not flag:
                preempt_seen.pop(name, None)
        bad = overbooked_chips(s)
        if bad:
            overbooked = sorted(set(overbooked) | set(bad))
        clock.advance(tick)

    views = frag_mod.fleet_views(s.snapshot())
    after = {
        "slice_availability": frag_mod.slice_availability(
            views, [gang_chips]),
        "max_free_box": frag_mod.largest_free_box(views),
    }
    s.close()
    replaced = sorted(n for n in placed_at
                      if n.endswith("-r"))
    return {
        "defrag": defrag_on,
        "released_for_fragmentation": released,
        "gang_members": len(members),
        "gang_chips_per_member": gang_chips,
        "admitted": admitted_at is not None,
        "admission_latency_s": admitted_at,
        "migrations": s.defrag.migrations_total,
        "plans": s.defrag.plans_total,
        "victims_migrated": sorted(set(victims_migrated)),
        "victims_checkpoint_first": sorted(set(checkpoint_first)),
        "victims_asked_uids": sorted(asked_uids),
        "victims_flagged_exited_uids": sorted(flagged_exited_uids),
        "victims_replaced": replaced,
        "availability_before": before,
        "availability_after": after,
        "overbooked_chips": overbooked,
    }


def run_fragmentation_phase(spec: dict, *, nodes: int, chips: int,
                            hbm: int, mesh, generation: str,
                            policy: str) -> dict:
    """Defrag-on vs defrag-off A/B on the same fragmented fleet and gang
    arrival.  The verdict: with defrag on the gang admits (and strictly
    sooner than off, which typically never admits), contiguous-slice
    availability at the gang's size is strictly better, every migrated
    victim was asked to checkpoint BEFORE its exit and was re-placed,
    and no card was ever double-booked in either run."""
    on = _run_frag_sim(spec, True, nodes=nodes, chips=chips, hbm=hbm,
                       mesh=mesh, generation=generation, policy=policy)
    off = _run_frag_sim(spec, False, nodes=nodes, chips=chips, hbm=hbm,
                        mesh=mesh, generation=generation, policy=policy)
    size = on["gang_chips_per_member"]
    avail_on = on["availability_after"]["slice_availability"].get(size, 0)
    avail_off = off["availability_after"]["slice_availability"].get(
        size, 0)
    # The availability comparison counts the gang's own landed boxes:
    # cards DELIVERED to the blocked gang are the point of compaction.
    delivered_on = on["gang_members"] if on["admitted"] else 0
    delivered_off = off["gang_members"] if off["admitted"] else 0
    latency_better = on["admitted"] and (
        not off["admitted"]
        or (on["admission_latency_s"] or 0.0)
        < (off["admission_latency_s"] or 0.0))
    verdict = {
        "gang_admitted_with_defrag": on["admitted"],
        "admission_latency_better": latency_better,
        "availability_better": (avail_on + delivered_on)
        > (avail_off + delivered_off),
        # Checkpoint-first proof: every victim a PLAN asked for was
        # observed carrying the eviction flag before its exit, and
        # nothing exited flagged that no plan asked for.
        "victims_checkpoint_first": (
            bool(on["victims_asked_uids"])
            and on["victims_asked_uids"]
            == on["victims_flagged_exited_uids"]),
        "victims_replaced": (
            len(on["victims_replaced"]) == len(on["victims_migrated"])),
        "no_overbooking": not (on["overbooked_chips"]
                               or off["overbooked_chips"]),
    }
    verdict["ok"] = all(verdict.values())
    return {
        "horizon_s": float(spec.get("horizon_s", 300.0)),
        "tick_s": float(spec.get("tick_s", 5.0)),
        "defrag_on": on,
        "defrag_off": off,
        "verdict": verdict,
    }


def format_fragmentation(fr: dict) -> str:
    v = fr["verdict"]
    on, off = fr["defrag_on"], fr["defrag_off"]

    def leg(r):
        adm = (f"admitted at {r['admission_latency_s']:.0f}s"
               if r["admitted"] else "NEVER admitted")
        return (f"{adm}; max free box "
                f"{r['availability_before']['max_free_box']} → "
                f"{r['availability_after']['max_free_box']} cards; "
                f"{r['plans']} plan(s), {r['migrations']} "
                f"migration(s)")

    lines = [
        "fragmentation A/B over {:.0f}s ({} gang member(s) × {} "
        "cards, {} churn pod(s) released):".format(
            fr["horizon_s"], on["gang_members"],
            on["gang_chips_per_member"],
            on["released_for_fragmentation"]),
        f"  defrag ON : {leg(on)}",
        f"  defrag OFF: {leg(off)}",
        "  victims: {} migrated, {} checkpoint-first, {} re-placed"
        .format(len(on["victims_migrated"]),
                len(on["victims_checkpoint_first"]),
                len(on["victims_replaced"])),
    ]
    if on["overbooked_chips"] or off["overbooked_chips"]:
        lines.append("  OVERBOOKED: "
                     + ", ".join(on["overbooked_chips"]
                                 + off["overbooked_chips"]))
    lines.append("  verdict: " + ("PASS" if v["ok"] else f"FAIL {v}"))
    return "\n".join(lines)


def _arrival_schedule(spec: dict) -> List[dict]:
    """The arrivals as one record a pod, in arrival order (name
    tie-break: the replay is deterministic)."""
    out = []
    for entry in spec.get("arrivals", []):
        count = int(entry.get("count", 1))
        at = float(entry.get("at_s", 0.0))
        every = float(entry.get("every_s", 0.0))
        for i in range(count):
            out.append({
                "entry": entry,
                "idx": i,
                "name": f"{entry['name']}-{i}",
                "namespace": entry.get("namespace", "sim"),
                "at_s": at + i * every,
                "runtime_s": float(entry.get("runtime_s", 60.0)),
            })
    out.sort(key=lambda a: (a["at_s"], a["name"]))
    return out


def _queue_spec_pod(arrival: dict, governed_queue: Optional[str]) -> dict:
    """One arrival's pod, with the webhook's annotations written by hand
    (no webhook in this path): the queue and its held state where
    governed, and the runtime estimate the backfill rule reads where the
    entry declares it."""
    entry = arrival["entry"]
    pod = spec_pod(entry, arrival["idx"])
    pod["metadata"]["namespace"] = arrival["namespace"]
    pod["metadata"]["uid"] = f"uid-{arrival['namespace']}-{arrival['name']}"
    anns = pod["metadata"]["annotations"]
    if governed_queue is not None:
        anns[QUEUE_ANNOTATION] = governed_queue
        anns[QUEUE_STATE_ANNOTATION] = STATE_HELD
    if entry.get("declare_runtime"):
        anns[RUNTIME_ESTIMATE_ANNOTATION] = str(arrival["runtime_s"])
    return pod


def _run_queue_sim(spec: dict, quota_on: bool, *, nodes: int, chips: int,
                   hbm: int, mesh, generation: str, policy: str) -> dict:
    """One time-stepped replay (fair, or FIFO without the queues) through
    the Scheduler and its admission loop on a SimClock.  Placed pods run
    for their runtime and exit; reclaim victims checkpoint (are deleted)
    ``checkpoint_delay_s`` after their request, the in-container watch's
    part, played here."""
    horizon = float(spec.get("horizon_s", 600.0))
    tick = float(spec.get("tick_s", 5.0))
    measure_from = float(spec.get("measure_from_s", horizon / 3))
    checkpoint_delay = float(spec.get("checkpoint_delay_s", tick))
    queues = tuple(spec.get("queues", ())) if quota_on else ()

    clock = SimClock()
    kube = FakeKube()
    cfg = Config(node_scheduler_policy=policy, quota_queues=queues,
                 queue_reclaim_grace_s=float(
                     spec.get("reclaim_grace_s", 2 * tick)),
                 fair_share_usage_informed=bool(
                     spec.get("usage_informed", False)))
    s = Scheduler(kube, cfg, clock=clock)
    names = build_fleet(s, kube, nodes, chips, hbm, mesh, generation)
    fleet_chips = nodes * chips
    kube.watch_pods(s.on_pod_event)

    schedule = _arrival_schedule(spec)
    ns_queue = {}
    for a in schedule:
        q = queue_for_namespace(queues, a["namespace"]) if quota_on else None
        ns_queue[a["namespace"]] = q.name if q else None
    next_arrival = 0
    live: Dict[str, dict] = {}       # name -> arrival record
    placed_at: Dict[str, float] = {}
    preempt_seen: Dict[str, float] = {}
    chip_seconds: Dict[str, float] = {}   # namespace -> measured window
    busy_seconds = 0.0                     # the fleet, measured window
    admit_actions: List[dict] = []
    reclaim_actions: List[dict] = []
    reclaim_victims_borrowed = True
    overbooked: List[str] = []

    steps = int(round(horizon / tick))
    start = clock()
    for _step in range(steps):
        now = clock() - start
        # 1. Arrivals.
        while next_arrival < len(schedule) \
                and schedule[next_arrival]["at_s"] <= now:
            a = schedule[next_arrival]
            next_arrival += 1
            kube.create_pod(_queue_spec_pod(a, ns_queue[a["namespace"]]))
            live[a["name"]] = a
        # 2. Completions.
        for name in [n for n, t in placed_at.items()
                     if t + live[n]["runtime_s"] <= now]:
            a = live.pop(name)
            placed_at.pop(name)
            kube.delete_pod(a["namespace"], name)
        # 3. Reclaim victims exit the delay after their request.
        for pod in kube.list_pods():
            anns = pod.get("metadata", {}).get("annotations", {})
            name = pod["metadata"]["name"]
            if anns.get(PREEMPT_ANNOTATION):
                first = preempt_seen.setdefault(name, now)
                if now - first >= checkpoint_delay and name in live:
                    a = live.pop(name)
                    placed_at.pop(name, None)
                    kube.delete_pod(a["namespace"], name)
            else:
                preempt_seen.pop(name, None)
        # 4. Admission.  Every reclaim victim must come out of cards its
        # donor queue held over nominal at plan time: the loop records
        # that amount a victim, the verdict holds it.
        if quota_on:
            for act in s.admission.tick():
                if act["kind"] == "admit":
                    admit_actions.append(dict(act, at_s=now))
                elif act["kind"] == "reclaim":
                    reclaim_actions.append(dict(act, at_s=now))
                    for v in act["victims"]:
                        if v.get("donor_borrowed", 0) < v["chips"]:
                            reclaim_victims_borrowed = False
        # 5. One Filter pass over the unplaced pods (kube-scheduler's
        # retry of unschedulable pods).
        for name, a in sorted(live.items()):
            if name in placed_at:
                continue
            try:
                pod = kube.get_pod(a["namespace"], name)
            except Exception:  # noqa: BLE001 — deleted this tick
                continue
            r = s.filter(pod, names)
            if r.node:
                s.bind(a["namespace"], name, pod["metadata"]["uid"],
                       r.node)
                nodelock.release_node(kube, r.node)
                placed_at[name] = now
        # 6. Admitted GPU-seconds, and the double-booking invariant.
        if now >= measure_from:
            busy = 0
            for p in s.pods.list_pods():
                n_chips = sum(len(c) for c in p.devices)
                busy += n_chips
                chip_seconds[p.namespace] = \
                    chip_seconds.get(p.namespace, 0.0) + n_chips * tick
            busy_seconds += busy * tick
        bad = overbooked_chips(s)
        if bad:
            overbooked = sorted(set(overbooked) | set(bad))
        clock.advance(tick)
    s.close()

    measured_window = max(tick, horizon - measure_from)
    util = busy_seconds / (fleet_chips * measured_window) \
        if fleet_chips else 0.0
    return {
        "chip_seconds_by_namespace": {
            ns: round(v, 1) for ns, v in sorted(chip_seconds.items())},
        "utilization": round(util, 4),
        "admitted": len(admit_actions),
        "backfilled": sum(1 for a in admit_actions if a.get("backfilled")),
        "reclaims": reclaim_actions,
        "reclaim_only_borrowed": reclaim_victims_borrowed,
        "overbooked_chips": overbooked,
        "still_pending": sorted(n for n in live if n not in placed_at),
        "queues": (s.quota.stats(s.pods.list_pods())["queues"]
                   if quota_on else []),
    }


def run_queueing_phase(spec: dict, *, nodes: int, chips: int, hbm: int,
                       mesh, generation: str, policy: str) -> dict:
    """Fair share against FIFO on the same contended arrivals.  The
    verdict: admitted GPU-seconds within ``weight_tolerance_pct`` of the
    weights' proportions, utilization at least FIFO's (less one tick's
    noise, 0.02), reclaim victims always borrowed, no card overbooked."""
    fair = _run_queue_sim(spec, True, nodes=nodes, chips=chips, hbm=hbm,
                          mesh=mesh, generation=generation, policy=policy)
    fifo = _run_queue_sim(spec, False, nodes=nodes, chips=chips, hbm=hbm,
                          mesh=mesh, generation=generation, policy=policy)

    queues = spec.get("queues", [])
    weight_total = sum(float(q.get("weight", 1.0)) for q in queues) or 1.0
    measured_total = sum(
        fair["chip_seconds_by_namespace"].get(ns, 0.0)
        for q in queues for ns in q.get("namespaces", ()))
    tol = float(spec.get("weight_tolerance_pct", 10.0)) / 100.0
    shares = []
    converged = measured_total > 0
    for q in queues:
        got = sum(fair["chip_seconds_by_namespace"].get(ns, 0.0)
                  for ns in q.get("namespaces", ()))
        share = got / measured_total if measured_total else 0.0
        target = float(q.get("weight", 1.0)) / weight_total
        ok = abs(share - target) <= tol
        converged = converged and ok
        shares.append({"queue": q["name"], "weight": q.get("weight", 1.0),
                       "target_share": round(target, 4),
                       "admitted_share": round(share, 4),
                       "admitted_chip_seconds": round(got, 1),
                       "within_tolerance": ok})
    verdict = {
        "converged": converged,
        "tolerance_pct": float(spec.get("weight_tolerance_pct", 10.0)),
        "utilization_ok": fair["utilization"] >= fifo["utilization"] - 0.02,
        "reclaim_only_borrowed": fair["reclaim_only_borrowed"],
        "no_overbooking": not (fair["overbooked_chips"]
                               or fifo["overbooked_chips"]),
    }
    verdict["ok"] = all(verdict[k] for k in
                        ("converged", "utilization_ok",
                         "reclaim_only_borrowed", "no_overbooking"))
    horizon = float(spec.get("horizon_s", 600.0))
    return {
        "horizon_s": horizon,
        "tick_s": float(spec.get("tick_s", 5.0)),
        "measure_from_s": float(spec.get("measure_from_s", horizon / 3)),
        "shares": shares,
        "fair": fair,
        "fifo": {"chip_seconds_by_namespace":
                 fifo["chip_seconds_by_namespace"],
                 "utilization": fifo["utilization"],
                 "overbooked_chips": fifo["overbooked_chips"]},
        "verdict": verdict,
    }


# --- elastic mesh resizing A/B (elastic/) -------------------------------------

def _elastic_gang_generation(gang_spec: dict, mesh_str: str, gen: int,
                             nums: int, governed_queue: Optional[str]
                             ) -> List[dict]:
    """One generation of the elastic gang at rung ``mesh_str``: the
    member count is ``volume // nums`` (per-member cards never change),
    every member carries the range annotations plus the webhook's
    mutations written by hand (queue and held state), and names and uids
    embed the generation so recreations never collide in the fake
    apiserver."""
    total = mesh_volume(parse_mesh(mesh_str)) // nums
    ns = gang_spec["namespace"]
    out = []
    for i in range(total):
        name = f"{gang_spec['name']}-g{gen}-{i}"
        limits = {_NAMES.count: str(nums),
                  _NAMES.cores: str(gang_spec["gpucores"])}
        anns = {
            MESH_ANNOTATION: mesh_str,
            MESH_MIN_ANNOTATION: str(gang_spec["mesh_min"]),
            MESH_MAX_ANNOTATION: str(gang_spec["mesh_max"]),
            GANG_GROUP_ANNOTATION: gang_spec["gang"],
            GANG_TOTAL_ANNOTATION: str(total),
        }
        if governed_queue is not None:
            anns[QUEUE_ANNOTATION] = governed_queue
            anns[QUEUE_STATE_ANNOTATION] = STATE_HELD
        out.append({
            "metadata": {"name": name, "namespace": ns,
                         "uid": f"uid-{ns}-{name}", "annotations": anns},
            "spec": {"containers": [{
                "name": "main", "resources": {"limits": limits}}]},
        })
    return out


def _run_elastic_sim(spec: dict, elastic_on: bool, *, nodes: int,
                     chips: int, hbm: int, mesh, generation: str,
                     policy: str) -> dict:
    """One time-stepped elastic replay through the port's REAL admission,
    reclaim and resize loops on a SimClock.  An elastic gang (mesh range
    declared) holds borrowed capacity; a latency burst arrives and the
    entitled queue takes cards back: with elastic ON by rung shrinks
    (``quota/admission.py``'s shrink pass → ``elastic.begin_shrink``),
    with it OFF by plain reclaim kills.  The harness plays the
    in-container watch AND the workload controller: flagged members
    checkpoint and exit after ``checkpoint_delay_s``; a generation whose
    members carry ``vtpu.dev/mesh-assigned`` is recreated whole at the
    assigned rung (same group, new total, fresh uids) and re-admits
    through the ordinary held-gang path.

    The gang's training trajectory is a sha256 hash chain stepped once
    per fully placed tick; each resize records (steps, state) at the
    checkpoint and the recreated generation RESUMES the chain: the final
    state must equal H^steps(seed), the bit-identical resume proof.
    """
    horizon = float(spec.get("horizon_s", 720.0))
    tick = float(spec.get("tick_s", 5.0))
    checkpoint_delay = float(spec.get("checkpoint_delay_s", tick))
    queues = tuple(spec.get("queues", ()))

    clock = SimClock()
    kube = FakeKube()
    cfg = Config(
        node_scheduler_policy=policy,
        quota_queues=queues,
        queue_reclaim_grace_s=float(spec.get("reclaim_grace_s", 6 * tick)),
        enable_elastic=elastic_on,
        elastic_interval_s=tick,
        resize_hysteresis_s=float(spec.get("hysteresis_s", 60.0)),
        resize_checkpoint_grace_s=float(
            spec.get("checkpoint_grace_s",
                     4 * checkpoint_delay + 2 * tick)),
        elastic_downgrade_after_s=float(
            spec.get("downgrade_after_s", 6 * tick)))
    s = Scheduler(kube, cfg, clock=clock)
    names = build_fleet(s, kube, nodes, chips, hbm, mesh, generation)
    fleet_chips = nodes * chips
    kube.watch_pods(s.on_pod_event)

    gang_spec = dict(spec.get("gang") or {})
    gang_spec.setdefault("name", "train")
    gang_spec.setdefault("gang", gang_spec["name"])
    gang_spec.setdefault("namespace", "sim")
    gang_spec.setdefault("gpu", 4)
    gang_spec.setdefault("gpucores", 100)
    gang_spec.setdefault("mesh", "4x4")
    gang_spec.setdefault("mesh_min", "2x2")
    gang_spec.setdefault("mesh_max", gang_spec["mesh"])
    nums = int(gang_spec["gpu"])
    gang_at = float(gang_spec.get("at_s", 0.0))
    gang_ns = gang_spec["namespace"]

    def governed(ns: str) -> Optional[str]:
        q = queue_for_namespace(queues, ns) if queues else None
        return q.name if q is not None else None

    schedule = _arrival_schedule(spec)
    ns_queue = {a["namespace"]: governed(a["namespace"])
                for a in schedule}

    # Gang state: the current generation's manifests and rung, and the
    # hash-chain trajectory carried ACROSS generations.
    current_mesh = str(gang_spec["mesh"])
    gen_idx = 0
    gen_pods: List[dict] = []
    gang_placed: set = set()
    gang_flagged_at: Optional[float] = None
    gang_assigned = ""
    seed = hashlib.sha256(
        f"elastic:{gang_ns}/{gang_spec['gang']}".encode()).digest()
    traj_steps = 0
    traj_state = seed
    resize_points: List[dict] = []

    next_arrival = 0
    live: Dict[str, dict] = {}
    placed_at: Dict[str, float] = {}
    first_placed: Dict[str, float] = {}
    completed_at: Dict[str, float] = {}
    preempt_seen: Dict[str, float] = {}
    kills: List[dict] = []
    killed_uids: set = set()
    accrued: Dict[str, float] = {}     # uid -> GPU-seconds
    uid_of: Dict[str, str] = {}        # arrival name -> uid
    resizes: List[dict] = []
    admits = 0
    reclaim_plans: List[dict] = []
    busy_seconds = 0.0
    overbooked: List[str] = []

    def place(pod) -> Optional[str]:
        r = s.filter(pod, names)
        if r.node:
            s.bind(pod["metadata"]["namespace"], pod["metadata"]["name"],
                   pod["metadata"]["uid"], r.node)
            nodelock.release_node(kube, r.node)
        return r.node

    steps = int(round(horizon / tick))
    t0 = clock()
    for _step in range(steps):
        now = clock() - t0
        # 1. Arrivals: the gang's first generation, then the singles.
        if not gen_pods and gen_idx == 0 and now >= gang_at:
            gen_pods = _elastic_gang_generation(
                gang_spec, current_mesh, 0, nums, governed(gang_ns))
            for p in gen_pods:
                kube.create_pod(p)
        while next_arrival < len(schedule) \
                and schedule[next_arrival]["at_s"] <= now:
            a = schedule[next_arrival]
            next_arrival += 1
            pod = _queue_spec_pod(a, ns_queue[a["namespace"]])
            uid_of[a["name"]] = pod["metadata"]["uid"]
            kube.create_pod(pod)
            live[a["name"]] = a
        # 2. Completions (runtime elapsed); the gang never completes.
        for name in [n for n, t in placed_at.items()
                     if t + live[n]["runtime_s"] <= now]:
            a = live.pop(name)
            placed_at.pop(name)
            completed_at[name] = now
            kube.delete_pod(a["namespace"], name)
        # 3a. The workload controller: a generation whose members carry
        # mesh-assigned and the eviction request checkpoints, exits after
        # the delay, and is recreated WHOLE at the assigned rung.
        flagged = False
        for p in gen_pods:
            try:
                cur = kube.get_pod(gang_ns, p["metadata"]["name"])
            except Exception:  # noqa: BLE001 — mid-churn
                continue
            anns = cur.get("metadata", {}).get("annotations", {})
            if anns.get(PREEMPT_ANNOTATION) \
                    and anns.get(MESH_ASSIGNED_ANNOTATION):
                flagged = True
                gang_assigned = anns[MESH_ASSIGNED_ANNOTATION]
        if flagged and gang_flagged_at is None:
            gang_flagged_at = now
        if gang_flagged_at is not None \
                and now - gang_flagged_at >= checkpoint_delay:
            resize_points.append({
                "at_s": now, "from": current_mesh, "to": gang_assigned,
                "steps": traj_steps, "state": traj_state.hex()})
            for p in gen_pods:
                try:
                    kube.delete_pod(gang_ns, p["metadata"]["name"])
                except Exception:  # noqa: BLE001 — already gone
                    pass
            gen_idx += 1
            current_mesh = gang_assigned
            gen_pods = _elastic_gang_generation(
                gang_spec, current_mesh, gen_idx, nums,
                governed(gang_ns))
            gang_placed = set()
            gang_flagged_at = None
            for p in gen_pods:
                kube.create_pod(p)
        # 3b. The in-container watch of PLAIN victims (reclaim kills,
        # elastic off): checkpoint and exit; nothing recreates them, the
        # sunk work is the kill's cost.
        for pod in kube.list_pods():
            name = pod["metadata"]["name"]
            if name not in live:
                continue
            anns = pod.get("metadata", {}).get("annotations", {})
            flag = anns.get(PREEMPT_ANNOTATION, "")
            if flag and not anns.get(MESH_ASSIGNED_ANNOTATION):
                first = preempt_seen.setdefault(name, now)
                if now - first >= checkpoint_delay:
                    a = live.pop(name)
                    placed_at.pop(name, None)
                    preempt_seen.pop(name, None)
                    kube.delete_pod(a["namespace"], name)
                    kills.append({"pod": name, "at_s": now})
                    killed_uids.add(uid_of[name])
            elif not flag:
                preempt_seen.pop(name, None)
        # 4. The REAL admission loop (quota gate, fair-share release,
        # reclaim, which shrinks first through the resize controller).
        for act in s.admission.tick():
            kind = act.get("kind")
            if kind == "admit":
                admits += 1
            elif kind == "reclaim":
                reclaim_plans.append(dict(act, at_s=now))
            elif kind.startswith("resize"):
                resizes.append(dict(act, at_s=now))
        # 5. The REAL resize controller (grow on surplus, hysteresis,
        # in-flight progress).  Not ticked when elastic is off: the off
        # leg must run no elastic code, as in production.
        if elastic_on:
            for act in s.elastic.tick():
                if act["kind"] in ("resize-shrink", "resize-grow",
                                   "resize-downgrade", "resize-abort"):
                    resizes.append(dict(act, at_s=now))
        # 6. Filter over the unplaced pods (kube-scheduler's retry).
        for name, a in sorted(live.items()):
            if name in placed_at:
                continue
            try:
                pod = kube.get_pod(a["namespace"], name)
            except Exception:  # noqa: BLE001 — deleted this tick
                continue
            if place(pod) is not None:
                placed_at[name] = now
                first_placed.setdefault(name, now)
        for p in gen_pods:
            name = p["metadata"]["name"]
            if name in gang_placed:
                continue
            try:
                pod = kube.get_pod(gang_ns, name)
            except Exception:  # noqa: BLE001 — deleted this tick
                continue
            if place(pod) is not None:
                gang_placed.add(name)
        # 7. Trajectory: the gang trains one step a tick while fully
        # placed and not checkpointing: the chain the resume must
        # continue bit for bit.
        if gen_pods and gang_flagged_at is None and not flagged \
                and all(p["metadata"]["name"] in gang_placed
                        for p in gen_pods):
            traj_steps += 1
            traj_state = hashlib.sha256(traj_state).digest()
        # 8. Accrual and the double-booking invariant.
        busy = 0
        for p in s.pods.list_pods():
            n_chips = sum(len(c) for c in p.devices)
            busy += n_chips
            accrued[p.uid] = accrued.get(p.uid, 0.0) + n_chips * tick
        busy_seconds += busy * tick
        bad = overbooked_chips(s)
        if bad:
            overbooked = sorted(set(overbooked) | set(bad))
        clock.advance(tick)

    # Trajectory proof: replay the chain from the seed alone and check
    # every recorded resize point AND the final state land on it.
    chain = [seed]
    for _ in range(traj_steps):
        chain.append(hashlib.sha256(chain[-1]).digest())
    traj_ok = traj_state == chain[traj_steps] and all(
        rp["steps"] <= traj_steps
        and rp["state"] == chain[rp["steps"]].hex()
        for rp in resize_points)

    # Goodput is exclusion-based: a saturated fleet conserves raw
    # GPU-seconds whoever holds them, so the discriminator is what the
    # accrual was WORTH: killed pods' sunk work (no checkpoint-resume
    # lineage) and deadline-missed latency runs count as waste, resized
    # gang generations keep every pre-resize second.
    total_accrued = sum(accrued.values())
    slo_met = slo_missed = 0
    jcts: List[float] = []
    wasted = sum(accrued.get(u, 0.0) for u in killed_uids)
    for a in schedule:
        deadline = a["entry"].get("deadline_s")
        if deadline is None:
            continue
        name = a["name"]
        jcts.append(completed_at.get(name, horizon) - a["at_s"])
        started = first_placed.get(name)
        if started is not None and started - a["at_s"] <= float(deadline):
            slo_met += 1
        else:
            slo_missed += 1
            if uid_of[name] not in killed_uids:  # never double-count
                wasted += accrued.get(uid_of[name], 0.0)
    mean_jct = sum(jcts) / len(jcts) if jcts else 0.0

    result = {
        "elastic": elastic_on,
        "total_chip_seconds": round(total_accrued, 1),
        "goodput_chip_seconds": round(total_accrued - wasted, 1),
        "wasted_chip_seconds": round(wasted, 1),
        "utilization": round(busy_seconds / (fleet_chips * horizon), 4)
        if fleet_chips else 0.0,
        "mean_latency_jct_s": round(mean_jct, 1),
        "slo_met": slo_met,
        "slo_missed": slo_missed,
        "kills": kills,
        "admitted": admits,
        "reclaim_plans": len(reclaim_plans),
        "resizes": resizes,
        "shrinks": sum(1 for r in resizes
                       if r["kind"] == "resize-shrink"),
        "grows": sum(1 for r in resizes if r["kind"] == "resize-grow"),
        "resizes_by_requester": {
            f"{d}/{lab}": n
            for (d, lab), n in sorted(s.elastic.resizes_total.items())},
        "thrash": s.elastic.thrash_total,
        "aborted_resizes": s.elastic.aborted_total,
        "gang": {
            "final_mesh": current_mesh,
            "generations": gen_idx + 1,
            "trajectory_steps": traj_steps,
            "resize_points": resize_points,
            "trajectory_ok": traj_ok,
        },
        "overbooked_chips": overbooked,
        "still_pending": sorted(n for n in live if n not in placed_at),
    }
    s.close()
    return result


def run_elastic_phase(spec: dict, *, nodes: int, chips: int, hbm: int,
                      mesh, generation: str, policy: str) -> dict:
    """Elastic on against elastic off on the same gang and burst.  The
    verdict: goodput and burst JCT strictly better with elastic on, the
    on leg resolves the crunch with ZERO kills (shrinks instead) while
    the off leg kills, the gang both shrinks and grows back, no thrash,
    the hash-chain trajectory resumes bit for bit at every resize point,
    no card overbooked in either leg, and the off leg runs no elastic
    code path (no resizes of any kind)."""
    on = _run_elastic_sim(spec, True, nodes=nodes, chips=chips, hbm=hbm,
                          mesh=mesh, generation=generation, policy=policy)
    off = _run_elastic_sim(spec, False, nodes=nodes, chips=chips,
                           hbm=hbm, mesh=mesh, generation=generation,
                           policy=policy)
    verdict = {
        "goodput_better": on["goodput_chip_seconds"]
        > off["goodput_chip_seconds"],
        "jct_better": on["mean_latency_jct_s"]
        < off["mean_latency_jct_s"],
        "no_kills_with_elastic": len(on["kills"]) == 0,
        "kills_without_elastic": len(off["kills"]) > 0,
        "shrank_and_regrew": on["shrinks"] >= 1 and on["grows"] >= 1,
        "no_thrash": on["thrash"] == 0,
        "trajectory_bit_identical": (on["gang"]["trajectory_ok"]
                                     and off["gang"]["trajectory_ok"]),
        "elastic_off_inert": not off["resizes"] and off["thrash"] == 0,
        "no_overbooking": not (on["overbooked_chips"]
                               or off["overbooked_chips"]),
    }
    verdict["ok"] = all(verdict.values())
    return {
        "horizon_s": float(spec.get("horizon_s", 720.0)),
        "tick_s": float(spec.get("tick_s", 5.0)),
        "elastic_on": on,
        "elastic_off": off,
        "verdict": verdict,
    }


# -- predictive capacity planning (accounting/forecast.py + planner.py) -------

def _capacity_demand_series(spec: dict, stream: dict,
                            total_buckets: int,
                            bucket_s: float) -> List[float]:
    """One stream's cards of new demand per bucket over history+horizon:
    an explicit captured trace (``series`` rows, resampled into buckets)
    or a named deterministic pattern (accounting/planner.py)."""
    rows = stream.get("series")
    if rows:
        sums = [0.0] * total_buckets
        ns = [0] * total_buckets
        for t, v in rows:
            b = int(t // bucket_s)
            if 0 <= b < total_buckets:
                sums[b] += float(v)
                ns[b] += 1
        return [sums[b] / ns[b] if ns[b] else 0.0
                for b in range(total_buckets)]
    pattern = stream.get("pattern") or spec.get("pattern")
    params = dict(spec.get("pattern_params") or {})
    params.update(stream.get("pattern_params") or {})
    return planner_mod.synth_demand(pattern, params, total_buckets)


def _run_capacity_sim(arrivals: List[dict], queues: tuple, *,
                      nodes: int, chips: int, hbm: int, mesh,
                      generation: str, policy: str, horizon_s: float,
                      tick_s: float, starve_after_s: float) -> dict:
    """One time-stepped replay of an arrival schedule through the port's
    admission loop on a SimClock: the quota gate and fair-share release,
    a batched ``filter_many`` of every unplaced pod each tick (in name
    order, as kube-scheduler re-queues unschedulable pods) and the defrag
    loop ticking alongside.  Starvation is per queue: the first moment any of
    its pods has waited ``starve_after_s`` unplaced.  Reclaim and defrag
    victims checkpoint and exit after one tick (the in-container watch's
    part, played here, as in the queueing phase)."""
    clock = SimClock()
    kube = FakeKube()
    cfg = Config(node_scheduler_policy=policy,
                 quota_queues=queues,
                 enable_defrag=True,
                 defrag_interval_s=tick_s,
                 queue_reclaim_grace_s=2 * tick_s)
    s = Scheduler(kube, cfg, clock=clock)
    names = build_fleet(s, kube, nodes, chips, hbm, mesh, generation)
    fleet_chips = nodes * chips
    kube.watch_pods(s.on_pod_event)

    schedule = _arrival_schedule({"arrivals": arrivals})
    ns_queue = {}
    for a in schedule:
        ns = a["namespace"]
        if ns not in ns_queue:
            q = queue_for_namespace(queues, ns) if queues else None
            ns_queue[ns] = q.name if q is not None else None

    next_arrival = 0
    live: Dict[str, dict] = {}
    created_at: Dict[str, float] = {}
    placed_at: Dict[str, float] = {}
    preempt_seen: Dict[str, float] = {}
    starved_at: Dict[str, float] = {}
    busy_seconds = 0.0
    overbooked: List[str] = []
    steps = int(round(horizon_s / tick_s))
    t0 = clock()
    for _step in range(steps):
        now = clock() - t0
        while next_arrival < len(schedule) \
                and schedule[next_arrival]["at_s"] <= now:
            a = schedule[next_arrival]
            next_arrival += 1
            kube.create_pod(_queue_spec_pod(a, ns_queue[a["namespace"]]))
            live[a["name"]] = a
            created_at[a["name"]] = now
        for name in [n for n, t in placed_at.items()
                     if t + live[n]["runtime_s"] <= now]:
            a = live.pop(name)
            placed_at.pop(name)
            kube.delete_pod(a["namespace"], name)
        # Reclaim/defrag victims checkpoint and exit after the delay.
        for pod in kube.list_pods():
            anns = pod.get("metadata", {}).get("annotations", {})
            name = pod["metadata"]["name"]
            if anns.get(PREEMPT_ANNOTATION):
                first = preempt_seen.setdefault(name, now)
                if now - first >= tick_s and name in live:
                    a = live.pop(name)
                    placed_at.pop(name, None)
                    kube.delete_pod(a["namespace"], name)
            else:
                preempt_seen.pop(name, None)
        if queues:
            s.admission.tick()
        s.defrag.tick()
        # The batched drain: every unplaced pod retries through one
        # filter_many a tick (scheduler/batch.py), as kube-scheduler
        # re-queues unschedulable pods.
        items = []
        order = []
        for name, a in sorted(live.items()):
            if name in placed_at:
                continue
            try:
                pod = kube.get_pod(a["namespace"], name)
            except Exception:  # noqa: BLE001 — deleted this tick
                continue
            items.append((pod, names))
            order.append((name, a, pod))
        if items:
            results = s.filter_many(items)
            for (name, a, pod), r in zip(order, results):
                if r.node:
                    s.bind(a["namespace"], name, pod["metadata"]["uid"],
                           r.node)
                    nodelock.release_node(kube, r.node)
                    placed_at[name] = now
        # Starvation census: a queue starves the instant one of its pods
        # has waited starve_after_s unplaced (held in the queue or
        # released but unplaceable both count: the tenant cannot tell
        # the difference).
        for name, a in sorted(live.items()):
            if name in placed_at:
                continue
            waited = now - created_at[name]
            if waited >= starve_after_s:
                q = ns_queue[a["namespace"]] or a["namespace"]
                starved_at.setdefault(
                    q, created_at[name] + starve_after_s)
        busy_seconds += sum(
            sum(len(c) for c in p.devices)
            for p in s.pods.list_pods()) * tick_s
        bad = overbooked_chips(s)
        if bad:
            overbooked = sorted(set(overbooked) | set(bad))
        clock.advance(tick_s)
    still_pending = sorted(n for n in live if n not in placed_at)
    s.close()
    return {
        "nodes": nodes,
        "placed": len(placed_at) + sum(
            1 for n in created_at if n not in live and n not in placed_at),
        "arrived": len(created_at),
        "still_pending": still_pending,
        "starved_at": {q: round(t, 3)
                       for q, t in sorted(starved_at.items())},
        "utilization": round(
            busy_seconds / (fleet_chips * horizon_s), 4)
        if fleet_chips and horizon_s else 0.0,
        "overbooked_chips": overbooked,
    }


def run_capacity_phase(spec: dict, *, nodes: int, chips: int, hbm: int,
                       mesh, generation: str, policy: str) -> dict:
    """Forecast-vs-actual capacity planning:

    1. each stream's demand trace is split into history + horizon;
    2. the forecaster learns the history and projects the horizon;
    3. the FORECAST arrivals replay through the admission loop →
       predicted starvation ETA per queue;
    4. the ACTUAL horizon arrivals replay identically → actual
       starvation;
    5. verdict: predicted within one forecast bucket of actual for every
       queue the scenario requires to starve, forecast error reported, no
       card overbooked in any replay — and, when the scenario asks for a
       scale recommendation, a node sweep over the forecast until the
       critical queue stays unstarved, then verified against the ACTUAL
       arrivals at the recommended size.

    With ``replica_loss`` the cost of losing a replica is priced through
    ``run_ha_phase`` with a storm sized from the forecast's peak."""
    bucket_s = float(spec.get("bucket_s", 30.0))
    history_buckets = int(spec.get("history_buckets", 48))
    horizon_buckets = int(spec.get("horizon_buckets", 16))
    tick_s = float(spec.get("tick_s", 5.0))
    starve_after_s = float(spec.get("starve_after_s", 60.0))
    horizon_s = horizon_buckets * bucket_s
    total = history_buckets + horizon_buckets
    queues = tuple(spec.get("queues", ()))
    fcfg = ForecastConfig(
        bucket_s=bucket_s,
        season_buckets=int(spec.get("season_buckets", 8)),
        alpha=float(spec.get("alpha", 0.1)),
        beta=float(spec.get("beta", 0.05)),
        gamma=float(spec.get("gamma", 0.5)))

    streams = spec.get("streams") or []
    per_stream = []
    err_num = err_den = 0.0
    for stream in streams:
        series = _capacity_demand_series(spec, stream, total, bucket_s)
        fc = SeriesForecaster(fcfg)
        for b in range(history_buckets):
            fc.observe(b * bucket_s, series[b])
        fc.observe(history_buckets * bucket_s, 0.0)  # close the last one
        points = fc.forecast(horizon_buckets)
        actual = series[history_buckets:total]
        predicted = [p.mean for p in points]
        err_num += sum(abs(p - a) for p, a in zip(predicted, actual))
        err_den += sum(abs(a) for a in actual)
        per_stream.append({
            "stream": stream, "actual": actual, "predicted": predicted,
            "upper": [p.upper for p in points],
            "error_ratio": (round(fc.error_ratio(), 4)
                            if fc.error_ratio() is not None else None),
        })
    forecast_error_ratio = round(err_num / err_den, 4) if err_den else 0.0

    def entries_of(kind: str) -> List[dict]:
        out = []
        for ps in per_stream:
            out.extend(planner_mod.arrival_entries(
                ps["stream"], ps[kind], bucket_s))
        return out

    sim_kw = dict(chips=chips, hbm=hbm, mesh=mesh,
                  generation=generation, policy=policy,
                  horizon_s=horizon_s, tick_s=tick_s,
                  starve_after_s=starve_after_s)
    predicted_run = _run_capacity_sim(entries_of("predicted"), queues,
                                      nodes=nodes, **sim_kw)
    actual_run = _run_capacity_sim(entries_of("actual"), queues,
                                   nodes=nodes, **sim_kw)

    require = list(spec.get("require_starvation", ()))
    eta_rows = []
    eta_ok = True
    starvation_observed = True
    for q in sorted(set(predicted_run["starved_at"])
                    | set(actual_run["starved_at"]) | set(require)):
        pred = predicted_run["starved_at"].get(q)
        act = actual_run["starved_at"].get(q)
        within = (pred is not None and act is not None
                  and abs(pred - act) <= bucket_s)
        eta_rows.append({"queue": q, "predicted_eta_s": pred,
                         "actual_eta_s": act,
                         "within_one_bucket": within})
        if q in require:
            starvation_observed = starvation_observed and act is not None
            eta_ok = eta_ok and within

    recommendation = None
    rec_ok = True
    if spec.get("recommend"):
        critical = spec.get("critical_queue", "")
        max_extra = int(spec.get("max_extra_nodes", 8))
        chosen = None
        sweep = []
        for extra in range(max_extra + 1):
            leg = _run_capacity_sim(entries_of("predicted"), queues,
                                    nodes=nodes + extra, **sim_kw)
            starved = critical in leg["starved_at"] if critical \
                else bool(leg["starved_at"])
            sweep.append({"nodes": nodes + extra,
                          "critical_starved": starved,
                          "overbooked": bool(leg["overbooked_chips"])})
            if not starved and not leg["overbooked_chips"]:
                chosen = nodes + extra
                break
        applied = None
        if chosen is not None:
            applied = _run_capacity_sim(entries_of("actual"), queues,
                                        nodes=chosen, **sim_kw)
        recommendation = {
            "critical_queue": critical,
            "nodes_current": nodes,
            "nodes_recommended": chosen,
            "nodes_to_add": (chosen - nodes)
            if chosen is not None else None,
            "sweep": sweep,
            "applied": applied,
        }
        rec_ok = (chosen is not None and applied is not None
                  and critical not in applied["starved_at"]
                  and not applied["overbooked_chips"])

    replica_loss = None
    if spec.get("replica_loss"):
        # "What does losing a replica cost?": the ha run (run_ha_phase)
        # with a storm sized from the forecast's peak, so the orphan
        # window is contended as the forecast says it will be.  The cost:
        # the adoption latency, the pods pended through the window (the
        # re-placement churn) and the rebalances.
        rl = dict(spec["replica_loss"])
        peak = max((max(ps["predicted"]) for ps in per_stream),
                   default=1.0)
        storm = rl.pop("storm", None) or {
            "name": "whatif", "gpu": 1, "gpumem": 2000,
            "count": max(8, int(math.ceil(peak)) * 4)}
        rl.setdefault("replicas", 3)
        rl.setdefault("seed", 7)
        ha = run_ha_phase(dict(rl, storm=storm), nodes=max(nodes, 3),
                          chips=chips, hbm=hbm, mesh=mesh,
                          generation=generation, policy=policy)
        replica_loss = {
            "replicas": ha["replicas"],
            "killed": ha["killed"],
            "adoption_latency_s": ha["adoption_latency_s"],
            "pods_pended_through_window": ha["pending_during_window"],
            "replacement_churn": len(ha["replaced"]),
            "shard_rebalances": ha["rebalances"],
            "protocol_ok": ha["verdict"]["ok"],
        }

    elastic_whatif = None
    if spec.get("elastic_whatif"):
        # "Shrink tenant A's elastic jobs, or buy nodes?" — the elastic
        # A/B (run_elastic_phase) on THIS fleet prices the shrink side of
        # the tradeoff the node sweep above prices in hardware: the
        # goodput delta of resize-instead-of-kill against the extra nodes
        # the recommendation says would absorb the same crunch.
        ew = run_elastic_phase(
            dict(spec["elastic_whatif"]), nodes=nodes, chips=chips,
            hbm=hbm, mesh=mesh, generation=generation, policy=policy)
        on_leg, off_leg = ew["elastic_on"], ew["elastic_off"]
        elastic_whatif = {
            "goodput_delta_chip_seconds": round(
                on_leg["goodput_chip_seconds"]
                - off_leg["goodput_chip_seconds"], 1),
            "kills_avoided": len(off_leg["kills"]),
            "slo_misses_avoided": (off_leg["slo_missed"]
                                   - on_leg["slo_missed"]),
            "nodes_to_add_instead": (recommendation or {}).get(
                "nodes_to_add"),
            "choice": ("shrink-elastic" if ew["verdict"]["ok"]
                       else "buy-nodes"),
            "ab": ew,
        }

    verdict = {
        "starvation_observed": starvation_observed,
        "eta_within_one_bucket": eta_ok,
        "forecast_error_reported": forecast_error_ratio is not None,
        "recommendation_protects_critical": rec_ok,
        "no_overbooking": not (predicted_run["overbooked_chips"]
                               or actual_run["overbooked_chips"]),
    }
    if replica_loss is not None:
        verdict["replica_loss_protocol_ok"] = replica_loss["protocol_ok"]
    if elastic_whatif is not None:
        verdict["elastic_whatif_resolved"] = \
            elastic_whatif["ab"]["verdict"]["no_overbooking"]
    verdict["ok"] = all(verdict.values())
    return {
        "bucket_s": bucket_s,
        "history_buckets": history_buckets,
        "horizon_buckets": horizon_buckets,
        "tick_s": tick_s,
        "starve_after_s": starve_after_s,
        "pattern": spec.get("pattern"),
        "forecast_error_ratio": forecast_error_ratio,
        "stream_error_ratios": {
            ps["stream"]["name"]: ps["error_ratio"]
            for ps in per_stream},
        "predicted": predicted_run,
        "actual": actual_run,
        "starvation": eta_rows,
        "recommendation": recommendation,
        "replica_loss": replica_loss,
        "elastic_whatif": elastic_whatif,
        "verdict": verdict,
    }


def run_ha_phase(spec: dict, *, nodes: int, chips: int, hbm: int,
                 mesh, generation: str, policy: str) -> dict:
    """Active extender replicas (``shard/``) on the virtual clock: N
    replica schedulers over one fake apiserver converge on a shard map, a
    pod storm is offered to each replica in turn (kube-scheduler's retry:
    a non-owner refuses, the owner places), a seeded replica is killed
    mid-storm, and the survivors' lease detectors drive the epoch bump,
    the adoption and the re-placement.  Everything runs on a SimClock, so
    a seed replays bit for bit.

    Raises :class:`SectionRefused` for ``explain`` (the JAX simulator's
    explain-timeline audit reads the provenance store, ROADMAP A.5)."""
    if spec.get("explain"):
        raise SectionRefused(
            "the 'ha' section's 'explain' audit is not simulated by this "
            "port: it reads the provenance store (provenance/), which "
            "comes with ROADMAP A.5")
    clock = SimClock()
    kube = FakeKube()
    n_rep = int(spec.get("replicas", 3))
    seed = int(spec.get("seed", 0))
    rng = random.Random(seed)
    # Tight coordination timings: the run is about the protocol (death,
    # bump, adoption), not production TTLs.
    ttl = float(spec.get("replica_ttl_s", 10.0))
    reps: List[Scheduler] = []
    for i in range(n_rep):
        reps.append(Scheduler(kube, Config(
            node_scheduler_policy=policy,
            shard_replica=f"replica-{i}",
            shard_ttl_s=ttl, shard_grace_beats=1,
            shard_stale_ttl_s=ttl / 2,
            shard_adoption_grace_s=ttl / 2 + 1.0), clock=clock))
    names = build_fleet(reps[0], kube, nodes, chips, hbm, mesh, generation)
    for s in reps[1:]:
        for n in names:
            info = reps[0].nodes.get_node(n)
            s.nodes.add_node(n, NodeInfo(
                name=n, devices=list(info.devices),
                topology=info.topology))
    for s in reps:
        kube.watch_pods(s.on_pod_event)

    alive = list(range(n_rep))

    def tick_all() -> None:
        for i in alive:
            reps[i].shards.tick()

    # The boot partition converges once every replica has seen every
    # other's beats.
    for _ in range(4):
        tick_all()
        clock.advance(1.0)
    epoch_before = reps[0].shards.epoch()

    storm_spec = dict(spec.get("storm") or
                      {"name": "train", "gpu": 1, "gpumem": 2000,
                       "count": 24})
    count = int(storm_spec.get("count", 24))
    interval = float(spec.get("storm_interval_s", 2.0))
    kill_after = int(spec.get("kill_after", max(1, count // 3)))
    pods = [spec_pod(storm_spec, i) for i in range(count)]
    for pod in pods:
        kube.create_pod(pod)

    placed: List[dict] = []
    pending: List[dict] = []
    killed: Optional[int] = None
    placed_before_kill = 0

    def try_place(pod) -> dict:
        # Offered to each live replica in turn, from a seeded start, so
        # the routing itself does not know the owner.
        start = rng.randrange(len(alive))
        last_err = ""
        for k in range(len(alive)):
            i = alive[(start + k) % len(alive)]
            r = reps[i].filter(pod, names)
            if r.node:
                return {"pod": pod["metadata"]["name"], "node": r.node,
                        "replica": reps[i].shards.replica}
            last_err = r.error or next(iter(r.failed.values()), "no fit")
        return {"pod": pod["metadata"]["name"], "reason": last_err,
                "placed": None}

    for idx, pod in enumerate(pods):
        if killed is None and idx == kill_after:
            # The seeded kill: the victim never ticks again and is never
            # offered a pod, as a replica killed outright looks from
            # outside.  Counted now: a pre-kill pod that pended must not
            # count a later placement as before the kill.
            killed = rng.choice(alive)
            alive.remove(killed)
            placed_before_kill = len(placed)
        got = try_place(pod)
        if got.get("node"):
            placed.append(got)
        else:
            pending.append({"pod": got["pod"], "reason": got["reason"]})
        clock.advance(interval)
        tick_all()

    grants_at_storm_end = {
        p["metadata"]["name"]:
            p.get("metadata", {}).get("annotations", {}).get(
                ASSIGNED_NODE_ANNOTATION, "")
        for p in kube.list_pods()}

    # Settle: the survivors declare the victim dead, bump the epoch, serve
    # the adoption grace and replay the decision annotations; done when
    # no adoption is pending and every node is placeable by its owner.
    settle_s = float(spec.get("settle_s", 120.0))
    settle_t0 = clock()
    while clock() - settle_t0 < settle_s:
        tick_all()
        owners_live = True
        adopting = False
        for n in names:
            m = reps[alive[0]].shards.map
            owner = m.owner_of(n) if m is not None else None
            if owner not in {reps[i].shards.replica for i in alive}:
                owners_live = False
                break
            oi = next(i for i in alive
                      if reps[i].shards.replica == owner)
            if reps[oi].shards.reject_reason(n) is not None:
                adopting = True
                break
        if owners_live and not adopting and all(
                not reps[i].shards.rebalancer.pending_nodes()
                for i in alive):
            break
        clock.advance(2.0)
    adoption_latencies = [
        lat for i in alive
        for lat in reps[i].shards.rebalancer.last_adoption_latency_s]
    epoch_after = reps[alive[0]].shards.epoch()

    # Every pod that pended through the orphan window is offered again.
    replaced: List[dict] = []
    still_pending: List[dict] = []
    for entry in pending:
        pod = kube.get_pod("sim", entry["pod"])
        got = try_place(pod)
        if got.get("node"):
            replaced.append({"pod": got["pod"], "node": got["node"],
                             "replica": got["replica"]})
        else:
            still_pending.append({"pod": got["pod"],
                                  "reason": got["reason"]})

    # The audits: every decision at the storm's end still stands (none
    # lost); no replica holds a pod on another node than its annotation
    # says (none duplicated); no card over its totals on any survivor.
    lost, duplicated = [], []
    for p in kube.list_pods():
        pname = p["metadata"]["name"]
        node_now = p.get("metadata", {}).get("annotations", {}).get(
            ASSIGNED_NODE_ANNOTATION, "")
        was = grants_at_storm_end.get(pname, "")
        if was and not node_now:
            lost.append(pname)
        uid = p["metadata"]["uid"]
        seen = {reps[i].pods.get(uid).node for i in alive
                if reps[i].pods.get(uid) is not None}
        if node_now:
            seen.add(node_now)
        if len(seen) > 1:
            duplicated.append({"pod": pname, "nodes": sorted(seen)})
    overbooked = sorted({c for i in alive
                         for c in overbooked_chips(reps[i])})

    verdict = {
        "adopted_all": all(
            not reps[i].shards.rebalancer.pending_nodes()
            for i in alive) and epoch_after > epoch_before,
        "replaced_all": not still_pending,
        "no_grant_lost": not lost,
        "no_grant_duplicated": not duplicated,
        "no_overbooking": not overbooked,
    }
    verdict["ok"] = all(verdict.values())
    result = {
        "seed": seed,
        "replicas": n_rep,
        "killed": f"replica-{killed}" if killed is not None else None,
        "epoch_before": epoch_before,
        "epoch_after": epoch_after,
        "placed_before_kill": placed_before_kill,
        "placed_total": len(placed) + len(replaced),
        "pending_during_window": len(pending),
        "replaced": replaced,
        "still_pending": still_pending,
        "adoption_latency_s": round(max(adoption_latencies), 1)
        if adoption_latencies else 0.0,
        "shards_adopted": sum(
            reps[i].shards.rebalancer.adopted_total for i in alive),
        "rebalances": sum(
            reps[i].shards.rebalances_total for i in alive),
        "cas_failures": {
            reps[i].shards.replica: dict(reps[i].shards.cas_failures)
            for i in range(n_rep)},
        "grants_lost": lost,
        "grants_duplicated": duplicated,
        "overbooked_chips": overbooked,
        "verdict": verdict,
    }
    for s in reps:
        s.close()
    return result


def format_capacity(cp: dict) -> str:
    v = cp["verdict"]
    lines = [
        "capacity planning ({} pattern; {} history + {} horizon buckets "
        "of {:.0f}s):".format(cp.get("pattern") or "captured trace",
                              cp["history_buckets"],
                              cp["horizon_buckets"], cp["bucket_s"]),
        f"  forecast-vs-actual error: {cp['forecast_error_ratio']:.1%} "
        "of demand",
    ]
    for row in cp["starvation"]:
        def eta(x):
            return f"{x:.0f}s" if x is not None else "never"
        lines.append(
            "  queue {:<14s} starves: predicted {:<7s} actual {:<7s} {}"
            .format(row["queue"], eta(row["predicted_eta_s"]),
                    eta(row["actual_eta_s"]),
                    "✓" if row["within_one_bucket"] else
                    ("-" if row["actual_eta_s"] is None else "OFF")))
    rec = cp.get("recommendation")
    if rec:
        lines.append(
            "  scale recommendation: {} → {} node(s) to keep '{}' "
            "unstarved{}".format(
                rec["nodes_current"], rec["nodes_recommended"],
                rec["critical_queue"],
                "" if rec["applied"] is None else
                " (verified against the actual trace)"))
    rl = cp.get("replica_loss")
    if rl:
        lines.append(
            "  losing a replica costs: {:.1f}s adoption, {} pod(s) "
            "pended, {} re-placed, {} rebalance(s)".format(
                rl["adoption_latency_s"],
                rl["pods_pended_through_window"],
                rl["replacement_churn"], rl["shard_rebalances"]))
    ew = cp.get("elastic_whatif")
    if ew:
        buy = ("buy {} node(s)".format(ew["nodes_to_add_instead"])
               if ew["nodes_to_add_instead"] is not None
               else "buy nodes (no sweep result)")
        lines.append(
            "  shrink elastic jobs vs {}: resize wins {:+.1f} chip-s "
            "goodput, avoids {} kill(s) + {} SLO miss(es) → {}".format(
                buy, ew["goodput_delta_chip_seconds"],
                ew["kills_avoided"], ew["slo_misses_avoided"],
                ew["choice"]))
    lines.append("  verdict: " + ("PASS" if v["ok"] else f"FAIL {v}"))
    return "\n".join(lines)


def format_elastic(el: dict) -> str:
    v = el["verdict"]
    on, off = el["elastic_on"], el["elastic_off"]

    def leg(r):
        return ("goodput {:>9.1f} chip-s (waste {:>7.1f}); burst JCT "
                "{:>6.1f}s, SLO {}/{}; {} kill(s)".format(
                    r["goodput_chip_seconds"], r["wasted_chip_seconds"],
                    r["mean_latency_jct_s"], r["slo_met"],
                    r["slo_met"] + r["slo_missed"], len(r["kills"])))

    lines = [
        "elastic mesh A/B over {:.0f}s (resize instead of kill):".format(
            el["horizon_s"]),
        f"  elastic ON : {leg(on)}",
        f"  elastic OFF: {leg(off)}",
    ]
    for r in on["resizes"]:
        if r["kind"] in ("resize-shrink", "resize-grow"):
            lines.append(
                "  {:>5.0f}s {:<13s} {} -> {:<5s} ({})".format(
                    r["at_s"], r["kind"], r["from"], r["to"],
                    r.get("requester", "")))
    g = on["gang"]
    lines.append(
        "  trajectory: {} step(s) across {} generation(s), {} resize "
        "point(s) — {}".format(
            g["trajectory_steps"], g["generations"],
            len(g["resize_points"]),
            "bit-identical resume" if g["trajectory_ok"]
            else "DIVERGED"))
    lines.append(
        "  final mesh {} (thrash {}, aborted {})".format(
            g["final_mesh"], on["thrash"], on["aborted_resizes"]))
    if on["overbooked_chips"] or off["overbooked_chips"]:
        lines.append("  OVERBOOKED: "
                     + ", ".join(on["overbooked_chips"]
                                 + off["overbooked_chips"]))
    lines.append("  verdict: " + ("PASS" if v["ok"] else f"FAIL {v}"))
    return "\n".join(lines)


def format_queueing(qr: dict) -> str:
    v = qr["verdict"]
    lines = [
        "capacity-queue A/B over {:.0f}s (measured from {:.0f}s):"
        .format(qr["horizon_s"], qr["measure_from_s"]),
        "  fair-share utilization {:.1%} vs FIFO {:.1%} ({})".format(
            qr["fair"]["utilization"], qr["fifo"]["utilization"],
            "OK" if v["utilization_ok"] else "REGRESSED"),
    ]
    for row in qr["shares"]:
        lines.append(
            "  {:<12s} weight {:>4.1f}: admitted share {:>5.1%} "
            "(target {:>5.1%}) {}".format(
                row["queue"], row["weight"], row["admitted_share"],
                row["target_share"],
                "✓" if row["within_tolerance"] else "OFF-TARGET"))
    lines.append(
        "  {} reclaim plan(s), victims {}; admissions {} "
        "({} backfilled)".format(
            len(qr["fair"]["reclaims"]),
            "all borrowed" if v["reclaim_only_borrowed"]
            else "TOUCHED IN-QUOTA GRANTS",
            qr["fair"]["admitted"], qr["fair"]["backfilled"]))
    if qr["fair"]["overbooked_chips"]:
        lines.append("  OVERBOOKED: "
                     + ", ".join(qr["fair"]["overbooked_chips"]))
    lines.append("  verdict: " + ("PASS" if v["ok"] else "FAIL"))
    return "\n".join(lines)


def format_serving(sv: dict) -> str:
    v = sv["verdict"]
    lines = ["serving QoS A/B (flat duty limiter vs SLO tiers):"]
    for row in sv["phase_compare"]:
        lines.append(
            "  {name:<10s} crit p99 {fp:>8.0f} → {tp:>6.0f} us   "
            "mean {fm:>8.1f} → {tm:>6.1f} us{ok}".format(
                name=row["name"], fp=row["flat_p99_us"],
                tp=row["tiered_p99_us"], fm=row["flat_mean_us"],
                tm=row["tiered_mean_us"],
                ok="" if "ok" not in row
                else ("  ok" if row["ok"] else "  FAIL")))
    dw = sv["tiered"]["duty_weights"]
    lines.append(
        f"  duty weights: critical ≤{dw['critical_max']}%, "
        f"best-effort ≥{dw['best_effort_min']}% "
        f"(final {dw['critical_final']}/{dw['best_effort_final']}; "
        f"{sv['tiered']['reweights']} re-weight(s))")
    lines.append(
        f"  best-effort goodput: {sv['best_effort_goodput_ratio']:.2f}x "
        f"flat (tolerance -{sv['goodput_tolerance_pct']:.0f}%)")
    bad = sv["violations"]["flat"] + sv["violations"]["tiered"]
    lines.append("  grant violations: "
                 + (", ".join(bad) if bad else "none"))
    lines.append("  verdict: " + ("OK" if v["ok"] else f"FAIL {v}"))
    return "\n".join(lines)


def format_ha(hr: dict) -> str:
    v = hr["verdict"]
    lines = [
        "active-active HA: {} replica(s), seed {}; killed {} "
        "mid-storm".format(hr["replicas"], hr["seed"], hr["killed"]),
        "  epoch {} → {}; {} shard(s) adopted in {:.1f}s; "
        "{} rebalance transition(s)".format(
            hr["epoch_before"], hr["epoch_after"],
            hr["shards_adopted"], hr["adoption_latency_s"],
            hr["rebalances"]),
        "  {} placed before kill, {} pended through the orphan "
        "window, {} re-placed on survivors".format(
            hr["placed_before_kill"], hr["pending_during_window"],
            len(hr["replaced"])),
    ]
    for r in hr["replaced"]:
        lines.append(f"  {r['pod']:<24s} ↻ {r['node']} "
                     f"(via {r['replica']})")
    for p in hr["still_pending"]:
        lines.append(f"  {p['pod']:<24s} STRANDED: {p['reason']}")
    if hr["grants_lost"] or hr["grants_duplicated"]:
        lines.append("  GRANTS lost: {} duplicated: {}".format(
            hr["grants_lost"], hr["grants_duplicated"]))
    if hr["overbooked_chips"]:
        lines.append("  OVERBOOKED: " + ", ".join(hr["overbooked_chips"]))
    lines.append("  verdict: " + ("PASS" if v["ok"] else f"FAIL {v}"))
    return "\n".join(lines)


def format_report(result: dict) -> str:
    cp = result.get("capacity")
    if cp:
        return format_capacity(cp)
    fr = result.get("fragmentation")
    if fr:
        return format_fragmentation(fr)
    sv = result.get("serving")
    if sv:
        return format_serving(sv)
    qr = result.get("queueing")
    if qr:
        return format_queueing(qr)
    el = result.get("elastic")
    if el:
        return format_elastic(el)
    hr = result.get("ha")
    if hr:
        return format_ha(hr)
    f = result["fleet"]
    if "source" in f:
        head = ("fleet: {nodes} node(s) from {source}, "
                "{existing_pods} existing pod(s) ({policy})".format(**f))
    else:
        head = ("fleet: {nodes} nodes × {chips_per_node} GPUs × "
                "{hbm_mib} MiB (mesh {mesh}, {policy})".format(**f))
    lines = [
        head,
        f"placed {len(result['placed'])} pod(s); "
        f"HBM allocated {result['hbm_allocated_fraction']:.0%}",
    ]
    for p in result["placed"]:
        grants = ", ".join(f"{c['uuid']}({c['mem_mib']}MiB/{c['cores']}%)"
                           for c in p["chips"][:4])
        more = "…" if len(p["chips"]) > 4 else ""
        lines.append(f"  {p['pod']:<24s} → {p['node']}: {grants}{more}")
    if result["pending"]:
        lines.append(f"UNSCHEDULABLE: {len(result['pending'])} pod(s)")
        for p in result["pending"]:
            lines.append(f"  {p['pod']:<24s} {p['reason']}")
    else:
        lines.append("workload fits.")
    acct = result.get("accounting")
    if acct:
        verdict = ("metered within {}% of simulated occupancy"
                   .format(acct["tolerance_pct"]) if acct["metering_ok"]
                   else "METERING DRIFT over tolerance")
        lines.append(
            f"accounting ({acct['runtime_s']:.0f}s @ {acct['tick_s']:.0f}s"
            f" ticks): {verdict} (max error {acct['max_error_pct']:.2f}%)")
        for p in acct["pods"]:
            lines.append(
                "  {:<24s} duty {:>4.0%}: {:>9.1f} metered / {:>9.1f} "
                "simulated GPU-s ({:.2f}%)".format(
                    p["pod"], p["duty"], p["metered_chip_seconds"],
                    p["simulated_chip_seconds"], p["error_pct"]))
        if acct["idle_grants"]:
            lines.append("  IDLE GRANTS: " + ", ".join(acct["idle_grants"]))
        if acct["fleet_efficiency"] is not None:
            lines.append(
                f"  fleet efficiency: {acct['fleet_efficiency']:.1%}")
    chaos = result.get("chaos")
    if chaos:
        lines.append(
            f"chaos (seed {chaos['seed']}): {len(chaos['injected'])} "
            f"fault(s) injected; {len(chaos['rescued'])} pod(s) rescued, "
            f"{len(chaos['replaced'])} re-placed on survivors")
        for r in chaos["replaced"]:
            lines.append(f"  {r['pod']:<24s} ↻ {r['node']}")
        for p in chaos["still_pending"]:
            lines.append(f"  {p['pod']:<24s} STRANDED: {p['reason']}")
        if chaos["overbooked_chips"]:
            lines.append("  OVERBOOKED during rescue: "
                         + ", ".join(chaos["overbooked_chips"]))
    return "\n".join(lines)


def fetch_fleet(url: str, timeout: float = 15.0) -> dict:
    """The extender's ``GET /fleetz`` at ``url`` (a base URL, with or
    without a scheme and the path)."""
    import urllib.request

    url = url.rstrip("/")
    if "://" not in url:
        url = "http://" + url
    if not url.endswith("/fleetz"):
        url += "/fleetz"
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.load(r)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser("vgpu-simulate")
    p.add_argument("--workload", required=True,
                   help="workload spec JSON (see the module docstring)")
    p.add_argument("--from-cluster", default="", metavar="URL",
                   help="plan against a LIVE fleet: fetch the extender's "
                        "GET /fleetz snapshot (inventory + fabric + "
                        "existing grants) instead of --nodes/--chips/...")
    p.add_argument("--nodes", type=int, default=1)
    p.add_argument("--chips", type=int, default=8, help="GPUs a node")
    p.add_argument("--hbm", type=int, default=81079, help="MiB a GPU")
    p.add_argument("--mesh", default="8",
                   help="NVLink fabric a node, e.g. 8 or 4x2")
    p.add_argument("--generation", default="h100")
    p.add_argument("--policy", choices=["spread", "binpack"],
                   default=None,
                   help="default: the live cluster's own policy with "
                        "--from-cluster, else spread")
    p.add_argument("--chaos-seed", type=int, default=None,
                   help="seed for the chaos phase (overrides the "
                        "workload's chaos.seed; enables chaos when the "
                        "workload has no chaos section)")
    p.add_argument("--chaos-random-events", type=int, default=None,
                   help="number of seeded random fault events to add to "
                        "the chaos schedule")
    p.add_argument("--json", action="store_true", dest="as_json")
    args = p.parse_args(argv)

    try:
        mesh = tuple(int(x) for x in args.mesh.lower().split("x"))
        with open(args.workload) as f:
            workload = json.load(f)
        export = fetch_fleet(args.from_cluster) if args.from_cluster \
            else None
    except (ValueError, OSError) as e:
        print(f"vgpu-simulate: {e}", file=sys.stderr)
        return 2
    if args.chaos_seed is not None or args.chaos_random_events is not None:
        chaos = dict(workload.get("chaos") or {})
        if args.chaos_seed is not None:
            chaos["seed"] = args.chaos_seed
        if args.chaos_random_events is not None:
            chaos["random_events"] = args.chaos_random_events
        workload["chaos"] = chaos
    try:
        result = run_simulation(workload, nodes=args.nodes,
                                chips=args.chips, hbm=args.hbm, mesh=mesh,
                                generation=args.generation,
                                policy=args.policy, fleet_export=export)
    except SectionRefused as e:
        print(f"vgpu-simulate: {e}", file=sys.stderr)
        return 2
    try:
        print(json.dumps(result, indent=1) if args.as_json
              else format_report(result))
    except BrokenPipeError:     # `vgpu-simulate ... | head` is fine
        pass
    return 0 if result["fits"] else 1


if __name__ == "__main__":
    sys.exit(main())
