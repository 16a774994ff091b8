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

The JAX simulator's other sections (``fragmentation``, ``elastic``,
``capacity``, ``audit``, ``slo``, ``ha``) replay subsystems the port does
not have yet (ROADMAP A.5): such a workload is refused by name, and the
command exits 2.

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
import json
import sys
import threading
from typing import Dict, List, Optional

from ..accounting import efficiency as eff_mod
from ..accounting.sampler import UsageSampler
from ..health.faults import FaultEvent, FaultInjector, SimClock
from ..k8s import FakeKube
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
    GANG_GROUP_ANNOTATION,
    GANG_TOTAL_ANNOTATION,
    MESH_ANNOTATION,
    ContainerDevice,
)

#: The JAX simulator's self-contained sections, in the order it tries
#: them: ``serving`` and ``queueing`` run here, the others wait for
#: ROADMAP A.5.  True: a section is requested when present; False: when
#: it is not empty.
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
        elif key == "queueing":
            # A self-contained time-stepped A/B: its own fair and FIFO
            # schedulers on the virtual clock (the plain replay below
            # would place its pods twice).
            result = run_queueing_phase(
                workload["queueing"], nodes=nodes, chips=chips, hbm=hbm,
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


def format_report(result: dict) -> str:
    sv = result.get("serving")
    if sv:
        return format_serving(sv)
    qr = result.get("queueing")
    if qr:
        return format_queueing(qr)
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
