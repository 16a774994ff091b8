"""The port's defragmenter (``placement/defrag.py``), its slice
reservations and their hooks in the extender, against the JAX package's,
on the CPU.

Every case of ``tests/test_defrag.py`` runs here on both packages:

- **The pure planner** (``TestPlannerProperties``): the same seeded
  fleets (``random_fleet`` draws them with ``random.Random(seed)`` in the
  JAX test's order), built once per package from one plain description,
  go to each ``plan_compaction``; the plans (node, box, victims with
  their costs, the largest box before and after) must be equal, and the
  JAX case's assertions then run on the port's plan.
- **The loop** (``TestDefragLoop``): each package's scheduler on a
  ``SimClock`` with ``enable_defrag``, the same fleet (nodes of eight
  16,384 MiB cards on a (4, 2) fabric), the same pods with the same uids
  and the same script of creates, Filters, ticks, deletes and clock
  advances.  Every Filter answer, every tick's actions, the demand
  registry, the reservations, the eviction annotations, the counters and
  the grants are recorded on both sides and held equal; then the JAX
  case's own assertions run on the port's side.

The JAX side is given the port's resource names and its serial Filter
(``optimistic_commit=False``), and its snapshot in the registry's order
(``tests/test_torch_gang.py``'s ``ordered_snapshot``: the JAX snapshot is
rebuilt by iterating a set of node names).  Cards are named
``<node>-gpu-<i>`` on both sides, and Filter's messages read "GPU" for
"TPU".  Neither side has usage reports, so the ledger's GPU-seconds (the
planner's cost) are 0 on both, as for mock pods on the card.

Besides: the card leg's fleet (``chip_smoke.HGX_PODS`` on the mock HGX
ring beside the real node with S and T bound), whose plan both planners
must give as ``chip_smoke.HGX_PLAN`` pins it; and the port's form of
``tests/test_chaos.py::TestDefragMigrationTrajectory``: both schedulers
decide the migration alike, and the victim, the port's
``run_preemptible`` in f32 on the CPU, checkpoints when the compaction
asks and resumes bit for bit against an uninterrupted run.

Where the port once departed (no perf timer around ``tick``; no revision
key in ``SnapEntry``) ``test_the_ports_departures`` now holds both alike;
the elastic shrink set is empty on both with elastic off.
"""

import copy
import dataclasses
import json
import random
from types import SimpleNamespace

import pytest

import chip_smoke
import k8s_vgpu_scheduler_tpu.health.faults as jfaults
import k8s_vgpu_scheduler_tpu.k8s as jk8s
import k8s_vgpu_scheduler_tpu.placement as jplace
import k8s_vgpu_scheduler_tpu.placement.mesh as jmesh
import k8s_vgpu_scheduler_tpu.scheduler as jsched
import k8s_vgpu_scheduler_tpu.scheduler.core as jcore
import k8s_vgpu_scheduler_tpu.scheduler.pods as jpods
import k8s_vgpu_scheduler_tpu.scheduler.score as jscore
import k8s_vgpu_scheduler_tpu.tpulib as jtpulib
import k8s_vgpu_scheduler_tpu.topology as jtopology
import k8s_vgpu_scheduler_tpu.util.types as jtypes
import k8s_vgpu_scheduler_tpu_torch.health.faults as tfaults
import k8s_vgpu_scheduler_tpu_torch.k8s as tk8s
import k8s_vgpu_scheduler_tpu_torch.placement as tplace
import k8s_vgpu_scheduler_tpu_torch.placement.mesh as tmesh
import k8s_vgpu_scheduler_tpu_torch.scheduler as tsched
import k8s_vgpu_scheduler_tpu_torch.scheduler.core as tcore
import k8s_vgpu_scheduler_tpu_torch.scheduler.pods as tpods
import k8s_vgpu_scheduler_tpu_torch.scheduler.score as tscore
import k8s_vgpu_scheduler_tpu_torch.topology as ttopology
import k8s_vgpu_scheduler_tpu_torch.tpulib.types as ttpulib
import k8s_vgpu_scheduler_tpu_torch.util.types as ttypes
from k8s_vgpu_scheduler_tpu.util.config import Config as JConfig
from k8s_vgpu_scheduler_tpu.util.config import ResourceNames as JNames
from k8s_vgpu_scheduler_tpu_torch.scheduler.preempt import \
    PREEMPT_ANNOTATION
from k8s_vgpu_scheduler_tpu_torch.util.config import Config as TConfig
from tests.test_scheduler_concurrency import assert_no_overallocation
from tests.test_torch_checkpoint import params  # noqa: F401 — a fixture
from tests.test_torch_gang import ordered_snapshot
from tests.test_torch_scheduler import PORT_NAMES

#: Each package's types, by ``port``.
PKG = {
    port: SimpleNamespace(
        SnapEntry=core.SnapEntry, DeviceUsage=score.DeviceUsage,
        PodInfo=pods.PodInfo, ContainerDevice=types.ContainerDevice,
        DeviceInfo=sched.DeviceInfo, NodeInfo=sched.NodeInfo,
        Topo=topo_desc, plan=place.plan_compaction,
        max_box=mesh.max_free_box_volume, Scheduler=sched.Scheduler,
        Kube=k8s.FakeKube, Clock=faults.SimClock,
        is_contiguous=topology.is_contiguous)
    for port, core, score, pods, types, sched, topo_desc, place, mesh, k8s,
    faults, topology in (
        (True, tcore, tscore, tpods, ttypes, tsched, ttpulib.TopologyDesc,
         tplace, tmesh, tk8s, tfaults, ttopology),
        (False, jcore, jscore, jpods, jtypes, jsched, jtpulib.TopologyDesc,
         jplace, jmesh, jk8s, jfaults, jtopology))}

DEFRAG = "rescue:defrag:"


def as_port(record):
    return json.loads(json.dumps(record).replace("TPU", "GPU"))


# -- the pure planner ------------------------------------------------------------

def random_node(rng, name, mesh=(4, 2)) -> dict:
    """``tests/test_defrag.py``'s ``random_node`` as a plain description,
    with the same draws in the same order: every card either free, or held
    by a single exclusive pod of random priority."""
    chips, pods = [], []
    n = mesh[0] * mesh[1]
    for i in range(n):
        cid = f"{name}-gpu-{i}"
        coords = (i % mesh[0], i // mesh[0])
        state = rng.choice(["free", "movable", "pinned", "gang"])
        used = state != "free"
        chips.append((cid, coords, used))
        if used:
            prio = {"movable": rng.choice([1, 2, 3]),
                    "pinned": 0, "gang": 1}[state]
            pods.append((state, (f"u-{cid}", f"p-{cid}", prio, cid)))
    return {"name": name, "mesh": mesh, "chips": chips, "pods": pods}


def random_fleet(rng, n_nodes=3):
    nodes = [random_node(rng, f"n{i}") for i in range(n_nodes)]
    protected = {p[0] for node in nodes for state, p in node["pods"]
                 if state == "gang"}
    priorities = {p[0]: p[2] for node in nodes for _state, p in node["pods"]}
    return nodes, protected, priorities


def build(port: bool, nodes) -> tuple:
    """(snapshot, pods_by_node) in one package's types."""
    k = PKG[port]
    snapshot, by_node = {}, {}
    for node in nodes:
        name = node["name"]
        usage = {cid: k.DeviceUsage(
            id=cid, type="NVIDIA-h100", health=True, coords=coords,
            total_slots=10, used_slots=1 if used else 0,
            total_mem=16384, used_mem=4000 if used else 0,
            total_cores=100, used_cores=100 if used else 0)
            for cid, coords, used in node["chips"]}
        info = k.NodeInfo(name=name, devices=[
            k.DeviceInfo(id=cid, count=10, devmem=16384, type="NVIDIA-h100",
                         health=True, coords=coords)
            for cid, coords, _used in node["chips"]],
            topology=k.Topo(generation="h100", mesh=node["mesh"]))
        snapshot[name] = k.SnapEntry(key=(0, 0), info=info, usage=usage)
        by_node[name] = [k.PodInfo(
            uid=uid, name=pname, namespace="default", node=name,
            priority=prio, devices=[[k.ContainerDevice(
                uuid=cid, type="NVIDIA-h100", usedmem=4000,
                usedcores=100)]])
            for _state, (uid, pname, prio, cid) in node["pods"]]
    return snapshot, by_node


def plan_record(plan):
    if plan is None:
        return None
    return {"node": plan.node,
            "box": [[list(c), cid] for c, cid in plan.box.items()],
            "victims": [dataclasses.asdict(v) for v in plan.victims],
            "demand_key": plan.demand_key,
            "demand_chips": plan.demand_chips,
            "max_box_before": plan.max_box_before,
            "max_box_after": plan.max_box_after,
            "cost": plan.cost_chip_seconds}


def both_plans(nodes, demand, **kw):
    """The port's plan, held equal to the JAX planner's on the same
    fleet."""
    plans = {port: PKG[port].plan(demand, *build(port, nodes), **kw)
             for port in (True, False)}
    assert plan_record(plans[True]) == plan_record(plans[False])
    return plans[True]


def strip(rows, used_at):
    """A (4, 2) node's cards and single-card residents: ``used_at(i,
    coords)`` says which are held, each by pod ``u<i>`` at priority 1."""
    chips, pods = [], []
    for i in range(rows[0] * rows[1]):
        cid = f"n0-gpu-{i}"
        coords = (i % rows[0], i // rows[0])
        used = used_at(i, coords)
        chips.append((cid, coords, used))
        if used:
            pods.append(("movable", (f"u{i}", f"p{i}", 1, cid)))
    return chips, pods


class TestPlannerProperties:
    def test_never_evicts_protected_or_pinned(self):
        for seed in range(40):
            rng = random.Random(seed)
            nodes, protected, priorities = random_fleet(rng)
            demand = rng.choice([2, 4, 8])
            plan = both_plans(nodes, demand, protected_uids=protected,
                              min_victim_priority=1)
            if plan is None:
                continue
            for v in plan.victims:
                assert v.uid not in protected, seed
                assert priorities[v.uid] >= 1, seed

    def test_strict_improvement_and_demand_reached(self):
        k = PKG[True]
        for seed in range(40):
            rng = random.Random(seed)
            nodes, protected, _prio = random_fleet(rng)
            demand = rng.choice([2, 4, 8])
            plan = both_plans(nodes, demand, protected_uids=protected,
                              min_victim_priority=1)
            if plan is None:
                continue
            assert plan.max_box_after >= demand, seed
            assert plan.max_box_after > plan.max_box_before, seed
            assert plan.victims, seed
            # The prediction recomputed independently: evict the victims
            # and measure.
            snapshot, pods_by_node = build(True, nodes)
            entry = snapshot[plan.node]
            victim_uids = {v.uid for v in plan.victims}
            held = {d.uuid for p in pods_by_node[plan.node]
                    if p.uid not in victim_uids
                    for c in p.devices for d in c}
            free = frozenset(u.coords for cid, u in entry.usage.items()
                             if cid not in held)
            assert k.max_box(entry.info.topology, free) == \
                plan.max_box_after, seed

    def test_deterministic(self):
        for seed in range(10):
            f1 = random_fleet(random.Random(seed))
            f2 = random_fleet(random.Random(seed))
            p1 = both_plans(f1[0], 4, protected_uids=f1[1])
            p2 = both_plans(f2[0], 4, protected_uids=f2[1])
            assert plan_record(p1) == plan_record(p2)

    def test_unattributed_used_chip_does_not_crash_planner(self):
        """A used card with no attributed resident (unhealthy idle, or
        usage ahead of the pod cache) is never vacatable."""
        chips, pods = strip((4, 2), lambda i, c: i in (1, 3, 5))
        pods = [p for p in pods if p[1][0] != "u5"]
        plan = both_plans([{"name": "n0", "mesh": (4, 2), "chips": chips,
                            "pods": pods}], 6, protected_uids=set())
        if plan is not None:
            assert "n0-gpu-5" not in plan.box.values()

    def test_mesh_shaped_planning(self):
        """A free 4x1 row satisfies a shapeless 4-card demand, not mesh
        2x2: the plan assembles a realizing box with 2 evictions."""
        chips, pods = strip((4, 2), lambda i, c: c[1] == 1)
        nodes = [{"name": "n0", "mesh": (4, 2), "chips": chips,
                  "pods": pods}]
        assert both_plans(nodes, 4, protected_uids=set()) is None
        plan = both_plans(nodes, 4, protected_uids=set(), mesh=(2, 2))
        assert plan is not None
        assert len(plan.victims) == 2

    def test_cheapest_by_sunk_chip_seconds(self):
        """Two symmetric options: the ledger's cost picks the victim with
        the least sunk work."""
        chips, pods = [], []
        for i in range(4):
            cid = f"n0-gpu-{i}"
            used = i in (1, 2)
            chips.append((cid, (i, 0), used))
            if used:
                pods.append(("movable", (f"u{i}", f"p{i}", 1, cid)))
        sunk = {"u1": 500.0, "u2": 10.0}
        plan = both_plans([{"name": "n0", "mesh": (4, 1), "chips": chips,
                            "pods": pods}], 2, protected_uids=set(),
                          chip_seconds_of=lambda uid: sunk[uid])
        assert plan is not None
        assert [v.uid for v in plan.victims] == ["u2"]
        assert plan.cost_chip_seconds == 10.0


# -- the loop over each package's scheduler --------------------------------------

class Side:
    """One package's scheduler as ``tests/test_defrag.py``'s
    ``defrag_env`` builds it: ``n_nodes`` nodes of eight cards (ten slots,
    16,384 MiB) on a ``mesh`` fabric, the informer wired, a SimClock."""

    def __init__(self, port: bool, n_nodes=1, mesh=(4, 2), **cfg):
        k = self.k = PKG[port]
        self.port = port
        self.clock = k.Clock()
        self.kube = k.Kube()
        cfg.setdefault("enable_defrag", True)
        cfg.setdefault("topology_policy", "guaranteed")
        if port:
            self.cfg = TConfig(optimistic_commit=False, **cfg)
        else:
            self.cfg = JConfig(resources=JNames(**PORT_NAMES),
                               scheduler_name="vgpu-scheduler",
                               optimistic_commit=False, **cfg)
        self.s = k.Scheduler(self.kube, self.cfg, clock=self.clock)
        if not port:
            ordered_snapshot(self.s)
        self.mesh = mesh
        self.names = [f"node-{i}" for i in range(n_nodes)]
        for name in self.names:
            self.kube.add_node({"metadata": {"name": name,
                                             "annotations": {}}})
            self.s.nodes.add_node(name, k.NodeInfo(
                name=name, devices=[
                    k.DeviceInfo(id=f"{name}-gpu-{i}", count=10,
                                 devmem=16384, type="NVIDIA-h100",
                                 health=True,
                                 coords=(i % mesh[0], i // mesh[0]))
                    for i in range(mesh[0] * mesh[1])],
                topology=k.Topo(generation="h100", mesh=mesh)))
        self.kube.watch_pods(self.s.on_pod_event)

    def filter(self, pod, names=None) -> dict:
        r = self.s.filter(pod, list(names or self.names))
        return as_port(dict(node=r.node, error=r.error, failed=r.failed))

    def create(self, *pods):
        for p in pods:
            self.kube.create_pod(copy.deepcopy(p))

    def delete(self, name):
        self.kube.delete_pod("default", name)

    def tick(self) -> list:
        return self.s.defrag.tick()

    def flagged(self) -> dict:
        return {p["metadata"]["name"]: v for p in self.kube.list_pods()
                for v in (p["metadata"]["annotations"].get(
                    PREEMPT_ANNOTATION, ""),) if v}

    def drain_victims(self) -> list:
        names = sorted(n for n, v in self.flagged().items()
                       if v.startswith(DEFRAG))
        for n in names:
            self.delete(n)
        return names

    def state(self) -> dict:
        d = self.s.defrag
        return {
            "demand": [dataclasses.asdict(x) for x in d.pending_demand()],
            "in_flight": sorted(d.in_flight()),
            "reservations": sorted(
                [r.node, sorted(r.chips), r.for_key, r.reserved_at,
                 r.expires_at] for r in self.s.reservations.active()),
            "reserved_chips": self.s.reservations.total_chips(),
            "counters": [d.plans_total, d.migrations_total,
                         d.completed_total, d.aborted_total],
            "flagged": self.flagged(),
            "grants": {p.uid: [p.node, sorted(dev.uuid for c in p.devices
                                              for dev in c)]
                       for p in self.s.pods.list_pods()},
        }

    def close(self):
        if hasattr(self.s, "close"):
            self.s.close()


def run_both(script, **build_kw):
    """``script(side, rec)`` on each package, ``rec`` a list it appends
    to; the records held equal, the port's side returned."""
    out = {}
    for port in (True, False):
        side = Side(port, **build_kw)
        rec = []
        try:
            script(side, rec)
            rec.append(side.state())
        finally:
            side.close()
        out[port] = (json.loads(json.dumps(rec)), side)
    assert out[True][0] == out[False][0]
    return out[True]


def exclusive_pod(name, uid, gpu=1, prio=None, anns=None):
    limits = {"nvidia.com/gpu": str(gpu), "nvidia.com/gpumem": "4000",
              "nvidia.com/gpucores": "100"}
    if prio is not None:
        limits["nvidia.com/priority"] = str(prio)
    return {"metadata": {"name": name, "namespace": "default",
                         "uid": uid, "annotations": dict(anns or {})},
            "spec": {"containers": [{"name": "c", "resources": {
                "limits": limits}}]}}


def fragment(side, node, prio=1, tag=""):
    """Fill ``node`` with exclusive singles, then free the even
    checkerboard (the JAX test's ``fragment``/``fragment_node``)."""
    info = side.s.nodes.get_node(node)
    for i, _d in enumerate(info.devices):
        p = exclusive_pod(f"churn-{tag}{i}", f"uc{tag}{i}", prio=prio)
        side.create(p)
        r = side.filter(p, [node])
        assert r["node"] == node, r
    for i, d in enumerate(info.devices):
        if sum(d.coords) % 2 == 0:
            side.delete(f"churn-{tag}{i}")


def gang_members():
    return [exclusive_pod(f"g-{i}", f"ug{i}", gpu=4,
                          anns={"vtpu.dev/pod-group": "g",
                                "vtpu.dev/pod-group-total": "2"})
            for i in range(2)]


def place_all(side, members, rec) -> dict:
    placed = {}
    for _ in range(2):
        for p in members:
            r = side.filter(p)
            rec.append(r)
            if r["node"]:
                placed[p["metadata"]["uid"]] = r["node"]
    return placed


class TestDefragLoop:
    def test_full_lifecycle_checkpoint_first(self):
        big = exclusive_pod("big", "ubig", gpu=4)

        def script(side, rec):
            fragment(side, side.names[0])
            side.create(big)
            rec.append(side.filter(big))
            rec.append(side.state())
            rec.append(side.tick())
            rec.append(side.state())
            # Checkpoint-first: the victims still hold their grants.
            rec.append(sorted(side.flagged()))
            for p in side.kube.list_pods():
                if p["metadata"]["name"] in side.flagged():
                    assert side.s.pods.get(p["metadata"]["uid"]) is not None
            rec.append(side.drain_victims())
            side.clock.advance(5.0)
            rec.append(side.tick())
            rec.append(side.state())
            rec.append(side.filter(big))

        rec, side = run_both(script)
        assert rec[0]["node"] is None
        assert rec[1]["demand"][0]["chips"] == 4
        assert [a["kind"] for a in rec[2]] == ["defrag-plan"]
        assert rec[4] and all(v.startswith(DEFRAG)
                              for v in rec[3]["flagged"].values())
        assert [a["kind"] for a in rec[6]] == ["defrag-complete"]
        assert rec[7]["reserved_chips"] == 4
        assert rec[8]["node"] == side.names[0]
        assert rec[-1]["reserved_chips"] == 0
        assert rec[-1]["demand"] == []
        assert_no_overallocation(side.s)

    def test_resource_blocked_pod_records_no_demand(self):
        fat = {"metadata": {"name": "fat", "namespace": "default",
                            "uid": "ufat", "annotations": {}},
               "spec": {"containers": [{"name": "c", "resources": {
                   "limits": {"nvidia.com/gpu": "2",
                              "nvidia.com/gpumem": "99999"}}}]}}

        def script(side, rec):
            fragment(side, side.names[0])
            side.create(fat)
            rec.append(side.filter(fat))
            rec.append(side.tick())

        rec, _ = run_both(script)
        assert rec[0]["node"] is None
        assert rec[1] == [] and rec[-1]["demand"] == []

    def test_unmovable_fleet_plans_nothing(self):
        big = exclusive_pod("big", "ubig", gpu=4)

        def script(side, rec):
            fragment(side, side.names[0], prio=0)
            side.create(big)
            rec.append(side.filter(big))
            rec.append(side.tick())

        rec, _ = run_both(script)
        assert rec[0]["node"] is None and rec[1] == []
        assert rec[-1]["counters"][0] == 0

    def test_no_deadlock_with_reclaim_in_flight(self):
        big = exclusive_pod("big", "ubig", gpu=4)

        def script(side, rec):
            fragment(side, side.names[0])
            occupied = [u for u in ("uc1", "uc3", "uc4", "uc6")
                        if side.s.pods.get(u) is not None]
            with side.s._preempt_lock:
                for uid in occupied:
                    side.s._preempt_requested[uid] = side.clock()
            side.create(big)
            rec.append(side.filter(big))
            rec.append(side.tick())      # every movable card in flight
            with side.s._preempt_lock:
                side.s._preempt_requested.clear()
            rec.append(side.tick())
            with side.s._preempt_lock:
                rec.append(sorted(side.s._preempt_requested))

        rec, _ = run_both(script)
        assert rec[0]["node"] is None and rec[1] == []
        assert [a["kind"] for a in rec[2]] == ["defrag-plan"]
        # The defrag victims are in the preemption ledger: reclaim's
        # protected set sees them.
        assert rec[3]

    def test_mesh_demand_compacts_past_a_non_realizing_strip(self):
        big = exclusive_pod("big", "ubig", gpu=4,
                            anns={"vtpu.dev/mesh": "2x2"})

        def script(side, rec):
            node = side.names[0]
            info = side.s.nodes.get_node(node)
            for i, _d in enumerate(info.devices):
                p = exclusive_pod(f"churn-{i}", f"uc{i}", prio=1)
                side.create(p)
                assert side.filter(p, [node])["node"] == node
            for i, d in enumerate(info.devices):
                if d.coords[1] == 0:      # free the y=0 row: a 4x1 strip
                    side.delete(f"churn-{i}")
            side.create(big)
            rec.append(side.filter(big))
            rec.append(side.state())
            rec.append(side.tick())
            rec.append(side.drain_victims())
            side.clock.advance(5.0)
            rec.append(side.tick())
            rec.append(side.filter(big))

        rec, side = run_both(script)
        assert rec[0]["node"] is None
        assert any(v.startswith("no-mesh-slice")
                   for v in rec[0]["failed"].values()), rec[0]
        assert rec[1]["demand"][0]["mesh"] == [2, 2]
        assert [a["kind"] for a in rec[2]] == ["defrag-plan"]
        assert rec[5]["node"] == side.names[0]
        info = side.s.nodes.get_node(side.names[0])
        ids = {d.uuid for c in side.s.pods.get("ubig").devices for d in c}
        cs = [tuple(d.coords) for d in info.devices if d.id in ids]
        assert {len({c[0] for c in cs}), len({c[1] for c in cs})} == {2}

    def test_abort_keeps_sibling_reservations(self):
        members = gang_members()

        def script(side, rec):
            for node in side.names:
                fragment(side, node, tag=f"{node}-")
            side.create(*members)
            for p in members:
                rec.append(side.filter(p))
            rec.append(side.tick())               # plan box 1
            rec.append(side.drain_victims())      # box 1's victims exit
            side.clock.advance(5.0)
            rec.append(side.tick())               # complete; box 2 planned
            rec.append(side.state())
            side.clock.advance(31.0)              # box 2's never exit
            rec.append(side.tick())

        rec, _ = run_both(script, n_nodes=2, defrag_checkpoint_grace_s=30.0)
        assert all(r["node"] is None for r in rec[:2])
        assert rec[5]["reservations"] and len(
            [r for r in rec[5]["reservations"] if r[2] == "default/g"]) == 2
        assert any(a["kind"] == "defrag-abort" for a in rec[6]), rec[6]
        assert len([r for r in rec[-1]["reservations"]
                    if r[2] == "default/g"]) == 1

    def test_gang_with_preexisting_free_box_delivers(self):
        members = gang_members()

        def script(side, rec):
            fragment(side, side.names[0], tag="node-0-")
            # node-1: the y=1 row pinned at priority 0 (unmovable): ONE
            # free 4-box (the y=0 strip) remains there.
            info1 = side.s.nodes.get_node(side.names[1])
            for i, d in enumerate(info1.devices):
                if d.coords[1] == 1:
                    p = exclusive_pod(f"pin-{i}", f"up{i}", prio=0)
                    side.create(p)
                    assert side.filter(p, [side.names[1]])["node"] == \
                        side.names[1]
            side.create(*members)
            for p in members:
                rec.append(side.filter(p))
            rec.append(side.tick())               # one compaction, node-0
            rec.append(side.drain_victims())
            side.clock.advance(5.0)
            rec.append(side.tick())
            rec.append(side.s.reservations.count_for("default/g"))
            rec.append(place_all(side, members, rec))

        rec, side = run_both(script, n_nodes=2)
        assert all(r["node"] is None for r in rec[:2])
        assert [a["kind"] for a in rec[2]] == ["defrag-plan"], rec[2]
        assert rec[2][0]["node"] == side.names[0]
        assert rec[5] == 1
        placed = [r for r in rec if isinstance(r, dict) and
                  set(r) == {"ug0", "ug1"}]
        assert len(placed) == 1 and len(placed[0]) == 2, rec
        assert_no_overallocation(side.s)

    def test_overdue_victim_aborts_and_rescinds(self):
        big = exclusive_pod("big", "ubig", gpu=4)

        def script(side, rec):
            fragment(side, side.names[0])
            side.create(big)
            rec.append(side.filter(big))
            rec.append(side.tick())
            rec.append(side.state())
            side.clock.advance(31.0)              # victims never exit
            rec.append(side.tick())

        rec, _ = run_both(script, defrag_checkpoint_grace_s=30.0)
        assert rec[2]["reserved_chips"] == 4
        assert any(a["kind"] == "defrag-abort" for a in rec[3])
        assert rec[-1]["reserved_chips"] == 0
        assert rec[-1]["counters"][3] == 1
        # Rescission cleared the victims' annotations (empty value).
        assert rec[-1]["flagged"] == {}

    def test_gang_release_waits_for_all_boxes(self):
        members = gang_members()

        def script(side, rec):
            for node in side.names:
                fragment(side, node, tag=f"{node}-")
            side.create(*members)
            for p in members:
                rec.append(side.filter(p))
            rec.append(side.state())
            rec.append(side.tick())               # plan box 1
            rec.append(side.drain_victims())
            side.clock.advance(5.0)
            rec.append(side.tick())               # box 1 done; box 2 planned
            rec.append(side.state())
            # Member Filters mid-assembly: the reservations survive.
            for p in members:
                rec.append(side.filter(p))
            rec.append(side.state())
            rec.append(side.drain_victims())
            side.clock.advance(5.0)
            rec.append(side.tick())               # box 2 complete
            rec.append(side.state())
            rec.append(place_all(side, members, rec))

        rec, side = run_both(script, n_nodes=2)
        d = rec[2]["demand"]
        assert d and d[0]["count"] == 2 and d[0]["chips"] == 4
        g = "default/g"
        assert len([r for r in rec[6]["reservations"] if r[2] == g]) == 2
        assert rec[6]["in_flight"] == [g]
        assert rec[7]["node"] is None and rec[8]["node"] is None
        assert len([r for r in rec[9]["reservations"] if r[2] == g]) == 2
        assert len([r for r in rec[12]["reservations"] if r[2] == g]) == 2
        assert rec[12]["in_flight"] == []
        placed = [r for r in rec if isinstance(r, dict)
                  and set(r) == {"ug0", "ug1"}]
        assert len(placed) == 1, rec
        for uid, node in placed[0].items():
            info = side.s.nodes.get_node(node)
            ids = {d.uuid for c in side.s.pods.get(uid).devices for d in c}
            cs = [tuple(d.coords) for d in info.devices if d.id in ids]
            assert PKG[True].is_contiguous(cs, PKG[True].Topo(
                generation="h100", mesh=(4, 2)))
        assert_no_overallocation(side.s)


# -- the card leg's fleet --------------------------------------------------------

def hgx_side(port: bool) -> Side:
    """chip_smoke's node-agent fleet as the compaction finds it: the real
    node (one card, mesh (1,)) holding S and T, the mock HGX ring of
    eight cards, and HGX_PODS placed as hgx_leg places them (the mesh pod
    deleted before ``arc3``), each at the leg's priority."""
    side = Side(port, n_nodes=0)
    k = side.k
    for name, mesh, wrap, n in ((chip_smoke.PLUGIN_NODE, (1,), (), 1),
                                (chip_smoke.HGX_NODE, (8,), (True,), 8)):
        side.kube.add_node({"metadata": {"name": name, "annotations": {}}})
        side.s.nodes.add_node(name, k.NodeInfo(
            name=name, devices=[
                k.DeviceInfo(id=f"{name}-gpu-{i}", count=10,
                             devmem=chip_smoke.HGX_FIXTURE["hbm_mib"],
                             type="NVIDIA-h100", health=True,
                             coords=(i,) if n > 1 else (0,))
                for i in range(n)],
            topology=k.Topo(generation="h100", mesh=mesh, wraparound=wrap)))
    side.names = [chip_smoke.PLUGIN_NODE, chip_smoke.HGX_NODE]
    for name, uid, mib, prio in chip_smoke.PLUGIN_PODS:
        p = chip_smoke.user_pod(name, uid, mib, prio,
                                cores=chip_smoke.CORES_SM_LIMIT)
        side.create(p)
        assert side.filter(p, [chip_smoke.PLUGIN_NODE])["node"]
    return side


def hgx_script(side, rec):
    for name, uid, cards, anns, prio in chip_smoke.HGX_PODS:
        if name == "arc3":
            side.delete("mesh2")
        p = chip_smoke.user_pod(name, uid, chip_smoke.HGX_MIB, prio,
                                cores=100, annotations=anns, cards=cards)
        side.create(p)
        rec.append(side.filter(p))
    rec.append(side.state())
    rec.append(side.tick())
    rec.append(side.state())


def test_the_card_legs_plan_is_the_jax_planners():
    """HGX_PODS' placements replayed through both schedulers: ``arc3``
    records a 3-card demand, and one tick plans to migrate the one-card
    ``pin`` (the only pod above priority 0) and reserve HGX_PLAN's box."""
    out = {}
    for port in (True, False):
        side = hgx_side(port)
        rec = []
        hgx_script(side, rec)
        side.close()
        out[port] = json.loads(json.dumps(rec))
    assert out[True] == out[False]
    rec = out[True]
    arc3 = rec[3]
    assert arc3["node"] is None and arc3["failed"][
        chip_smoke.HGX_NODE].startswith("no-ici-slice:")
    [demand] = rec[4]["demand"]
    assert (demand["key"], demand["chips"]) == ("uidX3", 3)
    [plan] = rec[5]
    want = chip_smoke.HGX_PLAN
    assert plan["kind"] == "defrag-plan" and plan["node"] == want["node"]
    assert plan["victims"] == want["victims"]
    [res] = rec[6]["reservations"]
    hgx = chip_smoke.HGX_NODE
    assert (res[0], res[1], res[2]) == (
        hgx, sorted(f"{hgx}-gpu-{i}" for i in want["box"]), "uidX3")
    assert rec[6]["flagged"] == {"pin": DEFRAG + "uidX3"}


def test_the_card_legs_beneficiary_lands_inside_the_box():
    """The rest of the leg on both schedulers: a bystander gets no card in
    the box and is deleted, ``arc3`` is refused while the victim runs, the
    victim's exit completes the plan, ``arc3`` lands on three contiguous
    cards inside the box (four are free: the box is the first run), and
    the victim's replacement takes the remaining card."""
    hgx = chip_smoke.HGX_NODE
    out = {}
    for port in (True, False):
        side = hgx_side(port)
        rec = []
        hgx_script(side, rec)
        by = chip_smoke.user_pod(*chip_smoke.DEFRAG_BYSTANDER, 1, cores=100,
                                 cards=1)
        side.create(by)
        rec.append(side.filter(by))
        rec.append(side.state()["grants"][chip_smoke.DEFRAG_BYSTANDER[1]])
        arc3 = side.kube.get_pod("default", "arc3")
        rec.append(side.filter(arc3))
        side.delete(chip_smoke.DEFRAG_BYSTANDER[0])
        side.delete("pin")
        side.clock.advance(1.0)
        rec.append(side.tick())
        rec.append(side.filter(arc3))
        rec.append(side.state())
        repl = chip_smoke.user_pod(*chip_smoke.DEFRAG_REPLACEMENT, 1,
                                   cores=100, cards=1)
        side.create(repl)
        rec.append(side.filter(repl))
        rec.append(side.state())
        side.close()
        out[port] = json.loads(json.dumps(rec))
    assert out[True] == out[False]
    rec = out[True]
    box = {f"{hgx}-gpu-{i}" for i in chip_smoke.HGX_PLAN["box"]}
    grants = rec[-1]["grants"]
    assert rec[7]["node"] == hgx and rec[8][0] == hgx
    assert not set(rec[8][1]) & box
    assert rec[9]["node"] is None
    assert [a["kind"] for a in rec[10]] == ["defrag-complete"]
    assert rec[11]["node"] == hgx and rec[12]["reserved_chips"] == 0
    assert set(grants["uidX3"][1]) == box
    assert rec[13]["node"] == hgx
    [card] = grants[chip_smoke.DEFRAG_REPLACEMENT[1]][1]
    assert card not in box


# -- the migration trajectory ----------------------------------------------------

def trajectory_side(port: bool) -> Side:
    """``tests/test_chaos.py``'s ``make_env(n_nodes=2, chips=2)``: two
    nodes of two cards on a (2, 1) fabric, registered through
    ``observe_registration``."""
    side = Side(port, n_nodes=0)
    k = side.k
    side.names = ["node-0", "node-1"]
    for n in side.names:
        side.kube.add_node({"metadata": {"name": n, "annotations": {}}})
        side.s.observe_registration(n, k.NodeInfo(name=n, devices=[
            k.DeviceInfo(id=f"{n}-gpu-{i}", count=10, devmem=16384,
                         type="NVIDIA-h100", health=True, coords=(i, 0))
            for i in range(2)],
            topology=k.Topo(generation="h100", mesh=(2, 1))))
    return side


def test_the_migrated_victim_resumes_bit_for_bit(params, tmp_path):
    """The port's form of TestDefragMigrationTrajectory: on both
    schedulers the blocked 2-card demand plans the migration of the
    priority-1 trainer, the compaction completes once it exits, the
    demand lands on the assembled box and the trainer's replacement on
    the remaining capacity.  The trainer is the port's run_preemptible
    (the f32 llama step of tests/test_torch_checkpoint.py): it stops at
    the step boundary where the eviction request appears, and resumes
    from its checkpoint to the uninterrupted run's losses and state, bit
    for bit."""
    import torch

    from k8s_vgpu_scheduler_tpu_torch.models import checkpoint as tckpt
    from k8s_vgpu_scheduler_tpu_torch.models import train as ttrain
    from tests.test_torch_checkpoint import (N_STEPS, assert_states_equal,
                                             batch, fresh, recording)

    tokens = torch.from_numpy(batch())

    def train(ckpt_dir, should_stop):
        _, step, state = fresh(params)
        losses = []
        mgr = tckpt.CheckpointManager(str(ckpt_dir))
        state, done, preempted = ttrain.run_preemptible(
            recording(step, losses), state, tokens, N_STEPS, mgr,
            should_stop)
        mgr.close()
        return state, done, preempted, losses

    ref, done, preempted, ref_losses = train(tmp_path / "ref",
                                             lambda: False)
    assert (done, preempted) == (N_STEPS, False)

    def exclusive(name, uid, gpu=1, prio=None):
        return exclusive_pod(name, uid, gpu=gpu, prio=prio)

    out = {}
    for port in (True, False):
        side = trajectory_side(port)
        rec = []
        train_pod = exclusive("train", "u-train", prio=1)
        pinned = exclusive("pinned", "u-pin", prio=0)
        big = exclusive("big", "u-big", gpu=2)
        side.create(train_pod, pinned, big)
        rec.append(side.filter(train_pod, [side.names[0]]))
        rec.append(side.filter(pinned, [side.names[1]]))
        rec.append(side.filter(big))
        rec.append(side.tick())
        rec.append(side.state())
        side.delete("train")
        side.clock.advance(5.0)
        rec.append(side.tick())
        rec.append(side.state())
        rec.append(side.filter(big))
        repl = exclusive("train-r", "u-train-r", prio=1)
        side.create(repl)
        rec.append(side.filter(repl))
        rec.append(side.state())
        side.close()
        out[port] = (json.loads(json.dumps(rec)), side)
    assert out[True][0] == out[False][0]
    rec, side = out[True]
    assert rec[0]["node"] == "node-0" and rec[1]["node"] == "node-1"
    assert rec[2]["node"] is None
    assert any(a["kind"] == "defrag-plan" for a in rec[3]), rec[3]
    flag = rec[4]["flagged"]["train"]
    assert flag == DEFRAG + "u-big"
    assert rec[6]["reserved_chips"] == 2
    assert rec[7]["node"] == "node-0"
    assert rec[8]["node"] == "node-1"
    assert_no_overallocation(side.s)

    # The in-container side: the request is seen at the boundary after
    # three clean steps; the victim checkpoints there and exits.
    calls = {"n": 0}

    def stop_check():
        calls["n"] += 1
        return calls["n"] >= 4 and flag.startswith(DEFRAG)

    mid, done, preempted, first = train(tmp_path / "victim", stop_check)
    assert (done, preempted) == (3, True)
    assert tckpt.CheckpointManager(str(tmp_path / "victim")).latest_step() \
        == 3
    res, done, preempted, rest = train(tmp_path / "victim", lambda: False)
    assert (done, preempted) == (N_STEPS, False)
    assert first + rest == ref_losses
    assert_states_equal(res, ref)


def test_the_ports_departures():
    """What the port's defragmenter once departed in, now the same on
    both: the tick (the same actions, each inside its ``defrag-tick``
    perf timer) and the snapshot's key (the (pod rev, inventory rev)
    generation).  The shrink set is each resize controller's own: empty
    on both with elastic off (``tests/test_torch_elastic.py`` holds it
    with elastic on)."""
    sides = {port: Side(port) for port in (True, False)}
    try:
        j, t = sides[False].s, sides[True].s
        assert j.elastic.shrinkable_uids() == {}
        assert t.elastic.shrinkable_uids() == {}
        from k8s_vgpu_scheduler_tpu.util import perf as jperf
        from k8s_vgpu_scheduler_tpu_torch.util import perf as tperf
        ticks = [reg.registry().phase("defrag-tick").count
                 for reg in (jperf, tperf)]
        assert j.defrag.tick() == t.defrag.tick() == []
        assert [reg.registry().phase("defrag-tick").count
                for reg in (jperf, tperf)] == [n + 1 for n in ticks]
        jsnap, tsnap = j.snapshot(), t.snapshot()
        assert list(tsnap) == list(jsnap) == ["node-0"]
        assert tsnap["node-0"].key == jsnap["node-0"].key
        assert {c: dataclasses.asdict(u) for c, u in
                tsnap["node-0"].usage.items()} == \
            {c: dataclasses.asdict(u) for c, u in
             jsnap["node-0"].usage.items()}
    finally:
        for side in sides.values():
            side.close()
