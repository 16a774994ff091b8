"""The port's gang scheduling (``scheduler/gang.py`` and its hooks in the
extender) against the JAX package's, on the CPU.

Every case of ``tests/test_gang.py`` runs here on both packages: the same
fleet (three nodes of four cards, 16,384 MiB and ten slots a card, a
(4, 1) fabric, as that file's ``register_node``), the same pods (the same
uids, so ``place_gang``'s uid order is the same), the same script of
creates, Filters, deletes and resyncs, and the same fake clock set through
``s.gangs._now`` on both sides.  What each side shows is held equal under
the name map (the JAX side's "TPU" reads "GPU"): every Filter answer, the
grants of the pod registry (node, UUIDs, MiB, cores), the group registry
(members, placements, ranks), the decision and rank annotations, and the
grants an expiry releases.  Then the JAX case's own assertions run on the
port's side.  The JAX side is given the port's resource names and the
serial Filter (``optimistic_commit=False``; its optimistic path sends a
gang to the serial decision anyway), and its snapshot in the nodes'
registration order (``ordered_snapshot``): the JAX snapshot is rebuilt by
iterating a set of node names, whose order follows Python's salted string
hash, so among nodes of equal score its gang placement changes from run
to run; the port's follows the registry's order, and so does the JAX
side's here.

Besides: the multi-node gang of ``tests/test_multinode_e2e.py`` in process
(two nodes registered through their register streams, each member's
Allocate on its own node's agent), the resync prune of
``tests/test_watch.py`` that must not tombstone a live member, and a
gang-scoped ``2x4`` mesh validated by the webhook and placed as JAX's.
"""

import copy
import json
import queue
import threading

import pytest

from k8s_vgpu_scheduler_tpu.api import device_register_pb2 as jpb
from k8s_vgpu_scheduler_tpu.k8s import FakeKube as JKube
from k8s_vgpu_scheduler_tpu.scheduler import Scheduler as JScheduler
from k8s_vgpu_scheduler_tpu.scheduler.nodes import DeviceInfo as JDevice
from k8s_vgpu_scheduler_tpu.scheduler.nodes import NodeInfo as JNode
from k8s_vgpu_scheduler_tpu.scheduler import webhook as jwebhook
from k8s_vgpu_scheduler_tpu.tpulib import TopologyDesc as JTopo
from k8s_vgpu_scheduler_tpu.util.config import Config as JConfig
from k8s_vgpu_scheduler_tpu.util.config import ResourceNames as JNames
from k8s_vgpu_scheduler_tpu_torch.deviceplugin import (GpuDevicePlugin,
                                                       inventory_to_request)
from k8s_vgpu_scheduler_tpu_torch.k8s import FakeKube as TKube
from k8s_vgpu_scheduler_tpu_torch.scheduler import Scheduler as TScheduler
from k8s_vgpu_scheduler_tpu_torch.scheduler import gang as tgang
from k8s_vgpu_scheduler_tpu_torch.scheduler import webhook as twebhook
from k8s_vgpu_scheduler_tpu_torch.scheduler.nodes import DeviceInfo as TDevice
from k8s_vgpu_scheduler_tpu_torch.scheduler.nodes import NodeInfo as TNode
from k8s_vgpu_scheduler_tpu_torch.tpulib import MockBackend
from k8s_vgpu_scheduler_tpu_torch.tpulib.types import TopologyDesc as TTopo
from k8s_vgpu_scheduler_tpu_torch.util import nodelock
from k8s_vgpu_scheduler_tpu_torch.util import types as t
from k8s_vgpu_scheduler_tpu_torch.util.config import Config as TConfig
from tests.test_torch_scheduler import PORT_NAMES

NODES = ["node-a", "node-b", "node-c"]
#: The pod's decision and gang annotations compared on both sides.
DECISION = (t.ASSIGNED_NODE_ANNOTATION, t.ASSIGNED_IDS_ANNOTATION,
            t.TO_ALLOCATE_ANNOTATION, t.GANG_RANK_ANNOTATION)


class Side:
    """One package's scheduler with ``tests/test_gang.py``'s ``env``:
    nodes of four cards (ten slots, ``hbm`` MiB, a (4, 1) fabric of
    ``generation``), the informer wired."""

    def __init__(self, port: bool, nodes=NODES, hbm=16384, chips=4,
                 **cfg):
        self.port = port
        self.kube = TKube() if port else JKube()
        if port:
            self.cfg = TConfig(**cfg)
        else:
            self.cfg = JConfig(resources=JNames(**PORT_NAMES),
                               scheduler_name="vgpu-scheduler",
                               optimistic_commit=False, **cfg)
        self.s = (TScheduler if port else JScheduler)(self.kube, self.cfg)
        if not port:
            ordered_snapshot(self.s)
        self.hbm, self.chips = hbm, chips
        for n in nodes:
            self.add_node(n)
        self.kube.watch_pods(self.s.on_pod_event)

    def add_node(self, name: str, generation: str = "h100"):
        Dev, Node, Topo = ((TDevice, TNode, TTopo) if self.port
                           else (JDevice, JNode, JTopo))
        self.kube.add_node({"metadata": {"name": name, "annotations": {}}})
        devs = [Dev(id=f"{name}-gpu-{i}", count=10, devmem=self.hbm,
                    type="NVIDIA-h100", health=True, coords=(i, 0))
                for i in range(self.chips)]
        self.s.nodes.add_node(name, Node(
            name=name, devices=devs,
            topology=Topo(generation=generation, mesh=(self.chips, 1))))

    def filter(self, pod: dict, nodes=NODES) -> dict:
        r = self.s.filter(pod, list(nodes))
        return as_port(dict(node=r.node, error=r.error, failed=r.failed))

    def grants(self) -> dict:
        return {p.uid: [p.node, [[d.uuid, d.usedmem, d.usedcores]
                                 for ctr in p.devices for d in ctr]]
                for p in sorted(self.s.pods.list_pods(),
                                key=lambda p: p.uid)}

    def gangs(self) -> dict:
        return {key: {"total": g.total, "members": sorted(g.members),
                      "placements": {u: node for u, (node, _)
                                     in sorted(g.placements.items())},
                      "ranks": dict(sorted(g.ranks.items()))}
                for key, g in sorted(self.s.gangs.groups().items())}

    def anns(self, name: str) -> dict:
        anns = self.kube.get_pod("default", name)["metadata"]["annotations"]
        return {k: anns[k] for k in DECISION if k in anns}

    def state(self, *names) -> dict:
        return {"grants": self.grants(), "gangs": self.gangs(),
                "anns": {n: self.anns(n) for n in names}}

    def fake_clock(self, clock: list) -> None:
        self.s.gangs._now = lambda: clock[0]


def ordered_snapshot(s) -> None:
    """The JAX scheduler's snapshot in its registry's order (see the
    module docstring)."""
    snapshot = s.snapshot

    def ordered():
        snap = snapshot()
        return {n: snap[n] for n in s.nodes.list_nodes() if n in snap}

    s.snapshot = ordered


def as_port(record):
    return json.loads(json.dumps(record).replace("TPU", "GPU"))


def gang_pod(name, uid, group="job1", total=3, nums="4", mem="1000",
             anns=None):
    return {"metadata": {"name": name, "namespace": "default", "uid": uid,
                         "annotations": {t.GANG_GROUP_ANNOTATION: group,
                                         t.GANG_TOTAL_ANNOTATION: str(total),
                                         **(anns or {})}},
            "spec": {"containers": [{"name": "main", "resources": {
                "limits": {"nvidia.com/gpu": nums,
                           "nvidia.com/gpumem": mem}}}]}}


def plain_pod(name, uid, nums="4", mem="3000"):
    p = gang_pod(name, uid, nums=nums, mem=mem)
    p["metadata"]["annotations"] = {}
    return p


def run_both(script, **build):
    """``script(side)`` on each package; the records held equal, the
    port's returned with its side."""
    out = {}
    for port in (True, False):
        side = Side(port, **build)
        out[port] = (json.loads(json.dumps(script(side))), side)
    assert out[True][0] == out[False][0]
    return out[True]


def create(side, *pods):
    for p in pods:
        side.kube.create_pod(copy.deepcopy(p))
    return list(pods)


class TestGangAdmission:
    def test_waits_for_quorum_then_places_all(self):
        def script(side):
            pods = create(side, *(gang_pod(f"w{i}", f"gu{i}")
                                  for i in range(3)))
            rec = {"r1": side.filter(pods[0]), "r2": side.filter(pods[1]),
                   "r3": side.filter(pods[2])}
            rec["r1b"] = side.filter(pods[0])
            rec["r2b"] = side.filter(pods[1])
            return {**rec, **side.state("w0", "w1", "w2")}

        rec, _ = run_both(script)
        assert rec["r1"]["node"] is None and "waiting (1/3)" in \
            rec["r1"]["error"]
        assert rec["r2"]["node"] is None and "waiting (2/3)" in \
            rec["r2"]["error"]
        assert rec["r3"]["node"] in NODES
        assert {rec["r1b"]["node"], rec["r2b"]["node"],
                rec["r3"]["node"]} == set(NODES)
        for name in ("w0", "w1"):
            assert rec["anns"][name][t.ASSIGNED_NODE_ANNOTATION] in NODES

    def test_conflicting_total_after_admission_rejected(self):
        def script(side):
            pods = create(side, *(gang_pod(f"w{i}", f"cu{i}", group="jobc",
                                           total=2) for i in range(2)))
            side.filter(pods[0])
            rec = {"r": side.filter(pods[1])}
            [stray] = create(side, gang_pod("w9", "cu9", group="jobc",
                                            total=3))
            rec["rs"] = side.filter(stray)
            [stray2] = create(side, gang_pod("w8", "cu8", group="jobc",
                                             total=2))
            rec["rs2"] = side.filter(stray2)
            rec["r0"] = side.filter(pods[0])
            return {**rec, **side.state("w0", "w1")}

        rec, _ = run_both(script)
        assert rec["r"]["node"] in NODES
        assert rec["rs"]["node"] is None and "rejected" in rec["rs"]["error"]
        assert rec["rs2"]["node"] is None and "rejected" in \
            rec["rs2"]["error"]
        assert rec["r0"]["node"] in NODES
        assert {"cu0", "cu1"} <= set(rec["grants"]) and \
            "cu9" not in rec["grants"]

    def test_replacement_member_fills_freed_slot(self):
        def script(side):
            pods = create(side, *(gang_pod(f"r{i}", f"ru{i}", group="jobr",
                                           total=2) for i in range(2)))
            side.filter(pods[0])
            rec = {"r1": side.filter(pods[1]),
                   "survivor": side.filter(pods[0])["node"]}
            side.kube.delete_pod("default", "r1")
            rec["ru1_after_delete"] = side.s.pods.get("ru1") is None
            [repl] = create(side, gang_pod("r1-new", "ru9", group="jobr",
                                           total=2))
            rec["rr"] = side.filter(repl)
            rec["survivor_again"] = side.filter(pods[0])["node"]
            return {**rec, **side.state("r0", "r1-new")}

        rec, _ = run_both(script)
        assert rec["r1"]["node"] in NODES and rec["ru1_after_delete"]
        assert rec["rr"]["node"] in NODES, rec["rr"]["error"]
        assert rec["survivor_again"] == rec["survivor"]
        assert "ru9" in rec["grants"]

    def test_stale_event_for_dropped_uid_rejected(self):
        def script(side):
            pods = create(side, *(gang_pod(f"d{i}", f"du{i}", group="jobd",
                                           total=2) for i in range(2)))
            side.filter(pods[0])
            rec = {"r1": side.filter(pods[1])}
            side.kube.delete_pod("default", "d1")
            rec["gone"] = side.s.pods.get("du1") is None
            rec["rs"] = side.filter(gang_pod("d1", "du1", group="jobd",
                                             total=2))
            return {**rec, **side.state("d0")}

        rec, _ = run_both(script)
        assert rec["r1"]["node"] in NODES and rec["gone"]
        assert rec["rs"]["node"] is None and "stale" in rec["rs"]["error"]
        assert "du1" not in rec["grants"]

    def test_stale_event_rejected_even_after_group_popped(self):
        def script(side):
            [lone] = create(side, gang_pod("e0", "eu0", group="jobe",
                                           total=2))
            rec = {"r": side.filter(lone)}
            side.kube.delete_pod("default", "e0")
            rec["rs"] = side.filter(gang_pod("e0", "eu0", group="jobe",
                                             total=2))
            [fresh] = create(side, gang_pod("e1", "eu1", group="jobe",
                                            total=2))
            rec["rf"] = side.filter(fresh)
            return {**rec, **side.state()}

        rec, _ = run_both(script)
        assert "waiting" in rec["r"]["error"]
        assert rec["rs"]["node"] is None and "stale" in rec["rs"]["error"]
        assert "waiting (1/2)" in rec["rf"]["error"]

    def test_replacement_keeps_generation_homogeneity(self):
        p_nodes = ["node-p1", "node-p2", "node-p3"]

        def script(side):
            for n in p_nodes:
                side.add_node(n, generation="h200")
            pods = create(side, *(gang_pod(f"h{i}", f"hu{i}", group="jobh",
                                           total=2) for i in range(2)))
            side.filter(pods[0])
            rec = {"r1": side.filter(pods[1])}
            side.kube.delete_pod("default", "h1")
            [repl] = create(side, gang_pod("h1-new", "hu9", group="jobh",
                                           total=2))
            rec["rr"] = side.filter(repl, NODES + p_nodes)
            return {**rec, **side.state("h0", "h1-new")}

        rec, _ = run_both(script)
        assert rec["r1"]["node"] in NODES
        assert rec["rr"]["node"] in NODES, rec["rr"]

    def test_infeasible_gang_admits_nobody(self):
        def script(side):
            pods = create(side, *(gang_pod(f"w{i}", f"gu{i}", total=4,
                                           mem="16384") for i in range(4)))
            rec = {"results": [side.filter(p) for p in pods]}
            [solo] = create(side, plain_pod("solo", "solo"))
            rec["solo"] = side.filter(solo)
            return {**rec, **side.state("solo")}

        rec, _ = run_both(script)
        assert all(r["node"] is None for r in rec["results"])
        assert "no atomic placement" in rec["results"][-1]["error"]
        assert rec["solo"]["node"] in NODES

    def test_reserved_capacity_not_stolen(self):
        def script(side):
            pods = create(side, *(gang_pod(f"w{i}", f"gu{i}")
                                  for i in range(3)))
            for p in pods[:2]:
                side.filter(p)
            rec = {"r3": side.filter(pods[2])}
            [thief] = create(side, plain_pod("thief", "thief",
                                             mem="16000"))
            rec["rt"] = side.filter(thief)
            rec["r0"] = side.filter(pods[0])
            rec["r1"] = side.filter(pods[1])
            return {**rec, **side.state("w0", "w1", "w2")}

        rec, _ = run_both(script)
        assert rec["r3"]["node"] is not None
        assert rec["rt"]["node"] is None
        assert rec["r0"]["node"] is not None and rec["r1"]["node"] is not None

    def test_prefers_homogeneous_generation(self):
        p_nodes = ["node-p1", "node-p2"]

        def script(side):
            for n in p_nodes:
                side.add_node(n, generation="h200")
            pods = create(side, *(gang_pod(f"w{i}", f"gu{i}", total=2)
                                  for i in range(2)))
            side.filter(pods[0], NODES + p_nodes)
            rec = {"r": side.filter(pods[1], NODES + p_nodes),
                   "r0": side.filter(pods[0], NODES + p_nodes)}
            return {**rec, **side.state("w0", "w1")}

        rec, _ = run_both(script)
        assert rec["r"]["node"] in NODES and rec["r0"]["node"] in NODES

    def test_expired_gang_releases_grants(self):
        def script(side):
            clock = [0.0]
            side.fake_clock(clock)
            pods = create(side, *(gang_pod(f"w{i}", f"gu{i}")
                                  for i in range(3)))
            rec = {"filters": [side.filter(p) for p in pods]}
            rec["before"] = side.grants()
            for p in pods:
                side.kube.delete_pod("default", p["metadata"]["name"])
            clock[0] = 1000.0
            [other] = create(side, gang_pod("x0", "xu0", group="job2",
                                            total=2))
            rec["other"] = side.filter(other)
            return {**rec, **side.state()}

        rec, _ = run_both(script)
        assert "gu0" in rec["before"]
        assert "gu0" not in rec["grants"] and "gu1" not in rec["grants"]

    def test_resync_keeps_tentative_grants(self):
        def script(side):
            pods = create(side, *(gang_pod(f"w{i}", f"gu{i}")
                                  for i in range(3)))
            for p in pods[:2]:
                side.filter(p)
            rec = {"r3": side.filter(pods[2])}
            side.s.resync_from_apiserver()
            side.s.on_pod_event("MODIFIED",
                                side.kube.get_pod("default", "w0"))
            rec["kept"] = side.grants()
            [thief] = create(side, plain_pod("thief", "thief",
                                             mem="16000"))
            rec["thief"] = side.filter(thief)
            return {**rec, **side.state("w0", "w1", "w2")}

        rec, _ = run_both(script)
        assert rec["r3"]["node"] is not None
        assert {"gu0", "gu1"} <= set(rec["kept"])
        assert rec["thief"]["node"] is None

    def test_reserved_retry_survives_lost_grant(self):
        def script(side):
            pods = create(side, *(gang_pod(f"w{i}", f"gu{i}")
                                  for i in range(3)))
            for p in pods:
                side.filter(p)
            side.s.pods.del_pod("gu0")
            rec = {"r": side.filter(pods[0])}
            return {**rec, **side.state("w0")}

        rec, _ = run_both(script)
        assert rec["r"]["node"] in NODES and "gu0" in rec["grants"]

    def test_member_deletion_releases_immediately(self):
        def script(side):
            pods = create(side, *(gang_pod(f"w{i}", f"gu{i}")
                                  for i in range(3)))
            for p in pods:
                side.filter(p)
            side.kube.delete_pod("default", "w1")
            return {"reserved": side.s.gangs.is_reserved("gu1"),
                    **side.state()}

        rec, _ = run_both(script)
        assert not rec["reserved"]
        assert "gu1" not in rec["grants"] and "gu0" in rec["grants"]

    def test_expiry_keeps_grant_on_transient_apiserver_error(self):
        def script(side):
            clock = [0.0]
            side.fake_clock(clock)
            pods = create(side, *(gang_pod(f"w{i}", f"gu{i}")
                                  for i in range(3)))
            for p in pods:
                side.filter(p)
            clock[0] = 1000.0
            orig = side.s.client.get_pod
            side.s.client.get_pod = lambda ns, n: (_ for _ in ()).throw(
                ConnectionError("apiserver hiccup"))
            try:
                side.s._release_expired_gangs()
            finally:
                side.s.client.get_pod = orig
            rec = {"kept": side.state()}
            for p in pods:
                side.kube._pods.pop(f"default/{p['metadata']['name']}",
                                    None)
            side.s._release_expired_gangs()
            return {**rec, **side.state()}

        rec, _ = run_both(script)
        assert "gu0" in rec["kept"]["grants"] and rec["kept"]["gangs"]
        assert "gu0" not in rec["grants"] and not rec["gangs"]

    def test_single_member_gang_places_immediately(self):
        def script(side):
            [p] = create(side, gang_pod("w0", "gu0", total=1, nums="2"))
            return {"r": side.filter(p), **side.state("w0")}

        rec, _ = run_both(script)
        assert rec["r"]["node"] in NODES
        assert rec["anns"]["w0"][t.GANG_RANK_ANNOTATION] == "0"


def ranked(side, pods):
    """Each member filtered twice (the quorum, then the retries that
    collect and write their reservations)."""
    for p in pods:
        side.filter(p)
    for p in pods:
        side.filter(p)


class TestGangRanks:
    def test_ranks_assigned_and_written_through(self):
        def script(side):
            pods = create(side, *(gang_pod(f"rk{i}", f"rku{i}",
                                           group="jobrk", total=3)
                                  for i in range(3)))
            ranked(side, pods)
            return side.state("rk0", "rk1", "rk2")

        rec, _ = run_both(script)
        assert {int(a[t.GANG_RANK_ANNOTATION])
                for a in rec["anns"].values()} == {0, 1, 2}

    def test_replacement_inherits_freed_rank(self):
        def script(side):
            pods = create(side, *(gang_pod(f"rr{i}", f"rru{i}",
                                           group="jobrr", total=2)
                                  for i in range(2)))
            ranked(side, pods)
            rec = {"before": side.state("rr0", "rr1")}
            side.kube.delete_pod("default", "rr0")
            [repl] = create(side, gang_pod("rr0-new", "rru9", group="jobrr",
                                           total=2))
            rec["r"] = side.filter(repl)
            return {**rec, **side.state("rr0-new", "rr1")}

        rec, _ = run_both(script)
        before = rec["before"]["anns"]
        assert rec["r"]["node"] in NODES, rec["r"]["error"]
        assert rec["anns"]["rr0-new"][t.GANG_RANK_ANNOTATION] == \
            before["rr0"][t.GANG_RANK_ANNOTATION]
        assert rec["anns"]["rr1"][t.GANG_RANK_ANNOTATION] == \
            before["rr1"][t.GANG_RANK_ANNOTATION]

    def test_rank_zero_follows_pod_name_ordinal_not_uid(self):
        def script(side):
            pods = create(side, *(gang_pod(
                f"job-{i}", f"{'zyx'[i]}{'zyx'[i]}-uid-{i}",
                group="jobord", total=3) for i in range(3)))
            ranked(side, pods)
            return side.state("job-0", "job-1", "job-2")

        rec, _ = run_both(script)
        for i in range(3):
            assert rec["anns"][f"job-{i}"][t.GANG_RANK_ANNOTATION] == str(i)

    def test_pre_admission_overflow_member_rejected(self):
        def script(side):
            pods = create(side, *(gang_pod(f"o{i}", f"ou{i}", group="jobo",
                                           total=2) for i in range(3)))
            side.filter(pods[0])
            rec = {"r1": side.filter(pods[1]), "r2": side.filter(pods[2])}
            return {**rec, **side.state("o0", "o1", "o2")}

        rec, _ = run_both(script)
        assert rec["r1"]["node"] in NODES
        assert rec["r2"]["node"] is None and "rejected" in rec["r2"]["error"]

    def test_rank_prefers_job_completion_index_annotation(self):
        def script(side):
            pods = create(side, *(gang_pod(
                f"ij-{i}-x7{9 - i}", f"iju{i}", group="jobij", total=2,
                anns={tgang.JOB_COMPLETION_INDEX_ANNOTATION: str(i)})
                for i in range(2)))
            ranked(side, pods)
            return side.state("ij-0-x79", "ij-1-x78")

        rec, _ = run_both(script)
        assert rec["anns"]["ij-0-x79"][t.GANG_RANK_ANNOTATION] == "0"
        assert rec["anns"]["ij-1-x78"][t.GANG_RANK_ANNOTATION] == "1"


# -- the registry and place_gang alone ------------------------------------------

def test_gang_of_reads_the_annotations_as_jax():
    from k8s_vgpu_scheduler_tpu.scheduler.gang import gang_of as jgang_of
    for anns in ({}, {t.GANG_GROUP_ANNOTATION: "g"},
                 {t.GANG_GROUP_ANNOTATION: "g", t.GANG_TOTAL_ANNOTATION: "x"},
                 {t.GANG_GROUP_ANNOTATION: "g", t.GANG_TOTAL_ANNOTATION: "0"},
                 {t.GANG_GROUP_ANNOTATION: "", t.GANG_TOTAL_ANNOTATION: "2"},
                 {t.GANG_GROUP_ANNOTATION: "g", t.GANG_TOTAL_ANNOTATION: "3"}):
        pod = {"metadata": {"annotations": anns}}
        assert tgang.gang_of(pod) == jgang_of(pod)


def test_the_keys_and_the_expiry_are_the_jax_packages():
    from k8s_vgpu_scheduler_tpu.scheduler import gang as jgang
    assert tgang.GANG_EXPIRE_SECONDS == jgang.GANG_EXPIRE_SECONDS == 600.0
    for key in ("GANG_GROUP_ANNOTATION", "GANG_TOTAL_ANNOTATION",
                "GANG_RANK_ANNOTATION", "GANG_COORDINATOR_ANNOTATION"):
        assert getattr(t, key) == getattr(jgang, key)


@pytest.mark.parametrize("names,index", [
    (["job-0", "job-1", "job-2"], None),
    (["job-2", "job-7", "other"], None),
    (["a", "b", "c"], None),
    (["w-1", "w-1x", "w-0"], None),
    (["x", "y"], ["1", "0"]),
    (["x-5", "y-0"], ["zz", None]),
], ids=["ordinals", "out_of_range", "names", "mixed", "index", "bad_index"])
def test_assign_ranks_matches_jax(names, index):
    """The ranks of a fresh gang, then of a replacement after a drop."""
    from k8s_vgpu_scheduler_tpu.scheduler import gang as jgang
    out = []
    for mod in (tgang, jgang):
        g = mod.Gang(key="default/g", total=len(names))
        for i, name in enumerate(names):
            anns = {}
            if index is not None and index[i] is not None:
                anns[tgang.JOB_COMPLETION_INDEX_ANNOTATION] = index[i]
            g.members[f"u{len(names) - i}"] = mod.GangMember(
                uid=f"u{len(names) - i}", name=name, namespace="default",
                requests=[], annotations=anns)
        g.assign_ranks(list(g.members))
        first = dict(g.ranks)
        dropped = sorted(g.members)[0]
        g.ranks.pop(dropped)
        g.members[dropped].name = "replacement"
        g.assign_ranks([dropped])
        out.append((first, dict(g.ranks)))
    assert out[0] == out[1]


def test_cow_usage_never_writes_its_base():
    from k8s_vgpu_scheduler_tpu_torch.scheduler import score
    base = {f"c{i}": score.DeviceUsage(f"c{i}", "NVIDIA-h100", True, (i,),
                                       10, 0, 16384, 0, 100, 0)
            for i in range(4)}
    before = {k: (u.used_slots, u.used_mem) for k, u in base.items()}
    view = score.CowUsage(score.CowUsage(base))
    got = score.fit_pod([t.ContainerDeviceRequest(nums=2, memreq=1000)],
                        view, None, {})
    assert got is not None and len(got[0]) == 2
    assert {k: (u.used_slots, u.used_mem) for k, u in base.items()} == before
    assert sum(u.used_mem for u in view.values()) == 2000
    assert len(view) == 4 and [u.id for u in view.values()] == list(base)


# -- the multi-node gang, in process --------------------------------------------

def board(node: str) -> dict:
    """tests/test_multinode_e2e.py's node: eight cards of 16,384 MiB on a
    (4, 2) fabric, UUIDs unique to the node."""
    return {"generation": "h100", "mesh": [4, 2], "hbm_mib": 16384,
            "chips": [{"uuid": f"GPU-{node}-{i}", "coords": [i % 4, i // 4]}
                      for i in range(8)]}


def test_gang_placed_atomically_across_two_registered_nodes():
    """tests/test_multinode_e2e.py's gang case in process: two nodes of
    eight cards register through their register streams (held open),
    two full-node members of ``ring`` (total 2, a coordinator) are
    filtered on both packages: the barrier, then both members on distinct
    nodes, with the same placements and rank annotations on both sides.
    On the port's side each member binds and its own node's agent answers
    Allocate with the gang env; a full-node pod then fits nowhere, and
    the delete of one member frees its node for it."""
    coord = "ring-0.ring.default.svc"

    def member(name):
        p = gang_pod(name, f"uid-{name}", group="ring", total=2, nums="8",
                     mem="16384",
                     anns={t.GANG_COORDINATOR_ANNOTATION: coord})
        return p

    records, sides = {}, {}
    for port in (True, False):
        kube = TKube() if port else JKube()
        cfg = (TConfig() if port else
               JConfig(resources=JNames(**PORT_NAMES),
                       scheduler_name="vgpu-scheduler",
                       optimistic_commit=False))
        s = (TScheduler if port else JScheduler)(kube, cfg)
        if not port:
            ordered_snapshot(s)
        kube.watch_pods(s.on_pod_event)
        streams, threads = [], []
        for n in ("node-a", "node-b"):
            kube.add_node({"metadata": {"name": n, "annotations": {}}})
            req = inventory_to_request(n, MockBackend(board(n)).inventory(),
                                       TConfig())
            if not port:
                req = jpb.RegisterRequest.FromString(req.SerializeToString())
            q = queue.Queue()
            q.put(req)
            streams.append(q)

            def messages(q=q):
                while True:
                    item = q.get()
                    if item is None:
                        return
                    yield item

            th = threading.Thread(target=s.handle_register_stream,
                                  args=(messages(),), daemon=True)
            th.start()
            threads.append(th)
        deadline = threading.Event()
        for _ in range(200):
            if len(s.nodes.list_nodes()) == 2:
                break
            deadline.wait(0.01)
        p0, p1 = member("ring-0"), member("ring-1")
        kube.create_pod(copy.deepcopy(p0))
        kube.create_pod(copy.deepcopy(p1))
        nodes = ["node-a", "node-b"]
        rec = {}
        for key, p in (("first", p0), ("second", p1), ("again", p0)):
            r = s.filter(p, nodes)
            rec[key] = as_port(dict(node=r.node, error=r.error,
                                    failed=r.failed))
        rec["anns"] = {n: {k: v for k, v in kube.get_pod("default", n)[
            "metadata"]["annotations"].items() if k in DECISION}
            for n in ("ring-0", "ring-1")}
        records[port] = rec
        sides[port] = (kube, s, streams, threads)
    assert records[True] == records[False]
    rec = records[True]
    assert rec["first"]["node"] is None and "waiting (1/2)" in \
        rec["first"]["error"]
    assert {rec["second"]["node"], rec["again"]["node"]} == \
        {"node-a", "node-b"}
    assert sorted(a[t.GANG_RANK_ANNOTATION]
                  for a in rec["anns"].values()) == ["0", "1"]

    kube, s, streams, threads = sides[True]
    try:
        envs = {}
        for name, node in (("ring-0", rec["again"]["node"]),
                           ("ring-1", rec["second"]["node"])):
            assert s.bind("default", name, f"uid-{name}", node) is None
            plugin = GpuDevicePlugin(kube, MockBackend(board(node)).inventory(),
                                     TConfig(node_name=node))
            [resp] = plugin.allocate(1)
            envs[name] = resp.envs
            assert kube.get_pod("default", name)["metadata"]["annotations"][
                t.BIND_PHASE_ANNOTATION] == t.BIND_SUCCESS
            assert not nodelock.is_locked(kube, node)
        for name, env in envs.items():
            assert env["VTPU_GANG_SIZE"] == "2"
            assert env["VTPU_GANG_GROUP"] == "ring"
            assert env["VTPU_GANG_COORDINATOR"] == coord
            assert env["VTPU_GANG_RANK"] == \
                rec["anns"][name][t.GANG_RANK_ANNOTATION]
            assert len(env["NVIDIA_VISIBLE_DEVICES"].split(",")) == 8
        extra = plain_pod("extra", "uid-extra", nums="8", mem="16384")
        kube.create_pod(copy.deepcopy(extra))
        assert s.filter(extra, ["node-a", "node-b"]).node is None
        kube.delete_pod("default", "ring-0")
        assert s.filter(extra, ["node-a", "node-b"]).node == \
            rec["again"]["node"]
    finally:
        for _kube, _s, qs, ths in sides.values():
            for q in qs:
                q.put(None)
            for th in ths:
                th.join(timeout=10)


def test_resync_prune_does_not_tombstone_live_gang_uids():
    """tests/test_watch.py's case on both packages: a resync whose list
    is empty drops the waiting member without a tombstone, so its next
    Filter waits again instead of being refused as stale."""
    def script(side):
        [pod] = create(side, gang_pod("g0", "ug0", group="j", total=2,
                                      nums="1", mem="3000"))
        rec = {"r": side.filter(pod, ["node-a"])}
        # A grant recorded before the list began is pruned; the member
        # holds none, so the drop is the gang registry's alone.
        real = side.kube.list_pods_with_rv
        side.kube.list_pods_with_rv = lambda: ([], "0")
        side.s.resync_from_apiserver()
        side.kube.list_pods_with_rv = real
        rec["dropped"] = side.gangs()
        rec["r2"] = side.filter(pod, ["node-a"])
        return {**rec, **side.state()}

    rec, _ = run_both(script)
    assert "waiting" in rec["r"]["error"]
    assert "stale" not in rec["r2"]["error"]
    assert "waiting" in rec["r2"]["error"]


# -- a gang-scoped mesh ----------------------------------------------------------

@pytest.mark.parametrize("mesh,nums,total", [
    ("2x4", "4", 2), ("2x4", "8", 2), ("2x4", "4", 3), ("4x2", "2", 4),
    ("2x4", "8", 1)],
    ids=["gang_2x4", "volume_too_big", "three_members", "axis0_split",
         "one_member"])
def test_a_gang_mesh_is_validated_as_jax(mesh, nums, total):
    """The webhook checks a member's ``vtpu.dev/mesh`` against the gang's
    volume (its card count times the members), axis 0 split across them:
    the same refusal, or none, as the JAX webhook's."""
    pod = gang_pod("m", "um", group="mesh", total=total, nums=nums,
                   anns={t.MESH_ANNOTATION: mesh})
    topo_t = [TTopo(generation="h100", mesh=(4, 1))]
    topo_j = [JTopo(generation="h100", mesh=(4, 1))]
    jcfg = JConfig(resources=JNames(**PORT_NAMES))
    got = twebhook.validate_pod_mesh(pod, TConfig(), topo_t)
    want = jwebhook.validate_pod_mesh(pod, jcfg, topo_j)
    assert got == as_port(want)
    if (mesh, nums, total) == ("2x4", "4", 2):
        assert got is None


def test_a_gang_2x4_mesh_is_placed_as_jax():
    """Two members of a ``2x4`` mesh, four cards each: each member's
    local mesh (1x4) lands on a (4, 1) box of one node, both members
    placed atomically, the same boxes and ranks on both packages."""
    def script(side):
        pods = create(side, *(gang_pod(
            f"mesh-{i}", f"um{i}", group="mesh", total=2,
            anns={t.MESH_ANNOTATION: "2x4"}) for i in range(2)))
        rec = {"r0": side.filter(pods[0]), "r1": side.filter(pods[1]),
               "r0b": side.filter(pods[0])}
        return {**rec, **side.state("mesh-0", "mesh-1")}

    rec, _ = run_both(script)
    assert rec["r1"]["node"] in NODES and rec["r0b"]["node"] in NODES
    assert rec["r1"]["node"] != rec["r0b"]["node"]
    for uid in ("um0", "um1"):
        assert len(rec["grants"][uid][1]) == 4


# -- the card's gang leg, on the CPU ---------------------------------------------

MEMBER = """
import json, os, sys, time
sys.path.insert(0, os.environ["REPO"])
import torch, torch.distributed as dist
from k8s_vgpu_scheduler_tpu_torch.parallel import multihost
t0 = time.monotonic()
assert multihost.initialize_from_env("gloo", timeout_s=60)
joined = time.monotonic()
rank = dist.get_rank()
err = torch.tensor([1e-3 * (rank + 1)], dtype=torch.float64)
total = torch.tensor([float(rank + 1)], dtype=torch.float64)
dist.all_reduce(err, op=dist.ReduceOp.MAX)
dist.all_reduce(total, op=dist.ReduceOp.SUM)
print(json.dumps(dict(
    rank=rank, size=dist.get_world_size(), launches=1,
    errors={"rel_max_err": 1e-3 * (rank + 1)}, checksum=float(rank + 1),
    max_rel_err_all=err.item(), checksum_all=total.item(),
    rendezvous_s=joined - t0, joined_t=joined,
    interposer={"refusals": 0, "context_bytes": 0, "alloc_bytes": 0})))
dist.destroy_process_group()
"""


def test_the_card_gang_leg_on_the_mock_nvml(tmp_path, monkeypatch):
    """chip_smoke's gang leg on the CPU, inside its quota leg: the control
    plane on the mock NVML with the leg's queues, V' holding its grant as
    in the phase.  B's pod is stood in for as in tests/test_torch_quota.py;
    each gang member by a process that forms the gloo group from its
    Allocate answer's gang env alone and all-reduces (no card: no kernel).
    Every check of the leg runs: the hold, the accumulating tick, the
    release of both, the refused atomic placement beside E with nothing
    granted, both placed with ranks 0 and 1 once E is gone, the gang env,
    the reduced values, the grants and the registry gone."""
    import os
    import subprocess
    import sys
    import time

    import chip_smoke
    from k8s_vgpu_scheduler_tpu_torch.ops import _kernels
    from k8s_vgpu_scheduler_tpu_torch.shim.preempt import PreemptionWatch

    root = str(chip_smoke.ROOT)

    class Child:
        def __init__(self, name, tmp, label=None, region=None, **grant):
            assert name in ("quota_pod", "gang_member") and region
            self.name, self.label, self.grant = name, label, grant

        def run(self, record, section, on_line=lambda line: None):
            if self.name == "quota_pod":
                watch = PreemptionWatch(
                    self.grant["VTPU_PODINFO_ANNOTATIONS"])
                on_line("LOOP 1")
                assert watch.requested()
                now = time.monotonic()
                return dict(loops=1, requester=watch.requester(),
                            stop_seen_t=now, interposer={}, exit_t=now)
            env = {k: v for k, v in os.environ.items()
                   if not k.startswith("VTPU_GANG_")}
            env.update({k: str(v) for k, v in self.grant.items()
                        if k.startswith("VTPU_GANG_")
                        or k == "GLOO_SOCKET_IFNAME"})
            env.update(REPO=root, OMP_NUM_THREADS="1")
            res = subprocess.run([sys.executable, "-c", MEMBER], env=env,
                                 capture_output=True, text=True, timeout=120)
            assert res.returncode == 0, res.stderr
            reading = json.loads(res.stdout.strip().splitlines()[-1])
            record.setdefault(section, {})[self.label] = reading
            return reading

        def stop(self):
            pass

    monkeypatch.setattr(chip_smoke, "EnforceChild", Child)
    lib = _kernels.build_mock_nvml()
    fixture = tmp_path / "nvml.json"
    fixture.write_text(json.dumps({"generation": "h100", "mesh": [1],
                                   "hbm_mib": 81079}))
    quota = tmp_path / "quota.json"
    quota.write_text(json.dumps({"queues": chip_smoke.QUOTA_QUEUES}))
    (tmp_path / "containers").mkdir()
    env = {k: v for k, v in os.environ.items()
           if k not in ("VTPU_MOCK_JSON", "MOCK_NVML_NOT_SUPPORTED")}
    env.update(LD_LIBRARY_PATH=str(lib.parent), MOCK_NVML_JSON=str(fixture),
               PLUGIN_DIR=str(tmp_path), QUOTA_CONFIG=str(quota))
    plane = chip_smoke.PlaneChild(env)
    record = {}
    try:
        name, uid, mib, prio, anns = chip_smoke.PREEMPT_PODS["V2"]
        created, out = chip_smoke.admit_pod(
            plane.base, plane, chip_smoke.user_pod(name, uid, mib, prio))
        chip_smoke.place_pod(plane.base, created, chip_smoke.PLUGIN_NODE,
                             out)
        plane.call("allocate")
        gang = chip_smoke.GangLeg(plane, plane.ready["uuid"],
                                  tmp_path / "volumes", tmp_path, [], record)
        chip_smoke.quota_leg(plane, plane.ready["uuid"],
                             tmp_path / "volumes", tmp_path, [], gang=gang)
        ended = plane.call("end")
    finally:
        rc = plane.close()
    assert rc == 0
    summary = gang.summary
    assert summary["mib"] == chip_smoke.GANG_MIB
    assert summary["card_remaining_mib"] == 81079 - 40000 - 24000
    assert summary["waiting"] == "gang ring waiting (1/2)"
    assert summary["no_fit"] == "gang ring: no atomic placement for 2 members"
    assert summary["blocked"] == {
        "team-g": ["uidG0", "gang ring accumulating (1/2)"]}
    assert summary["max_rel_err_all"] == 2e-3
    assert summary["checksum_all"] == 3.0
    assert set(summary["queuez"]) == {"released", "placed", "deleted"}
    assert sorted(record["gang"]) == ["gang_ring-0", "gang_ring-1"]
    assert ended["held"] == [["uidPV2", "trainer-2"]]
