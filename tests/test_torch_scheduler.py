"""The port's scheduler extender against the JAX package's, on the CPU.

The same seeded fleet (three nodes of eight mock H100s, 81,079 MiB each,
split 10, and a node of four H100s and four A100s) registers with each
side through that side's decode of the port's ``inventory_to_request``;
the same pod sequences then go through both.  Every FilterResult (node,
every ``failed`` reason, error), the pods' annotations after every Filter
and Bind, Bind's errors, phases and lock, and the usage of every card are
held equal.

What the JAX side is given, and why:

- the port's resource names and scheduler name (``PORT_NAMES``), so both
  read the same pods;
- ``optimistic_commit=False``, on both sides: the serial decision.  The
  default optimistic path picks among nodes within 1% of the best score by
  a digest of (pod, node), Python's salted ``hash()`` in the JAX package,
  which changes from run to run (tests/test_torch_concurrency.py holds the
  optimistic paths);
- the port's register request as it is, ``Topology`` message included:
  both sides place a multi-card request on a node with a fabric by the
  slice engine under the pod's topology policy, and a ``vtpu.dev/mesh``
  pod by the mesh engine; a node without one (an empty mesh) takes the
  plain choice of cards on both.

Pods and strings are compared under the name table: the JAX side's pods
carry the type-affinity keys under its names (``vtpu.dev/use-tputype``
for ``nvidia.com/use-gputype``), and its "TPU" in its two human messages
("no TPU inventory registered", "no node fits TPU request") reads "GPU"
in the port's.  Every reason token is the same.

The decision annotations are compared whole, ``vtpu.dev/assigned-time``
as "present and an integer".  Keys the JAX scheduler writes at defaults
that none of these pods makes it write: ``vtpu.dev/pod-group-rank`` (a
gang member's; ``tests/test_torch_gang.py`` compares it), and, with why
none is in the port, ``vtpu.dev/preempt-requested`` (preemption is off by
default; ROADMAP A.3b), ``vtpu.dev/queue``/``queue-state`` (capacity
queues are off without a quota config; A.5), the shard owner (the shard
layer is off without a replica name; A.5) and ``vtpu.dev/mesh-assigned``
(the resize controller's, off by default; ``tests/test_torch_elastic.py``
compares it).
"""

import copy
import itertools
import json

import pytest

from k8s_vgpu_scheduler_tpu.api import device_register_pb2 as jpb
from k8s_vgpu_scheduler_tpu.health.lease import LeaseTracker as JLeases
from k8s_vgpu_scheduler_tpu.health.lease import LeaseConfig as JLeaseConfig
from k8s_vgpu_scheduler_tpu.k8s import FakeKube as JKube
from k8s_vgpu_scheduler_tpu.scheduler import Scheduler as JScheduler
from k8s_vgpu_scheduler_tpu.scheduler import score as jscore
from k8s_vgpu_scheduler_tpu.scheduler.core import \
    decode_register_request as jdecode
from k8s_vgpu_scheduler_tpu.util import resources as jresources
from k8s_vgpu_scheduler_tpu.util.config import Config as JConfig
from k8s_vgpu_scheduler_tpu.util.config import ResourceNames as JNames
from k8s_vgpu_scheduler_tpu_torch.deviceplugin import inventory_to_request
from k8s_vgpu_scheduler_tpu_torch.health import LeaseConfig, LeaseTracker
from k8s_vgpu_scheduler_tpu_torch.k8s import FakeKube as TKube
from k8s_vgpu_scheduler_tpu_torch.scheduler import Scheduler as TScheduler
from k8s_vgpu_scheduler_tpu_torch.scheduler import score as tscore
from k8s_vgpu_scheduler_tpu_torch.scheduler import webhook
from k8s_vgpu_scheduler_tpu_torch.scheduler.core import \
    decode_register_request as tdecode
from k8s_vgpu_scheduler_tpu_torch.tpulib import MockBackend
from k8s_vgpu_scheduler_tpu_torch.util import nodelock, resources
from k8s_vgpu_scheduler_tpu_torch.util import types as t
from k8s_vgpu_scheduler_tpu_torch.util.config import Config as TConfig

PORT_NAMES = dict(count="nvidia.com/gpu", memory="nvidia.com/gpumem",
                  memory_percentage="nvidia.com/gpumem-percentage",
                  cores="nvidia.com/gpucores",
                  priority="nvidia.com/priority")
H100_MIB, A100_MIB = 81079, 40960
# Annotation keys, the port's to the JAX package's.
KEYS = {t.GPU_USE_TYPE_ANNOTATION: jscore.TPU_USE_TYPE_ANNOTATION,
        t.GPU_NOUSE_TYPE_ANNOTATION: jscore.TPU_NOUSE_TYPE_ANNOTATION}


def fixture(node: str, types) -> dict:
    """A node's cards: one entry of ``types`` a card, UUIDs unique in the
    fleet."""
    return {"generation": "h100", "mesh": [len(types)], "hbm_mib": H100_MIB,
            "chips": [{"coords": [i], "type": f"NVIDIA-{kind}",
                       "hbm_mib": H100_MIB if kind == "h100" else A100_MIB,
                       "uuid": f"GPU-{node}-{i:02d}-5b3f-0a1c-2222"}
                      for i, kind in enumerate(types)]}


def fabric(node: str, mesh, wrap=None, missing=()) -> dict:
    """A node of H100s at every point of ``mesh`` (``wrap``: its
    wraparound), the cards in ``missing`` without coordinates.  All of
    them missing is a node without a fabric, as NvmlBackend reports a
    node whose NVLink matrix is not all pairs."""
    points = list(itertools.product(*(range(d) for d in mesh)))
    fx = {"generation": "h100", "mesh": list(mesh), "hbm_mib": H100_MIB,
          "chips": [{"coords": [] if i in missing else list(c),
                     "type": "NVIDIA-h100", "hbm_mib": H100_MIB,
                     "uuid": f"GPU-{node}-{i:02d}-5b3f-0a1c-2222"}
                    for i, c in enumerate(points)]}
    if wrap is not None:
        fx["wraparound"] = list(wrap)
    return fx


FLEET = {**{f"h100-{n}": fixture(f"h100-{n}", ["h100"] * 8)
            for n in range(3)},
         "mixed": fixture("mixed", ["h100"] * 4 + ["a100"] * 4)}
NODES = list(FLEET)


def limits(nums=1, mem=None, pct=None, cores=None, prio=None) -> dict:
    out = {"nvidia.com/gpu": str(nums)}
    for key, value in (("gpumem", mem), ("gpumem-percentage", pct),
                       ("gpucores", cores), ("priority", prio)):
        if value is not None:
            out[f"nvidia.com/{key}"] = str(value)
    return out


def pod(name: str, *containers, anns=None) -> dict:
    """A pod whose containers have the limits given (``None``: a container
    that asks for no card)."""
    return {"metadata": {"name": name, "namespace": "default",
                         "uid": f"uid-{name}", "annotations": dict(anns or {})},
            "spec": {"containers": [
                {"name": f"c{i}", "resources": {"limits": lim or {"cpu": "1"}}}
                for i, lim in enumerate(containers)]}}


class Clock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now

    def advance(self, dt):
        self.now += dt
        return self.now


class Side:
    """One package's scheduler on its own FakeKube, with the fleet
    (``FLEET`` unless another is given) registered and the informer
    wired."""

    def __init__(self, port: bool, fleet=None, **cfg):
        self.port = port
        self.fleet = fleet or FLEET
        self.clock = Clock()
        base = JKube if not port else TKube
        side = self

        class Kube(base):
            def patch_pod_annotations(self, namespace, name, annotations,
                                      resource_version=None):
                if side.fail_writes:
                    side.fail_writes -= 1
                    raise RuntimeError("apiserver down")
                return super().patch_pod_annotations(
                    namespace, name, annotations,
                    resource_version=resource_version)

        self.fail_writes = 0
        self.kube = Kube()
        for name in self.fleet:
            self.kube.add_node({"metadata": {"name": name,
                                             "annotations": {}}})
        if port:
            self.cfg = TConfig(optimistic_commit=False, **cfg)
        else:
            self.cfg = JConfig(resources=JNames(**PORT_NAMES),
                               scheduler_name="vgpu-scheduler",
                               optimistic_commit=False, **cfg)
        self.fixtures = copy.deepcopy(self.fleet)
        self.seen = {}
        self.s = None
        self.start()

    def start(self):
        if self.s is not None:
            self.kube.unwatch_pods(self.s.on_pod_event)
        cls = TScheduler if self.port else JScheduler
        self.s = cls(self.kube, self.cfg, clock=self.clock)
        self.kube.watch_pods(self.s.on_pod_event)
        for name in self.fleet:
            self.s.observe_registration(name, self.info(name))

    def request(self, node):
        """The port's register message for ``node``, as each side reads
        it off the wire."""
        req = inventory_to_request(
            node, MockBackend(self.fixtures[node]).inventory(), TConfig())
        if self.port:
            return req
        return jpb.RegisterRequest.FromString(req.SerializeToString())

    def info(self, node):
        return (tdecode if self.port else jdecode)(self.request(node))

    # -- the ops of a script; each returns what it records ---------------------
    def create(self, p):
        p = copy.deepcopy(p)
        if not self.port:
            anns = p["metadata"]["annotations"]
            for k in [k for k in anns if k in KEYS]:
                anns[KEYS[k]] = anns.pop(k)
        self.kube.create_pod(p)

    def filter(self, name, nodes=None):
        p = self.kube.get_pod("default", name)
        r = self.s.filter(p, list(nodes or self.fleet))
        self.seen[name] = self.kube.get_pod("default", name)
        plan = getattr(r, "preempt", None)
        return dict(node=r.node, failed=r.failed, error=r.error,
                    annotations=decision(self.seen[name]),
                    preempt=plan and [plan.node,
                                      [v.uid for v in plan.victims]])

    def bind(self, name, node):
        err = self.s.bind("default", name, f"uid-{name}", node)
        try:
            stored = self.kube.get_pod("default", name)
            anns = stored["metadata"]["annotations"]
            bound = dict(
                phase=anns.get(t.BIND_PHASE_ANNOTATION),
                bind_time=anns.get(t.BIND_TIME_ANNOTATION, "").isdigit(),
                node_name=stored["spec"].get("nodeName"))
        except Exception as e:  # noqa: BLE001 — a pod that never was
            bound = type(e).__name__
        locked = t.NODE_LOCK_ANNOTATION in self.kube.get_node(
            node)["metadata"]["annotations"]
        return dict(error=err, pod=bound, locked=locked)

    def release(self, node):
        nodelock.release_node(self.kube, node)

    def delete(self, name):
        self.kube.delete_pod("default", name)

    def replay(self, name):
        """An ADDED for the pod as it was after its Filter (a stale list)."""
        self.s.on_pod_event("ADDED", copy.deepcopy(self.seen[name]))

    def restart(self):
        self.start()
        self.s.resync_from_apiserver()

    def advance(self, seconds):
        self.clock.now += seconds

    def beat(self, node):
        self.s.observe_registration(node, self.info(node))

    def disconnect(self, node):
        self.s.handle_register_stream(iter([self.request(node)]))

    def health(self, node, card, healthy):
        self.fixtures[node]["chips"][card]["healthy"] = healthy
        self.beat(node)

    def fail_next_write(self):
        self.fail_writes = 1

    def topologies(self):
        """known_topologies.  The JAX scheduler also lists the mesh of a
        node none of whose cards has coordinates, and the port does not
        (test_a_node_without_a_fabric_adds_no_mesh_to_the_fleet): the
        JAX side's list leaves those out here."""
        fabrics = {(i.topology.mesh, i.topology.wrap())
                   for i in self.s.nodes.list_nodes().values()
                   if i.topology and any(d.coords for d in i.devices)}
        return sorted([list(t.mesh), list(t.wrap())]
                      for t in self.s.known_topologies()
                      if self.port or (t.mesh, t.wrap()) in fabrics)

    def refabric(self, node, mesh, wrap=None):
        """The node re-registers with another fabric (an empty mesh: none,
        and no card coordinates)."""
        fx = self.fixtures[node]
        fx["mesh"] = list(mesh)
        fx.pop("wraparound", None)
        if wrap is not None:
            fx["wraparound"] = list(wrap)
        points = list(itertools.product(*(range(d) for d in mesh)))
        for i, chip in enumerate(fx["chips"]):
            chip["coords"] = list(points[i]) if mesh else []
        self.beat(node)
        info = self.s.nodes.get_node(node)
        return info.topology and [list(info.topology.mesh),
                                  list(info.topology.wrap())]

    def usage(self):
        got = self.s.get_nodes_usage()
        return {n: [[u.id, u.used_slots, u.used_mem, u.used_cores,
                     u.total_mem, u.health] for u in usage.values()]
                for n, (_, usage) in sorted(got.items())}


def decision(p: dict) -> dict:
    back = {v: k for k, v in KEYS.items()}
    anns = {back.get(k, k): v
            for k, v in (p["metadata"].get("annotations") or {}).items()}
    if t.ASSIGNED_TIME_ANNOTATION in anns:
        assert anns[t.ASSIGNED_TIME_ANNOTATION].isdigit(), anns
        anns[t.ASSIGNED_TIME_ANNOTATION] = "<int>"
    return anns


def run(script, port: bool, cfg: dict, fleet=None):
    side = Side(port, fleet=fleet, **cfg)
    out = []
    for op, *args in script:
        got = getattr(side, op)(*args)
        if got is not None:
            out.append([op, *args[:1], got])
    return json.loads(json.dumps(out))


def as_port(record):
    """The JAX side's record under the name table."""
    return json.loads(json.dumps(record).replace("TPU", "GPU"))


F = "filter"
H1 = ["h100-1"]
SCENARIOS = {
    "fractional_spread": ({}, [
        ("create", pod("a", limits(mem=24000, cores=30))),
        ("create", pod("b", limits(mem=24000, cores=30))),
        ("create", pod("c", limits(mem=24000, cores=30))),
        ("create", pod("d", limits(mem=24000, cores=30))),
        (F, "a"), (F, "b"), (F, "c"), (F, "d"), ("usage",)]),
    "percentage_and_cores": ({}, [
        ("create", pod("a", limits(pct=50, cores=25))),
        ("create", pod("b", limits(pct=60, cores=25))),
        ("create", pod("c", limits(pct=40, cores=25))),
        ("create", pod("d", limits(pct=50))),
        (F, "a", ["mixed"]), (F, "b", ["mixed"]), (F, "c", ["mixed"]),
        (F, "d", ["mixed"]), ("usage",)]),
    "whole_card_by_default": ({}, [
        ("create", pod("a", limits())), ("create", pod("b", limits(nums=2))),
        (F, "a"), (F, "b", ["mixed"]), ("usage",)]),
    "default_mem_and_cores": ({"default_mem": 10000, "default_cores": 20}, [
        ("create", pod("a", limits())),
        ("create", pod("b", limits(mem=5000))),
        ("create", pod("c", limits(pct=10))),
        (F, "a"), (F, "b"), (F, "c"), ("usage",)]),
    "exclusive_cores": ({}, [
        ("create", pod("x", limits(mem=1000, cores=100))),
        ("create", pod("y", limits(mem=1000, cores=10))),
        ("create", pod("z", limits(nums=8, mem=1000, cores=100))),
        (F, "x", H1), (F, "y", H1), (F, "z", H1), ("usage",)]),
    "cores_exhausted": ({}, [
        ("create", pod("a", limits(nums=8, mem=1000, cores=60))),
        ("create", pod("b", limits(mem=1000, cores=60))),
        ("create", pod("c", limits(nums=8, mem=1000, cores=40))),
        ("create", pod("d", limits(mem=1000, cores=0))),
        (F, "a", H1), (F, "b", H1), (F, "c", H1), (F, "d", H1),
        ("usage",)]),
    "several_cards_per_container_and_pod": ({}, [
        ("create", pod("one", limits(mem=30000))),
        ("create", pod("three", limits(nums=3, mem=20000, cores=10))),
        ("create", pod("pair", limits(nums=2, pct=25), None,
                       limits(nums=2, mem=1000, cores=5))),
        ("create", pod("nine", limits(nums=9, mem=1000))),
        (F, "one", H1), (F, "three", H1), (F, "pair", H1),
        (F, "nine", H1), ("usage",)]),
    "type_use_and_nouse": ({}, [
        ("create", pod("use", limits(mem=1000),
                       anns={t.GPU_USE_TYPE_ANNOTATION: "A100"})),
        ("create", pod("nouse", limits(mem=1000),
                       anns={t.GPU_NOUSE_TYPE_ANNOTATION: "h100, v100"})),
        ("create", pod("none", limits(mem=1000),
                       anns={t.GPU_USE_TYPE_ANNOTATION: "v100"})),
        ("create", pod("blank", limits(mem=1000),
                       anns={t.GPU_USE_TYPE_ANNOTATION: " ,"})),
        ("create", pod("both", limits(nums=5, mem=1000),
                       anns={t.GPU_USE_TYPE_ANNOTATION: "nvidia",
                             t.GPU_NOUSE_TYPE_ANNOTATION: "a100"})),
        (F, "use"), (F, "nouse"), (F, "none"), (F, "blank"), (F, "both"),
        ("usage",)]),
    "binpack": ({"node_scheduler_policy": "binpack"}, [
        *[("create", pod(f"p{i}", limits(mem=20000, cores=20)))
          for i in range(5)],
        *[(F, f"p{i}") for i in range(5)], ("usage",)]),
    "capacity_exhausted_across_filters": ({}, [
        *[("create", pod(f"p{i}", limits(mem=80000))) for i in range(9)],
        *[(F, f"p{i}", H1) for i in range(9)], ("usage",)]),
    "slots_exhausted": ({}, [
        *[("create", pod(f"p{i}", limits(mem=100, cores=0)))
          for i in range(81)],
        *[(F, f"p{i}", H1) for i in range(81)]]),
    "non_gpu_pod_passes_through": ({}, [
        ("create", pod("cpu", None, None)), (F, "cpu"), ("usage",)]),
    "unregistered_node": ({}, [
        ("create", pod("a", limits(mem=1000))),
        ("create", pod("b", limits(mem=1000))),
        (F, "a", ["ghost", "h100-2"]), (F, "b", ["ghost"])]),
    "bad_quantity": ({}, [
        ("create", pod("a", limits(mem="lots"))), (F, "a")]),
    "delete_frees_capacity": ({}, [
        *[("create", pod(f"p{i}", limits(nums=4, mem=80000)))
          for i in range(3)],
        (F, "p0", H1), (F, "p1", H1), (F, "p2", H1), ("delete", "p0"),
        ("usage",), (F, "p2", H1), ("usage",)]),
    "resync_after_restart": ({}, [
        *[("create", pod(f"p{i}", limits(mem=40000, cores=25)))
          for i in range(6)],
        *[(F, f"p{i}") for i in range(4)], ("delete", "p1"), ("restart",),
        ("usage",), (F, "p4"), (F, "p5"), ("usage",)]),
    "replayed_added_after_delete": ({}, [
        ("create", pod("a", limits(nums=2, mem=50000))),
        (F, "a", H1), ("delete", "a"), ("replay", "a"), ("usage",)]),
    "stream_disconnect": ({}, [
        ("create", pod("a", limits(mem=1000))),
        ("create", pod("b", limits(mem=1000))),
        ("disconnect", "h100-0"), (F, "a", ["h100-0", "h100-1"]),
        ("beat", "h100-0"), (F, "b", ["h100-0"]), ("usage",)]),
    "expired_lease": ({}, [
        *[("create", pod(f"p{i}", limits(mem=1000))) for i in range(4)],
        ("advance", 16.0), (F, "p0", ["h100-0", "h100-1"]),
        ("beat", "h100-0"), (F, "p1", ["h100-0", "h100-1"]),
        ("advance", 50.0), (F, "p2", ["h100-0", "h100-1"]),
        ("beat", "h100-1"), (F, "p3", ["h100-0", "h100-1"])]),
    "unhealthy_card": ({}, [
        ("create", pod("a", limits(nums=8, mem=1000))),
        ("create", pod("b", limits(nums=7, mem=1000))),
        ("health", "h100-1", 3, False), (F, "a", H1), (F, "b", H1),
        ("usage",)]),
    "failed_write_rolls_back": ({}, [
        ("create", pod("a", limits(nums=8, mem=80000))),
        ("fail_next_write",), (F, "a", H1), ("usage",), (F, "a", H1),
        ("usage",)]),
    "qos_priority_and_trace": ({}, [
        ("create", pod("lc", limits(mem=24000, cores=50, prio=0),
                       anns={t.QOS_ANNOTATION: "latency-critical",
                             "vtpu.dev/trace-id": "ab" * 16})),
        ("create", pod("be", limits(mem=40000, cores=50, prio=1),
                       anns={t.QOS_ANNOTATION: "best-effort"})),
        ("create", pod("flat", limits(mem=1000, cores=10))),
        (F, "lc", H1), (F, "be", H1), (F, "flat", H1), ("usage",)]),
    "bind_phases_lock_and_release": ({}, [
        ("create", pod("a", limits(mem=24000, cores=50))),
        (F, "a", H1), ("bind", "a", "h100-1"), ("release", "h100-1"),
        ("bind", "ghost", "h100-1")]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_the_port_decides_as_the_jax_scheduler(name):
    cfg, script = SCENARIOS[name]
    want = as_port(run(script, port=False, cfg=cfg))
    got = run(script, port=True, cfg=cfg)
    assert got == want


# A fleet with fabrics: an NVSwitch board (a ring of 8), a 4x2 grid, a
# node of four cards without a fabric and a line of four whose third card
# sent no coordinates.
TOPO_FLEET = {"ring": fabric("ring", [8], wrap=[True]),
              "grid": fabric("grid", [4, 2]),
              "pcie": fabric("pcie", [4], missing=range(4)),
              "partial": fabric("partial", [4], missing=(2,))}
POLICY = "vtpu.dev/topology-policy"
GUAR = {POLICY: "guaranteed"}
RING, GRID, PCIE, PART = ["ring"], ["grid"], ["pcie"], ["partial"]


def whole(name, nums, anns=None):
    """A pod of ``nums`` whole cards (exclusive, so each card it takes is
    busy for every later pod)."""
    return ("create", pod(name, limits(nums=nums, mem=1000, cores=100),
                          anns=anns))


TOPO_SCENARIOS = {
    "guaranteed_arcs_on_a_ring": ({}, [
        whole("a", 4, GUAR), whole("b", 2, GUAR), whole("c", 1),
        whole("d", 3, GUAR), whole("e", 2, GUAR),
        (F, "a", RING), (F, "b", RING), (F, "c", RING), ("delete", "b"),
        (F, "d", RING), (F, "e", RING), ("usage",)]),
    "policies_on_a_fragmented_ring": ({}, [
        whole("a", 2), whole("b", 1), whole("c", 2), whole("d", 1),
        whole("g", 3, GUAR), whole("r", 3, {POLICY: "restricted"}),
        whole("e", 3, {POLICY: "best-effort"}),
        (F, "a", RING), (F, "b", RING), (F, "c", RING), (F, "d", RING),
        ("delete", "a"), ("delete", "c"),
        (F, "g", RING), (F, "r", RING), (F, "e", RING), ("usage",)]),
    "slices_on_a_grid_and_across_nodes": ({}, [
        whole("a", 4), whole("b", 2, GUAR), whole("c", 3),
        whole("d", 3, GUAR), whole("e", 5, {POLICY: "restricted"}),
        (F, "a"), (F, "b", GRID), (F, "c", GRID), (F, "d"), (F, "e"),
        ("usage",)]),
    "the_configured_default_policy": ({"topology_policy": "guaranteed"}, [
        whole("a", 1), whole("b", 3), whole("c", 3),
        whole("d", 3, {POLICY: "best-effort"}), whole("e", 2),
        (F, "a", GRID), (F, "b", GRID), (F, "c", GRID), (F, "d", GRID),
        (F, "e", PART + PCIE), ("usage",)]),
    "meshes": ({}, [
        whole("sq", 4, {t.MESH_ANNOTATION: "2x2"}),
        whole("line", 4, {t.MESH_ANNOTATION: "4"}),
        whole("wide", 8, {t.MESH_ANNOTATION: "2x4"}),
        whole("bad", 2, {t.MESH_ANNOTATION: "2x"}),
        whole("vol", 2, {t.MESH_ANNOTATION: "3"}),
        whole("one", 1, {t.MESH_ANNOTATION: "1"}),
        whole("pair", 2, {t.MESH_ANNOTATION: "2", **GUAR}),
        (F, "sq"), (F, "line", RING), (F, "wide"), (F, "bad"),
        (F, "vol"), (F, "one", PCIE), (F, "pair", PCIE + PART + RING),
        ("usage",)]),
    "coords_missing_and_no_fabric": ({}, [
        whole("a", 2, GUAR), whole("b", 2), whole("c", 3, GUAR),
        whole("d", 2, {t.MESH_ANNOTATION: "2"}),
        (F, "a", PART), (F, "b", PART), (F, "c", PCIE), (F, "d", PCIE),
        (F, "d", PART), ("usage",)]),
    "known_topologies_and_reregistration": ({}, [
        ("topologies",), ("refabric", "ring", [8], [False]),
        ("topologies",), whole("a", 2, GUAR), (F, "a", RING),
        ("refabric", "ring", []), ("topologies",),
        whole("b", 2, GUAR), (F, "b", RING),
        ("refabric", "pcie", [4]), ("topologies",), whole("c", 4, GUAR),
        (F, "c", PCIE), ("disconnect", "grid"), ("topologies",),
        ("usage",)]),
}


@pytest.mark.parametrize("name", sorted(TOPO_SCENARIOS))
def test_the_port_places_on_a_fabric_as_the_jax_scheduler(name):
    cfg, script = TOPO_SCENARIOS[name]
    want = as_port(run(script, port=False, cfg=cfg, fleet=TOPO_FLEET))
    got = run(script, port=True, cfg=cfg, fleet=TOPO_FLEET)
    assert got == want


@pytest.mark.parametrize("anns,reason", [
    (GUAR, "topology-unverifiable: guaranteed policy but chip coords "
           "missing"),
    ({t.MESH_ANNOTATION: "2"}, "topology-unverifiable: mesh declared but "
                               "chip coords missing"),
    ({t.MESH_ANNOTATION: "2", POLICY: "best-effort"},
     "topology-unverifiable: mesh declared but chip coords missing"),
    ({POLICY: "restricted"}, None), ({POLICY: "best-effort"}, None), ({}, None),
], ids=["guaranteed", "mesh", "mesh_best_effort", "restricted",
        "best_effort", "default"])
def test_a_node_without_a_fabric_refuses_a_guaranteed_or_mesh_pod(anns,
                                                                   reason):
    """On the PCIe node a 2-card pod that is guaranteed or declares a mesh
    is refused; any other gets two of its cards."""
    side = Side(True, fleet=TOPO_FLEET)
    side.create(whole("p", 2, anns)[1])
    rec = side.filter("p", PCIE)
    if reason is None:
        assert rec["node"] == "pcie" and rec["failed"] == {}, rec
        cards = rec["annotations"][t.ASSIGNED_IDS_ANNOTATION]
        assert cards.count("GPU-pcie-") == 2, cards
    else:
        assert rec["node"] is None and rec["failed"] == {"pcie": reason}


def test_a_node_without_a_fabric_adds_no_mesh_to_the_fleet():
    """known_topologies leaves out a node none of whose cards has
    coordinates (the JAX scheduler lists its mesh), so the webhook refuses
    a mesh that only such a node's line of cards could hold."""
    fleet = {"pcie": fabric("pcie", [8], missing=range(8)),
             "ring": fabric("ring", [4], wrap=[True])}
    port, jax = Side(True, fleet=fleet), Side(False, fleet=fleet)
    assert port.topologies() == [[[4], [True]]]
    assert sorted([list(t.mesh), list(t.wrap())]
                  for t in jax.s.known_topologies()) == \
        [[[4], [True]], [[8], [False]]]
    p = pod("m", limits(nums=8, mem=1000, cores=100),
            anns={t.MESH_ANNOTATION: "8"})
    why = webhook.validate_pod_mesh(p, TConfig(),
                                    port.s.known_topologies)
    assert why == ("vtpu.dev/mesh: mesh '8': per-pod local mesh 8 fits no "
                   "node topology in the fleet (meshes: 4)")
    port.refabric("pcie", [8])
    assert webhook.validate_pod_mesh(p, TConfig(),
                                     port.s.known_topologies) is None


def test_the_fabric_scenarios_reach_every_topology_token():
    seen, placed = set(), 0
    for cfg, script in TOPO_SCENARIOS.values():
        for op, *_, rec in run(script, port=True, cfg=cfg, fleet=TOPO_FLEET):
            if op == F:
                placed += rec["node"] is not None
                seen |= {why.split(":")[0] for why in rec["failed"].values()}
    assert seen >= {"no-ici-slice", "no-mesh-slice", "bad-mesh",
                    "topology-unverifiable"}, seen
    assert placed >= 15


def test_scenarios_reach_every_rejection_token():
    """The scripts above reach each per-card reason and every node gate."""
    seen = set()
    for cfg, script in SCENARIOS.values():
        for op, *_, rec in run(script, port=True, cfg=cfg):
            if op != F:
                continue
            for reason in rec["failed"].values():
                token, _, detail = reason.partition(":")
                seen.add(token)  # and each token the tally names
                seen |= {part.split()[-1] for part in detail.split(",")
                         if "/" in part}
    assert seen >= {"unhealthy", "type-mismatch", "slots-exhausted",
                    "cores-exhausted", "exclusive-chip-busy",
                    "insufficient-cores", "insufficient-hbm",
                    "too-few-chips", "lease-suspect", "lease-dead",
                    "no GPU inventory registered"}, seen


@pytest.mark.parametrize("anns", [
    {t.GANG_GROUP_ANNOTATION: "job-1"},
    {t.GANG_GROUP_ANNOTATION: "job-1", t.MESH_ANNOTATION: "2x4"},
    {t.MESH_MIN_ANNOTATION: "2x2", t.MESH_MAX_ANNOTATION: "2x4",
     t.MESH_ANNOTATION: "2x4"},
    {t.MESH_MAX_ANNOTATION: "2x4"},
], ids=["pod_group", "mesh+pod_group", "mesh_range", "mesh_max"])
def test_a_mesh_or_gang_pod_is_refused_never_placed(anns):
    """A lone member of a pod group (with or without a mesh) is refused as
    the JAX scheduler refuses it: its group waits for its second member
    and nothing is granted (``tests/test_torch_gang.py`` places whole
    groups).  A pod with an elastic mesh range bound but no group (the
    webhook refuses it; Filter sees it only where the webhook was not
    in the path) gets the JAX scheduler's answer: the range annotations
    are read by the resize controller alone, so Filter decides as for
    the pod without them.  Until the port's resize controller came,
    Filter refused such a pod by name; a plain mesh pod is placed
    (test_the_port_places_on_a_fabric_as_the_jax_scheduler)."""
    got = {}
    for port in (True, False):
        side = Side(port)
        p = pod("m", limits(nums=8, mem=1000),
                anns={**anns, t.GANG_TOTAL_ANNOTATION: "2"})
        side.create(p)
        got[port] = (json.loads(json.dumps(side.filter("m"))),
                     sorted((g.uid, g.node) for g in side.s.pods.list_pods()))
    rec, granted = got[True]
    assert rec == as_port(got[False][0])
    assert granted == got[False][1]
    if t.GANG_GROUP_ANNOTATION in anns:
        assert rec["node"] is None and rec["failed"] == {}
        assert t.ASSIGNED_NODE_ANNOTATION not in rec["annotations"]
        assert granted == []
        assert rec["error"] == "gang job-1 waiting (1/2)"
        return
    assert "A.5" not in rec["error"], rec["error"]


@pytest.mark.parametrize("spec", [
    limits(), limits(mem=3000), limits(pct=30, cores=40),
    limits(nums=2, mem="2Gi"), limits(mem="1.5k"), limits(prio=3),
    {"nvidia.com/gpu": "0", "nvidia.com/gpumem": "10"},
    {"cpu": "2"},
], ids=["count", "mem", "pct_cores", "suffix_gi", "suffix_k", "prio",
        "zero", "cpu"])
@pytest.mark.parametrize("cfg", [{}, {"default_mem": 7000,
                                      "default_cores": 15}],
                         ids=["defaults", "configured"])
def test_requests_and_priority_match_the_jax_decode(spec, cfg):
    p = pod("p", spec, {**limits(nums=1, prio=2)})
    jcfg = JConfig(resources=JNames(**PORT_NAMES), **cfg)
    tcfg = TConfig(**cfg)
    want = [dict(vars(r), type="NVIDIA")
            for r in jresources.container_requests(p, jcfg)]
    got = [vars(r) for r in resources.container_requests(p, tcfg)]
    assert got == want
    assert resources.pod_priority(p, tcfg) == jresources.pod_priority(p,
                                                                      jcfg)
    assert resources.pod_requests_any(p, tcfg) == \
        jresources.pod_requests_any(p, jcfg)


@pytest.mark.parametrize("q", ["12x", "1.2.3Mi", "", "Gi"])
def test_an_unreadable_quantity_raises_as_in_jax(q):
    with pytest.raises(jresources.QuantityError):
        jresources._quantity_to_int(q)
    with pytest.raises(resources.QuantityError):
        resources.quantity_to_int(q)


USAGE = [("c0", "NVIDIA-h100", True, 10, 2, H100_MIB, 30000, 100, 40),
         ("c1", "NVIDIA-h100", True, 10, 0, H100_MIB, 0, 100, 0),
         ("c2", "NVIDIA-a100", True, 10, 9, A100_MIB, 1000, 100, 90),
         ("c3", "NVIDIA-a100", False, 10, 0, A100_MIB, 0, 100, 0)]


def usages():
    j = {r[0]: jscore.DeviceUsage(r[0], r[1], r[2], (), *r[3:])
         for r in USAGE}
    t_ = {r[0]: tscore.DeviceUsage(r[0], r[1], r[2], (), *r[3:])
          for r in USAGE}
    return j, t_


@pytest.mark.parametrize("req", [
    dict(nums=1, memreq=50000, coresreq=60), dict(nums=2, coresreq=100),
    dict(nums=1, mem_percentage_req=50, coresreq=11),
    dict(nums=3, memreq=1000), dict(nums=1, memreq=90000),
    dict(nums=4, memreq=1), dict(nums=2, memreq=20000, coresreq=10)],
    ids=["mem_cores", "exclusive", "pct", "three", "too_big", "four",
         "pair"])
@pytest.mark.parametrize("anns", [{}, {"use": "a100"}, {"nouse": "A100"},
                                  {"use": ""}],
                         ids=["any", "use", "nouse", "use_empty"])
def test_fit_and_reject_summary_match_the_jax_score(req, anns):
    keys = {"use": (jscore.TPU_USE_TYPE_ANNOTATION,
                    t.GPU_USE_TYPE_ANNOTATION),
            "nouse": (jscore.TPU_NOUSE_TYPE_ANNOTATION,
                      t.GPU_NOUSE_TYPE_ANNOTATION)}
    janns = {keys[k][0]: v for k, v in anns.items()}
    tanns = {keys[k][1]: v for k, v in anns.items()}
    ju, tu = usages()
    jwhy, twhy = {}, {}
    from k8s_vgpu_scheduler_tpu.util.types import ContainerDeviceRequest
    want = jscore.fit_pod([ContainerDeviceRequest(**req)], ju, None, janns,
                          reasons=jwhy)
    got = tscore.fit_pod([t.ContainerDeviceRequest(**req)], tu, None, tanns,
                         reasons=twhy)
    assert twhy == jwhy
    assert (got is None) == (want is None)
    if want is not None:
        assert [[vars(d) for d in c] for c in got] == \
            [[vars(d) for d in c] for c in want]
    assert [(u.used_slots, u.used_mem, u.used_cores) for u in tu.values()] \
        == [(u.used_slots, u.used_mem, u.used_cores) for u in ju.values()]
    for policy in ("spread", "binpack"):
        assert tscore.node_score(tu, policy) == jscore.node_score(ju, policy)
    assert tscore.type_excluded(tscore.parse_affinity(tanns), tu) == \
        jscore.type_excluded(jscore.parse_affinity(janns), ju)


@pytest.mark.parametrize("ages", [(0.0,), (15.0,), (15.5,), (45.0,),
                                  (45.5, 1.0), (10.0, 10.0, 10.0)],
                         ids=["fresh", "at_ttl", "suspect", "at_dead",
                              "dead_then_beat", "beats"])
def test_lease_reject_reason_matches_the_jax_lease(ages):
    """Each age in ``ages`` is a wait, then a read; a beat comes between
    waits."""
    clock = Clock()
    j = JLeases(JLeaseConfig(ttl_s=15.0, grace_beats=2), clock=clock)
    p = LeaseTracker(LeaseConfig(ttl_s=15.0, grace_beats=2), clock=clock)
    assert p.reject_reason("n") is None and p.state_of("n") is None
    for lease in (j, p):
        lease.beat("n")
    for i, age in enumerate(ages):
        if i:
            for lease in (j, p):
                lease.beat("n")
        clock.now += age
        assert p.reject_reason("n") == j.reject_reason("n")
        assert int(p.state_of("n")) == int(j.state_of("n"))
