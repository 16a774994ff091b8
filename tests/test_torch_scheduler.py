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
- ``optimistic_commit=False``: the port carries the JAX package's serial
  decision.  The default optimistic path picks among nodes within 1% of
  the best score by Python's salted ``hash()``, which changes from run to
  run;
- the register request without its ``Topology`` message: the port's
  topology slice (ROADMAP A.3c) has not landed, and a JAX node without
  one takes the same plain choice of cards (its ``score.py:366–370``).

Pods and strings are compared under the name table: the JAX side's pods
carry the type-affinity keys under its names (``vtpu.dev/use-tputype``
for ``nvidia.com/use-gputype``), and its "TPU" in its two human messages
("no TPU inventory registered", "no node fits TPU request") reads "GPU"
in the port's.  Every reason token is the same.

The decision annotations are compared whole, ``vtpu.dev/assigned-time``
as "present and an integer".  Keys the JAX scheduler writes at defaults
that none of these pods makes it write, and why none is in the port:
``vtpu.dev/pod-group-rank`` (gang members: the port refuses gangs,
ROADMAP A.5), ``vtpu.dev/preempt-requested`` (preemption is off by
default; ROADMAP A.3b), ``vtpu.dev/queue``/``queue-state`` (capacity
queues are off without a quota config; A.5), the shard owner (the shard
layer is off without a replica name; A.5) and ``vtpu.dev/mesh-assigned``
(elastic meshes are off by default; A.3c).
"""

import copy
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
            self.cfg = TConfig(**cfg)
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
        jreq = jpb.RegisterRequest.FromString(req.SerializeToString())
        jreq.ClearField("topology")
        return jreq

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


def run(script, port: bool, cfg: dict):
    side = Side(port, **cfg)
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


@pytest.mark.parametrize("key,value", [
    (t.MESH_ANNOTATION, "2x4"),
    (t.GANG_GROUP_ANNOTATION, "job-1"),
], ids=["mesh", "pod_group"])
def test_a_mesh_or_gang_pod_is_refused_never_placed(key, value):
    side = Side(True)
    p = pod("m", limits(nums=8, mem=1000),
            anns={key: value, t.GANG_TOTAL_ANNOTATION: "2"})
    side.create(p)
    rec = side.filter("m")
    slice_ = "A.3c" if key == t.MESH_ANNOTATION else "A.5"
    assert rec["node"] is None and rec["failed"] == {}
    assert key in rec["error"] and slice_ in rec["error"], rec["error"]
    assert t.ASSIGNED_NODE_ANNOTATION not in rec["annotations"]
    assert side.s.pods.list_pods() == []


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
    t_ = {r[0]: tscore.DeviceUsage(*r) for r in USAGE}
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
    got = tscore.fit_pod([t.ContainerDeviceRequest(**req)], tu, tanns,
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
