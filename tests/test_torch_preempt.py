"""The port's priority preemption (``scheduler/preempt.py`` and its wiring
in ``scheduler/core.py``) against the JAX package's, on the CPU.

Both schedulers run the JAX package's serial path on the same fleet and
the same pod scripts, as tests/test_torch_scheduler.py runs them (its
``Side``: the port's resource names, ``optimistic_commit=False`` on the
JAX side, each node's ``TopologyDesc`` as its agent registers it), with
``enable_preemption=True``.  The scenarios are tests/test_preempt.py's, on
H100 nodes whose fabric is a line of cards and again on the (cards, 1)
mesh of tests/test_preempt.py, plus plans whose requester needs a
contiguous slice under each topology policy: each Filter's node,
reasons, error and eviction plan (node, victims in order), the pods'
annotations after each step (the ``vtpu.dev/preempt-requested`` value
included), the requester -> victims ledger and the victims asked, the
count of requests written, and the cards' usage.  Every comparison is
equality.

tests/test_preempt.py's gang case runs on both packages too, on that
case's one node of two cards (``tests/test_torch_gang.py``'s ``Side``).
Left out, and why: its trajectory and watch cases (the port's
run_preemptible and watch are held in tests/test_torch_checkpoint.py; the
watch's reading of a rescue value is held below).
"""

import json

import pytest

from k8s_vgpu_scheduler_tpu.scheduler.pods import PodInfo as JPodInfo
from k8s_vgpu_scheduler_tpu.scheduler.preempt import \
    plan_preemption as jplan
from k8s_vgpu_scheduler_tpu.scheduler.score import build_usage as jbuild
from k8s_vgpu_scheduler_tpu.shim.preempt import \
    PreemptionWatch as JWatch
from k8s_vgpu_scheduler_tpu.util import types as jtypes
from k8s_vgpu_scheduler_tpu.util.resources import \
    container_requests as jrequests
from k8s_vgpu_scheduler_tpu_torch.scheduler.pods import PodInfo as TPodInfo
from k8s_vgpu_scheduler_tpu_torch.scheduler.preempt import (
    PREEMPT_ANNOTATION, plan_preemption as tplan)
from k8s_vgpu_scheduler_tpu_torch.scheduler.score import build_usage as tbuild
from k8s_vgpu_scheduler_tpu_torch.shim.preempt import \
    PreemptionWatch as TWatch
from k8s_vgpu_scheduler_tpu_torch.util import types as ttypes
from k8s_vgpu_scheduler_tpu_torch.util.resources import \
    container_requests as trequests
from tests.test_torch_scheduler import (
    Side, as_port, decision, fabric, fixture, limits, pod)

PREEMPT = {"enable_preemption": True}
ONE = {"node-a": fixture("node-a", ["h100"])}
TWO = {**ONE, "node-b": fixture("node-b", ["h100"])}
EIGHT = {"node-a": fixture("node-a", ["h100"] * 8)}


class PreemptSide(Side):
    """The parity Side with the ops these scenarios read."""

    def __init__(self, port, fleet, **cfg):
        super().__init__(port, fleet=dict(fleet), **cfg)

    def anns(self, name):
        return decision(self.kube.get_pod("default", name))

    def ledger(self):
        return dict(
            by_requester={r: sorted(v) for r, v in
                          sorted(self.s._preempt_by_requester.items())},
            asked=sorted(self.s._preempt_requested),
            written=self.s.preemptions_requested)

    def join(self, node):
        """A node of one H100 joins the fleet."""
        self.fleet[node] = self.fixtures[node] = fixture(node, ["h100"])
        self.kube.add_node({"metadata": {"name": node, "annotations": {}}})
        self.beat(node)

    def stop(self):
        """The scheduler goes down: its informer hears nothing more."""
        self.kube.unwatch_pods(self.s.on_pod_event)

    def annotate(self, name, key, value):
        """A write by another party (a kubectl, another replica)."""
        self.kube.patch_pod_annotations("default", name, {key: value})

    def pods(self):
        return sorted((p.uid, p.node) for p in self.s.pods.list_pods())


def run(fleet, cfg, script, port):
    side = PreemptSide(port, fleet, **cfg)
    out = []
    for op, *args in script:
        got = getattr(side, op)(*args)
        if got is not None:
            out.append([op, *args[:1], got])
    return json.loads(json.dumps(out))


F = "filter"
G = 60000  # MiB: two of these do not fit on one H100 (81,079 MiB)
SIDECAR = {"nvidia.com/priority": "2"}  # a container that asks no card
SCENARIOS = {
    "high_priority_no_fit_annotates_victim": (ONE, PREEMPT, [
        ("create", pod("lp", limits(mem=G, prio=1))), (F, "lp"),
        ("create", pod("hp", limits(mem=G))), (F, "hp"),
        ("anns", "lp"), ("ledger",), ("usage",)]),
    "victim_deletion_frees_and_pod_places": (ONE, PREEMPT, [
        ("create", pod("lp", limits(mem=G, prio=1))), (F, "lp"),
        ("create", pod("hp", limits(mem=G))), (F, "hp"),
        ("delete", "lp"), (F, "hp"), ("ledger",), ("usage",)]),
    "equal_priority_is_never_preempted": (ONE, PREEMPT, [
        ("create", pod("lp", limits(mem=G))), (F, "lp"),
        ("create", pod("hp", limits(mem=G))), (F, "hp"), ("anns", "lp"),
        ("ledger",)]),
    "low_priority_requester_cannot_preempt_high": (ONE, PREEMPT, [
        ("create", pod("hp", limits(mem=G))), (F, "hp"),
        ("create", pod("lp", limits(mem=G, prio=1))), (F, "lp"),
        ("anns", "hp"), ("ledger",)]),
    "single_cheapest_victim": (ONE, PREEMPT, [
        ("create", pod("lp1", limits(mem=30000, prio=2))), (F, "lp1"),
        ("create", pod("lp2", limits(mem=30000, prio=1))), (F, "lp2"),
        ("create", pod("hp", limits(mem=30000))), (F, "hp"),
        ("anns", "lp1"), ("anns", "lp2"), ("ledger",)]),
    "multi_victim_accumulation": (ONE, PREEMPT, [
        ("create", pod("lp1", limits(mem=30000, prio=1))), (F, "lp1"),
        ("create", pod("lp2", limits(mem=30000, prio=1))), (F, "lp2"),
        ("create", pod("hp", limits(mem=70000))), (F, "hp"),
        ("anns", "lp1"), ("anns", "lp2"), ("ledger",)]),
    "youngest_and_lowest_first_on_eight_cards": (EIGHT, PREEMPT, [
        *[("create", pod(f"v{i}", limits(nums=2, mem=G, prio=1 + i % 3)))
          for i in range(4)],
        *[(F, f"v{i}") for i in range(4)],
        ("create", pod("hp", limits(nums=3, mem=G))), (F, "hp"),
        *[("anns", f"v{i}") for i in range(4)], ("ledger",),
        ("usage",)]),
    "fewest_victims_across_nodes": (TWO, PREEMPT, [
        ("create", pod("a1", limits(mem=G, prio=1))), (F, "a1", ["node-a"]),
        ("create", pod("b1", limits(mem=30000, prio=1))),
        ("create", pod("b2", limits(mem=30000, prio=1))),
        (F, "b1", ["node-b"]), (F, "b2", ["node-b"]),
        ("create", pod("hp", limits(mem=G))), (F, "hp"),
        ("anns", "a1"), ("anns", "b1"), ("anns", "b2"), ("ledger",)]),
    "only_offered_nodes_are_planned": (TWO, PREEMPT, [
        ("create", pod("a1", limits(mem=G, prio=1))), (F, "a1", ["node-a"]),
        ("create", pod("b1", limits(mem=G, prio=1))), (F, "b1", ["node-b"]),
        ("create", pod("hp", limits(mem=G))), (F, "hp", ["node-b"]),
        ("anns", "a1"), ("anns", "b1")]),
    "a_suspect_node_is_not_planned": (TWO, PREEMPT, [
        ("create", pod("a1", limits(mem=G, prio=1))), (F, "a1", ["node-a"]),
        ("create", pod("b1", limits(mem=G, prio=1))), (F, "b1", ["node-b"]),
        ("advance", 16.0), ("beat", "node-b"),
        ("create", pod("hp", limits(mem=G))), (F, "hp"),
        ("anns", "a1"), ("anns", "b1")]),
    "repeat_filter_throttles_patches": (ONE, PREEMPT, [
        ("create", pod("lp", limits(mem=G, prio=1))), (F, "lp"),
        ("create", pod("hp", limits(mem=G))), (F, "hp"), ("ledger",),
        (F, "hp"), ("ledger",), ("anns", "lp")]),
    "failed_request_write_is_asked_again": (ONE, PREEMPT, [
        ("create", pod("lp", limits(mem=G, prio=1))), (F, "lp"),
        ("create", pod("hp", limits(mem=G))), ("fail_next_write",),
        (F, "hp"), ("ledger",), ("anns", "lp"), (F, "hp"), ("ledger",),
        ("anns", "lp")]),
    "sidecar_priority_cannot_make_pod_preemptible": (ONE, PREEMPT, [
        ("create", pod("lp", limits(mem=G), SIDECAR)), (F, "lp"),
        ("create", pod("hp", limits(mem=G))), (F, "hp"), ("anns", "lp"),
        ("ledger",)]),
    "disabled_by_default": (ONE, {}, [
        ("create", pod("lp", limits(mem=G, prio=1))), (F, "lp"),
        ("create", pod("hp", limits(mem=G))), (F, "hp"), ("anns", "lp"),
        ("ledger",)]),
    "placement_elsewhere_rescinds": (ONE, PREEMPT, [
        ("create", pod("lp", limits(mem=G, prio=1))), (F, "lp"),
        ("create", pod("hp", limits(mem=G))), (F, "hp"),
        ("join", "node-b"), (F, "hp", ["node-a", "node-b"]),
        ("anns", "lp"), ("ledger",)]),
    "requester_deletion_rescinds": (ONE, PREEMPT, [
        ("create", pod("lp", limits(mem=G, prio=1))), (F, "lp"),
        ("create", pod("hp", limits(mem=G))), (F, "hp"),
        ("delete", "hp"), ("anns", "lp"), ("ledger",)]),
    "restart_rebuilds_ledger_from_annotations": (ONE, PREEMPT, [
        ("create", pod("lp", limits(mem=G, prio=1))), (F, "lp"),
        ("create", pod("hp", limits(mem=G))), (F, "hp"),
        ("restart",), ("ledger",), ("join", "node-b"),
        (F, "hp", ["node-a", "node-b"]), ("anns", "lp"), ("ledger",)]),
    "resync_rescinds_when_requester_gone": (ONE, PREEMPT, [
        ("create", pod("lp", limits(mem=G, prio=1))), (F, "lp"),
        ("create", pod("hp", limits(mem=G))), (F, "hp"),
        ("stop",), ("delete", "hp"), ("anns", "lp"), ("restart",),
        ("anns", "lp"), ("ledger",), ("pods",)]),
    "resync_rescinds_when_requester_placed": (ONE, PREEMPT, [
        ("create", pod("lp", limits(mem=G, prio=1))), (F, "lp"),
        ("create", pod("hp", limits(mem=G))), (F, "hp"),
        ("stop",), ("annotate", "hp", ttypes.ASSIGNED_NODE_ANNOTATION,
                    "node-b"),
        ("anns", "lp"), ("restart",), ("anns", "lp"), ("ledger",)]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_the_port_preempts_as_the_jax_scheduler(name):
    fleet, cfg, script = SCENARIOS[name]
    want = as_port(run(fleet, cfg, script, port=False))
    got = run(fleet, cfg, script, port=True)
    assert got == want


def column(fleet):
    """The fleet's nodes as tests/test_preempt.py builds them: the cards on
    a (cards, 1) mesh."""
    out = {}
    for name, fx in fleet.items():
        col = fabric(name, [len(fx["chips"]), 1])
        for mine, theirs in zip(col["chips"], fx["chips"]):
            mine["uuid"] = theirs["uuid"]
        out[name] = col
    return out


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_the_port_preempts_on_a_column_mesh_as_the_jax_scheduler(name):
    fleet, cfg, script = SCENARIOS[name]
    want = as_port(run(column(fleet), cfg, script, port=False))
    got = run(column(fleet), cfg, script, port=True)
    assert got == want


def whole(name, nums, prio, anns=None):
    return ("create", pod(name, limits(nums=nums, mem=1000, cores=100,
                                       prio=prio), anns=anns))


LINE4 = {"node-a": fabric("node-a", [4, 1])}
RING8 = {"node-a": fabric("node-a", [8], wrap=[True]),
         "node-b": fabric("node-b", [8], wrap=[True])}
GUAR = {"vtpu.dev/topology-policy": "guaranteed"}
# Four exclusive one-card pods fill the line (cards 0-3 in order), the
# second one not preemptible; a two-card requester then needs victims
# that free two neighbours.
FILL = [whole("v3", 1, 3), whole("keep", 1, 0), whole("v2", 1, 2),
        whole("v1", 1, 1), (F, "v3"), (F, "keep"), (F, "v2"), (F, "v1")]
TOPO_SCENARIOS = {
    "a_slice_needs_neighbouring_victims": (LINE4, PREEMPT, [
        *FILL, whole("hp", 2, 0, GUAR), (F, "hp"),
        *[("anns", v) for v in ("v1", "v2", "v3")], ("ledger",)]),
    "best_effort_takes_any_two_victims": (LINE4, PREEMPT, [
        *FILL, whole("hp", 2, 0), (F, "hp"),
        *[("anns", v) for v in ("v1", "v2", "v3")], ("ledger",)]),
    "the_configured_policy_plans": (
        LINE4, {**PREEMPT, "topology_policy": "guaranteed"}, [
            *FILL, whole("hp", 2, 0), (F, "hp"), ("ledger",)]),
    "no_victims_make_a_slice": (LINE4, PREEMPT, [
        *FILL, whole("hp", 3, 0, GUAR), (F, "hp"), ("ledger",)]),
    "fewest_victims_across_rings": (RING8, PREEMPT, [
        *[whole(f"a{i}", 2, 1 + i % 2) for i in range(4)],
        *[whole(f"b{i}", 1, 1) for i in range(8)],
        *[(F, f"a{i}", ["node-a"]) for i in range(4)],
        *[(F, f"b{i}", ["node-b"]) for i in range(8)],
        whole("hp", 4, 0, GUAR), (F, "hp"), ("ledger",),
        ("delete", "a1"), ("delete", "a3"), (F, "hp"), ("ledger",),
        ("usage",)]),
}


@pytest.mark.parametrize("name", sorted(TOPO_SCENARIOS))
def test_the_port_plans_slices_as_the_jax_scheduler(name):
    fleet, cfg, script = TOPO_SCENARIOS[name]
    want = as_port(run(fleet, cfg, script, port=False))
    got = run(fleet, cfg, script, port=True)
    assert got == want


def test_the_slice_plans_differ_by_policy():
    """Under guaranteed the planner evicts up to a free pair of
    neighbours; under best-effort any two victims do."""
    plans = {}
    for name in ("a_slice_needs_neighbouring_victims",
                 "best_effort_takes_any_two_victims",
                 "no_victims_make_a_slice"):
        fleet, cfg, script = TOPO_SCENARIOS[name]
        [rec] = [r[2] for r in run(fleet, cfg, script, port=True)
                 if r[:2] == [F, "hp"]]
        plans[name] = rec["preempt"]
    assert plans == {
        "a_slice_needs_neighbouring_victims":
            ["node-a", ["uid-v3", "uid-v2", "uid-v1"]],
        "best_effort_takes_any_two_victims":
            ["node-a", ["uid-v3", "uid-v2"]],
        "no_victims_make_a_slice": None}


def test_the_scenarios_write_and_rescind_requests():
    """The scripts reach a request, a rescission, a no-plan and a
    multi-victim plan."""
    seen = set()
    for fleet, cfg, script in SCENARIOS.values():
        for op, *_, rec in run(fleet, cfg, script, port=True):
            if op == F and rec["preempt"]:
                seen.add(f"victims={len(rec['preempt'][1])}")
            if op == F and rec["error"] and not rec["preempt"]:
                seen.add("no-plan")
            if op == "anns" and PREEMPT_ANNOTATION in rec:
                seen.add("rescinded" if rec[PREEMPT_ANNOTATION] == ""
                         else "requested")
    assert seen >= {"victims=1", "victims=2", "no-plan", "requested",
                    "rescinded"}, seen


def victims(mod, uids, uuid):
    cls = JPodInfo if mod == "jax" else TPodInfo
    cd = (jtypes if mod == "jax" else ttypes).ContainerDevice
    return [cls(uid=u, name=u, namespace="default", node="node-a",
                devices=[[cd(uuid, "NVIDIA-h100", 30000, 0)]],
                priority=1, touched_at=123.0) for u in uids]


@pytest.mark.parametrize("order", [["zz", "aa", "mm"], ["mm", "zz", "aa"],
                                   ["aa", "mm", "zz"]])
def test_equal_victims_order_by_uid_as_in_jax(order):
    """Victims of one priority granted at one instant order by uid, so a
    plan does not depend on the registry's order."""
    side = {m: PreemptSide(m == "port", ONE, **PREEMPT)
            for m in ("jax", "port")}
    got = {}
    for mod, s in side.items():
        info = s.s.nodes.get_node("node-a")
        req = (trequests if mod == "port" else jrequests)(
            pod("hp", limits(mem=40000)), s.cfg)
        entries = {"node-a": (info, (tbuild if mod == "port" else jbuild)(
            info, []))}
        args = (req, 0, entries,
                {"node-a": victims(mod, order, info.devices[0].id)}, {})
        plan = tplan(*args) if mod == "port" else \
            jplan(*args, "best-effort")
        got[mod] = [plan.node, [v.uid for v in plan.victims]]
    assert got["port"] == got["jax"] == ["node-a", ["aa", "mm"]]


@pytest.mark.parametrize("value,requested,requester", [
    ('"uid-hp"', True, "uid-hp"), ('"rescue:chip-quarantined"', True,
                                   "rescue:chip-quarantined"),
    ('""', False, None)], ids=["requester", "rescue", "rescinded"])
def test_the_watch_reads_a_rescue_value_and_a_rescission_as_jax(
        tmp_path, value, requested, requester):
    """The in-container watch stops on any non-empty value, a rescuer's
    ``rescue:`` value included, and reads an empty one as rescinded."""
    path = tmp_path / "annotations"
    path.write_text(f'kubernetes.io/config.seen="2026"\n'
                    f'{PREEMPT_ANNOTATION}={value}\n')
    for watch in (JWatch(str(path)), TWatch(str(path))):
        assert watch.requested() is requested
        assert watch.requester() == requester


def test_the_eviction_request_is_written_once_per_victim():
    """The value on the victim is the requester's uid, and the count of
    requests written matches the JAX scheduler's."""
    script = SCENARIOS["multi_victim_accumulation"][2]
    got = run(ONE, PREEMPT, script, port=True)
    anns = {rec[1]: rec[2][PREEMPT_ANNOTATION] for rec in got
            if rec[0] == "anns"}
    assert anns == {"lp1": "uid-hp", "lp2": "uid-hp"}
    [ledger] = [rec[1] for rec in got if rec[0] == "ledger"]
    assert ledger["written"] == 2 and ledger["asked"] == ["uid-lp1",
                                                          "uid-lp2"]


def test_gang_members_are_never_victims():
    """tests/test_preempt.py's gang case on both packages: two members of
    ``job1`` at low priority fill a two-card node; a pod that outranks
    them fits nowhere and gets no plan (gang uids are never victims), and
    no member is asked to leave."""
    from tests.test_torch_gang import gang_pod, run_both

    def script(side):
        members = []
        for i in range(2):
            m = gang_pod(f"g{i}", f"u-g{i}", total=2, nums="1",
                         mem="16000")
            m["spec"]["containers"][0]["resources"]["limits"][
                "nvidia.com/priority"] = "2"
            members.append(m)
            side.kube.create_pod(m)
        rec = {"wait": side.filter(members[0], ["node-a"]),
               "g1": side.filter(members[1], ["node-a"]),
               "g0": side.filter(members[0], ["node-a"])}
        hp = gang_pod("hp", "u-hp", nums="1", mem="16000")
        hp["metadata"]["annotations"] = {}
        side.kube.create_pod(hp)
        res = side.s.filter(hp, ["node-a"])
        rec["hp"] = [res.node, res.preempt is None,
                     res.error.replace("TPU", "GPU")]
        rec["asked"] = [side.kube.get_pod("default", f"g{i}")["metadata"][
            "annotations"].get(PREEMPT_ANNOTATION) for i in range(2)]
        return {**rec, **side.state("g0", "g1")}

    rec, _ = run_both(script, nodes=["node-a"], chips=2,
                      enable_preemption=True)
    assert rec["g1"]["node"] == "node-a" and rec["g0"]["node"] == "node-a"
    assert rec["hp"][:2] == [None, True]
    assert rec["asked"] == [None, None]
