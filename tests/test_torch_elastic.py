"""The port's elastic mesh resizing (``elastic/``: the range grammar and
the ResizeController) and its hooks in the extender, the queues and the
defragmenter, against the JAX package's, on the CPU.

Every case of ``tests/test_elastic.py`` runs here on both packages:

- **The grammar** (``TestRangeGrammar``, ``TestValidateRange``): the same
  arguments go to each package's function; the answers must be equal
  (messages under the name map: "GPU" for "TPU"), then the JAX case's
  assertions run on the port's answer.
- **The webhook** (``TestWebhookRangeValidation``): the same
  AdmissionReview, in the port's resource names, goes to each package's
  ``handle_admission_review`` (the JAX side given the port's names, the
  fleet a (4, 4) fabric of each package); the replies must be equal.
- **The controller** (``TestResizeController``): each package's scheduler
  on a ``SimClock`` with ``enable_elastic``, the same fleet (nodes of
  sixteen 16,384 MiB cards on a (4, 4) fabric), the same gang manifests
  and the same script of creates, Filters, binds, ticks, deletes and
  clock advances.  Every action, the elastic gangs, the shrink set, the
  in-flight resizes, the counters, the pod states, the eviction requests,
  the ``mesh-assigned`` and eviction annotations and the grants are
  recorded on both sides and held equal; then the JAX case's assertions
  run on the port's side.
- **The cross-shape restore** (``TestCrossShapeRestore``): the JAX case's
  numpy model, and its form through the port's ``CheckpointManager``:
  member shards saved at one member count and restored at another resume
  bit for bit.

The JAX side is given the port's resource names, its serial Filter
(``optimistic_commit=False``) and its snapshot in the registry's order
(``tests/test_torch_gang.py``'s ``ordered_snapshot``).  The one departure:
the JAX controller records each resize in its provenance store
(``provenance.explain`` shows ``resize-shrink``); the port has no
provenance store yet (ROADMAP A.5), so that assertion runs on the JAX side
alone, in ``test_shrink_protocol_end_to_end``.

Besides: a reclaim tick that shrinks an elastic borrower instead of
evicting it, a defrag plan whose victims are an elastic gang's shrink,
the simulator's elastic A/B (``tests/test_simulate.py``'s
``test_elastic_ab_resize_beats_kill``), the three elastic metric families
in each state against the JAX collector, the off switch's byte-identical
defrag plan, and a CPU rehearsal of ``chip_smoke.py``'s elastic leg with
stand-in members.
"""

import copy
import dataclasses
import itertools
import json

import numpy as np
import pytest

import k8s_vgpu_scheduler_tpu.elastic as jel
import k8s_vgpu_scheduler_tpu.health.faults as jfaults
import k8s_vgpu_scheduler_tpu.k8s as jk8s
import k8s_vgpu_scheduler_tpu.scheduler as jsched
import k8s_vgpu_scheduler_tpu.scheduler.webhook as jwebhook
import k8s_vgpu_scheduler_tpu.tpulib as jtpulib
import k8s_vgpu_scheduler_tpu.util.nodelock as jnodelock
import k8s_vgpu_scheduler_tpu_torch.elastic as tel
import k8s_vgpu_scheduler_tpu_torch.health.faults as tfaults
import k8s_vgpu_scheduler_tpu_torch.k8s as tk8s
import k8s_vgpu_scheduler_tpu_torch.scheduler as tsched
import k8s_vgpu_scheduler_tpu_torch.scheduler.webhook as twebhook
import k8s_vgpu_scheduler_tpu_torch.tpulib.types as ttpulib
import k8s_vgpu_scheduler_tpu_torch.util.nodelock as tnodelock
from k8s_vgpu_scheduler_tpu.util.config import Config as JConfig
from k8s_vgpu_scheduler_tpu.util.config import ResourceNames as JNames
from k8s_vgpu_scheduler_tpu_torch.util import types as t
from k8s_vgpu_scheduler_tpu_torch.util.config import Config as TConfig
from tests.test_torch_gang import ordered_snapshot
from tests.test_torch_scheduler import PORT_NAMES
from tests.test_torch_scheduler_http import decoded
from tests.test_torch_simulate import serial  # noqa: F401 — a fixture

#: Each package's modules, by ``port``.
PKG = {
    True: dict(el=tel, faults=tfaults, k8s=tk8s, sched=tsched,
               webhook=twebhook, Topo=ttpulib.TopologyDesc,
               nodelock=tnodelock),
    False: dict(el=jel, faults=jfaults, k8s=jk8s, sched=jsched,
                webhook=jwebhook, Topo=jtpulib.TopologyDesc,
                nodelock=jnodelock),
}
LADDER_2x2_4x4 = [(4, 4), (4, 2), (2, 4), (2, 2)]
PREEMPT = "vtpu.dev/preempt-requested"
RECLAIM = "rescue:reclaim:"


def topo(port, mesh=(4, 4)):
    return PKG[port]["Topo"](generation="h100", mesh=mesh)


def as_port(obj):
    return json.loads(json.dumps(obj).replace("TPU", "GPU"))


def both(fn_name, *args, topos=None):
    """``fn_name`` of each package's ``elastic`` with the same arguments
    (``topos``: the last argument, a list of mesh shapes made each
    package's TopologyDesc); equal answers, the port's returned."""
    got = {}
    for port in (True, False):
        extra = () if topos is None else ([topo(port, m) for m in topos],)
        got[port] = getattr(PKG[port]["el"], fn_name)(*args, *extra)
    assert json.loads(json.dumps(got[True])) == as_port(
        json.loads(json.dumps(got[False])))
    return got[True]


# -- range grammar and ladder ---------------------------------------------------

class TestRangeGrammar:
    def test_format_mesh(self):
        assert both("format_mesh", (2, 4)) == "2x4"
        assert both("format_mesh", (8,)) == "8"

    def test_divisor_steps_largest_first(self):
        assert both("mesh_range_shapes", (2, 2), (4, 4)) == LADDER_2x2_4x4

    def test_min_right_padded_to_max_rank(self):
        assert both("mesh_range_shapes", (2,), (2, 2)) == [(2, 2), (2, 1)]

    def test_empty_when_no_divisor_step_exists(self):
        assert both("mesh_range_shapes", (3,), (4,)) == []

    def test_empty_when_min_outranks_max(self):
        assert both("mesh_range_shapes", (2, 2, 2), (4, 4)) == []

    def test_ladder_requires_whole_member_count(self):
        assert both("mesh_ladder", (2, 2), (4, 4), 4,
                    topos=[(4, 4)]) == LADDER_2x2_4x4
        assert both("mesh_ladder", (2, 2), (4, 4), 3, topos=[(4, 4)]) == []

    def test_ladder_empty_fleet_skips_fold_check(self):
        assert both("mesh_ladder", (2, 2), (4, 4), 4, topos=[]) == \
            LADDER_2x2_4x4

    def test_ladder_drops_rungs_no_topology_realizes(self):
        assert both("mesh_ladder", (2, 2), (4, 4), 4, topos=[(2, 1)]) == []

    def test_next_smaller_skips_equal_volume_rungs(self):
        assert both("next_smaller", LADDER_2x2_4x4, (4, 2)) == (2, 2)
        assert both("next_smaller", LADDER_2x2_4x4, (4, 4)) == (4, 2)
        assert both("next_smaller", LADDER_2x2_4x4, (2, 2)) is None

    def test_next_larger_one_rung_at_a_time(self):
        assert both("next_larger", LADDER_2x2_4x4, (2, 2)) == (2, 4)
        assert both("next_larger", LADDER_2x2_4x4, (2, 4)) == (4, 4)
        assert both("next_larger", LADDER_2x2_4x4, (4, 4)) is None

    def test_elastic_range_of(self):
        assert both("elastic_range_of", {}) is None
        assert both("elastic_range_of", {t.MESH_ANNOTATION: "2x2"}) is None
        assert both("elastic_range_of",
                    {t.MESH_MIN_ANNOTATION: "2x2"}) == ("2x2", "")
        assert both("elastic_range_of",
                    {t.MESH_MIN_ANNOTATION: "2x2",
                     t.MESH_MAX_ANNOTATION: "4x4"}) == ("2x2", "4x4")

    def test_requester_label_bounded_cardinality(self):
        assert both("requester_label",
                    tel.RECLAIM_SHRINK_PREFIX + "e1/ns/g") == "reclaim"
        assert both("requester_label", "rescue:defrag:d/ns/g") == "defrag"
        assert both("requester_label",
                    tel.GROW_REQUESTER_PREFIX + "ns/g") == "grow"
        assert both("requester_label",
                    tel.ADMISSION_REQUESTER_PREFIX + "ns/g") == "admission"
        assert both("requester_label", "rescue:lease-expired") == "other"

    def test_the_names_are_the_jax_ones(self):
        """Every exported name of the JAX package's ``elastic`` is the
        port's, with the same value where it is a constant."""
        names = [n for n in dir(jel) if not n.startswith("_")
                 and n not in ("controller", "ranges")]
        for n in names:
            assert hasattr(tel, n), n
            if isinstance(getattr(jel, n), str):
                assert getattr(tel, n) == getattr(jel, n), n


class TestValidateRange:
    def test_valid_range_passes(self):
        assert both("validate_mesh_range", "2x2", "4x4", "4x4", 4, 4,
                    topos=[(4, 4)]) is None

    def test_single_member_generation_is_legitimate(self):
        assert both("validate_mesh_range", "2x2", "4x4", "2x2", 4, 1,
                    topos=[(4, 4)]) is None
        why = both("validate_mesh_range", "2x2", "4x4", "2x2", 4, 0,
                   topos=[(4, 4)])
        assert why is not None and "non-gang" in why

    def test_malformed_current_mesh_not_double_reported(self):
        assert both("validate_mesh_range", "2x2", "4x4", "2x", 4, 4,
                    topos=[(4, 4)]) is None

    def test_a_pod_without_cards_is_named(self):
        """The one message with the name map in it (JAX: "TPU chips")."""
        why = both("validate_mesh_range", "2x2", "4x4", "4x4", 0, 4,
                   topos=[(4, 4)])
        assert why == ("vtpu.dev/mesh-min declared but the pod requests no "
                       "GPU chips")


# -- the webhook -------------------------------------------------------------------

def range_pod(name="m", uid="um", gpu=4, mesh="4x4", mn="2x2", mx="4x4",
              gang="train", gang_total=4):
    anns = {}
    if mesh:
        anns[t.MESH_ANNOTATION] = mesh
    if mn:
        anns[t.MESH_MIN_ANNOTATION] = mn
    if mx:
        anns[t.MESH_MAX_ANNOTATION] = mx
    if gang:
        anns[t.GANG_GROUP_ANNOTATION] = gang
        anns[t.GANG_TOTAL_ANNOTATION] = str(gang_total)
    return {
        "metadata": {"name": name, "namespace": "default", "uid": uid,
                     "annotations": anns},
        "spec": {"containers": [{
            "name": "main",
            "resources": {"limits": {"nvidia.com/gpu": str(gpu),
                                     "nvidia.com/gpumem": "4000"}}}]},
    }


JCFG = JConfig(resources=JNames(**PORT_NAMES), scheduler_name="vgpu-scheduler",
               optimistic_commit=False)


class TestWebhookRangeValidation:
    def _review(self, pod):
        body = {"request": {"uid": "rq", "operation": "CREATE",
                            "namespace": "default", "object": pod}}
        got = {}
        for port in (True, False):
            cfg = TConfig(optimistic_commit=False) if port else JCFG
            got[port] = decoded(PKG[port]["webhook"].handle_admission_review(
                copy.deepcopy(body), cfg, topologies=[topo(port)]))
        assert got[True] == as_port(got[False])
        return got[True]

    def _rejects(self, pod, *needles):
        r = self._review(pod)["response"]
        assert r["allowed"] is False
        assert r["status"]["code"] == 422
        for needle in needles:
            assert needle in r["status"]["message"], r["status"]["message"]

    def test_valid_range_admits(self):
        out = self._review(range_pod())
        assert out["response"]["allowed"] is True

    def test_bare_mesh_without_range_stays_inert(self):
        out = self._review(range_pod(mn=None, mx=None))
        assert out["response"]["allowed"] is True

    def test_min_without_max_422(self):
        self._rejects(range_pod(mx=None), "without", t.MESH_MAX_ANNOTATION)

    def test_max_without_min_422(self):
        self._rejects(range_pod(mn=None), "without", t.MESH_MIN_ANNOTATION)

    def test_malformed_min_422(self):
        self._rejects(range_pod(mn="2x"), t.MESH_MIN_ANNOTATION)

    def test_malformed_max_422(self):
        self._rejects(range_pod(mx="x4"), t.MESH_MAX_ANNOTATION)

    def test_non_gang_pod_422(self):
        self._rejects(range_pod(gang=None, mesh="2x2"), "non-gang",
                      "pod-group")

    def test_single_member_generation_admits(self):
        out = self._review(range_pod(mesh="2x2", gang_total=1))
        assert out["response"]["allowed"] is True

    def test_range_without_current_mesh_422(self):
        self._rejects(range_pod(mesh=None), "current shape")

    def test_min_volume_exceeds_max_422(self):
        self._rejects(range_pod(mn="4x4", mx="2x2", mesh="2x2",
                                gang_total=1), "exceeds")

    def test_min_rank_exceeds_max_422(self):
        self._rejects(range_pod(mn="2x2x2", mx="4x4"), "more axes")

    def test_empty_ladder_422(self):
        self._rejects(range_pod(mn="3x1", mx="4x1", mesh="4x1",
                                gang_total=1), "no valid mesh shape")

    def test_current_mesh_off_ladder_422(self):
        self._rejects(range_pod(mesh="4x1", gang_total=1),
                      "not a valid rung", "valid:")


# -- the ResizeController on each package's scheduler -----------------------------

class Side:
    """One package's scheduler as ``tests/test_elastic.py``'s ``build``
    makes it: ``nodes`` nodes of sixteen cards on a (4, 4) fabric, the
    informer wired, a SimClock, elastic on unless asked otherwise."""

    def __init__(self, port: bool, nodes=1, enable_elastic=True, **cfg_kw):
        k = PKG[port]
        self.port = port
        self.nodelock = k["nodelock"]
        self.clock = k["faults"].SimClock()
        cfg_kw.setdefault("resize_hysteresis_s", 60.0)
        cfg_kw.setdefault("resize_checkpoint_grace_s", 50.0)
        cfg_kw.setdefault("elastic_downgrade_after_s", 5.0)
        if port:
            cfg = TConfig(enable_elastic=enable_elastic,
                          optimistic_commit=False, **cfg_kw)
        else:
            cfg = JConfig(resources=JNames(**PORT_NAMES),
                          scheduler_name="vgpu-scheduler",
                          optimistic_commit=False,
                          enable_elastic=enable_elastic, **cfg_kw)
        self.kube = k["k8s"].FakeKube()
        self.s = k["sched"].Scheduler(self.kube, cfg, clock=self.clock)
        if not port:
            ordered_snapshot(self.s)
        self.names = []
        for i in range(nodes):
            n = f"n{i}"
            self.names.append(n)
            self.kube.add_node({"metadata": {"name": n, "annotations": {}}})
            devs = [k["sched"].DeviceInfo(
                id=f"{n}-gpu-{x}-{y}", count=1, devmem=16384,
                type="NVIDIA-h100", health=True, coords=(x, y))
                for x, y in itertools.product(range(4), range(4))]
            self.s.nodes.add_node(n, k["sched"].NodeInfo(
                name=n, devices=devs, topology=topo(port)))
        self.kube.watch_pods(self.s.on_pod_event)

    @property
    def el(self):
        return self.s.elastic

    def place_gang(self, pods, rec=None, create=True):
        """Create the members (unless ``create`` is False), Filter each
        once (the barrier registers them), then again, binding each."""
        if create:
            for p in pods:
                self.kube.create_pod(copy.deepcopy(p))
        live = [self.kube.get_pod(p["metadata"]["namespace"],
                                  p["metadata"]["name"]) for p in pods]
        for p in live:
            self.s.filter(copy.deepcopy(p), self.names)
        for p in live:
            r = self.s.filter(copy.deepcopy(p), self.names)
            assert r.node, f"{p['metadata']['name']}: {r.error}"
            if rec is not None:
                rec.append([p["metadata"]["name"], r.node])
            self.s.bind(p["metadata"]["namespace"], p["metadata"]["name"],
                        p["metadata"]["uid"], r.node)
            self.nodelock.release_node(self.kube, r.node)

    def checkpoint_and_exit(self, pods):
        for p in pods:
            self.kube.delete_pod(p["metadata"]["namespace"],
                                 p["metadata"]["name"])

    def anns(self, name, ns="default"):
        return self.kube.get_pod(ns, name)["metadata"]["annotations"]

    def state(self) -> dict:
        e = self.el
        return {
            "gangs": [dataclasses.asdict(g) | {"at_max": g.at_max}
                      for g in e.elastic_gangs()],
            "shrinkable": e.shrinkable_uids(),
            "in_flight": sorted(e.in_flight()),
            "resizes": {f"{d}/{lab}": n
                        for (d, lab), n in sorted(e.resizes_total.items())},
            "counters": [e.thrash_total, e.completed_total,
                         e.aborted_total],
            "pod_states": e.pod_states(),
            "preempt_requested": sorted(self.s._preempt_requested),
            "annotations": {
                p["metadata"]["name"]: [
                    p["metadata"]["annotations"].get(
                        t.MESH_ASSIGNED_ANNOTATION),
                    p["metadata"]["annotations"].get(PREEMPT)]
                for p in self.kube.list_pods()},
            "grants": {p.uid: [p.node, sorted(d.uuid for c in p.devices
                                              for d in c)]
                       for p in self.s.pods.list_pods()},
        }

    def close(self):
        self.s.close()


def run_both(script, **build_kw):
    """``script(side, rec)`` on each package; the records held equal, the
    port's side returned with its record."""
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
    assert out[True][0] == as_port(out[False][0])
    return out[True]


def gang_manifests(mesh="4x4", gen=0, group="train", nums=4,
                   mn="2x2", mx="4x4", ns="default", cores=None):
    vol = 1
    for d in mesh.split("x"):
        vol *= int(d)
    total = vol // nums
    pods = []
    for i in range(total):
        name = f"{group}-g{gen}-{i}"
        pods.append({
            "metadata": {
                "name": name, "namespace": ns, "uid": f"uid-{ns}-{name}",
                "annotations": {
                    t.MESH_ANNOTATION: mesh,
                    t.MESH_MIN_ANNOTATION: mn,
                    t.MESH_MAX_ANNOTATION: mx,
                    t.GANG_GROUP_ANNOTATION: group,
                    t.GANG_TOTAL_ANNOTATION: str(total),
                }},
            "spec": {"containers": [{
                "name": "main",
                "resources": {"limits": {"nvidia.com/gpu": str(nums),
                                         "nvidia.com/gpumem": "4000"}}}]},
        })
        if cores is not None:
            pods[-1]["spec"]["containers"][0]["resources"]["limits"][
                "nvidia.com/gpucores"] = str(cores)
    return pods


def single(name, gpu=4, ns="default", anns=None, prio=None, cores=None):
    limits = {"nvidia.com/gpu": str(gpu), "nvidia.com/gpumem": "4000"}
    if cores is not None:
        limits["nvidia.com/gpucores"] = str(cores)
    if prio is not None:
        limits["nvidia.com/priority"] = str(prio)
    return {"metadata": {"name": name, "namespace": ns,
                         "uid": f"uid-{name}",
                         "annotations": dict(anns or {})},
            "spec": {"containers": [{"name": "main", "resources": {
                "limits": limits}}]}}


class TestResizeController:
    def test_discovery_and_shrinkable_set(self):
        def script(side, rec):
            side.place_gang(gang_manifests(), rec)

        rec, _ = run_both(script)
        st = rec[-1]
        assert len(st["gangs"]) == 1
        g = st["gangs"][0]
        assert g["key"] == "default/train"
        assert g["current"] == [4, 4] and g["at_max"] and g["admitted"]
        assert [tuple(r) for r in g["ladder"]] == LADDER_2x2_4x4
        assert g["nums"] == 4
        assert set(st["shrinkable"]) == set(g["member_uids"])
        assert set(st["shrinkable"].values()) == {"default/train"}

    def test_off_switch_is_inert(self):
        def script(side, rec):
            side.place_gang(gang_manifests())
            rec.append(side.el.shrinkable_uids())
            rec.append(side.el.begin_shrink(
                "default/train", RECLAIM + "e/default/train"))
            rec.append(side.el.tick())
            side.el.observe_rejection("default/train")
            rec.append(sorted(side.el.in_flight()))
            rec.append([side.el.resizes_total == {}, side.el.thrash_total])

        rec, _ = run_both(script, enable_elastic=False)
        assert rec[:5] == [{}, None, [], [], [True, 0]]

    def test_shrink_protocol_end_to_end(self):
        gen0 = gang_manifests()

        def script(side, rec):
            side.place_gang(gen0)
            rec.append(side.el.begin_shrink(
                "default/train", RECLAIM + "entry1/default/train",
                reason="queue a over quota"))
            rec.append(side.state())
            if not side.port:
                # The JAX controller's provenance record of each member's
                # resize; the port has no provenance store yet (the
                # stated departure).
                for p in gen0:
                    stages = [r["stage"] for r in side.s.provenance.explain(
                        p["metadata"]["uid"])["records"]]
                    assert "resize-shrink" in stages
            else:
                assert not hasattr(side.s, "provenance")
            side.checkpoint_and_exit(gen0)
            rec.append(side.el.tick())
            rec.append(side.state())
            side.place_gang(gang_manifests(mesh="4x2", gen=1))

        rec, _ = run_both(script)
        act = rec[0]
        assert act["kind"] == "resize-shrink"
        assert act["from"] == "4x4" and act["to"] == "4x2"
        assert act["freed_chips"] == 8 and act["members"] == 4
        mid = rec[1]
        assert mid["resizes"] == {"shrink/reclaim": 1}
        for p in gen0:
            name, uid = p["metadata"]["name"], p["metadata"]["uid"]
            assigned, flag = mid["annotations"][name]
            assert assigned == "4x2" and flag
            assert uid in mid["preempt_requested"]
        assert mid["pod_states"]["resizing"] == 4
        assert [a["kind"] for a in rec[2]] == ["resize-complete"]
        assert rec[2][0]["to"] == "4x2"
        after = rec[3]
        assert after["counters"][1] == 1
        assert after["in_flight"] == [] and after["preempt_requested"] == []
        final = rec[-1]
        g = final["gangs"][0]
        assert g["current"] == [4, 2] and g["admitted"] and not g["at_max"]
        assert final["pod_states"]["shrunk"] == 2

    def test_no_double_evict_across_requesters(self):
        gen0 = gang_manifests()
        uids = sorted(p["metadata"]["uid"] for p in gen0)

        def script(side, rec):
            side.place_gang(gen0)
            rec.append(side.el.begin_shrink(
                "default/train", RECLAIM + "e1/default/train") is not None)
            rec.append(side.el.shrinkable_uids())
            rec.append(side.el.begin_shrink(
                "default/train", "rescue:defrag:d1/default/train"))
            rec.append(side.el.begin_grow("default/train"))
            rec.append(side.el.tick())
            rec.append(side.state())
            side.checkpoint_and_exit(gen0)
            rec.append(side.el.tick())
            gen1 = gang_manifests(mesh="4x2", gen=1)
            side.place_gang(gen1)
            side.clock.advance(1000.0)
            rec.append(side.el.shrinkable_uids())
            side.s.rescuer.enqueue(gen1[0]["metadata"]["uid"],
                                   "lease-expired")
            rec.append(side.el.shrinkable_uids())
            rec.append(side.el.begin_shrink(
                "default/train", RECLAIM + "e2/default/train"))
            rec.append(side.el.tick())

        rec, _ = run_both(script)
        assert rec[0] is True
        assert rec[1] == {} and rec[2] is None and rec[3] is None
        assert all(a["kind"] != "resize-grow" for a in rec[4])
        assert rec[5]["preempt_requested"] == uids
        assert rec[5]["resizes"] == {"shrink/reclaim": 1}
        assert rec[7] != {} and rec[8] == {} and rec[9] is None
        assert all(a["kind"] != "resize-grow" for a in rec[10])

    def test_grow_blocked_by_capacity_is_not_thrash(self):
        def script(side, rec):
            side.place_gang(gang_manifests())
            side.el.begin_shrink("default/train",
                                 RECLAIM + "e1/default/train")
            side.checkpoint_and_exit(gang_manifests())
            rec.append(side.el.tick())
            side.place_gang(gang_manifests(mesh="4x2", gen=1))
            for _ in range(5):
                side.clock.advance(10.0)
                rec.append(side.el.tick())

        rec, _ = run_both(script, nodes=1)
        for acts in rec[1:6]:
            assert all(a["kind"] != "resize-grow" for a in acts)
        assert rec[-1]["counters"][0] == 0

    def test_grow_hysteresis_counts_thrash_once_then_grows(self):
        def script(side, rec):
            side.place_gang(gang_manifests())
            side.el.begin_shrink("default/train",
                                 RECLAIM + "e1/default/train")
            side.checkpoint_and_exit(gang_manifests())
            side.el.tick()
            gen1 = gang_manifests(mesh="4x2", gen=1)
            side.place_gang(gen1)
            side.clock.advance(10.0)
            rec.append(side.el.tick())
            rec.append(side.el.thrash_total)
            side.clock.advance(10.0)
            rec.append(side.el.tick())
            rec.append(side.el.thrash_total)
            side.clock.advance(60.0)
            rec.append(side.el.tick())
            rec.append(side.state())
            side.checkpoint_and_exit(gen1)
            rec.append(side.el.tick())
            side.place_gang(gang_manifests(mesh="4x4", gen=2))

        rec, _ = run_both(script, nodes=2, resize_hysteresis_s=60.0)
        assert rec[0] == [] and rec[1] == 1
        assert rec[2] == [] and rec[3] == 1
        assert [a["kind"] for a in rec[4]] == ["resize-grow"]
        assert rec[4][0]["from"] == "4x2" and rec[4][0]["to"] == "4x4"
        assert rec[5]["resizes"]["grow/grow"] == 1
        assert [a["kind"] for a in rec[6]] == ["resize-complete"]
        assert rec[-1]["gangs"][0]["current"] == [4, 4]
        assert rec[-1]["pod_states"]["at-max"] == 4

    def test_checkpoint_grace_abort_rolls_back(self):
        gen0 = gang_manifests()

        def script(side, rec):
            side.place_gang(gen0)
            side.el.begin_shrink("default/train",
                                 RECLAIM + "e1/default/train")
            side.clock.advance(51.0)
            rec.append(side.el.tick())
            rec.append(side.state())
            rec.append(side.el.begin_shrink(
                "default/train", RECLAIM + "e2/default/train"))
            side.clock.advance(51.0)
            rec.append(side.el.begin_shrink(
                "default/train", RECLAIM + "e3/default/train") is not None)

        rec, _ = run_both(script, resize_checkpoint_grace_s=50.0)
        assert [a["kind"] for a in rec[0]] == ["resize-abort"]
        assert rec[1]["counters"][2] == 1
        assert rec[1]["preempt_requested"] == []
        for p in gen0:
            assert not rec[1]["annotations"][p["metadata"]["name"]][0]
        assert rec[2] is None
        assert rec[3] is True

    def test_admission_downgrade_steps_pending_gang_down(self):
        gen0 = gang_manifests()

        def script(side, rec):
            for i in range(2):
                filler = single(f"f{i}")
                side.kube.create_pod(filler)
                r = side.s.filter(copy.deepcopy(filler), side.names)
                assert r.node
                side.s.bind("default", f"f{i}", f"uid-f{i}", r.node)
                side.nodelock.release_node(side.kube, r.node)
            for p in gen0:
                side.kube.create_pod(copy.deepcopy(p))
            for p in gen0:
                r = side.s.filter(copy.deepcopy(p), side.names)
                assert not r.node
                rec.append(r.error)
            side.clock.advance(6.0)
            for p in gen0:
                assert not side.s.filter(copy.deepcopy(p), side.names).node
            rec.append(side.state())
            rec.append(side.el.tick())
            rec.append(side.state())
            rec.append(side.el.tick())
            side.checkpoint_and_exit(gen0)
            side.place_gang(gang_manifests(mesh="4x2", gen=1))

        rec, _ = run_both(script, nodes=1, elastic_downgrade_after_s=5.0)
        assert rec[4]["pod_states"]["pending"] == 4
        acts = rec[5]
        assert [a["kind"] for a in acts] == ["resize-downgrade"]
        assert acts[0]["from"] == "4x4" and acts[0]["to"] == "4x2"
        assert acts[0]["requester"].startswith(tel.ADMISSION_REQUESTER_PREFIX)
        assert rec[6]["resizes"]["shrink/admission"] == 1
        for p in gen0:
            assert rec[6]["annotations"][p["metadata"]["name"]][0] == "4x2"
        assert rec[7] == []
        assert rec[-1]["gangs"][0]["admitted"]


# -- cross-shape checkpoint restore -------------------------------------------------

class TestCrossShapeRestore:
    def test_resharded_restore_is_bit_identical(self, tmp_path):
        """The JAX case's model (member-sharded state gathered and
        re-sharded), and the same trajectory with every shard saved by
        the port's ``CheckpointManager`` at one member count and restored
        at the next: both bit for bit the steady run."""
        import torch

        from k8s_vgpu_scheduler_tpu_torch.models.checkpoint import \
            CheckpointManager

        rng = np.random.default_rng(7)
        state = rng.standard_normal((16, 8))

        def run(member_counts):
            x = state.copy()
            for step, members in enumerate(member_counts):
                shards = np.split(x, members, axis=0)
                x = np.concatenate(shards, axis=0)
                x = x * 1.000001 + step
            return x

        class Shard(torch.nn.Module):
            def __init__(self, rows):
                super().__init__()
                self.register_buffer("x", torch.zeros(rows, 8,
                                                      dtype=torch.float64))

        def run_port(member_counts, root):
            x = torch.from_numpy(state.copy())
            prev = member_counts[0]
            for step, members in enumerate(member_counts):
                # Each member of the last generation saves its shard ...
                for i, part in enumerate(torch.chunk(x, prev)):
                    m = Shard(part.shape[0])
                    m.x.copy_(part)
                    CheckpointManager(str(root / f"{step}-{i}")).save(
                        step, m)
                # ... and the next generation reads them all back.
                parts = []
                for i in range(prev):
                    m = Shard(16 // prev)
                    CheckpointManager(str(root / f"{step}-{i}")).restore(m)
                    parts.append(m.x)
                x = torch.cat(parts) * 1.000001 + step
                prev = members
            return x.numpy()

        steady = run([4, 4, 4, 4])
        resized = run([4, 2, 1, 4])
        np.testing.assert_array_equal(steady, resized)
        np.testing.assert_array_equal(
            run_port([4, 2, 1, 4], tmp_path / "resized"), steady)


# -- the movers' hooks: reclaim, defrag -------------------------------------------

BATCH = {"name": "batch", "namespaces": ["team-batch"], "cohort": "pool",
         "quota": {"chips": 8}, "borrow_limit_chips": 8}
LATENCY = {"name": "latency", "namespaces": ["team-lat"], "cohort": "pool",
           "quota": {"chips": 8}, "borrow_limit_chips": 0}


def held(pod, queue):
    pod = copy.deepcopy(pod)
    pod["metadata"]["annotations"].update({
        "vtpu.dev/queue": queue, "vtpu.dev/queue-state": "held"})
    return pod


@pytest.mark.parametrize("elastic", [True, False], ids=["on", "off"])
def test_reclaim_shrinks_an_elastic_borrower_instead_of_evicting(elastic):
    """A 4x4 elastic gang of queue ``batch`` (nominal 8) borrows 8 of the
    node's 16 cards; a 4-card pod of queue ``latency`` (nominal 8, in
    quota) is held behind it.  The admission tick's reclaim steps the
    gang down a rung (its shrink pass, before any eviction): one
    ``resize-shrink`` action naming the donor queue and its borrowed
    cards, the members asked under a ``rescue:reclaim:`` key, no pod
    evicted.  With elastic off the gang members are protected and the
    tick reclaims nothing.  Both packages alike."""
    gen0 = [held(p, "batch") for p in
            gang_manifests(ns="team-batch")]
    rt = held(single("rt", ns="team-lat"), "latency")

    def script(side, rec):
        for p in gen0:
            side.kube.create_pod(copy.deepcopy(p))
        rec.append(side.s.admission.tick())
        side.place_gang(gen0, create=False)
        side.kube.create_pod(copy.deepcopy(rt))
        rec.append(side.s.admission.tick())
        rec.append(side.state())
        rec.append(side.kube.get_pod("team-lat", "rt")["metadata"][
            "annotations"].get("vtpu.dev/queue-state"))

    rec, _ = run_both(script, quota_queues=(BATCH, LATENCY),
                      queue_reclaim_grace_s=0.0, enable_elastic=elastic)
    acts = rec[1]
    shrinks = [a for a in acts if a["kind"] == "resize-shrink"]
    assert not [a for a in acts if a["kind"] == "reclaim"]
    if not elastic:
        assert shrinks == [] and rec[2]["preempt_requested"] == []
        return
    assert len(shrinks) == 1
    a = shrinks[0]
    assert (a["from"], a["to"], a["freed_chips"]) == ("4x4", "4x2", 8)
    assert a["requester"] == (RECLAIM + "uid-rt/team-batch/train")
    assert (a["queue"], a["donor_queue"], a["donor_borrowed"]) == \
        ("latency", "batch", 8)
    assert rec[2]["resizes"] == {"shrink/reclaim": 1}
    assert rec[2]["preempt_requested"] == sorted(
        p["metadata"]["uid"] for p in gen0)


def test_a_defrag_plan_shrinks_an_elastic_gang():
    """The elastic gang fills the node; a guaranteed 4-card pod fits
    nowhere.  The defragmenter's plan takes gang members as victims (the
    shrink set is the one exception to gang protection) and asks the
    resize controller for the gang's shrink under its own key: the plan
    and the ``resize-shrink`` action equal on both packages."""
    from tests.test_torch_defrag import Side as DefragSide

    big = single("big", cores=100,
                 anns={"vtpu.dev/topology-policy": "guaranteed"})

    def script(side, rec):
        for p in gang_manifests(cores=100):
            side.create(p)
        for _ in range(2):
            for p in gang_manifests(cores=100):
                r = side.filter(p)
                if r["node"]:
                    side.s.bind("default", p["metadata"]["name"],
                                p["metadata"]["uid"], r["node"])
                    PKG[side.port]["nodelock"].release_node(
                        side.kube, r["node"])
        side.create(big)
        rec.append(side.filter(big))
        rec.append(side.tick())
        rec.append(sorted(side.s.elastic.in_flight()))
        rec.append(side.flagged())

    out = {}
    for port in (True, False):
        side = DefragSide(port, mesh=(4, 4), enable_elastic=True)
        try:
            rec = []
            script(side, rec)
            out[port] = json.loads(json.dumps(rec))
        finally:
            side.close()
    assert out[True] == as_port(out[False])
    rec = out[True]
    assert rec[0]["node"] is None
    plan = [a for a in rec[1] if a["kind"] == "defrag-plan"]
    assert len(plan) == 1 and plan[0]["shrinks"] == ["default/train"]
    shrink = [a for a in rec[1] if a["kind"] == "resize-shrink"]
    assert len(shrink) == 1 and shrink[0]["to"] == "4x2"
    assert shrink[0]["requester"] == \
        "rescue:defrag:uid-big/default/train"
    assert rec[2] == ["default/train"]
    assert set(rec[3].values()) == {"rescue:defrag:uid-big/default/train"}


def test_the_off_switch_keeps_the_defrag_plan_byte_identical():
    """With ``--enable-elastic`` off the gang is protected: the same fleet
    gives the plan of a build without the controller (none: every card is
    a gang member's), on both packages."""
    from tests.test_torch_defrag import Side as DefragSide

    big = single("big", cores=100,
                 anns={"vtpu.dev/topology-policy": "guaranteed"})
    out = {}
    for port in (True, False):
        side = DefragSide(port, mesh=(4, 4))
        try:
            for p in gang_manifests(cores=100):
                side.create(p)
            for _ in range(2):
                for p in gang_manifests(cores=100):
                    side.filter(p)
            side.create(big)
            out[port] = [side.filter(big), side.tick(),
                         side.s.elastic.shrinkable_uids(), side.flagged()]
        finally:
            side.close()
    assert json.loads(json.dumps(out[True])) == as_port(
        json.loads(json.dumps(out[False])))
    assert out[True][1:] == [[], {}, {}]


# -- the simulator's elastic A/B ------------------------------------------------

def test_elastic_ab_resize_beats_kill(serial):
    """``tests/test_simulate.py``'s case through both simulators, on the
    JAX example (``examples/workload-elastic.json``; the port reads it in
    its own names, ``examples/vgpu-workload-elastic.json``) at 2 x 16 on a
    (4, 4) fabric: the results equal under the name map, and the JAX
    case's assertions on the port's verdict."""
    from tests.test_torch_simulate import EXAMPLES, both as sim_both

    workload = json.loads((EXAMPLES / "vgpu-workload-elastic.json")
                          .read_text())
    port, ref = sim_both(workload, nodes=2, chips=16, hbm=16384,
                         mesh=(4, 4))
    assert port == ref
    r = port["elastic"]
    v = r["verdict"]
    assert v["goodput_better"] and v["jct_better"]
    assert v["no_kills_with_elastic"] and v["kills_without_elastic"]
    assert v["shrank_and_regrew"] and v["no_thrash"]
    assert v["trajectory_bit_identical"], r["elastic_on"]["gang"]
    assert v["elastic_off_inert"] and v["no_overbooking"]
    assert v["ok"]


# -- the metric families ------------------------------------------------------------

def test_the_elastic_families_read_as_the_jax_collector(monkeypatch):
    """The shrink protocol's trajectory read by both collectors at each
    elastic state: pending (a 4x4 gang that cannot place beside two
    fillers), at-max, resizing (a reclaim shrink in flight), shrunk (the
    4x2 generation), and a thrash-suppressed grow once the fillers left.  Every family equal
    (the A.5 ones zero), the three elastic ones by value."""
    from k8s_vgpu_scheduler_tpu.scheduler import metrics as jcluster
    from k8s_vgpu_scheduler_tpu_torch.scheduler import metrics as tcluster
    from k8s_vgpu_scheduler_tpu_torch.util import exposition as expo
    from tests.test_torch_metrics import (families, fresh_tracers,
                                          gpu_reasons, jax_text,
                                          same_families)

    ELASTIC = ("vtpu_resizes", "vtpu_elastic_pods", "vtpu_resize_thrash")
    steps = ("pending", "at-max", "resizing", "shrunk", "thrash")
    texts = {}
    for port in (True, False):
        fresh_tracers(monkeypatch)
        side = Side(port, nodes=2)
        rec = []

        def read():
            rec.append(expo.render(tcluster.ClusterCollector(
                side.s).collect()) if port
                else jax_text(jcluster.ClusterCollector(side.s)))

        try:
            fillers = [single(f"f{i}", gpu=4) for i in range(8)]
            for f in fillers:
                side.kube.create_pod(f)
                r = side.s.filter(copy.deepcopy(f), side.names)
                side.s.bind("default", f["metadata"]["name"],
                            f["metadata"]["uid"], r.node)
                side.nodelock.release_node(side.kube, r.node)
            gen0 = gang_manifests()
            for p in gen0:
                side.kube.create_pod(copy.deepcopy(p))
            for p in gen0:
                side.s.filter(copy.deepcopy(p), side.names)
            read()                                       # pending
            for f in fillers[:4]:
                side.kube.delete_pod("default", f["metadata"]["name"])
            side.place_gang(gen0, create=False)
            read()                                       # at-max
            side.el.begin_shrink("default/train",
                                 RECLAIM + "e1/default/train")
            read()                                       # resizing
            side.checkpoint_and_exit(gen0)
            side.el.tick()
            side.place_gang(gang_manifests(mesh="4x2", gen=1))
            read()                                       # shrunk
            for f in fillers[4:]:
                side.kube.delete_pod("default", f["metadata"]["name"])
            side.clock.advance(10.0)
            side.el.tick()
            read()                                       # thrash
        finally:
            side.close()
        texts[port] = rec
    for i, step in enumerate(steps):
        got = same_families(texts[True][i], texts[False][i],
                            wall={"vtpu_scheduling_phase_latency_seconds"},
                            a5=set(tcluster.A5_FAMILIES),
                            rename={"vtpu_filter_rejections": gpu_reasons})
        assert not set(ELASTIC) & set(tcluster.A5_FAMILIES)
        fams = families(texts[True][i])
        states = {s.labels["state"]: s.value
                  for s in fams["vtpu_elastic_pods"].samples}
        resizes = {(s.labels["direction"], s.labels["requester"]): s.value
                   for s in fams["vtpu_resizes"].samples}
        thrash = fams["vtpu_resize_thrash"].samples[0].value
        want_states = {"pending": {"pending": 4}, "at-max": {"at-max": 4},
                       "resizing": {"resizing": 4}, "shrunk": {"shrunk": 2},
                       "thrash": {"shrunk": 2}}[step]
        assert states == {s: want_states.get(s, 0) for s in
                          ("at-max", "shrunk", "resizing", "pending")}, step
        assert resizes[("shrink", "reclaim")] == \
            (0 if step in ("pending", "at-max") else 1), step
        assert sum(resizes.values()) == resizes[("shrink", "reclaim")]
        assert thrash == (1 if step == "thrash" else 0), step
        assert got is not None


# -- the card leg, rehearsed ----------------------------------------------------

def test_the_card_leg_rehearses_on_the_mock_nvml(tmp_path):
    """``chip_smoke.py``'s elastic leg on the CPU: the node agent child on
    the mock NVML with stand-in members (``DEFRAG_TRAINER=standin``, as
    the compaction's trainers are stood in for).  Every check of the leg
    runs in the child: the malformed range's 422, the downgrade to (2,),
    thrash counted once inside the window, the grow with its
    ``elastic:grow:`` request, the member's checkpoint and exit, the
    completed resize with an empty preemption ledger, the two members at
    (4,) with ranks 0 and 1 and their gang env restoring the checkpoint,
    ``/metrics`` against the controller at each step, the grants freed.
    Here: the final chain is the stand-ins' uninterrupted one, and the
    record holds what the card run prints."""
    import os
    import subprocess
    import sys

    import chip_smoke
    from k8s_vgpu_scheduler_tpu_torch.ops import _kernels

    lib = _kernels.build_mock_nvml()
    fixture = tmp_path / "nvml.json"
    fixture.write_text(json.dumps({"generation": "h100", "mesh": [1],
                                   "hbm_mib": 81079}))
    env = {k: v for k, v in os.environ.items()
           if k not in ("VTPU_MOCK_JSON", "MOCK_NVML_NOT_SUPPORTED")}
    env.update(LD_LIBRARY_PATH=str(lib.parent), MOCK_NVML_JSON=str(fixture),
               PLUGIN_DIR=str(tmp_path), DEFRAG_TRAINER="standin")
    res = subprocess.run(
        [sys.executable, str(chip_smoke.ROOT / "chip_smoke.py"),
         "--enforce-child", "node_agent"], cwd=chip_smoke.ROOT, env=env,
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    [line] = [x for x in res.stdout.splitlines() if x.startswith("ENFORCE ")]
    e = json.loads(line[len("ENFORCE "):])["hgx"]["elastic"]
    want = chip_smoke.elastic_chain(
        chip_smoke.elastic_chain_seed(),
        [chip_smoke.elastic_standin_digest(i)
         for i in range(chip_smoke.ELASTIC_ITEMS)]).hex()
    assert e["kind"] == "standin" and e["final_chain"] == want
    assert e["bad_range"]["status"]["message"] == \
        chip_smoke.ELASTIC_BAD_RANGE_MESSAGE
    assert e["gen0_filters"][1:] == [
        "gang ering: no atomic placement for 2 members"] * 2
    kinds = [[a["kind"] for a in acts] for acts in e["ticks"]]
    assert kinds == [["resize-downgrade"], [], [], ["resize-grow"],
                     ["resize-complete"]]
    assert e["grow_request"] == "elastic:grow:default/ering"
    m = e["metrics"]
    assert m["pending"]["pods"]["pending"] == 2
    assert m["downgraded"]["resizes"] == {"shrink/admission": 1.0}
    assert m["thrash"]["thrash"] == 1 and m["thrash"]["pods"]["shrunk"] == 1
    assert m["resizing"]["pods"]["resizing"] == 1
    assert m["resizing"]["resizes"] == {"shrink/admission": 1.0,
                                        "grow/grow": 1.0}
    assert m["regrown"]["pods"]["at-max"] == 2
    assert set(m["deleted"]["pods"].values()) == {0.0}
    runs = e["runs"]
    assert runs["elastic_g1"]["done"] == chip_smoke.ELASTIC_WAIT_AT
    assert sorted(runs[k]["rank"] for k in ("elastic_g2r0",
                                            "elastic_g2r1")) == [0, 1]
    assert [g["rank"] for g in e["g2"]] == ["0", "1"]
    assert all(len(g["cards"]) == 2 for g in [e["g1"]] + e["g2"])
    assert e["launches"] == 0 and e["card_window"][1] is not None
    # The phase's record of the leg, as the card run prints it.
    e["reference_chain"], e["reference_s"] = want, 0.0
    assert chip_smoke.elastic_summary(e)["final_chain"] == want


def test_the_leg_s_malformed_range_answer_is_the_jax_webhook_s():
    """``ELASTIC_BAD_RANGE_MESSAGE``, which the card leg holds its 422 to,
    is the JAX webhook's message for that pod (and the port's)."""
    import chip_smoke

    pod = range_pod(gpu=chip_smoke.ELASTIC_CARDS, mesh="4", mn=None, mx="4",
                    gang=chip_smoke.ELASTIC_GROUP, gang_total=2)
    r = TestWebhookRangeValidation()._review(pod)["response"]
    assert r["status"]["message"] == chip_smoke.ELASTIC_BAD_RANGE_MESSAGE


def test_a_resync_leaves_resize_requests_to_the_controller():
    """The preemption ledger's rebuild after a restart rescinds a request
    whose requester is gone, but never a resize's (``elastic:``) or a
    rescue's (``rescue:``, reclaim and defrag shrinks among them): their
    grace and rescission are their owner's, and clearing one would stop
    a checkpoint midway.  Both packages alike."""
    values = ("elastic:grow:default/train", "elastic:admission:default/t",
              RECLAIM + "uid-x/default/train", "uid-gone")

    def script(side, rec):
        for i, v in enumerate(values):
            p = single(f"v{i}", anns={PREEMPT: v})
            side.kube.create_pod(p)
        side.s.resync_from_apiserver()
        rec.append([side.anns(f"v{i}").get(PREEMPT)
                    for i in range(len(values))])

    rec, _ = run_both(script)
    assert rec[0] == list(values[:3]) + [""]


# -- active replicas: one resize planner -------------------------------------------

def elastic_planner(pkg):
    """Two replicas with elastic resizing on: which replicas' ticks plan
    (reach the gang scan), before and after the planner is killed."""
    from tests.test_torch_shard import kill_and_settle, make_fleet

    kube, reps, names, clock = make_fleet(pkg, n_rep=2, enable_elastic=True)
    planned = []
    try:
        for s in reps:
            real = s.elastic.elastic_gangs

            def scan(_s=s, _real=real):
                planned.append(_s.shards.replica)
                return _real()

            s.elastic.elastic_gangs = scan
        for s in reps:
            s.elastic.tick()
        first = list(planned)
        planner = next(s for s in reps if s.shards.replica == first[0])
        alive = kill_and_settle(reps, clock, planner)
        del planned[:]
        for s in alive:
            s.elastic.tick()
        return dict(first=first, second=list(planned),
                    leads=[s.shards.leads("elastic") for s in reps])
    finally:
        for s in reps:
            s.close()


def test_one_replica_plans_resizes_and_the_lead_moves_with_the_epoch():
    """The resize controller's leader gate (``shards.leads("elastic")``)
    on both packages."""
    from tests.test_torch_shard import PKGS, SIDES

    got = {side: elastic_planner(PKGS[side]) for side in SIDES}
    assert got["port"] == got["jax"], got
    assert len(got["port"]["first"]) == len(got["port"]["second"]) == 1
    assert got["port"]["first"] != got["port"]["second"]
