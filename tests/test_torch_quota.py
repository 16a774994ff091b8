"""The port's capacity queues (``quota/`` and their hooks in the extender)
against the JAX package's, on the CPU.

Every case of ``tests/test_quota.py`` but the pending table's
``/explainz`` join (provenance) runs here on both packages: the
same fleet (two nodes of four cards, a (4, 1) fabric each), the same pods,
the same script of creates, Filters, Binds, deletes and admission ticks,
each side on its own SimClock.  What each side shows is held equal: the
Filter answers and holds, the tick's actions (releases in order, reclaim
victims), the queue annotations and events, the queue usage, the
``/queuez`` document, the five queue families of ``/metrics`` and the
report's quota columns; then the JAX case's own assertions run on the
port's side.  The JAX side is given the port's resource names and the
serial Filter (``optimistic_commit=False``), as in
``tests/test_torch_scheduler.py``.
"""

import json
import threading
import urllib.request

import pytest

from k8s_vgpu_scheduler_tpu.accounting import efficiency as jeff
from k8s_vgpu_scheduler_tpu.accounting.ledger import UsageLedger as JLedger
from k8s_vgpu_scheduler_tpu.cmd import scheduler as jcmd
from k8s_vgpu_scheduler_tpu.cmd import vtpu_report as jreport
from k8s_vgpu_scheduler_tpu.health.faults import SimClock as JClock
from k8s_vgpu_scheduler_tpu.k8s import FakeKube as JKube
from k8s_vgpu_scheduler_tpu.quota import fairshare as jfair
from k8s_vgpu_scheduler_tpu.quota import queues as jq
from k8s_vgpu_scheduler_tpu.quota.reclaim import plan_reclaim as jplan
from k8s_vgpu_scheduler_tpu.scheduler import Scheduler as JScheduler
from k8s_vgpu_scheduler_tpu.scheduler import metrics as jmetrics
from k8s_vgpu_scheduler_tpu.scheduler.nodes import DeviceInfo as JDevice
from k8s_vgpu_scheduler_tpu.scheduler.nodes import NodeInfo as JNode
from k8s_vgpu_scheduler_tpu.scheduler.pods import PodInfo as JPod
from k8s_vgpu_scheduler_tpu.scheduler.pods import PodManager as JPods
from k8s_vgpu_scheduler_tpu.scheduler.webhook import mutate_pod as jmutate
from k8s_vgpu_scheduler_tpu.tpulib import TopologyDesc as JTopo
from k8s_vgpu_scheduler_tpu.util import nodelock as jlock
from k8s_vgpu_scheduler_tpu.util.config import Config as JConfig
from k8s_vgpu_scheduler_tpu.util.config import ResourceNames as JNames
from k8s_vgpu_scheduler_tpu.util.types import ContainerDevice as JCD
from k8s_vgpu_scheduler_tpu_torch.accounting import efficiency as teff
from k8s_vgpu_scheduler_tpu_torch.accounting.ledger import \
    UsageLedger as TLedger
from k8s_vgpu_scheduler_tpu_torch.cmd import scheduler as tcmd
from k8s_vgpu_scheduler_tpu_torch.cmd import vgpu_report as treport
from k8s_vgpu_scheduler_tpu_torch.health.faults import SimClock as TClock
from k8s_vgpu_scheduler_tpu_torch.k8s import FakeKube as TKube
from k8s_vgpu_scheduler_tpu_torch.quota import fairshare as tfair
from k8s_vgpu_scheduler_tpu_torch.quota import queues as tq
from k8s_vgpu_scheduler_tpu_torch.quota.reclaim import plan_reclaim as tplan
from k8s_vgpu_scheduler_tpu_torch.scheduler import Scheduler as TScheduler
from k8s_vgpu_scheduler_tpu_torch.scheduler import metrics as tmetrics
from k8s_vgpu_scheduler_tpu_torch.scheduler.nodes import DeviceInfo as TDevice
from k8s_vgpu_scheduler_tpu_torch.scheduler.nodes import NodeInfo as TNode
from k8s_vgpu_scheduler_tpu_torch.scheduler.pods import PodInfo as TPod
from k8s_vgpu_scheduler_tpu_torch.scheduler.pods import PodManager as TPods
from k8s_vgpu_scheduler_tpu_torch.scheduler.preempt import PREEMPT_ANNOTATION
from k8s_vgpu_scheduler_tpu_torch.scheduler.routes import ExtenderServer
from k8s_vgpu_scheduler_tpu_torch.scheduler.webhook import (
    handle_admission_review, mutate_pod as tmutate)
from k8s_vgpu_scheduler_tpu_torch.tpulib.types import TopologyDesc as TTopo
from k8s_vgpu_scheduler_tpu_torch.util import exposition
from k8s_vgpu_scheduler_tpu_torch.util import nodelock as tlock
from k8s_vgpu_scheduler_tpu_torch.util.config import Config as TConfig
from k8s_vgpu_scheduler_tpu_torch.util.types import ContainerDevice as TCD
from tests.test_torch_scheduler import PORT_NAMES

QA = {"name": "a", "namespaces": ["team-a"], "cohort": "m", "weight": 3,
      "quota": {"chips": 6}, "borrow_limit_chips": 2}
QB = {"name": "b", "namespaces": ["team-b"], "cohort": "m", "weight": 1,
      "quota": {"chips": 2}, "borrow_limit_chips": 6}
#: Events the queues send (the rest, the rescuer's and provenance's, are
#: not this file's).
QUEUE_EVENTS = ("Queued", "Admitted", "QuotaReclaim",
                "BorrowedGrantReclaimed")
ANNOTATIONS = (tq.QUEUE_ANNOTATION, tq.QUEUE_STATE_ANNOTATION,
               tq.QUEUE_POSITION_ANNOTATION, PREEMPT_ANNOTATION)
QUEUE_FAMILIES = ("vtpu_queue_pending", "vtpu_queue_admitted",
                  "vtpu_queue_fair_share", "vtpu_borrowed_chips",
                  "vtpu_reclaims")


class Side:
    """One package's scheduler with the JAX test's ``build``: ``nodes``
    nodes of ``chips`` cards of ``hbm`` MiB on a (chips, 1) fabric, the
    quota ``queues``, reclaim grace 0, the informer wired."""

    def __init__(self, port: bool, queues=(QA, QB), nodes=2, chips=4,
                 hbm=16384, **cfg_kw):
        self.port = port
        self.clock = TClock() if port else JClock()
        cfg_kw = dict(quota_queues=tuple(queues), queue_reclaim_grace_s=0.0,
                      **cfg_kw)
        if port:
            self.cfg = TConfig(optimistic_commit=False, **cfg_kw)
        else:
            self.cfg = JConfig(resources=JNames(**PORT_NAMES),
                               scheduler_name="vgpu-scheduler",
                               optimistic_commit=False, **cfg_kw)
        self.kube = TKube() if port else JKube()
        self.s = (TScheduler if port else JScheduler)(self.kube, self.cfg,
                                                      clock=self.clock)
        Dev, Node, Topo = ((TDevice, TNode, TTopo) if port
                           else (JDevice, JNode, JTopo))
        self.names = []
        for i in range(nodes):
            n = f"n{i}"
            self.names.append(n)
            self.kube.add_node({"metadata": {"name": n, "annotations": {}}})
            devs = [Dev(id=f"{n}-c{j}", count=1, devmem=hbm,
                        type="NVIDIA-h100", health=True, coords=(j, 0))
                    for j in range(chips)]
            self.s.nodes.add_node(n, Node(
                name=n, devices=devs,
                topology=Topo(generation="h100", mesh=(chips, 1))))
        self.kube.watch_pods(self.s.on_pod_event)
        self.lock = tlock if port else jlock

    def create(self, *pods) -> list:
        for p in pods:
            self.kube.create_pod(p)
        return list(pods)

    def place(self, pod) -> str:
        r = self.s.filter(pod, self.names)
        assert r.node, r.error
        ns = pod["metadata"]["namespace"]
        self.s.bind(ns, pod["metadata"]["name"], pod["metadata"]["uid"],
                    r.node)
        self.lock.release_node(self.kube, r.node)
        return r.node

    def held_usage(self) -> dict:
        return {k: v.chips for k, v in
                self.s.quota.usage(self.s.pods.list_pods()).items()}

    def anns(self, ns, name) -> dict:
        """The pod's queue annotations and eviction request (the decision
        annotations are ``tests/test_torch_scheduler.py``'s)."""
        anns = self.kube.get_pod(ns, name)["metadata"]["annotations"]
        return {k: v for k, v in anns.items() if k in ANNOTATIONS}

    def queue_events(self) -> list:
        return [e for e in self.kube.events if e["reason"] in QUEUE_EVENTS]

    def queues(self) -> dict:
        return self.s.export_queues()

    def close(self):
        if self.port:
            self.s.admission.stop()
        else:
            self.s.close()


def mkpod(name, ns, chips=2, queue=None, extra_anns=None):
    anns = dict(extra_anns or {})
    if queue is not None:
        anns[tq.QUEUE_ANNOTATION] = queue
        anns[tq.QUEUE_STATE_ANNOTATION] = tq.STATE_HELD
    return {
        "metadata": {"name": name, "namespace": ns, "uid": f"uid-{name}",
                     "annotations": anns},
        "spec": {"containers": [{
            "name": "m",
            "resources": {"limits": {"nvidia.com/gpu": str(chips),
                                     "nvidia.com/gpumem": "16384"}}}]},
    }


def run_both(script, **build):
    """``script(side)`` on the port's side and the JAX side; asserts the
    two records equal and returns the port's (record, side)."""
    out = {}
    for port in (True, False):
        side = Side(port, **build)
        try:
            out[port] = (script(side), side)
        finally:
            side.close()
    assert out[True][0] == out[False][0]
    return out[True]


def observed(side) -> dict:
    """Everything a case compares at its end."""
    return {"usage": side.held_usage(), "queuez": side.queues(),
            "events": side.queue_events()}


def pod_info(port, **kw):
    return (TPod if port else JPod)(**kw)


def cd(port, *args):
    return (TCD if port else JCD)(*args)


# ---------------------------------------------------------------------------
# config + fair-share math
# ---------------------------------------------------------------------------

class TestConfig:
    @pytest.mark.parametrize("doc, match", [
        ({"queues": [QA, dict(QA, namespaces=[])]}, "duplicate"),
        ({"queues": [QA, dict(QB, namespaces=["team-a"])]},
         "governed by both"),
        ({"queues": [dict(QA, weight=0)]}, "weight"),
    ], ids=["duplicate_queue", "doubly_governed_namespace",
            "nonpositive_weight"])
    def test_parse_rejects(self, doc, match):
        msgs = []
        for parse in (tq.parse_quota_config, jq.parse_quota_config):
            with pytest.raises(ValueError, match=match) as e:
                parse(doc)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]

    def test_parse_matches_jax(self):
        doc = {"queues": [QA, QB, {"name": "c", "namespaces": ["x", "y"],
                                   "quota": {"chips": 1, "hbm_mib": 512},
                                   "borrow_limit_hbm_mib": 64}]}
        import dataclasses
        assert [dataclasses.asdict(q) for q in tq.parse_quota_config(doc)] \
            == [dataclasses.asdict(q) for q in jq.parse_quota_config(doc)]
        assert tq.parse_quota_config({}) == jq.parse_quota_config({}) == ()

    def test_load_quota_config_tolerates_empty_and_yaml(self, tmp_path):
        pytest.importorskip("yaml")
        for load in (tcmd.load_quota_config, jcmd.load_quota_config):
            assert load("") == ()
            empty = tmp_path / "empty.yaml"
            empty.write_text("# nothing here\n")
            assert load(str(empty)) == ()
            y = tmp_path / "quota.yaml"
            y.write_text("queues:\n  - name: a\n    namespaces: [team-a]\n")
            (q,) = load(str(y))
            assert q["name"] == "a"
            bad = tmp_path / "bad.yaml"
            bad.write_text("- just\n- a\n- list\n")
            with pytest.raises(ValueError, match="expected a mapping"):
                load(str(bad))

    def test_load_quota_config_reads_json_and_fails_loudly(self, tmp_path,
                                                           monkeypatch):
        """JSON needs no PyYAML; a YAML file without it names the file; a
        bad config fails at boot."""
        j = tmp_path / "quota.json"
        j.write_text(json.dumps({"queues": [QA, QB]}))
        assert tcmd.load_quota_config(str(j)) == \
            jcmd.load_quota_config(str(j)) == (QA, QB)
        blank = tmp_path / "blank.json"
        blank.write_text("\n")
        assert tcmd.load_quota_config(str(blank)) == ()
        y = tmp_path / "quota.yaml"
        y.write_text("queues: []\n")
        monkeypatch.setitem(__import__("sys").modules, "yaml", None)
        with pytest.raises(ValueError, match="quota.yaml.*PyYAML"):
            tcmd.load_quota_config(str(y))
        dup = tmp_path / "dup.json"
        dup.write_text(json.dumps({"queues": [QA, QA]}))
        with pytest.raises(ValueError, match="duplicate"):
            tcmd.load_quota_config(str(dup))

    def test_queue_for_namespace_accepts_raw_dicts(self):
        for find in (tq.queue_for_namespace, jq.queue_for_namespace):
            q = find((QA, QB), "team-b")
            assert q is not None and q.name == "b"
            assert find((QA, QB), "elsewhere") is None


class TestFairShare:
    @pytest.mark.parametrize("nominal, hbm, used, mem", [
        (8, 1000, 4, 900), (8, 1000, 6, 100), (0, 0, 1, 0), (0, 0, 0, 0),
        (4, 0, 3, 7000), (0, 500, 2, 250)])
    def test_dominant_share_matches_jax(self, nominal, hbm, used, mem):
        got, want = (
            m.dominant_share(qm.QueueUsage(chips=used, mem_mib=mem),
                             qm.QueueConfig(name="q", namespaces=("x",),
                                            nominal_chips=nominal,
                                            nominal_hbm_mib=hbm))
            for m, qm in ((tfair, tq), (jfair, jq)))
        assert got == want

    def test_dominant_share_is_max_over_dimensions(self):
        q = tq.QueueConfig(name="q", namespaces=("x",), nominal_chips=8,
                           nominal_hbm_mib=1000)
        assert tfair.dominant_share(tq.QueueUsage(chips=4, mem_mib=900),
                                    q) == 0.9
        assert tfair.dominant_share(tq.QueueUsage(chips=6, mem_mib=100),
                                    q) == 0.75

    def test_zero_nominal_chips_reads_as_all_borrowed(self):
        q = tq.QueueConfig(name="scavenger", namespaces=("x",),
                           nominal_chips=0)
        assert tfair.dominant_share(tq.QueueUsage(chips=1), q) == \
            float("inf")
        assert tfair.dominant_share(tq.QueueUsage(), q) == 0.0

    @pytest.mark.parametrize("case", ["weighted", "ties", "informed"])
    def test_fair_share_order_matches_jax(self, case):
        def order(fair, qm):
            if case == "ties":
                queues = {n: qm.QueueConfig(name=n, namespaces=(n,),
                                            nominal_chips=4)
                          for n in ("zz", "aa", "mm")}
                usage = {n: qm.QueueUsage(chips=2) for n in queues}
                return fair.fair_share_order(queues, usage)
            queues = {
                "a": qm.QueueConfig(name="a", namespaces=("a",), weight=3,
                                    nominal_chips=6),
                "b": qm.QueueConfig(name="b", namespaces=("b",), weight=1,
                                    nominal_chips=6)}
            usage = {"a": qm.QueueUsage(chips=3), "b": qm.QueueUsage(chips=3)}
            if case == "informed":
                return fair.fair_share_order(queues, usage,
                                             {"a": 0.1, "b": None}, True)
            return fair.fair_share_order(queues, usage)

        got, want = order(tfair, tq), order(jfair, jq)
        assert got == want
        if case == "weighted":
            assert [n for _s, n in got] == ["a", "b"]
        if case == "ties":
            assert [n for _s, n in got] == ["aa", "mm", "zz"]

    def test_usage_informed_demotes_idle_tenant_with_floor(self):
        q = tq.QueueConfig(name="q", namespaces=("x",), weight=2.0)
        jqc = jq.QueueConfig(name="q", namespaces=("x",), weight=2.0)
        for eff, informed in ((None, True), (0.5, False), (0.5, True),
                              (0.0, True), (5.0, True)):
            assert tfair.effective_weight(q, eff, informed) == \
                jfair.effective_weight(jqc, eff, informed)
        assert tfair.effective_weight(q, 0.0, True) == \
            2.0 * tfair.USAGE_WEIGHT_FLOOR

    def test_counter_reset_safe_usage_weighting(self):
        """A monitor restart (counters back near zero) must never give a
        negative or wild efficiency: the weight stays in [floor*w, w], and
        the port's per-queue efficiency is the JAX one."""
        effs = {}
        for port in (True, False):
            clock = TClock() if port else JClock()
            ledger = (TLedger if port else JLedger)(clock=clock)
            row = {"ctrkey": "u1_p1", "chips": 2, "active": True,
                   "chip_seconds": 100.0, "hbm_byte_seconds": 0.0,
                   "throttled_seconds": 0.0, "oversub_spill_seconds": 0.0}
            ledger.record("n0", [row])
            clock.advance(60)
            ledger.record("n0", [dict(row, chip_seconds=160.0)])
            clock.advance(60)
            ledger.record("n0", [dict(row, chip_seconds=5.0)])
            assert ledger.resets_observed == 1
            eff = teff if port else jeff
            pods = [pod_info(port, uid="u1", name="p1", namespace="team-a",
                             node="n0",
                             devices=[[cd(port, "c0", "h100", 100, 0),
                                       cd(port, "c1", "h100", 100, 0)]])]
            fleet = eff.grant_efficiency(
                pods, ledger, eff.EfficiencyConfig(window_s=300.0),
                now=clock())
            fair = tfair if port else jfair
            effs[port] = fair.queue_efficiencies(fleet, {"team-a": "a"})
        assert effs[True] == effs[False]
        assert effs[True]["a"] is not None and effs[True]["a"] >= 0.0
        q = tq.QueueConfig(name="a", namespaces=("team-a",), weight=3.0)
        w = tfair.effective_weight(q, effs[True]["a"], True)
        assert 3.0 * tfair.USAGE_WEIGHT_FLOOR <= w <= 3.0


# ---------------------------------------------------------------------------
# gate / bypass / webhook
# ---------------------------------------------------------------------------

class TestGate:
    def test_ungoverned_namespace_bypasses_entirely(self):
        def script(side):
            (pod,) = side.create(mkpod("free-0", "other"))
            node = side.place(pod)
            return {"node": node, "entries": side.s.quota.entries(),
                    "anns": side.anns("other", "free-0").get(
                        tq.QUEUE_STATE_ANNOTATION)}

        rec, _ = run_both(script)
        assert rec["node"] and rec["entries"] == [] and rec["anns"] is None

    def test_governed_pod_held_with_position(self):
        def script(side):
            list(side.create(*(mkpod(f"a{i}", "team-a", queue="a")
                               for i in range(3))))
            r = side.s.filter(mkpod("a1", "team-a", queue="a"), side.names)
            return {"node": r.node, "error": r.error, "failed": r.failed,
                    **observed(side)}

        rec, _ = run_both(script)
        assert rec["node"] is None
        assert "held in capacity queue a" in rec["error"]
        assert "position 2/3" in rec["error"]

    def test_admitted_annotation_is_the_restart_wal(self):
        def script(side):
            pod = mkpod("a0", "team-a", queue="a")
            pod["metadata"]["annotations"][tq.QUEUE_STATE_ANNOTATION] = \
                tq.STATE_ADMITTED
            list(side.create(pod))
            return {"node": side.place(pod), **observed(side)}

        rec, _ = run_both(script)
        assert rec["node"]

    def test_quota_disabled_is_inert(self):
        def script(side):
            (pod,) = side.create(mkpod("a0", "team-a", queue="a"))
            return {"node": side.place(pod),
                    "enabled": side.s.quota.enabled,
                    "queuez": side.queues()}

        rec, side = run_both(script, queues=())
        assert rec["node"] and not rec["enabled"]
        assert rec["queuez"] == {"queues": [], "reclaims_total": 0,
                                 "fair_share_order": [], "enabled": False}

    def test_webhook_stamps_governed_pods_only(self):
        tcfg = TConfig(quota_queues=(QA, QB))
        jcfg = JConfig(resources=JNames(**PORT_NAMES),
                       scheduler_name="vgpu-scheduler",
                       quota_queues=(QA, QB))
        for name, ns in (("w0", "team-a"), ("w1", "nobody")):
            got = tmutate(mkpod(name, ns), tcfg, trace_id="t1", namespace=ns)
            want = jmutate(mkpod(name, ns), jcfg, trace_id="t1",
                           namespace=ns)
            assert got == want
            text = str(got)
            if ns == "team-a":
                added = {}
                for p in got:
                    if p["path"] == "/metadata/annotations":
                        added.update(p["value"])
                    elif p["path"].startswith("/metadata/annotations/"):
                        added[p["path"].rsplit("/", 1)[1]
                              .replace("~1", "/")] = p["value"]
                assert added[tq.QUEUE_ANNOTATION] == "a"
                assert added[tq.QUEUE_STATE_ANNOTATION] == tq.STATE_HELD
            else:
                assert tq.QUEUE_ANNOTATION not in text
        # A pod with no annotations at all gets one map holding both.
        bare = mkpod("w2", "team-b")
        del bare["metadata"]["annotations"]
        bare2 = mkpod("w2", "team-b")
        del bare2["metadata"]["annotations"]
        assert tmutate(bare, tcfg, trace_id="t2", namespace="team-b") == \
            jmutate(bare2, jcfg, trace_id="t2", namespace="team-b")

    def test_webhook_leaves_existing_queue_state_alone(self):
        tcfg = TConfig(quota_queues=(QA,))
        pod = mkpod("w2", "team-a",
                    extra_anns={tq.QUEUE_STATE_ANNOTATION:
                                tq.STATE_ADMITTED})
        patches = tmutate(pod, tcfg, namespace="team-a")
        assert tq.QUEUE_ANNOTATION not in str(patches)
        jcfg = JConfig(resources=JNames(**PORT_NAMES),
                       scheduler_name="vgpu-scheduler", quota_queues=(QA,))
        assert patches == jmutate(pod, jcfg, namespace="team-a")

    def test_admission_review_reads_the_request_namespace(self):
        """A pod CREATE often omits metadata.namespace: the review's
        namespace is the governance key."""
        pod = mkpod("w3", "team-a")
        del pod["metadata"]["namespace"]
        body = {"request": {"uid": "r1", "namespace": "team-a",
                            "operation": "CREATE", "object": pod}}
        out = handle_admission_review(body, TConfig(quota_queues=(QA,)))
        import base64
        ops = json.loads(base64.b64decode(out["response"]["patch"]))
        assert {"op": "add", "path": "/metadata/annotations/vtpu.dev~1queue",
                "value": "a"} in ops

    def test_pod_group_is_refused_and_never_queued(self):
        """A governed pod group's lone member, as the JAX package answers
        it: Filter holds it in its queue (the gate comes before the gang
        barrier), the informer queues it as a gang member, and a tick
        leaves it held while its group accumulates (TestBackfill places
        whole groups)."""
        def script(side):
            [pod] = side.create(mkpod(
                "g0", "team-a", queue="a",
                extra_anns={"vtpu.dev/pod-group": "ring",
                            "vtpu.dev/pod-group-total": "2"}))
            r = side.s.filter(pod, side.names)
            return {"filter": [r.node, r.error],
                    "entries": [[e.uid, e.gang, e.gang_total, e.state]
                                for e in side.s.quota.entries()],
                    "acts": side.s.admission.tick(), **observed(side)}

        rec, _ = run_both(script)
        assert rec["filter"][0] is None and rec["filter"][1].startswith(
            "held in capacity queue a (position 1/1")
        assert rec["entries"] == [["uid-g0", "ring", 2, "held"]]
        assert rec["acts"] == []
        assert rec["queuez"]["queues"][0]["pending_pods"][0]["gang"] == \
            "ring"


# ---------------------------------------------------------------------------
# admission flow
# ---------------------------------------------------------------------------

class TestAdmission:
    def test_hold_admit_place_with_events_and_positions(self):
        def script(side):
            pods = list(side.create(*(mkpod(f"a{i}", "team-a", queue="a")
                                      for i in range(4))))
            acts = side.s.admission.tick()
            nodes = [side.place(p) for p in pods]
            return {"acts": acts, "nodes": nodes,
                    "anns": side.anns("team-a", "a0"), **observed(side)}

        rec, _ = run_both(script)
        assert [a["kind"] for a in rec["acts"]].count("admit") == 4
        assert rec["usage"] == {"a": 8, "b": 0}
        assert [e["reason"] for e in rec["events"]].count("Admitted") == 4
        assert rec["anns"][tq.QUEUE_STATE_ANNOTATION] == tq.STATE_ADMITTED

    def test_held_pod_gets_position_annotation_and_queued_event(self):
        def script(side):
            list(side.create(*(mkpod(f"a{i}", "team-a", queue="a")
                               for i in range(5))))
            acts = side.s.admission.tick()
            return {"acts": acts, "anns": side.anns("team-a", "a4"),
                    **observed(side)}

        rec, _ = run_both(script)
        assert rec["anns"][tq.QUEUE_POSITION_ANNOTATION] == "1/1"
        assert "Queued" in [e["reason"] for e in rec["events"]]

    def test_fleet_throttle_holds_releases_at_capacity(self):
        def script(side):
            list(side.create(*(mkpod(f"a{i}", "team-a", queue="a")
                               for i in range(6))))
            list(side.create(*(mkpod(f"b{i}", "team-b", queue="b")
                               for i in range(2))))
            return {"acts": side.s.admission.tick(), **observed(side)}

        rec, _ = run_both(script)
        u = rec["usage"]
        assert u["a"] + u["b"] <= 8
        assert u["b"] == 2

    def test_a_reservation_lowers_the_fleet_cap(self):
        """A defrag compaction's reserved cards leave the release
        throttle (JAX ``_fleet_chip_cap``): with 3 of the 8 cards
        reserved, the same demand releases into 5, where the whole fleet
        released 8; the cap returns with the reservation."""
        def script(side):
            res = side.s.reservations.reserve(
                "n0", {"n0-c0", "n0-c1", "n0-c2"}, "beneficiary")
            rec = {"cap": side.s.admission._fleet_chip_cap()}
            list(side.create(*(mkpod(f"a{i}", "team-a", queue="a")
                               for i in range(6))))
            list(side.create(*(mkpod(f"b{i}", "team-b", queue="b")
                               for i in range(2))))
            rec["acts"] = side.s.admission.tick()
            rec["held"] = side.held_usage()
            side.s.reservations.release(res)
            rec["cap_after"] = side.s.admission._fleet_chip_cap()
            return {**rec, **observed(side)}

        rec, _ = run_both(script)
        assert rec["cap"] == 5.0 and rec["cap_after"] == 8.0
        assert 0 < rec["held"]["a"] + rec["held"]["b"] <= 5

    def test_fair_share_order_equalizes_weighted_shares(self):
        qa = dict(QA, quota={"chips": 4}, borrow_limit_chips=0)
        qb = dict(QB, quota={"chips": 4}, borrow_limit_chips=0)

        def script(side):
            for i in range(4):
                list(side.create(mkpod(f"a{i}", "team-a", chips=1, queue="a"),
                                 mkpod(f"b{i}", "team-b", chips=1,
                                       queue="b")))
            return {"acts": side.s.admission.tick(), **observed(side)}

        rec, _ = run_both(script, queues=(qa, qb), nodes=2, chips=3)
        assert rec["usage"] == {"a": 4, "b": 2}

    def test_usage_informed_loop_matches_jax(self):
        """--fair-share-usage-informed with no usage reports: unknown is
        not idle, so the releases are the configured weights'."""
        def script(side):
            for i in range(3):
                list(side.create(mkpod(f"a{i}", "team-a", chips=1, queue="a"),
                                 mkpod(f"b{i}", "team-b", chips=1,
                                       queue="b")))
            return {"acts": side.s.admission.tick(), **observed(side)}

        run_both(script, fair_share_usage_informed=True)


# ---------------------------------------------------------------------------
# borrow / reclaim
# ---------------------------------------------------------------------------

def borrowed_fleet(side):
    pods = list(side.create(*(mkpod(f"a{i}", "team-a", queue="a")
                              for i in range(4))))
    side.s.admission.tick()
    for p in pods:
        side.place(p)
    assert side.held_usage()["a"] == 8  # nominal 6 + borrowed 2


class TestBorrowReclaim:
    def test_reclaim_targets_only_borrowed_youngest_first(self):
        def script(side):
            borrowed_fleet(side)
            list(side.create(mkpod("b0", "team-b", queue="b")))
            side.clock.advance(1)
            acts = side.s.admission.tick()
            return {"acts": acts,
                    "anns": {n: side.anns("team-a", n).get(
                        PREEMPT_ANNOTATION) for n in ("a0", "a1", "a2",
                                                      "a3")},
                    **observed(side)}

        rec, _ = run_both(script)
        recl = [a for a in rec["acts"] if a["kind"] == "reclaim"]
        assert len(recl) == 1
        assert [v["pod"] for v in recl[0]["victims"]] == ["team-a/a3"]
        assert all(v["donor_borrowed"] >= v["chips"]
                   for v in recl[0]["victims"])
        assert rec["anns"]["a3"] == "uid-b0"
        assert not any(rec["anns"][n] for n in ("a0", "a1", "a2"))

    def test_no_replan_while_victims_checkpoint(self):
        def script(side):
            borrowed_fleet(side)
            list(side.create(mkpod("b0", "team-b", queue="b")))
            side.clock.advance(1)
            acts1 = side.s.admission.tick()
            side.clock.advance(30)
            acts2 = side.s.admission.tick()
            return {"acts": [acts1, acts2],
                    "reclaims": side.s.quota.reclaims_total,
                    **observed(side)}

        rec, _ = run_both(script)
        assert sum(1 for a in rec["acts"][0] + rec["acts"][1]
                   if a["kind"] == "reclaim") == 1
        assert rec["reclaims"] == 1

    def test_victim_exit_admits_entitled_tenant(self):
        def script(side):
            borrowed_fleet(side)
            (b0,) = side.create(mkpod("b0", "team-b", queue="b"))
            side.clock.advance(1)
            side.s.admission.tick()
            side.kube.delete_pod("team-a", "a3")
            side.clock.advance(1)
            acts = side.s.admission.tick()
            return {"acts": acts, "node": side.place(b0), **observed(side)}

        rec, _ = run_both(script)
        assert rec["node"]
        assert rec["usage"] == {"a": 6, "b": 2}
        assert rec["queuez"]["queues"][0]["borrowed_chips"] == 0

    def test_reclaim_never_dips_donor_below_nominal(self):
        plans = {}
        for port in (True, False):
            qm, plan = (tq, tplan) if port else (jq, jplan)
            queues = {q.name: q for q in qm.parse_quota_config(
                {"queues": [QA, QB]})}
            usage = {"a": qm.QueueUsage(chips=8), "b": qm.QueueUsage(chips=0)}
            pods = [pod_info(port, uid=f"u{i}", name=f"p{i}",
                             namespace="team-a", node="n0",
                             devices=[[cd(port, "c", "h100", 100, 0)] * 2],
                             touched_at=float(i))
                    for i in range(4)]
            p = plan(2, queues["b"], queues, usage, pods)
            plans[port] = ([v.uid for v in p.victims], p.node,
                           plan(4, queues["b"], queues, usage, pods))
        assert plans[True] == plans[False] == (["u3"], "n0", None)

    def test_cohortless_queues_are_private(self):
        qa = dict(QA, cohort="", quota={"chips": 4}, borrow_limit_chips=0)
        qb = dict(QB, cohort="", quota={"chips": 4}, borrow_limit_chips=0)

        def script(side):
            mgr = side.s.quota
            qm = tq if side.port else jq
            usage = {"a": qm.QueueUsage(chips=4), "b": qm.QueueUsage(chips=0)}
            fits = mgr.fits_quota(mgr.queues["b"], usage, 4, 0)
            pods = [pod_info(side.port, uid="u0", name="p0",
                             namespace="team-a", node="n0",
                             devices=[[cd(side.port, "c", "h100", 100, 0)]],
                             touched_at=1.0)]
            plan = (tplan if side.port else jplan)(
                1, mgr.queues["b"], mgr.queues,
                {"a": qm.QueueUsage(chips=5), "b": qm.QueueUsage(chips=0)},
                pods)
            return {"fits": fits, "plan": plan}

        rec, _ = run_both(script, queues=(qa, qb))
        assert rec["fits"][0], rec["fits"][1]
        assert rec["plan"] is None

    @pytest.mark.parametrize("chips,mem", [(1, 0), (3, 0), (2, 1 << 30)])
    def test_fits_quota_matches_jax(self, chips, mem):
        """The quota arithmetic's answers and reasons, across queue
        fill levels."""
        qa = dict(QA, quota={"chips": 6, "hbm_mib": 40000},
                  borrow_limit_hbm_mib=1000)

        def script(side):
            mgr = side.s.quota
            qm = tq if side.port else jq
            return [mgr.fits_quota(mgr.queues[q], {
                "a": qm.QueueUsage(chips=a, mem_mib=a * 8000),
                "b": qm.QueueUsage(chips=b)}, chips, mem)
                for q in ("a", "b") for a in range(0, 9, 2)
                for b in range(0, 5, 2)]

        run_both(script, queues=(qa, QB))

    def test_reclaim_fires_for_released_but_unplaced_in_quota_pod(self):
        def script(side):
            pods = []
            for i in range(4):
                pods += side.create(mkpod(f"a{i}", "team-a", queue="a"))
                side.clock.advance(1)
            side.s.admission.tick()
            for p in pods:
                side.place(p)
            (b0,) = side.create(mkpod("b0", "team-b", queue="b"))
            side.clock.advance(1)
            state = side.s.quota.entry("uid-b0").state
            side.s.quota.release("uid-b0")
            r = side.s.filter(b0, side.names)
            side.clock.advance(5)
            acts = side.s.admission.tick()
            return {"state": state, "node": r.node, "acts": acts,
                    **observed(side)}

        rec, _ = run_both(script)
        assert rec["state"] == tq.STATE_HELD and rec["node"] is None
        recl = [a for a in rec["acts"] if a["kind"] == "reclaim"]
        assert len(recl) == 1, rec["acts"]
        assert [v["pod"] for v in recl[0]["victims"]] == ["team-a/a3"]

    def test_position_annotation_tracks_denominator(self):
        def script(side):
            for i in range(5):
                list(side.create(mkpod(f"a{i}", "team-a", queue="a")))
                side.clock.advance(1)
            side.s.admission.tick()
            first = side.anns("team-a", "a4")[tq.QUEUE_POSITION_ANNOTATION]
            list(side.create(mkpod("a5", "team-a", queue="a")))
            side.s.admission.tick()
            return {"positions": [first, side.anns("team-a", "a4")[
                tq.QUEUE_POSITION_ANNOTATION]], **observed(side)}

        rec, _ = run_both(script)
        assert rec["positions"] == ["1/1", "1/2"]

    def test_reclaim_plan_is_deterministic_under_frozen_clock(self):
        for port in (True, False):
            qm, plan = (tq, tplan) if port else (jq, jplan)
            queues = {q.name: q for q in qm.parse_quota_config(
                {"queues": [dict(QA, borrow_limit_chips=4), QB]})}
            usage = {"a": qm.QueueUsage(chips=10),
                     "b": qm.QueueUsage(chips=0)}
            pods = [pod_info(port, uid=u, name=u, namespace="team-a",
                             node="n0",
                             devices=[[cd(port, "c", "h100", 100, 0)] * 2],
                             touched_at=50.0)
                    for u in ("zz", "aa", "mm")]
            for _ in range(5):
                p = plan(4, queues["b"], queues, usage, pods)
                assert [v.uid for v in p.victims] == ["aa", "mm"]

    def test_failed_release_write_is_retried(self):
        """The admitted-state patch fails: the release stands in memory
        (the gate passes) and the next tick writes it."""
        side = Side(True)
        try:
            (pod,) = side.create(mkpod("a0", "team-a", queue="a"))
            real = side.kube.patch_pod_annotations
            calls = []

            def flaky(ns, name, anns, resource_version=None):
                if anns.get(tq.QUEUE_STATE_ANNOTATION) and not calls:
                    calls.append(name)
                    raise RuntimeError("apiserver down")
                return real(ns, name, anns,
                            resource_version=resource_version)

            side.kube.patch_pod_annotations = flaky
            acts = side.s.admission.tick()
            assert [a["kind"] for a in acts] == ["admit"] and calls
            assert side.anns("team-a", "a0")[tq.QUEUE_STATE_ANNOTATION] == \
                tq.STATE_HELD
            assert side.s.quota.gate(pod, []) is None
            side.s.admission.tick()
            assert side.anns("team-a", "a0")[tq.QUEUE_STATE_ANNOTATION] == \
                tq.STATE_ADMITTED
        finally:
            side.close()

    def test_no_reclaim_config_never_evicts(self):
        def script(side):
            borrowed_fleet(side)
            list(side.create(mkpod("b0", "team-b", queue="b")))
            side.clock.advance(1)
            return {"acts": side.s.admission.tick(), **observed(side)}

        rec, _ = run_both(script, enable_reclaim=False)
        assert not [a for a in rec["acts"] if a["kind"] == "reclaim"]


# ---------------------------------------------------------------------------
# interplay: reclaim vs rescuer (no double eviction)
# ---------------------------------------------------------------------------

GANG_ANNS = {"vtpu.dev/pod-group": "ring", "vtpu.dev/pod-group-total": "2"}


class TestBackfill:
    """tests/test_quota.py's gang-aware backfill: a short-runtime pod and
    one in the footprint's hole released ahead of an accumulating gang,
    and the complete gang released atomically, then placed."""

    def test_short_runtime_pod_admits_ahead_of_accumulating_gang(self):
        def script(side):
            side.create(mkpod("ring-0", "team-a", queue="a",
                              extra_anns=GANG_ANNS))
            side.clock.advance(1)
            side.create(mkpod(
                "quick", "team-a", chips=1, queue="a",
                extra_anns={"vtpu.dev/estimated-runtime-seconds": "30"}))
            side.create(mkpod("slow", "team-a", chips=1, queue="a"))
            return {"acts": side.s.admission.tick(), **observed(side)}

        rec, side = run_both(script, queues=(dict(QA, quota={"chips": 4}),),
                             nodes=1, chips=4)
        admitted = [a["pod"] for a in rec["acts"] if a["kind"] == "admit"]
        assert admitted == ["team-a/quick"]
        assert all(a.get("backfilled") for a in rec["acts"]
                   if a["kind"] == "admit")
        # The port keeps the tick's blocked heads (the card leg reads it).
        assert side.s.admission.blocked == {
            "a": ("uid-ring-0", "gang ring accumulating (1/2)")}

    def test_backfill_uses_footprint_hole_when_fleet_has_room(self):
        def script(side):
            side.create(mkpod("ring-0", "team-a", queue="a",
                              extra_anns=GANG_ANNS))
            side.clock.advance(1)
            side.create(mkpod("filler", "team-a", chips=2, queue="a"))
            return {"acts": side.s.admission.tick(), **observed(side)}

        rec, _ = run_both(script, queues=(dict(QA, quota={"chips": 8}),),
                          nodes=2, chips=4)
        assert [a["pod"] for a in rec["acts"] if a["kind"] == "admit"] == \
            ["team-a/filler"]

    def test_gang_admits_atomically_once_complete_never_starved(self):
        def script(side):
            [m0] = side.create(mkpod("ring-0", "team-a", queue="a",
                                     extra_anns=GANG_ANNS))
            side.clock.advance(1)
            [quick] = side.create(mkpod(
                "quick", "team-a", chips=1, queue="a",
                extra_anns={"vtpu.dev/estimated-runtime-seconds": "30"}))
            rec = {"first": side.s.admission.tick()}
            rec["quick"] = side.place(quick)
            [m1] = side.create(mkpod("ring-1", "team-a", queue="a",
                                     extra_anns=GANG_ANNS))
            rec["blocked_tick"] = side.s.admission.tick()
            side.kube.delete_pod("team-a", "quick")
            rec["release"] = side.s.admission.tick()
            r0 = side.s.filter(m0, side.names)
            r1 = side.s.filter(m1, side.names)
            r0b = side.s.filter(m0, side.names)
            rec["filters"] = [[r.node, r.error] for r in (r0, r1, r0b)]
            rec["ranks"] = {n: side.kube.get_pod("team-a", n)["metadata"][
                "annotations"].get("vtpu.dev/pod-group-rank")
                for n in ("ring-0", "ring-1")}
            return {**rec, **observed(side)}

        rec, _ = run_both(script, queues=(dict(QA, quota={"chips": 4}),),
                          nodes=1, chips=4)
        assert not [a for a in rec["blocked_tick"] if a["kind"] == "admit"]
        assert sorted(a["pod"] for a in rec["release"]
                      if a["kind"] == "admit") == \
            ["team-a/ring-0", "team-a/ring-1"]
        assert all(a["gang"] == "ring" for a in rec["release"])
        assert "waiting" in rec["filters"][0][1]
        assert rec["filters"][1][0] and rec["filters"][2][0]
        assert rec["ranks"] == {"ring-0": "0", "ring-1": "1"}

    def test_no_queue_backfill_holds_everything_behind_the_gang(self):
        """--no-queue-backfill: the short-runtime pod waits behind the
        accumulating gang too, as in the JAX loop."""
        def script(side):
            side.create(mkpod("ring-0", "team-a", queue="a",
                              extra_anns=GANG_ANNS))
            side.clock.advance(1)
            side.create(mkpod(
                "quick", "team-a", chips=1, queue="a",
                extra_anns={"vtpu.dev/estimated-runtime-seconds": "30"}))
            return {"acts": side.s.admission.tick(), **observed(side)}

        rec, side = run_both(script, queues=(dict(QA, quota={"chips": 4}),),
                             nodes=1, chips=4, enable_queue_backfill=False)
        assert rec["acts"] == [] and not side.s.admission.cfg.backfill

    def test_the_report_shows_a_held_member_with_its_gang(self):
        """vgpu-report's pending table from each side's own /queuez: a
        held gang member's row names its gang, as the JAX report's does
        (its /explainz reason '-' on both: provenance is A.5's)."""
        def script(side):
            side.create(mkpod("ring-0", "team-a", queue="a",
                              extra_anns=GANG_ANNS))
            side.s.admission.tick()
            rep = treport if side.port else jreport
            export = rep.join_quota(side.s.export_usage(), side.queues())
            export = rep.join_pending_reasons(export, "http://unused",
                                              fetch=lambda c, r: None)
            # The commands' names differ (vgpu-explain, vtpu-explain).
            return {"rows": export["pending_pods"],
                    "text": rep.format_report(export).replace("vtpu-",
                                                              "vgpu-")}

        rec, _ = run_both(script)
        assert rec["rows"] == [{"pod": "team-a/ring-0", "queue": "a",
                                "position": 1, "chips": 2, "gang": "ring",
                                "dominant_rejection": "-"}]

    def test_a_complete_gang_reclaims_its_whole_footprint(self):
        """A gang in an under-nominal queue reclaims only once all its
        members are held, for their cards together; borrowed grants go,
        and gang members are never victims."""
        def script(side):
            borrowed_fleet(side)
            side.create(mkpod("g-0", "team-b", chips=1, queue="b",
                              extra_anns=GANG_ANNS))
            side.clock.advance(1)
            rec = {"accumulating": side.s.admission.tick()}
            side.create(mkpod("g-1", "team-b", chips=1, queue="b",
                              extra_anns=GANG_ANNS))
            side.clock.advance(1)
            rec["complete"] = side.s.admission.tick()
            return {**rec, **observed(side)}

        rec, _ = run_both(script)
        assert not [a for a in rec["accumulating"] if a["kind"] == "reclaim"]
        [plan] = [a for a in rec["complete"] if a["kind"] == "reclaim"]
        assert plan["chips"] == 2 and plan["victims"]
        assert all(v["donor_borrowed"] >= v["chips"]
                   for v in plan["victims"])


def seed_busy(side, node, chips, uid):
    """tests/test_qos.py's ledger report: ``chips`` dispatching cards on
    ``node``."""
    side.s.ledger.record(node, [{
        "ctrkey": f"{uid}_{uid}", "chips": chips, "active": True,
        "oversubscribe": False, "chip_seconds": 1.0,
        "hbm_byte_seconds": 0.0, "throttled_seconds": 0.0,
        "oversub_spill_seconds": 0.0, "window_s": 2.0}])


class TestBackfillIdleInterlock:
    """tests/test_qos.py's quota backfill against measured idle duty: a
    best-effort backfill waits for idle cards the usage ledger reports;
    an unmeasured fleet, and other classes, pass."""

    @pytest.mark.parametrize("qos,busy,want", [
        ("best-effort", [(("n0", 4, "t0"), ("n1", 4, "t1")),
                         (("n1", 1, "t1"),)], [[], ["team-a/filler"]]),
        ("best-effort", [()], [["team-a/filler"]]),
        (None, [(("n0", 4, "t0"), ("n1", 4, "t1"))], [["team-a/filler"]]),
    ], ids=["needs_measured_idle", "unmeasured_fleet", "not_best_effort"])
    def test_the_interlock_matches_jax(self, qos, busy, want):
        def script(side):
            side.create(mkpod("ring-0", "team-a", queue="a",
                              extra_anns=GANG_ANNS))
            side.clock.advance(1)
            side.create(mkpod("filler", "team-a", chips=2, queue="a",
                              extra_anns={"vtpu.dev/qos": qos}
                              if qos else None))
            admitted = []
            for reports in busy:
                for node, chips, uid in reports:
                    seed_busy(side, node, chips, uid)
                admitted.append([a["pod"] for a in side.s.admission.tick()
                                 if a["kind"] == "admit"])
            return {"admitted": admitted, **observed(side)}

        rec, _ = run_both(script, queues=(dict(QA, quota={"chips": 8}),),
                          nodes=2, chips=4)
        assert rec["admitted"] == want


class TestReclaimRescuerInterplay:
    def test_reclaim_skips_victims_already_being_rescued(self):
        def script(side):
            pods = list(side.create(*(mkpod(f"a{i}", "team-a", queue="a")
                                      for i in range(2))))
            side.s.admission.tick()
            nodes = [side.place(p) for p in pods]
            usage = side.held_usage()
            chip = side.s.pods.get("uid-a1").devices[0][0].uuid
            side.s.quarantine.quarantine(nodes[1], chip, "flap")
            side.s.rescuer.sweep()
            pending = sorted(side.s.rescuer.pending())
            rescue = side.anns("team-a", "a1")[PREEMPT_ANNOTATION]
            list(side.create(mkpod("b0", "team-b", queue="b")))
            side.clock.advance(1)
            acts = side.s.admission.tick()
            after = side.anns("team-a", "a1")[PREEMPT_ANNOTATION]
            side.s.rescuer.sweep()
            return {"usage0": usage, "pending": pending,
                    "rescue": rescue.split(":")[0], "acts": acts,
                    "after": after == rescue,
                    "a0": side.s.pods.get("uid-a0") is not None,
                    **observed(side)}

        rec, _ = run_both(script, queues=(dict(QA, quota={"chips": 2},
                                               borrow_limit_chips=2), QB),
                          nodes=1, chips=4)
        assert rec["usage0"]["a"] == 4
        assert "uid-a1" in rec["pending"] and rec["rescue"] == "rescue"
        recl = [a for a in rec["acts"] if a["kind"] == "reclaim"]
        assert len(recl) == 1
        assert [v["pod"] for v in recl[0]["victims"]] == ["team-a/a0"]
        assert rec["after"] and rec["a0"]


# ---------------------------------------------------------------------------
# scheduling-protocol invariant with the admission loop on
# ---------------------------------------------------------------------------

class TestConcurrency:
    def test_zero_double_booking_with_admission_loop_on(self):
        """Threads race the admission tick against Filter and Bind on the
        port (the order is the threads', so the two packages are held to
        the same invariants, not to one sequence)."""
        from k8s_vgpu_scheduler_tpu_torch.cmd.simulate import \
            overbooked_chips

        qa = dict(QA, quota={"chips": 4}, borrow_limit_chips=0)
        qb = dict(QB, quota={"chips": 4}, borrow_limit_chips=0)
        side = Side(True, queues=(qa, qb))
        s, kube, names = side.s, side.kube, side.names
        pods = []
        for i in range(4):
            pods.append(mkpod(f"a{i}", "team-a", chips=1, queue="a"))
            pods.append(mkpod(f"b{i}", "team-b", chips=1, queue="b"))
        for p in pods:
            kube.create_pod(p)
        stop = threading.Event()

        def admission_churn():
            while not stop.is_set():
                s.admission.tick()

        t = threading.Thread(target=admission_churn, daemon=True)
        t.start()
        placed, errors = [], []

        def filter_one(pod):
            for _ in range(200):
                r = s.filter(pod, names)
                if r.node:
                    ns = pod["metadata"]["namespace"]
                    s.bind(ns, pod["metadata"]["name"],
                           pod["metadata"]["uid"], r.node)
                    tlock.release_node(kube, r.node)
                    placed.append(pod["metadata"]["name"])
                    return
            errors.append(pod["metadata"]["name"])

        threads = [threading.Thread(target=filter_one, args=(p,))
                   for p in pods]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
        stop.set()
        t.join(timeout=5)
        side.close()
        assert overbooked_chips(s) == []
        assert sorted(placed) == sorted(p["metadata"]["name"] for p in pods)
        assert not errors


# ---------------------------------------------------------------------------
# usage accounting from the registry aggregates
# ---------------------------------------------------------------------------

class TestUsageSnapshot:
    def test_usage_from_counts_race_window_grant_exactly_once(self):
        out = {}
        for port in (True, False):
            qm = tq if port else jq
            mgr = qm.QuotaManager([qm.QueueConfig(
                name="a", namespaces=("team-a",), nominal_chips=4)])
            reg = (TPods if port else JPods)()
            reg.add_pod(pod_info(
                port, uid="placed", name="p0", namespace="team-a",
                node="n0", devices=[[cd(port, "c0", "h100", 100, 0),
                                     cd(port, "c1", "h100", 100, 0)]]))
            mgr._entries["racing"] = qm.QueueEntry(
                uid="racing", name="p1", namespace="team-a", queue="a",
                chips=2, mem_mib=100, state=qm.STATE_ADMITTED)
            ns_usage, granted = reg.ns_usage_snapshot(["racing", "placed"])
            reg.add_pod(pod_info(
                port, uid="racing", name="p1", namespace="team-a",
                node="n1", devices=[[cd(port, "c0", "h100", 50, 0),
                                     cd(port, "c1", "h100", 50, 0)]]))
            u = mgr.usage_from(ns_usage, granted.__contains__)
            live = mgr.usage_from(ns_usage,
                                  lambda uid: reg.get(uid) is not None)
            out[port] = (ns_usage, granted, u["a"].chips, live["a"].chips)
        assert out[True] == out[False] == (
            {"team-a": (2, 200)}, {"placed"}, 4, 2)


# ---------------------------------------------------------------------------
# observability surfaces
# ---------------------------------------------------------------------------

def queue_families(side) -> dict:
    """The five queue families of the side's exporter, parsed."""
    from prometheus_client import CollectorRegistry, generate_latest
    from prometheus_client.parser import text_string_to_metric_families
    from prometheus_client.registry import Collector

    if side.port:
        text = exposition.render(tmetrics.ClusterCollector(side.s).collect())
    else:
        collector = jmetrics.ClusterCollector(side.s)

        class _C(Collector):
            def collect(self):
                return collector.collect()

        registry = CollectorRegistry()
        registry.register(_C())
        text = generate_latest(registry).decode()
    return {f.name: (f.documentation, f.type,
                     sorted((s.name, tuple(sorted(s.labels.items())),
                             s.value) for s in f.samples))
            for f in text_string_to_metric_families(text)
            if f.name in QUEUE_FAMILIES}, text


class TestObservability:
    def test_metrics_exporter_emits_queue_families(self):
        def script(side):
            list(side.create(*(mkpod(f"a{i}", "team-a", queue="a")
                               for i in range(5))))
            side.s.admission.tick()
            fams, _ = queue_families(side)
            return fams

        rec, side = run_both(script)
        assert set(rec) == set(QUEUE_FAMILIES)
        _, text = queue_families(side)
        assert 'vtpu_queue_pending{queue="a"} 1' in text
        assert 'vtpu_queue_admitted_total{queue="a"} 4' in text
        assert 'vtpu_queue_fair_share{queue="a"}' in text
        assert 'vtpu_borrowed_chips{queue="a"} 2' in text
        assert "vtpu_reclaims_total 0" in text

    def test_metrics_count_a_reclaim(self):
        def script(side):
            borrowed_fleet(side)
            list(side.create(mkpod("b0", "team-b", queue="b")))
            side.clock.advance(1)
            side.s.admission.tick()
            return queue_families(side)[0]

        rec, _ = run_both(script)
        assert rec["vtpu_reclaims"][2] == [("vtpu_reclaims_total", (), 1.0)]

    def test_queuez_export_shape(self):
        def script(side):
            list(side.create(*(mkpod(f"a{i}", "team-a", queue="a")
                               for i in range(4))))
            side.s.admission.tick()
            return side.queues()

        out, _ = run_both(script)
        assert out["enabled"] and out["fair_share_order"]
        rows = {r["queue"]: r for r in out["queues"]}
        assert rows["a"]["nominal_chips"] == 6
        assert rows["a"]["held_chips"] == 8
        assert rows["a"]["borrowed_chips"] == 2
        assert rows["b"]["pending"] == 0

    def test_queuez_over_http(self):
        side = Side(True)
        server = ExtenderServer(side.s, side.cfg, host="127.0.0.1", port=0)
        server.start()
        try:
            list(side.create(*(mkpod(f"a{i}", "team-a", queue="a")
                               for i in range(5))))
            side.s.admission.tick()
            url = f"http://127.0.0.1:{server.port}/queuez"
            with urllib.request.urlopen(url, timeout=10) as r:
                doc = json.load(r)
            assert doc == json.loads(json.dumps(side.queues()))
            assert doc["queues"][0]["pending_pods"] == [
                {"pod": "team-a/a4", "position": 1, "chips": 2,
                 "gang": None}]
            # The report's own fetch reads it, and joins it.
            assert treport.fetch_queues(
                f"http://127.0.0.1:{server.port}")["enabled"]
        finally:
            server.stop()
            side.close()

    def test_vtpu_report_joins_quota_columns(self):
        def make():
            export = {"window_s": 300.0, "fleet": {},
                      "namespaces": [{"namespace": "team-a", "pods": 2,
                                      "chip_seconds": 100.0,
                                      "hbm_byte_seconds": 0.0,
                                      "granted_chip_seconds": 200.0,
                                      "efficiency": 0.5, "idle_grants": 0}],
                      "pods": [], "idle_grants": []}
            queues = {"enabled": True, "queues": [
                {"queue": "a", "cohort": "m", "weight": 3.0,
                 "nominal_chips": 6, "held_chips": 8, "borrowed_chips": 2,
                 "pending": 1, "fair_share": 0.44,
                 "namespaces": ["team-a"]}]}
            return export, queues

        got = treport.join_quota(*make())
        want = jreport.join_quota(*make())
        assert got == want
        row = got["namespaces"][0]
        assert row["queue"] == "a" and row["nominal_chips"] == 6
        assert row["held_chips"] == 8 and row["borrowed_chips"] == 2
        assert treport.NAMESPACE_COLUMNS == jreport.NAMESPACE_COLUMNS
        csv_text = treport.to_csv(got["namespaces"],
                                  treport.NAMESPACE_COLUMNS)
        assert csv_text == jreport.to_csv(want["namespaces"],
                                          jreport.NAMESPACE_COLUMNS)
        assert "nominal_chips" in csv_text.splitlines()[0]
        text = treport.format_report(got)
        assert text == jreport.format_report(want)
        assert "capacity queues" in text and "OVER" in text

    def test_report_from_live_queuez_matches_jax(self):
        """The report's quota columns and queue table from each side's own
        ``/queuez`` and showback after a reclaim."""
        def script(side):
            borrowed_fleet(side)
            list(side.create(mkpod("b0", "team-b", queue="b")))
            side.clock.advance(1)
            side.s.admission.tick()
            rep = treport if side.port else jreport
            export = rep.join_quota(side.s.export_usage(), side.queues())
            return {"csv": rep.to_csv(export["namespaces"],
                                      rep.NAMESPACE_COLUMNS),
                    "queues": export["queues"]}

        rec, _ = run_both(script)
        assert "team-a" in rec["csv"] and ",a,6,8,2" in rec["csv"]


def test_scheduler_flags_build_the_quota_config(tmp_path):
    """vgpu-scheduler's quota flags land in Config as the JAX daemon's
    do."""
    path = tmp_path / "quota.json"
    path.write_text(json.dumps({"queues": [QA, QB]}))
    argv = [f"--quota-config={path}", "--fair-share-usage-informed",
            "--admission-interval=0.5", "--queue-reclaim-grace=2",
            "--queue-fleet-headroom=2.5", "--no-reclaim"]
    cfg = tcmd.build_config(tcmd.parse_args(argv))
    jargs = jcmd.parse_args(argv)
    assert cfg.quota_queues == jcmd.load_quota_config(str(path)) == (QA, QB)
    for field, jfield in (("fair_share_usage_informed",
                           "fair_share_usage_informed"),
                          ("admission_interval_s", "admission_interval"),
                          ("queue_reclaim_grace_s", "queue_reclaim_grace"),
                          ("queue_fleet_headroom", "queue_fleet_headroom")):
        assert getattr(cfg, field) == getattr(jargs, jfield)
    assert cfg.enable_reclaim is False and jargs.no_reclaim is True
    default = tcmd.build_config(tcmd.parse_args([]))
    assert default.quota_queues == () and default.enable_reclaim
    s = TScheduler(TKube(), cfg)
    assert s.admission.cfg.fleet_headroom == 2.5
    assert s.admission.cfg.reclaim is False and s.quota.enabled


def test_the_card_quota_leg_on_the_mock_nvml(tmp_path, monkeypatch):
    """chip_smoke's quota leg on the CPU: phase_preempt's control plane on
    the mock NVML with the leg's queues, V' holding its grant as in the
    phase, and B's pod stood in for by a child that reads its own
    downward-API file once after its first loop.  Every check of the leg
    runs (the queues, /metrics and vgpu-report agreeing at each step,
    the reclaim on B, E placed with its own MiB), and the sweeps of
    ``end`` find V' alone.  The capacity view runs with it: /capacityz
    held to /queuez, /metrics and vgpu-report at each step, then the
    horizon clamp, the 400s and the captured replay."""
    import os
    import time

    import chip_smoke
    from k8s_vgpu_scheduler_tpu_torch.ops import _kernels
    from k8s_vgpu_scheduler_tpu_torch.shim.preempt import PreemptionWatch

    class Child:
        def __init__(self, name, tmp, label=None, region=None, **grant):
            assert name == "quota_pod" and region
            self.grant = grant

        def run(self, record, section, on_line):
            watch = PreemptionWatch(self.grant["VTPU_PODINFO_ANNOTATIONS"])
            assert not watch.requested()
            on_line("LOOP 1")
            assert watch.requested()
            now = time.monotonic()
            return dict(loops=1, requester=watch.requester(),
                        stop_seen_t=now, interposer={}, exit_t=now)

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
    try:
        name, uid, mib, prio, anns = chip_smoke.PREEMPT_PODS["V2"]
        created, out = chip_smoke.admit_pod(
            plane.base, plane, chip_smoke.user_pod(name, uid, mib, prio))
        assert not any("queue" in op["path"] for op in out["patch"])
        chip_smoke.place_pod(plane.base, created, chip_smoke.PLUGIN_NODE,
                             out)
        plane.call("allocate")
        leg = chip_smoke.quota_leg(plane, plane.ready["uuid"],
                                   tmp_path / "volumes", tmp_path, [])
        ended = plane.call("end")
    finally:
        rc = plane.close()
    assert rc == 0
    assert [v["uid"] for v in leg["reclaim"]["victims"]] == ["uidQB"]
    assert set(leg["queuez"]) == {"b_held", "b_placed", "reclaim",
                                  "e_released", "e_placed"}
    assert leg["queuez"]["e_placed"]["reclaims_total"] == 1
    # The capacity view at each step (queue_view) and once at the end.
    assert set(leg["capacity_steps"]) == set(leg["queuez"])
    assert leg["capacity_steps"]["b_held"]["demand"] == {
        "team-a": 1.0, "team-b": 0.0, "team-g": 0.0}
    assert leg["capacity_steps"]["reclaim"]["demand"] == {
        "team-a": 1.0, "team-b": 1.0, "team-g": 0.0}
    cap = leg["capacity"]
    assert cap["clamp_horizon_s"] == 1440.0
    assert cap["refused"] == {"nan": 400, "0": 400}
    assert cap["replay"]["streams"] == 3
    assert cap["replay"]["verdict"]["no_overbooking"]
    assert ended["held"] == [["uidPV2", "trainer-2"]]


# -- active replicas: one admission leader ------------------------------------------

SHARD_QUEUE = {"name": "qa", "namespaces": ["team-a"], "weight": 1,
               "quota": {"chips": 4}}


def admission_leader(pkg):
    """Three replicas over one apiserver: which replicas' admission ticks
    act on a held pod (only the elected leader's), then the same after
    the leader is killed (the election moves with the epoch)."""
    from tests.test_torch_shard import kill_and_settle, make_fleet

    kube, reps, names, clock = make_fleet(
        pkg, n_rep=3, quota_queues=(SHARD_QUEUE,), queue_reclaim_grace_s=0.0)
    try:
        def hold(name):
            pod = pkg.pod(name, f"{name}-u", mem="2000")
            pod["metadata"]["namespace"] = "team-a"
            kube.create_pod(pod)
            for s in live:
                r = s.filter(pod, names)
                assert r.node is None and "queue" in r.error

        live = list(reps)
        hold("first")
        first = [s.shards.replica for s in live if s.admission.tick()]
        leader = next(s for s in reps if s.shards.replica == first[0])
        live = kill_and_settle(reps, clock, leader)
        hold("second")
        second = [s.shards.replica for s in live if s.admission.tick()]
        return dict(first=first, second=second,
                    leads=[s.shards.leads("quota-admission") for s in live])
    finally:
        for s in reps:
            s.close()


def test_one_replica_admits_and_the_lead_moves_with_the_epoch():
    """The admission loop's leader gate (``shards.leads``) on both
    packages: one replica releases, and after its death one survivor."""
    from tests.test_torch_shard import PKGS, SIDES

    got = {side: admission_leader(PKGS[side]) for side in SIDES}
    assert got["port"] == got["jax"], got
    assert len(got["port"]["first"]) == len(got["port"]["second"]) == 1
    assert got["port"]["first"] != got["port"]["second"]
    assert got["port"]["leads"].count(True) == 1
