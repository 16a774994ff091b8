"""Scheduler core: the node and pod registries, Filter and Bind (the port's
copy of the reference's surface of the JAX package's ``scheduler/core.py``).

Reference: pkg/scheduler/scheduler.go (the Register stream handler
134–169, getNodesUsage 176–222, Filter 266–314, Bind 224–264).  Filter is
the extender's predicate: given a pod and candidate nodes, it picks the
best node, writes the device decision into the pod's annotations and
returns that node alone.  Bind takes the node lock, marks the allocating
phase and posts the Binding; the node agent's Allocate completes the
two-phase commit and releases the lock.

Each decision runs whole under one lock, as the JAX package's serial path
does (``Config.optimistic_commit=False``).  Of the JAX scheduler's
subsystems this one carries fleet health (``health/``: the node leases
Filter gates on, the card quarantine stripped from every usage, the
rescuer) and priority preemption (``preempt.py``): with
``Config.enable_preemption``, a pod that fits nowhere asks strictly
lower-priority pods to checkpoint and leave, and the requests are kept,
rescinded and rebuilt from the annotations as in the JAX scheduler.  With
``Config.quota_queues`` the capacity queues (``quota/``) gate Filter: a
pod of a governed namespace is held until the admission loop releases it
in fair-share order, and a starved in-quota queue reclaims borrowed grants
through the same eviction requests.  Each
register-stream message's usage counters go into the usage ledger
(``accounting/ledger.py``), which the granted-vs-actual join
(``grant_efficiency``, ``export_usage`` behind ``/usagez``), the
exporter, the rescuer's idle-grant flag and ``Config.score_by_actual``
read; the ``allocate`` span is rebuilt from the bind time and the
terminal bind phase the informer sees.  A
node's fabric (the ``TopologyDesc`` and card coordinates its agent
registers) places multi-card requests by the slice engine under the pod's
topology policy, and ``vtpu.dev/mesh`` pods by ``placement/mesh.py``.  A
pod group (``vtpu.dev/pod-group``) is placed all or none by ``gang.py``:
its members wait for their quorum, are placed at once on one snapshot
with a rank each (``vtpu.dev/pod-group-rank``), keep their grants until
deletion, and are never preemption victims.  A pod that declares an
elastic mesh range (``vtpu.dev/mesh-min``/``-max``) is refused with an
error that names the slice that places it: it is never placed as though
it declared none.  This
module imports neither grpc nor protobuf: the register stream's messages
are read through their attributes, and only ``cmd/scheduler.py`` converts
at the gRPC edge.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..accounting import efficiency as eff_mod
from ..accounting.ledger import UsageLedger, decode_usage
from ..health.lease import LeaseConfig, LeaseState, LeaseTracker
from ..health.quarantine import ChipQuarantine, QuarantineConfig
from ..health.rescuer import RESCUE_VALUE_PREFIX, RescueConfig, Rescuer
from ..k8s.client import (
    Gone,
    KubeClient,
    NotFound,
    is_pod_terminated,
    pod_name,
    pod_namespace,
    pod_qos,
    pod_uid,
)
from ..quota.admission import AdmissionConfig, AdmissionLoop
from ..quota.queues import QuotaManager
from ..tpulib.types import TopologyDesc
from ..util import codec, trace
from ..util.config import Config
from ..util.nodelock import NodeLockError, lock_node, release_node
from ..util.protocol import bind_timestamp
from ..util.resources import container_requests, pod_priority
from ..util.types import (
    ASSIGNED_IDS_ANNOTATION,
    ASSIGNED_NODE_ANNOTATION,
    ASSIGNED_TIME_ANNOTATION,
    BIND_ALLOCATING,
    BIND_FAILED,
    BIND_PHASE_ANNOTATION,
    BIND_SUCCESS,
    BIND_TIME_ANNOTATION,
    GANG_RANK_ANNOTATION,
    MESH_MAX_ANNOTATION,
    MESH_MIN_ANNOTATION,
    QOS_ANNOTATION,
    QOS_BEST_EFFORT,
    QOS_DUTY_SPLIT_ANNOTATION,
    TO_ALLOCATE_ANNOTATION,
)
from . import score as score_mod
from .gang import (
    GangConflictError,
    GangManager,
    GangMember,
    gang_of,
    place_gang,
)
from .nodes import DeviceInfo, NodeInfo, NodeManager
from .pods import PodInfo, PodManager
from .preempt import PREEMPT_ANNOTATION, PreemptionPlan, plan_preemption

log = logging.getLogger(__name__)

#: Annotations this scheduler refuses to place without, by the slice of
#: the port that places them.
UNPLACED_ANNOTATIONS = {
    MESH_MIN_ANNOTATION: "elastic mesh ranges are placed by the elastic "
                         "slice (ROADMAP A.5)",
    MESH_MAX_ANNOTATION: "elastic mesh ranges are placed by the elastic "
                         "slice (ROADMAP A.5)",
}

#: Filter's error when no candidate fits: the case preemption plans for.
NO_FIT = "no node fits GPU request"


class FilterResult:
    def __init__(self, node: Optional[str] = None,
                 failed: Optional[Dict[str, str]] = None,
                 error: str = "",
                 preempt: Optional[PreemptionPlan] = None) -> None:
        self.node = node
        self.failed = failed or {}
        self.error = error
        # A no-fit decision may carry an eviction plan: filter() writes
        # its requests outside the lock and the pod pends meanwhile.
        self.preempt = preempt


def decode_register_request(req) -> NodeInfo:
    """A RegisterRequest (any object with its fields) → NodeInfo, each
    card's fabric coordinates and the node's topology with it (an empty
    mesh: no topology)."""
    devices = [DeviceInfo(id=d.id, count=d.count, devmem=d.devmem,
                          type=d.type, health=d.health,
                          coords=tuple(d.coords), cores=d.cores or 100)
               for d in req.devices]
    topo = None
    if req.topology.mesh:
        topo = TopologyDesc(generation=req.topology.generation,
                            mesh=tuple(req.topology.mesh),
                            wraparound=tuple(req.topology.wraparound) or ())
    return NodeInfo(name=req.node, devices=devices, topology=topo)


class Scheduler:
    def __init__(self, client: KubeClient, cfg: Optional[Config] = None,
                 clock=None) -> None:
        self.client = client
        self.cfg = cfg or Config()
        self._clock = clock or time.monotonic
        self.nodes = NodeManager()
        self.pods = PodManager()
        # Pod groups on wall time (GangManager's own clock, as in the JAX
        # scheduler); tests set ``gangs._now``.
        self.gangs = GangManager()
        # ``clock`` (time.monotonic by default) drives the leases, the
        # quarantine and the rescuer, so tests age them without sleeping.
        self.leases = LeaseTracker(
            LeaseConfig(ttl_s=self.cfg.lease_ttl_s,
                        grace_beats=self.cfg.lease_grace_beats),
            clock=clock)
        self.quarantine = ChipQuarantine(
            QuarantineConfig(
                flap_threshold=self.cfg.quarantine_flap_threshold,
                flap_window_s=self.cfg.quarantine_flap_window_s,
                probation_s=self.cfg.quarantine_probation_s),
            clock=clock)
        # vgpu-scheduler starts the rescue thread; embedders and tests
        # call rescuer.sweep() themselves.
        self.rescuer = Rescuer(
            self,
            RescueConfig(
                interval_s=self.cfg.rescue_interval_s,
                checkpoint_grace_s=self.cfg.rescue_checkpoint_grace_s,
                lease_retention_s=self.cfg.lease_retention_s),
            clock=clock)
        # Capacity queues: inert (every namespace passes) without a quota
        # config.  vgpu-scheduler starts the admission thread; embedders
        # and tests call admission.tick() themselves.
        self.quota = QuotaManager(self.cfg.quota_queues, clock=clock)
        self.admission = AdmissionLoop(
            self,
            AdmissionConfig(
                interval_s=self.cfg.admission_interval_s,
                reclaim_grace_s=self.cfg.queue_reclaim_grace_s,
                usage_informed=self.cfg.fair_share_usage_informed,
                backfill=self.cfg.enable_queue_backfill,
                reclaim=self.cfg.enable_reclaim,
                fleet_headroom=self.cfg.queue_fleet_headroom),
            clock=clock)
        # Held for a whole decision: candidate evaluation and the
        # tentative grant, never across apiserver I/O.
        self._lock = threading.Lock()
        # uid -> monotonic time of its DELETE.  A uid never returns, so a
        # replayed ADDED of one (a resync list older than the delete) is
        # ignored, or it would book a dead pod's cards again.
        self._deleted_uids: Dict[str, float] = {}
        self._deleted_lock = threading.Lock()
        self._deleted_horizon_s = 900.0
        self._deleted_pruned_at = 0.0
        # victim uid -> monotonic time of its last eviction request: the
        # pending pod is Filtered again every cycle while its victims
        # checkpoint, and the request is not written again within
        # PREEMPT_REASK_S.
        self._preempt_requested: Dict[str, float] = {}
        # requester uid -> {victim uid: (namespace, name)}, to rescind the
        # requests when the requester is placed or deleted.
        self._preempt_by_requester: Dict[str, Dict[str, Tuple[str, str]]] \
            = {}
        self._preempt_lock = threading.Lock()
        #: Eviction requests written since the start.
        self.preemptions_requested = 0
        # Usage accounting: per-pod actual-usage accounts fed by the
        # counters each node agent's register stream carries, and the
        # granted-vs-actual join /metrics, /usagez, the idle-grant flag
        # and --score-by-actual read.
        self.ledger = UsageLedger(clock=clock,
                                  retention_s=self.cfg.usage_retention_s)
        self.efficiency_cfg = eff_mod.EfficiencyConfig(
            window_s=self.cfg.efficiency_window_s,
            idle_grace_s=self.cfg.idle_grant_grace_s)
        # uids whose allocate span was recorded (once each).
        self._alloc_traced: set = set()
        self._alloc_traced_lock = threading.Lock()

    #: Seconds before a victim's eviction request is written again, and
    #: the age past which a request is forgotten once more than
    #: PREEMPT_CAP are held.
    PREEMPT_REASK_S = 30.0
    PREEMPT_FORGET_S = 300.0
    PREEMPT_CAP = 4096

    # -- register stream (gRPC DeviceService.Register) -------------------------
    def observe_registration(self, node_name: str, info: NodeInfo,
                             usage=None) -> None:
        """One register-stream message: a lease beat, a health reading of
        each card for the quarantine, the usage counters it carries
        (USAGE_FIELDS rows) for the ledger, and the inventory where it
        changed."""
        self.leases.beat(node_name)
        self.quarantine.observe_node(
            node_name, {d.id: d.health for d in info.devices})
        if usage:
            self.ledger.record(node_name, usage)
        if not self.nodes.same_inventory(node_name, info):
            self.nodes.add_node(node_name, info)
            log.info("registered node %s with %d cards", node_name,
                     len(info.devices))

    def handle_register_stream(self, request_iterator, context=None) -> str:
        """Consume one node agent's stream; when it ends, drop the node
        (reference Register, scheduler.go:134–169).  The node's lease is
        kept: an agent reconnects within seconds, and a blip must not
        read as a dead node."""
        node_name = ""
        try:
            for req in request_iterator:
                node_name = req.node
                self.observe_registration(node_name,
                                          decode_register_request(req),
                                          usage=decode_usage(req.usage))
        finally:
            if node_name:
                log.warning("register stream for %s closed; dropping node",
                            node_name)
                self.nodes.rm_node(node_name)
        return node_name

    # -- pod informer ----------------------------------------------------------
    def _note_deleted(self, uid: str) -> None:
        """Tombstone a deleted uid.  Tombstones past the horizon are pruned
        at most once a minute: a scan on every DELETE would make a
        completion storm quadratic."""
        now = time.monotonic()
        with self._deleted_lock:
            if now - self._deleted_pruned_at >= 60.0:
                self._deleted_pruned_at = now
                cutoff = now - self._deleted_horizon_s
                for u in [u for u, t in self._deleted_uids.items()
                          if t < cutoff]:
                    del self._deleted_uids[u]
            self._deleted_uids[uid] = now

    def _deleted(self, uid: str) -> bool:
        with self._deleted_lock:
            return uid in self._deleted_uids

    def on_pod_event(self, event: str, pod: dict) -> None:
        """Rebuild the grants from the pods' ``assigned-ids`` (reference
        onAddPod, scheduler.go:66–86): free a deleted or finished pod's,
        and ignore an ADDED replayed after its DELETE."""
        uid = pod_uid(pod)
        if not uid:
            return
        if self.quota.enabled:
            # Deletes and placements leave the queues; after a restart the
            # held and admitted pods are learned from their annotations.
            self.quota.observe_pod(
                event, pod,
                requests_fn=lambda p: container_requests(p, self.cfg))
        anns = pod.get("metadata", {}).get("annotations", {}) or {}
        node = anns.get(ASSIGNED_NODE_ANNOTATION, "")
        phase = anns.get(BIND_PHASE_ANNOTATION, "")
        if event != "DELETED" and phase in (BIND_SUCCESS, BIND_FAILED):
            # The node agent's half of the two-phase commit completed.
            self._trace_allocate(uid, pod, anns, phase)
        if event == "DELETED" or is_pod_terminated(pod):
            self.gangs.drop_member(uid)
            if self.pods.get(uid) is not None and not self._deleted(uid):
                trace.tracer().event(uid, "deleted", trace_id=anns.get(
                    trace.TRACE_ID_ANNOTATION, ""), pod=pod_name(pod),
                    event=event)
            self._note_deleted(uid)
            # A deleted requester's victims need not checkpoint.
            if self._preempt_by_requester.get(uid):
                self._rescind_preemptions(uid)
            self.pods.del_pod(uid)
            return
        if not node:
            # A gang member between its admission and its own decision
            # write holds a grant without ``assigned-node``: an event or a
            # resync must not free it, or other pods take the gang's cards.
            if not self.gangs.is_reserved(uid):
                self.pods.del_pod(uid)
            return
        if event == "ADDED" and self._deleted(uid):
            return
        encoded = anns.get(ASSIGNED_IDS_ANNOTATION, "")
        if not encoded:
            return
        if self.nodes.get_node(node) is None and \
                self.leases.state_of(node) is LeaseState.DEAD:
            # A grant on a node whose inventory is gone and whose lease
            # has expired: adding it would book cards nobody can account
            # for.  The rescuer clears the decision so the pod reschedules.
            # (A node with no lease stays on the add path: at boot the
            # agents have not connected yet.)
            self.pods.del_pod(uid)
            self.rescuer.enqueue(uid, "node-dead",
                                 namespace=pod_namespace(pod),
                                 name=pod_name(pod), node=node)
            return
        try:
            devices = codec.decode_pod_devices(encoded)
        except codec.CodecError as e:
            log.error("pod %s has a malformed %s: %s", pod_name(pod),
                      ASSIGNED_IDS_ANNOTATION, e)
            return
        try:
            prio = pod_priority(pod, self.cfg)
        except Exception:  # noqa: BLE001 — a priority never blocks the rebuild
            prio = 0
        info = PodInfo(uid=uid, name=pod_name(pod),
                       namespace=pod_namespace(pod), node=node,
                       devices=devices, priority=prio,
                       trace_id=anns.get(trace.TRACE_ID_ANNOTATION, ""),
                       qos=pod_qos(pod))
        # Usually the echo of this scheduler's own decision write.
        if not self.pods.refresh_if_unchanged(info):
            self.pods.add_pod(info)
        if event == "ADDED" and self._deleted(uid):
            # A DELETE that landed between the check above and the add.
            self.pods.del_pod(uid)

    def _trace_allocate(self, uid: str, pod: dict, anns: Dict[str, str],
                        phase: str) -> None:
        """The ``allocate`` span, rebuilt from the bind-time annotation and
        the arrival of the terminal bind phase: the scheduler's record of
        the node agent's Allocate.  Once a uid; a replay older than 300 s
        (a restart re-listing long-bound pods) goes to the journal alone,
        so it cannot pollute the latency histogram."""
        with self._alloc_traced_lock:
            if uid in self._alloc_traced:
                return
            if len(self._alloc_traced) > 8192:
                self._alloc_traced.clear()
            self._alloc_traced.add(uid)
        tid = anns.get(trace.TRACE_ID_ANNOTATION, "")
        node = anns.get(ASSIGNED_NODE_ANNOTATION, "")
        end = time.time()
        try:
            start = int(anns.get(BIND_TIME_ANNOTATION, "0")) / 1e9
        except ValueError:
            start = 0.0
        extra: Dict[str, object] = {}
        if 0.0 < start <= end and end - start < 300.0:
            trace.tracer().record("allocate", tid, start, end,
                                  pod=pod_name(pod), node=node,
                                  phase=phase, qos=pod_qos(pod))
        elif start > 0.0:
            extra = {"histogram": "dropped-stale",
                     "duration_s": round(end - start, 3)}
        trace.tracer().event(uid, f"allocate-{phase}", trace_id=tid,
                             pod=pod_name(pod), node=node, **extra)

    def resync_from_apiserver(self) -> str:
        """Full reconcile: apply every listed pod and prune the grants of
        pods no longer listed.  Returns the list's resourceVersion, where
        :func:`run_watch_loop` resumes.  A grant recorded after the list
        began is kept unless a point read says its pod is gone (the list
        may simply predate it)."""
        list_started = time.monotonic()
        try:
            pods, rv = self.client.list_pods_with_rv()
        except NotImplementedError:
            pods, rv = self.client.list_pods(), "0"
        for pod in pods:
            self.on_pod_event("ADDED", pod)
        alive = {pod_uid(p) for p in pods}
        for info in self.pods.list_pods():
            if info.uid in alive:
                continue
            if info.touched_at >= list_started:
                try:
                    cur = self.client.get_pod(info.namespace, info.name)
                    if pod_uid(cur) == info.uid:
                        continue
                except NotFound:
                    pass
                except Exception:  # noqa: BLE001 — kept; the next pass retries
                    continue
            # No tombstone: the list may only be stale about a live pod.
            self.gangs.drop_member(info.uid, tombstone=False)
            self.pods.del_pod(info.uid)
        self._reconcile_preemptions(pods)
        return rv

    def _reconcile_preemptions(self, pods: List[dict]) -> None:
        """The annotations are the preemption ledger's log: after a
        restart the requester -> victims map is empty but the victims'
        annotations remain.  Rebuild the map from the list, and rescind
        each request whose requester is gone or already placed."""
        by_uid = {pod_uid(p): p for p in pods}
        for pod in pods:
            anns = pod.get("metadata", {}).get("annotations", {}) or {}
            requester = anns.get(PREEMPT_ANNOTATION)
            if not requester or requester.startswith(RESCUE_VALUE_PREFIX):
                # A rescue request's grace and rescission are the
                # rescuer's.
                continue
            req_pod = by_uid.get(requester)
            still_pending = (
                req_pod is not None and not is_pod_terminated(req_pod)
                and not (req_pod.get("metadata", {}).get("annotations")
                         or {}).get(ASSIGNED_NODE_ANNOTATION))
            if still_pending:
                with self._preempt_lock:
                    self._preempt_by_requester.setdefault(
                        requester, {})[pod_uid(pod)] = (
                            pod_namespace(pod), pod_name(pod))
                continue
            try:
                self.client.patch_pod_annotations(
                    pod_namespace(pod), pod_name(pod),
                    {PREEMPT_ANNOTATION: ""})
                log.info("resync: rescinded stale preemption on %s "
                         "(requester %s gone or placed)", pod_name(pod),
                         requester)
            except Exception as e:  # noqa: BLE001 — the next resync retries
                log.info("resync: stale-preemption rescission for %s not "
                         "written (%s)", pod_name(pod), e)

    # -- usage -----------------------------------------------------------------
    def _usage(self, name: str, info: NodeInfo
               ) -> Dict[str, score_mod.DeviceUsage]:
        """``name``'s inventory less its grants, built fresh, with its
        quarantined cards left out: no fit can place on a card it cannot
        see."""
        usage = score_mod.build_usage(info, self.pods.pods_on_node(name))
        quarantined = self.quarantine.quarantined_on(name)
        if quarantined:
            usage = {cid: u for cid, u in usage.items()
                     if cid not in quarantined}
        return usage

    def get_nodes_usage(self, node_names: Optional[List[str]] = None
                        ) -> Dict[str, Tuple[NodeInfo,
                                             Dict[str, score_mod.DeviceUsage]]]:
        """Each registered node's inventory less its grants and its
        quarantined cards (reference getNodesUsage), built fresh: the
        caller owns the maps."""
        allow = None if node_names is None else set(node_names)
        return {name: (info, self._usage(name, info))
                for name, info in self.nodes.list_nodes().items()
                if allow is None or name in allow}

    def inspect_all_nodes_usage(self) -> Dict[str, Dict[str,
                                                      score_mod.DeviceUsage]]:
        """For the metrics collector: each registered node's card usage,
        built fresh (the caller owns the maps), off the decision lock."""
        return {name: usage
                for name, (_, usage) in self.get_nodes_usage().items()}

    def grant_efficiency(self, now: Optional[float] = None
                         ) -> "eff_mod.FleetEfficiency":
        """The granted-vs-actual join of the live registry against the
        usage ledger, read by the exporter, the rescuer's idle-grant flag
        and /usagez; off the decision lock."""
        return eff_mod.grant_efficiency(
            self.pods.list_pods(), self.ledger, self.efficiency_cfg,
            now=now if now is not None else self._clock())

    def export_usage(self, window_s: Optional[float] = None) -> dict:
        """Per-namespace showback over a trailing window (``GET /usagez``
        → ``vgpu-report``)."""
        return eff_mod.showback(self.pods.list_pods(), self.ledger,
                                self.efficiency_cfg,
                                now=self._clock(), window_s=window_s)

    def export_queues(self) -> dict:
        """Capacity-queue state (``GET /queuez``): each queue's quota,
        held and borrowed cards, fair share and pending pods with their
        positions, and the fair-share order; off the decision lock."""
        stats = self.quota.stats(self.pods.list_pods())
        stats["fair_share_order"] = [
            name for _s, name in sorted(
                (row["fair_share"], row["queue"])
                for row in stats["queues"])
        ]
        stats["enabled"] = self.quota.enabled
        return stats

    def known_topologies(self) -> List[TopologyDesc]:
        """The distinct fabrics registered in the fleet, one per shape and
        wraparound: the webhook's mesh-feasibility check reads them.  A
        node none of whose cards has coordinates has no fabric (what
        ``NvmlBackend`` sends without an all-pairs NVLink matrix) and
        adds none: Filter refuses every mesh pod there.  The JAX
        scheduler lists its mesh."""
        seen = {}
        for info in self.nodes.list_nodes().values():
            t = info.topology
            if t is not None and any(d.coords for d in info.devices):
                seen[(t.mesh, t.wrap())] = t
        return list(seen.values())

    def export_fleet(self) -> dict:
        """Read-only fleet snapshot for capacity tooling (``GET /fleetz``
        → ``vgpu-simulate --from-cluster``): the node inventory with its
        fabric and every live grant, one consistent copy under the
        decision lock (no grant is recorded while the lists are taken) —
        enough to rebuild this scheduler's placement state elsewhere.  A
        node without a fabric goes out as it registered, ``mesh (n,)``
        with no card coordinates; a node with no topology as None."""
        with self._lock:
            nodes = [
                {
                    "name": name,
                    "generation": (info.topology.generation
                                   if info.topology else None),
                    "mesh": (list(info.topology.mesh)
                             if info.topology else None),
                    "wraparound": (list(info.topology.wraparound)
                                   if info.topology else None),
                    "chips": [
                        {"id": d.id, "type": d.type, "count": d.count,
                         "devmem": d.devmem, "health": d.health,
                         "coords": list(d.coords), "cores": d.cores}
                        for d in info.devices
                    ],
                }
                for name, info in self.nodes.list_nodes().items()
            ]
            pods = [
                {
                    "uid": p.uid, "name": p.name, "namespace": p.namespace,
                    "node": p.node, "priority": p.priority,
                    "devices": [
                        [{"uuid": d.uuid, "type": d.type,
                          "usedmem": d.usedmem, "usedcores": d.usedcores}
                         for d in container]
                        for container in p.devices
                    ],
                }
                for p in self.pods.list_pods()
            ]
        return {
            "nodes": nodes,
            "pods": pods,
            # The policies a replay must place under to answer for this
            # scheduler.
            "config": {
                "node_scheduler_policy": self.cfg.node_scheduler_policy,
                "topology_policy": self.cfg.topology_policy,
            },
        }

    def _pods_by_node(self) -> Dict[str, List[PodInfo]]:
        out: Dict[str, List[PodInfo]] = {}
        for info in self.pods.list_pods():
            out.setdefault(info.node, []).append(info)
        return out

    # -- Filter ----------------------------------------------------------------
    def filter(self, pod: dict, node_names: List[str]) -> FilterResult:
        """Decide under the lock, then write the decision outside it; the
        tentative grant is rolled back if the write fails.  The decision
        is the ``filter`` span, the write the ``decision-write`` span."""
        tid = trace.trace_id_of(pod)
        tr = trace.tracer()
        # The expiry sweep first, outside the lock (it reads the
        # apiserver).
        if self.gangs.groups():
            self._release_expired_gangs()
        with tr.span("filter", trace_id=tid, pod=pod_name(pod),
                     candidates=len(node_names), qos=pod_qos(pod)) as sp:
            result = self._decide(pod, node_names)
            if result.failed:
                # Each rejected node counts under its dominant token (the
                # reason's leading word keeps the label set bounded).
                for reason in result.failed.values():
                    tr.reject(reason.split(":", 1)[0].strip())
                sp.set("rejected_nodes", len(result.failed))
                sp.set("rejections", "; ".join(
                    f"{n}={r}" for n, r in
                    sorted(result.failed.items())[:8]))
            if result.error:
                sp.set("error", result.error)
            if result.node is not None:
                sp.set("node", result.node)
        uid = pod_uid(pod)
        if result.node is None:
            if result.error or result.failed:
                tr.event(uid, "filter-rejected", trace_id=tid,
                         pod=pod_name(pod), error=result.error,
                         preempting=result.preempt is not None)
            if result.failed:
                # A released governed pod that found no seat: the reclaim
                # trigger's signal (borrowers may hold its cards).
                self.quota.note_unplaced(uid)
            if result.preempt is not None:
                self._request_preemptions(pod, result.preempt)
            return result
        tr.event(uid, "filter-assigned", trace_id=tid, pod=pod_name(pod),
                 node=result.node)
        if self._preempt_by_requester.get(uid):
            # Placed after all (room freed elsewhere): its eviction
            # requests are pointless now.
            self._rescind_preemptions(uid)
        err = self._write_decision(pod, result)
        if err is None:
            return result
        self.pods.del_pod(uid)
        tr.event(uid, "decision-write-failed", trace_id=tid, error=err)
        return FilterResult(error=err)

    def _decide(self, pod: dict, node_names: List[str]) -> FilterResult:
        try:
            requests = container_requests(pod, self.cfg)
        except ValueError as e:
            return FilterResult(error=f"bad resource request: {e}")
        if not any(r.nums > 0 for r in requests):
            # Not ours: every candidate passes (the default scheduler
            # decides).
            return FilterResult()
        anns = pod.get("metadata", {}).get("annotations", {}) or {}
        for key, why in UNPLACED_ANNOTATIONS.items():
            if anns.get(key):
                return FilterResult(
                    error=f"{key} is not placed by this scheduler: {why}")
        # The capacity-queue gate, before any fit: a governed pod stays
        # held until the admission loop releases it.
        hold = self.quota.gate(pod, requests)
        if hold is not None:
            return FilterResult(error=hold)
        gang = gang_of(pod)
        if gang is not None:
            with self._lock:
                return self._decide_gang_locked(pod, requests, node_names,
                                                gang)
        with self._lock:
            result = self._decide_locked(pod, requests, node_names, anns)
        if result.node is None and result.error == NO_FIT:
            result.preempt = self._plan_preemption(pod, requests, anns,
                                                   node_names)
        return result

    def _plan_preemption(self, pod: dict, requests, anns: Dict[str, str],
                         node_names: List[str]
                         ) -> Optional[PreemptionPlan]:
        """The eviction plan for a pod that fits nowhere, off the lock
        (the planner is pure and may scan every node's pods).  Only the
        offered nodes that take placements count: room freed elsewhere is
        no use to the pod."""
        if not self.cfg.enable_preemption:
            return None
        # Gang members are never victims: evicting one hangs the rest of
        # its collective and frees a fraction of the gang's cards.
        gang_uids = {u for g in self.gangs.groups().values()
                     for u in (*g.members, *g.placements)}
        offered = set(node_names)
        entries = {name: (info, None)
                   for name, info in self.nodes.list_nodes().items()
                   if name in offered
                   and self.leases.reject_reason(name) is None}
        return plan_preemption(
            requests, pod_priority(pod, self.cfg), entries,
            self._pods_by_node(), anns, self.cfg.topology_policy,
            protected_uids=gang_uids,
            node_policy=self.cfg.node_scheduler_policy)

    def _request_preemptions(self, pod: dict, plan: PreemptionPlan) -> None:
        """Write the plan's eviction requests (apiserver writes, outside
        the lock).  A victim is asked again only after PREEMPT_REASK_S:
        it needs a while to checkpoint, and the pending pod is Filtered
        every cycle meanwhile."""
        now = time.monotonic()
        requester = pod_uid(pod)
        for v in plan.victims:
            with self._preempt_lock:
                if now - self._preempt_requested.get(v.uid, 0.0) \
                        < self.PREEMPT_REASK_S:
                    continue
                self._preempt_requested[v.uid] = now
                if len(self._preempt_requested) > self.PREEMPT_CAP:
                    for u in [u for u, t in self._preempt_requested.items()
                              if now - t > self.PREEMPT_FORGET_S]:
                        del self._preempt_requested[u]
            try:
                self.client.patch_pod_annotations(
                    v.namespace, v.name, {PREEMPT_ANNOTATION: requester})
            except Exception as e:  # noqa: BLE001 — the next cycle retries
                log.error("preemption request for %s failed: %s", v.name, e)
                with self._preempt_lock:
                    self._preempt_requested.pop(v.uid, None)
                continue
            with self._preempt_lock:
                self.preemptions_requested += 1
                self._preempt_by_requester.setdefault(
                    requester, {})[v.uid] = (v.namespace, v.name)
            tr = trace.tracer()
            tr.event(v.uid, "preempt-requested", namespace=v.namespace,
                     name=v.name, requester=requester,
                     requester_pod=pod_name(pod), node=plan.node)
            tr.event(requester, "preemption-planned",
                     namespace=pod_namespace(pod), name=pod_name(pod),
                     node=plan.node,
                     victims=[f"{x.namespace}/{x.name}"
                              for x in plan.victims])
            log.warning("preemption: asked %s/%s (prio %d) to checkpoint "
                        "and release %s for pod %s", v.namespace, v.name,
                        v.priority, plan.node, pod_name(pod))

    def _rescind_preemptions(self, requester_uid: str) -> None:
        """The requester no longer needs the room (placed, or deleted):
        clear its victims' requests to the empty value, which the
        in-container watch reads as none (a key deletion is not portable
        across patch types)."""
        with self._preempt_lock:
            victims = self._preempt_by_requester.pop(requester_uid, None)
        for vuid, (namespace, name) in (victims or {}).items():
            with self._preempt_lock:
                self._preempt_requested.pop(vuid, None)
            try:
                self.client.patch_pod_annotations(
                    namespace, name, {PREEMPT_ANNOTATION: ""})
            except Exception as e:  # noqa: BLE001 — the victim may be gone
                log.info("preemption rescission for %s/%s not written "
                         "(%s)", namespace, name, e)
                continue
            trace.tracer().event(vuid, "preempt-rescinded",
                                 namespace=namespace, name=name,
                                 requester=requester_uid)
            log.info("preemption rescinded for %s/%s (requester %s no "
                     "longer pending)", namespace, name, requester_uid)

    def _decide_locked(self, pod: dict, requests, node_names: List[str],
                       anns: Dict[str, str]) -> FilterResult:
        """Every candidate fitted on a copy of its usage; the highest
        score wins, the first of equals in the candidates' order."""
        uid = pod_uid(pod)
        self.pods.del_pod(uid)  # a retried Filter replaces its grant
        affinity = score_mod.parse_affinity(anns)
        failed: Dict[str, str] = {}
        best: Optional[Tuple[float, str, list]] = None
        for name in node_names:
            info = self.nodes.get_node(name)
            if info is None:
                failed[name] = "no GPU inventory registered"
                continue
            why = self.leases.reject_reason(name)
            if why is not None:
                failed[name] = why
                continue
            usage = self._usage(name, info)
            why = score_mod.type_excluded(affinity, usage)
            if why is not None:
                failed[name] = why
                continue
            reasons: Dict[str, str] = {}
            placement = score_mod.fit_pod(requests, usage, info.topology,
                                          anns, self.cfg.topology_policy,
                                          reasons)
            if placement is None:
                failed[name] = reasons.get("reason",
                                           "insufficient GPU capacity")
                continue
            s = score_mod.node_score(usage, self.cfg.node_scheduler_policy)
            if self.cfg.score_by_actual:
                s += eff_mod.actual_idle_bonus(self.ledger, name,
                                               len(usage))
            if best is None or s > best[0]:
                best = (s, name, placement)
        if best is None:
            return FilterResult(error=NO_FIT, failed=failed)
        _, node, placement = best
        # Recorded at once, so the next decision sees the grant.
        self.pods.add_pod(PodInfo(
            uid=uid, name=pod_name(pod), namespace=pod_namespace(pod),
            node=node, devices=placement,
            priority=pod_priority(pod, self.cfg),
            trace_id=trace.trace_id_of(pod), qos=pod_qos(pod)))
        return FilterResult(node=node, failed=failed)

    # -- gangs (gang.py) ---------------------------------------------------------
    def _decide_gang_locked(self, pod: dict, requests, node_names: List[str],
                            gang_key: Tuple[str, int]) -> FilterResult:
        """A member's Filter: registered with its group; refused while the
        group waits for its quorum; the quorum's member places the whole
        group atomically over the offered nodes whose leases are healthy
        and charges every member's grant at once; an admitted member gets
        its reserved node back."""
        group, total = gang_key
        uid = pod_uid(pod)
        try:
            g = self.gangs.observe(
                pod_namespace(pod), group, total,
                GangMember(uid=uid, name=pod_name(pod),
                           namespace=pod_namespace(pod), requests=requests,
                           annotations=pod.get("metadata", {}).get(
                               "annotations") or {}))
        except GangConflictError as e:
            # The admitted members' placements stay as they are.
            return FilterResult(error=str(e))

        if uid in g.placements:
            node, devices = g.placements[uid]
            if node_names and node not in node_names:
                return FilterResult(
                    error=f"gang {group}: reserved node {node} not offered")
            if self.pods.get(uid) is None:
                # The grant was lost (a failed decision write rolled it
                # back): restore it from the placement.
                self.pods.add_pod(PodInfo(
                    uid=uid, name=pod_name(pod),
                    namespace=pod_namespace(pod), node=node,
                    devices=devices, priority=pod_priority(pod, self.cfg),
                    trace_id=trace.trace_id_of(pod), qos=pod_qos(pod)))
            return FilterResult(node=node)

        if len(g.members) < g.total:
            # The barrier: kube-scheduler retries the early members.
            return FilterResult(
                error=f"gang {group} waiting ({len(g.members)}/{g.total})")

        offered = set(node_names) if node_names else None
        usage = {name: (info, self._usage(name, info))
                 for name, info in self.nodes.list_nodes().items()
                 if (offered is None or name in offered)
                 and self.leases.reject_reason(name) is None}
        # An admitted gang at its quorum again has replacements in freed
        # slots: only they are placed (the peers' grants are charged, and
        # a bound member's node never changes).
        missing = ([u for u in sorted(g.members) if u not in g.placements]
                   if g.placements else None)
        placements = place_gang(
            g, usage, score_mod.fit_pod,
            lambda u: score_mod.node_score(u, self.cfg.node_scheduler_policy),
            self.cfg.topology_policy, only_uids=missing)
        if placements is None:
            return FilterResult(
                error=f"gang {group}: no atomic placement for "
                      f"{g.total} members")
        g.placements.update(placements)
        g.assign_ranks(placements)
        # Every member's grant now, so no other Filter takes the reserved
        # cards while the members' retries come in.  The priority stays
        # PodInfo's default (the member's spec is not at hand): gang uids
        # are never preemption victims anyway.
        for member_uid, (node, devices) in placements.items():
            m = g.members[member_uid]
            self.pods.add_pod(PodInfo(
                uid=member_uid, name=m.name, namespace=m.namespace,
                node=node, devices=devices,
                trace_id=m.annotations.get(trace.TRACE_ID_ANNOTATION, ""),
                qos=m.annotations.get(QOS_ANNOTATION, "") or ""))
        log.info("gang %s admitted: %s", group,
                 {u: n for u, (n, _) in placements.items()})
        node, _ = g.placements[uid]
        return FilterResult(node=node)

    def _release_expired_gangs(self) -> None:
        """Free the tentative grants of groups without progress, but never
        a member's that already bound (its pod carries a bind phase).
        Outside the decision lock: each member is read from the
        apiserver, and a transient error keeps its grant and the group for
        the next sweep."""
        for g in self.gangs.expired():
            unresolved = False
            for member_uid in list(g.placements):
                if self.pods.get(member_uid) is None:
                    continue
                m = g.members[member_uid]
                try:
                    p = self.client.get_pod(m.namespace, m.name)
                    anns = p.get("metadata", {}).get("annotations") or {}
                    release = not anns.get(BIND_PHASE_ANNOTATION)
                except NotFound:
                    release = True
                except Exception as e:  # noqa: BLE001 — kept; the next sweep retries
                    log.warning("gang expiry: cannot check %s (%s); keeping",
                                member_uid, e)
                    unresolved = True
                    continue
                if release:
                    self.pods.del_pod(member_uid)
                    log.warning("gang %s expired; released %s", g.key,
                                member_uid)
            if not unresolved:
                self.gangs.forget(g.key)

    def _write_decision(self, pod: dict, result: FilterResult
                        ) -> Optional[str]:
        """The decision as one annotation patch; the error, or None."""
        encoded = codec.encode_pod_devices(
            self.pods.get(pod_uid(pod)).devices)
        patch = {
            ASSIGNED_NODE_ANNOTATION: result.node,
            ASSIGNED_IDS_ANNOTATION: encoded,
            TO_ALLOCATE_ANNOTATION: encoded,
            ASSIGNED_TIME_ANNOTATION: str(int(time.time())),
        }
        if pod_qos(pod):
            patch[QOS_DUTY_SPLIT_ANNOTATION] = self._qos_duty_split(
                result.node)
        rank = self.gangs.rank_of(pod_uid(pod))
        if rank is not None:
            # The member's process rank, stable across replacements: the
            # node agent passes it on as VTPU_GANG_RANK.
            patch[GANG_RANK_ANNOTATION] = str(rank)
        with trace.tracer().span("decision-write",
                                 trace_id=trace.trace_id_of(pod),
                                 pod=pod_name(pod), node=result.node,
                                 qos=pod_qos(pod)) as sp:
            try:
                self.client.patch_pod_annotations(
                    pod_namespace(pod), pod_name(pod), patch)
            except Exception as e:  # noqa: BLE001 — no grant outlives a failed write
                log.error("failed to write the decision for %s: %s",
                          pod_name(pod), e)
                sp.set("error", str(e))
                return f"writing decision failed: {e}"
        return None

    def _qos_duty_split(self, node: str) -> str:
        """The granted cores of each QoS class on ``node`` as of this
        decision: ``best-effort=120,latency-critical=40`` (an unclassed
        grant counts as best-effort, the region's default)."""
        split: Dict[str, int] = {}
        for info in self.pods.pods_on_node(node):
            cls = info.qos or QOS_BEST_EFFORT
            cores = sum(d.usedcores for ctr in info.devices for d in ctr)
            split[cls] = split.get(cls, 0) + cores
        return ",".join(f"{cls}={split[cls]}" for cls in sorted(split))

    # -- Bind ------------------------------------------------------------------
    def bind(self, namespace: str, name: str, uid: str, node: str
             ) -> Optional[str]:
        """The error, or None (reference Bind, scheduler.go:224–264).  On
        success the node lock stays held: the device plugin releases it
        when the allocation completes."""
        info = self.pods.get(uid)
        tid = info.trace_id if info is not None else ""
        tr = trace.tracer()
        with tr.span("bind", trace_id=tid, pod=name, node=node,
                     qos=info.qos if info is not None else "") as sp:
            try:
                lock_node(self.client, node)
            except NodeLockError as e:
                sp.set("error", str(e))
                tr.event(uid, "bind-lock-denied", trace_id=tid, node=node)
                return str(e)
            try:
                self.client.patch_pod_annotations(namespace, name, {
                    BIND_PHASE_ANNOTATION: BIND_ALLOCATING,
                    BIND_TIME_ANNOTATION: bind_timestamp()})
                self.client.bind_pod(namespace, name, node)
            except Exception as e:  # noqa: BLE001 — any failure frees the node
                log.error("bind %s/%s to %s failed: %s", namespace, name,
                          node, e)
                try:
                    release_node(self.client, node)
                except Exception:  # noqa: BLE001
                    log.exception("failed to release the lock on %s", node)
                sp.set("error", str(e))
                tr.event(uid, "bind-failed", trace_id=tid, node=node,
                         error=str(e))
                return str(e)
        tr.event(uid, "bound", trace_id=tid, pod=name, node=node)
        return None


def run_watch_loop(scheduler: Scheduler, stop: threading.Event,
                   window_seconds: float = 50.0, error_backoff: float = 2.0,
                   initial_rv: Optional[str] = None) -> None:
    """The informer (reference scheduler.go:66–86): stream pod events from
    a list's bookmark into :meth:`Scheduler.on_pod_event`, so a deleted
    pod's grant is freed at once; a 410 Gone or a transport error re-lists
    and resumes.  Runs until ``stop`` is set; ``initial_rv`` is the boot
    reconcile's bookmark."""
    client = scheduler.client
    rv: Optional[str] = initial_rv
    while not stop.is_set():
        try:
            if rv is None:
                rv = scheduler.resync_from_apiserver()
            for ev, pod, new_rv in client.watch_pods_events(
                    rv, timeout_seconds=window_seconds):
                scheduler.on_pod_event(ev, pod)
                rv = new_rv
                if stop.is_set():
                    return
        except Gone:
            log.info("watch bookmark expired; re-listing")
            rv = None
        except NotImplementedError:
            log.info("the client cannot watch; the periodic resync remains")
            return
        except Exception:  # noqa: BLE001 — re-list after a pause
            log.exception("watch stream failed; re-listing in %.1fs",
                          error_backoff)
            rv = None
            stop.wait(error_backoff)
