"""Scheduler core: the node and pod registries, Filter and Bind (the port's
copy of the reference's surface of the JAX package's ``scheduler/core.py``).

Reference: pkg/scheduler/scheduler.go (the Register stream handler
134–169, getNodesUsage 176–222, Filter 266–314, Bind 224–264).  Filter is
the extender's predicate: given a pod and candidate nodes, it picks the
best node, writes the device decision into the pod's annotations and
returns that node alone.  Bind takes the node lock, marks the allocating
phase and posts the Binding; the node agent's Allocate completes the
two-phase commit and releases the lock.

A decision is optimistic by default, as in the JAX package
(``Config.optimistic_commit``): candidates are fitted without a lock on
an immutable snapshot of the fleet's usage, each node's entry keyed by
its (pod rev, inventory rev) and kept incrementally (a grant's delta is
published under the rev it produced; only the nodes the registries mark
dirty rebuild).  A worker pool fits the candidates a generation-keyed fit
cache misses; the winner is picked among the nodes within 1% of the best
score by a process-stable digest of (pod, node).  The commit lock is held
only to re-check the winner's revisions and record the grant; a lost race
refits on the node's live usage, then retries on a fresh snapshot, and
the last retry decides serially.  Gangs, and every pod with
``optimistic_commit=False``, decide whole under the commit lock.  Batched
scheduling cycles (``batch.py``): ``filter_many`` decides a backlog
together, and with ``Config.filter_batch`` concurrent Filters collapse
into cycles at the batch gate, each one snapshot (``snapshot_for_batch``),
a columnar evaluation a request class, a joint solve and a
revision-validated group commit a node (``PodManager.add_pods_group``,
``_publish_grants_many``), its decisions written in bulk
(``_finish_decisions_bulk``); what a cycle cannot place goes through the
per-pod path; ``Config.solve_workers`` runs the class evaluations in
worker processes (``parallelcp/``).  Decision writes go through a
group-commit batcher (``util/decisionwriter.py``), and every phase and
lock is timed into the performance observatory (``util/perf.py``) behind
``GET /perfz``.  Of the JAX scheduler's
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
terminal bind phase the informer sees.  The capacity planner
(``accounting/planner.py``) forecasts each queue's demand (held plus
pending cards; granted cards per namespace without a quota config) from
the samples ``observe_capacity`` takes, and ``export_capacity`` turns
them into ``/capacityz``.  A
node's fabric (the ``TopologyDesc`` and card coordinates its agent
registers) places multi-card requests by the slice engine under the pod's
topology policy, and ``vtpu.dev/mesh`` pods by ``placement/mesh.py``.  A
pod group (``vtpu.dev/pod-group``) is placed all or none by ``gang.py``:
its members wait for their quorum, are placed at once on one snapshot
with a rank each (``vtpu.dev/pod-group-rank``), keep their grants until
deletion, and are never preemption victims.  A gang that declares an
elastic mesh range (``vtpu.dev/mesh-min``/``-max``) is placed at its
current ``vtpu.dev/mesh`` like any gang; with ``Config.enable_elastic``
the resize controller (``elastic/``) steps it between the range's rungs:
quota reclaim and the defragmenter shrink it instead of evicting it, its
tick grows it back after a hysteresis window, and a pending gang that
Filter keeps rejecting is downgraded, each a whole-gang
checkpoint-restart through the same eviction requests.  Placement
(``placement/``): a multi-card pod that fits nowhere because no
contiguous box is free records a demand with the
defragmenter (``placement/defrag.py``); with ``Config.enable_defrag`` its
tick plans the cheapest compaction, reserves the box
(``placement/reserve.py``: the reserved cards leave every usage a fit
reads, beside the quarantined ones) and asks the victims to checkpoint
through the same eviction requests, and the beneficiary's next Filter
releases the box and lands on it.  ``snapshot()`` is the fleet's usage as
the defragmenter and the fragmentation views read it.  With
``Config.shard_replica`` the extender is one of several active replicas
(``shard/``): each places only on the nodes the epoch-numbered shard map
gives it, commits a decision as a compare-and-swap fenced by that epoch,
and adopts a dead replica's nodes.  This
module imports neither grpc nor protobuf: the register stream's messages
are read through their attributes, and only ``cmd/scheduler.py`` converts
at the gRPC edge.
"""

from __future__ import annotations

import logging
import os
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from typing import Dict, List, NamedTuple, Optional, Set, Tuple

from ..accounting import efficiency as eff_mod
from ..accounting import planner as planner_mod
from ..accounting.forecast import ForecastConfig
from ..accounting.ledger import UsageLedger, decode_usage
from ..accounting.planner import CapacityTracker
from ..elastic.controller import (
    ELASTIC_VALUE_PREFIX,
    ElasticConfig,
    ResizeController,
)
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
from ..placement.defrag import DefragConfig, Defragmenter
from ..placement.mesh import MESH_ANNOTATION, local_mesh_for, parse_mesh
from ..placement.reserve import SliceReservations
from ..quota.admission import AdmissionConfig, AdmissionLoop
from ..quota.queues import QuotaManager
from ..shard import commit as shard_commit
from ..shard.shardmap import ShardConfig, ShardManager
from ..tpulib.types import TopologyDesc
from ..util import codec, perf, trace
from ..util.config import Config
from ..util.decisionwriter import DecisionBatcher
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
    QOS_ANNOTATION,
    QOS_BEST_EFFORT,
    QOS_DUTY_SPLIT_ANNOTATION,
    TO_ALLOCATE_ANNOTATION,
    ContainerDevice,
)
from . import score as score_mod
from .batch import BatchEngine, BatchJob
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


class SnapEntry(NamedTuple):
    """One node's slice of the fleet's immutable usage snapshot: its
    inventory and its card usage, as a fit reads them.  ``usage`` is the
    shared cached map, read-only by contract (a fit that simulates a
    placement lays a ``CowUsage`` view over it).  ``key`` is the (pod
    rev, inventory rev) generation the map was built at: an optimistic
    commit re-reads the winner's live revs and commits only on equality,
    so a decision computed on a superseded snapshot never books cards."""

    key: Tuple[int, int]
    info: NodeInfo
    usage: Dict[str, score_mod.DeviceUsage]


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
        # The performance observatory is process-global, like the tracer;
        # --no-perf switches it off.
        perf.registry().enabled = self.cfg.perf_enabled
        if self.cfg.perf_tracemalloc:
            perf.registry().enable_tracemalloc()
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
            # A quarantine or release bumps the node's inventory rev: its
            # cached usage rebuilds, and a commit validated before the
            # flip fails.
            clock=clock, on_change=self.nodes.touch)
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
        # Placement: slice reservations on the scheduler's clock, stripped
        # from every usage a fit reads (``_refresh_entry_locked``), each
        # change bumping the node's inventory rev; the defragmenter is
        # inert unless ``enable_defrag`` (its demand registry and the
        # availability metrics still work).  vgpu-scheduler starts its
        # thread; embedders and tests call defrag.tick() themselves.
        self.reservations = SliceReservations(
            clock=clock, on_change=self.nodes.touch,
            ttl_s=self.cfg.defrag_reservation_ttl_s)
        self.defrag = Defragmenter(
            self,
            DefragConfig(
                enabled=self.cfg.enable_defrag,
                interval_s=self.cfg.defrag_interval_s,
                demand_fresh_s=self.cfg.defrag_demand_fresh_s,
                checkpoint_grace_s=self.cfg.defrag_checkpoint_grace_s,
                reservation_ttl_s=self.cfg.defrag_reservation_ttl_s,
                min_victim_priority=self.cfg.defrag_min_victim_priority,
                max_victims_per_plan=self.cfg.defrag_max_victims),
            clock=clock)
        # Elastic mesh resizing: inert unless ``enable_elastic`` (shrink
        # offers empty, the tick never plans, every other path
        # byte-identical).  vgpu-scheduler starts its thread; embedders
        # and tests call elastic.tick() themselves.
        self.elastic = ResizeController(
            self,
            ElasticConfig(
                enabled=self.cfg.enable_elastic,
                interval_s=self.cfg.elastic_interval_s,
                hysteresis_s=self.cfg.resize_hysteresis_s,
                checkpoint_grace_s=self.cfg.resize_checkpoint_grace_s,
                downgrade_after_s=self.cfg.elastic_downgrade_after_s),
            clock=clock)
        # Active-active replicas (shard/): inert without
        # Config.shard_replica, when candidate_gate() is None, no gate runs
        # on any path and decisions keep the group-commit writer.
        # vgpu-scheduler starts the coordination thread; embedders, tests
        # and the simulator call shards.tick() themselves.
        self.shards = ShardManager(
            self,
            ShardConfig(
                replica=self.cfg.shard_replica,
                ttl_s=self.cfg.shard_ttl_s,
                grace_beats=self.cfg.shard_grace_beats,
                stale_ttl_s=self.cfg.shard_stale_ttl_s,
                adoption_grace_s=self.cfg.shard_adoption_grace_s,
                coord_object=self.cfg.shard_coord_object),
            clock=clock)
        # The commit lock: held to re-check a winner's revisions and
        # record its grant, and for gang and serial decisions whole; never
        # across apiserver I/O.  1-in-8 sampled (one acquire a decision).
        self._commit_lock = perf.TimedLock("commit", sample_shift=3)
        # Each node's cached usage, (key, map), keyed on (pod rev,
        # inventory rev), and the published snapshot built from it.  The
        # maps and the dict are never mutated once published: refreshes
        # replace them, so snapshot() hands them out without a lock.
        self._usage_cache_lock = perf.TimedLock("snapshot-cache",
                                                sample_shift=3)
        self._usage_cache: Dict[str, tuple] = {}
        self._snap: Dict[str, SnapEntry] = {}
        # Names whose snapshot entry was replaced since the batch engine's
        # last refresh (kept under the usage-cache lock): the columnar
        # refresh walks these instead of scanning the whole fleet.
        self._changed_for_batch: Set[str] = set()
        # The fit cache: (node, request fingerprint) -> (snapshot key, fit
        # outcome); a hit counts only at the node's current key, so any
        # grant, delete or re-registration on the node invalidates it.
        self._fit_cache_lock = threading.Lock()
        self._fit_cache: Dict[tuple, tuple] = {}
        # The candidate-evaluation pool (made on first need, _eval_pool)
        # and its busy high-water mark.
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pool_lock = threading.Lock()
        self._pool_unavailable = False
        self.worker_pool_size = 0
        self.workers_busy_peak = 0
        self._busy = 0
        self._busy_lock = threading.Lock()
        #: Optimistic commits that lost their revision race.
        self.commit_conflicts = 0
        # Group commit of the decision writes.
        self._decisions = DecisionBatcher(client)
        # Batched scheduling cycles (batch.py): the columnar fleet, the
        # class evaluator, the joint solver and the per-node group commit.
        # Always built (filter_many drives it whatever the flag says);
        # Filter goes through its gate only with Config.filter_batch.
        self.batch = BatchEngine(self)
        # on_pod_event's counter, for the 1-in-8 informer-apply sample.
        self._informer_events = 0
        #: Full per-node usage rebuilds, and grant deltas written through
        #: to the cache instead.
        self.usage_rebuilds = 0
        self.usage_writethroughs = 0
        #: Decision writes that failed (the grant rolled back), by reason,
        #: and every decision write attempted.
        self.decision_write_failures: Dict[str, int] = {}
        self.decision_writes_total = 0
        self._dwf_lock = threading.Lock()
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
        # Predictive capacity (accounting/forecast.py + planner.py):
        # per-queue demand forecasting behind /capacityz and the
        # vtpu_capacity_* gauges, fed by observe_capacity().
        # vgpu-scheduler samples on a thread; embedders, tests and the
        # simulator call it on their own clocks.
        self.capacity = CapacityTracker(
            ForecastConfig(
                bucket_s=self.cfg.capacity_bucket_s,
                season_buckets=self.cfg.capacity_season_buckets),
            starve_after_s=self.cfg.capacity_starve_after_s)
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
        changed.  Timed into the ``register-apply`` phase."""
        t0 = time.monotonic()
        self.leases.beat(node_name)
        self.quarantine.observe_node(
            node_name, {d.id: d.health for d in info.devices})
        if usage:
            self.ledger.record(node_name, usage)
        if not self.nodes.same_inventory(node_name, info):
            self.nodes.add_node(node_name, info)
            log.info("registered node %s with %d cards", node_name,
                     len(info.devices))
        perf.registry().record("register-apply", time.monotonic() - t0)

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
    def _del_pod_wt(self, uid: str) -> None:
        """Drop a grant and write its release through to the node's cached
        usage (a broken rev chain leaves the node's dirty rebuild to it)."""
        dropped = self.pods.del_pod(uid)
        if dropped is not None:
            info, rev = dropped
            self._write_through(info.node, info.devices, rev, -1)

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
        and ignore an ADDED replayed after its DELETE.  One event in
        ``perf.INFORMER_SAMPLE_EVERY`` is timed into the
        ``informer-apply`` phase, whose recent p99 is the exported
        informer lag."""
        n = self._informer_events
        self._informer_events = n + 1
        reg = perf.registry()
        if not reg.enabled or n & (perf.INFORMER_SAMPLE_EVERY - 1):
            self._apply_pod_event(event, pod)
            return
        t0 = time.monotonic()
        try:
            self._apply_pod_event(event, pod)
        finally:
            reg.record("informer-apply", time.monotonic() - t0)

    def _apply_pod_event(self, event: str, pod: dict) -> None:
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
            self._del_pod_wt(uid)
            return
        if not node:
            # A gang member between its admission and its own decision
            # write holds a grant without ``assigned-node``: an event or a
            # resync must not free it, or other pods take the gang's cards.
            if not self.gangs.is_reserved(uid):
                self._del_pod_wt(uid)
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
        # Usually the echo of this scheduler's own decision write, which
        # refreshes in place; a grant new to the registry writes its delta
        # through to the node's cached usage.
        new_rev = self.pods.upsert(info)
        if new_rev is not None:
            self._write_through(node, devices, new_rev, 1)
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
        may simply predate it).  Timed into the ``informer-resync``
        phase, its last cost kept as a gauge."""
        t0 = time.monotonic()
        try:
            return self._resync_from_apiserver()
        finally:
            cost = time.monotonic() - t0
            perf.registry().record("informer-resync", cost)
            perf.registry().set_gauge("informer_resync_last_s", cost)

    def _resync_from_apiserver(self) -> str:
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
            if not requester or requester.startswith(
                    (RESCUE_VALUE_PREFIX, ELASTIC_VALUE_PREFIX)):
                # A rescue request's grace and rescission are the
                # rescuer's, a resize restart's the resize controller's:
                # clearing one here would stop a checkpoint midway.
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

    # -- usage snapshot --------------------------------------------------------
    def _write_through(self, node: str, devices, new_rev: int,
                       sign: int) -> None:
        """Publish one pod's grant delta (``sign`` +1 add, -1 release) into
        ``node``'s cached usage at generation ``new_rev``.  Only on an
        unbroken rev chain: the cache must hold exactly ``new_rev - 1``;
        anything else means an unobserved change interleaved, and the
        node's pending dirty mark rebuilds it instead.  A published delta
        is queued for the batch engine's columnar fleet too."""
        published = None
        with self._usage_cache_lock:
            cached = self._usage_cache.get(node)
            if cached is not None:
                (k0, k1), usage = cached
                if new_rev == k0 + 1:
                    new_usage = self._delta_usage(usage, devices, sign)
                    if new_usage is not None:
                        self._usage_cache[node] = ((new_rev, k1),
                                                   new_usage)
                        published = (new_rev, k1)
        if published is not None:
            self.usage_writethroughs += 1
            # The same delta for the columnar fleet: the next cycle patches
            # the node's row in place instead of reloading it.
            self.batch.note_delta(node, devices, sign, published)

    @staticmethod
    def _delta_usage(usage: dict, devices, sign: int):
        """``usage`` plus or minus one pod's devices as a fresh map (the
        published maps are never mutated), or None where a card is unknown
        or a release would go below zero: the dirty rebuild recomputes
        from scratch then."""
        touched: Dict[str, score_mod.DeviceUsage] = {}
        for container in devices:
            for d in container:
                u = touched.get(d.uuid)
                if u is None:
                    base = usage.get(d.uuid)
                    if base is None:
                        return None
                    u = touched[d.uuid] = score_mod.clone_usage(base)
                u.used_slots += sign
                u.used_mem += sign * d.usedmem
                u.used_cores += sign * d.usedcores
                if sign < 0 and (u.used_slots < 0 or u.used_mem < 0
                                 or u.used_cores < 0):
                    return None
        new_usage = dict(usage)
        new_usage.update(touched)
        return new_usage

    def snapshot(self) -> Dict[str, SnapEntry]:
        """The whole fleet's usage as every fit reads it, one entry a
        registered node in the registry's order: its inventory less its
        grants, its quarantined and reserved cards left out.  Kept
        incrementally: the registries name the nodes changed since the
        last call (``drain_dirty``) and only those entries refresh, so an
        unchanged fleet returns the published dict as it is.  The dict and
        its maps are immutable once published."""
        with self._usage_cache_lock:
            return self._snapshot_locked()

    def _snapshot_locked(self) -> Dict[str, SnapEntry]:
        dirty = self.pods.drain_dirty()
        dirty |= self.nodes.drain_dirty()
        if not dirty:
            return self._snap
        reg = perf.registry()
        rebuilds_before = self.usage_rebuilds
        t0 = time.monotonic()
        try:
            snap = dict(self._snap)
            t_copy = time.monotonic()
            resized = False
            for name in dirty:
                entry = self._refresh_entry_locked(name)
                if entry is None:
                    resized |= snap.pop(name, None) is not None
                else:
                    resized |= name not in snap
                    snap[name] = entry
            if resized:
                # Registry order, whatever order the dirty set iterates in
                # (the JAX snapshot's order follows a set of names).
                snap = {name: snap[name] for name in self.nodes.names()
                        if name in snap}
            self._snap = snap
            self._changed_for_batch |= dirty
            if reg.enabled:
                now = time.monotonic()
                reg.record("snapshot-publish", t_copy - t0)
                reg.record("snapshot-refresh", now - t_copy)
                reg.set_gauge("snapshot_dirty_nodes", len(dirty))
                reg.set_gauge("snapshot_nodes_rebuilt",
                              self.usage_rebuilds - rebuilds_before)
            return snap
        except BaseException:
            # The drain was destructive: hand the names back, or the
            # published view goes stale.
            self.pods.mark_dirty(dirty)
            self.nodes.mark_dirty(dirty)
            raise

    def snapshot_for_batch(self
                           ) -> Tuple[Dict[str, SnapEntry], Set[str]]:
        """The batch engine's read: the published snapshot and the names
        whose entries were replaced since the previous call, refreshed and
        drained under one acquire (with two, a per-pod snapshot() between
        them could publish a newer entry whose change this drain would
        consume against the older dict, and the row would never hear of
        it)."""
        with self._usage_cache_lock:
            snap = self._snapshot_locked()
            changed, self._changed_for_batch = \
                self._changed_for_batch, set()
        return snap, changed

    def _refresh_entry_locked(self, name: str) -> Optional[SnapEntry]:
        """One node's entry at its live revs, from the cache or rebuilt
        (the usage-cache lock held); None where the node is gone.  A
        rebuild keys its map on the pod rev read with the pods in one
        acquire (``PodManager.node_view``): the write-through moves a map
        keyed ``k`` to ``k + 1`` by one event's delta, so the map must
        hold exactly rev ``k``'s pods.  (The JAX scheduler reads the rev
        and the pods in two acquires, and an event landing between them
        is counted twice; ``tests/test_torch_concurrency.py`` pins both
        answers.)  The inventory half is read before the node and its
        quarantined and reserved cards: a change landing between those
        reads leaves the node's dirty mark pending, so it can only force a
        needless rebuild, and no write-through moves that half."""
        inv_rev = self.nodes.rev_of(name)
        info = self.nodes.get_node(name)
        if info is None:
            self._usage_cache.pop(name, None)
            return None
        cached = self._usage_cache.get(name)
        if cached is None or cached[0] != (self.pods.rev_of(name), inv_rev):
            self.usage_rebuilds += 1
            pod_rev, granted = self.pods.node_view(name)
            usage = score_mod.build_usage(info, granted)
            # Quarantined cards, and reserved ones (a compaction's
            # assembled box), leave the usage outright: no fit can place on
            # a card it cannot see.  Each quarantine and reservation change
            # bumped the node's rev, so the key reflects the current sets.
            quarantined = self.quarantine.quarantined_on(name)
            if quarantined:
                usage = {cid: u for cid, u in usage.items()
                         if cid not in quarantined}
            reserved = self.reservations.reserved_on(name)
            if reserved:
                usage = {cid: u for cid, u in usage.items()
                         if cid not in reserved}
            cached = ((pod_rev, inv_rev), usage)
            self._usage_cache[name] = cached
        return SnapEntry(cached[0], info, cached[1])

    def get_nodes_usage(self, node_names: Optional[List[str]] = None
                        ) -> Dict[str, Tuple[NodeInfo,
                                             Dict[str, score_mod.DeviceUsage]]]:
        """Each registered node's inventory less its grants and its
        quarantined and reserved cards (reference getNodesUsage), as
        copies of the snapshot's maps: the caller owns them."""
        clone = score_mod.clone_usage
        allow = None if node_names is None else set(node_names)
        return {name: (e.info, {cid: clone(u) for cid, u in e.usage.items()})
                for name, e in self.snapshot().items()
                if allow is None or name in allow}

    def inspect_all_nodes_usage(self) -> Dict[str, Dict[str,
                                                      score_mod.DeviceUsage]]:
        """For the metrics collector: each node's card usage from the
        immutable snapshot, off the commit lock (a scrape never blocks a
        decision).  The maps are shallow copies whose entries are shared:
        read them only."""
        return {n: dict(e.usage) for n, e in self.snapshot().items()}

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

    def observe_capacity(self, now: Optional[float] = None,
                         quota_stats: Optional[dict] = None
                         ) -> Dict[str, float]:
        """One demand sample per queue into the capacity forecaster:
        cards the tenant wants right now — held (placed) plus pending
        (queued or unplaced requests).  Ungoverned fleets sample granted
        cards per namespace instead (no quota layer, no pending side: the
        forecast then tracks standing usage).  Off every scheduler lock
        (the registry's list and the quota manager's own).
        ``quota_stats`` lets export_capacity share one stats snapshot
        instead of walking the registry twice per export.  Timed into the
        ``capacity-tick`` phase."""
        tick_t0 = time.monotonic()
        now = self._clock() if now is None else now
        samples: Dict[str, float] = {}
        if self.quota.enabled:
            if quota_stats is None:
                quota_stats = self.quota.stats(self.pods.list_pods())
            for row in quota_stats["queues"]:
                pending = sum(p["chips"] for p in row["pending_pods"])
                samples[row["queue"]] = float(row["held_chips"] + pending)
        else:
            for p in self.pods.list_pods():
                chips = sum(len(c) for c in p.devices)
                if chips:
                    samples[p.namespace] = \
                        samples.get(p.namespace, 0.0) + chips
        self.capacity.observe_queues(samples, now)
        perf.registry().record("capacity-tick",
                               time.monotonic() - tick_t0)
        return samples

    def export_capacity(self, horizon_s: Optional[float] = None,
                        quota_stats: Optional[dict] = None,
                        detail: bool = True) -> dict:
        """The predictive-capacity assessment (``GET /capacityz`` →
        ``vgpu-report`` and the vtpu_capacity_* gauges): per-queue demand
        forecasts with bands, starvation ETAs against admissible
        capacity, a fleet scale recommendation and forecast-vs-actual
        drift.  Analytic: the replay-verified answers come from
        ``vgpu-simulate``'s capacity section.  ``quota_stats`` lets the
        metrics collector, which computed the same snapshot for the queue
        gauges, avoid a second registry walk per scrape."""
        now = self._clock()
        stats = quota_stats if quota_stats is not None else (
            self.quota.stats(self.pods.list_pods())
            if self.quota.enabled else None)
        self.observe_capacity(now, quota_stats=stats)
        snap = self.snapshot()
        fleet_chips = sum(len(e.usage) for e in snap.values())
        free_chips = sum(1 for e in snap.values()
                         for u in e.usage.values()
                         if u.used_slots == 0)
        chips_per_node = max((len(e.usage) for e in snap.values()),
                             default=1)
        rows = []
        if stats is not None:
            # The snapshot the demand sample above read: sampled demand
            # and reported entitlements stay consistent.
            rows = [{"queue": r["queue"],
                     "nominal_chips": r["nominal_chips"],
                     "borrow_limit_chips": r["borrow_limit_chips"]}
                    for r in stats["queues"]]
        return planner_mod.assess(
            self.capacity, fleet_chips=fleet_chips,
            free_chips=free_chips, chips_per_node=chips_per_node,
            nodes_current=len(snap), queue_rows=rows, now=now,
            horizon_s=horizon_s
            if horizon_s is not None else self.cfg.capacity_horizon_s,
            detail=detail)

    def export_perf(self, top_ticks: int = 8) -> dict:
        """The performance observatory (``GET /perfz``): each phase's
        p50/p99/max over its recent window, the lock wait/hold table,
        informer lag and resync cost, the batch gate's queue, GC pressure,
        the decision writer's amortization, the batch engine's counters,
        the solve workers and the slowest recent ticks.  Reads the
        process's registry and this scheduler's counters, never a
        scheduler lock."""
        doc = perf.registry().export(top_ticks=top_ticks)
        batcher = self._decisions
        doc["decision_writer"] = {
            "batches": batcher.batches,
            "writes": batcher.writes,
            "amortization": round(batcher.writes / batcher.batches, 3)
            if batcher.batches else 0.0,
        }
        doc["queue"]["pending_depth"] = len(self.batch._queue)
        fleet = self.batch.fleet
        doc["counters"] = {
            "commit_conflicts": self.commit_conflicts,
            "batch_cycles": self.batch.stats.cycles,
            "batch_fallbacks": self.batch.stats.fallbacks,
            # A steady state keeps the rebuild counters flat and carries
            # its churn on the patched and write-through ones.
            "columnar_full_rebuilds": fleet.rebuilds,
            "columnar_rows_reloaded": fleet.rows_reloaded_total,
            "columnar_rows_patched": fleet.rows_patched_total,
            "class_evals_full": fleet.class_evals_full,
            "class_rows_patched": fleet.class_rows_patched,
            "class_evals_offloaded": fleet.class_evals_offloaded,
            "snapshot_usage_rebuilds": self.usage_rebuilds,
            "snapshot_usage_writethroughs": self.usage_writethroughs,
        }
        # The solve workers (parallelcp/), present with the pool off too.
        pool = self.batch.pool
        if pool is not None:
            doc["solve_workers"] = pool.export()
        else:
            doc["solve_workers"] = {
                "configured": 0, "workers": 0, "restarts_total": 0,
                "evals_offloaded": 0, "eval_fallbacks": 0,
                "per_worker": [],
            }
        return doc

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
        commit lock (no grant is recorded while the lists are taken) —
        enough to rebuild this scheduler's placement state elsewhere.  A
        node without a fabric goes out as it registered, ``mesh (n,)``
        with no card coordinates; a node with no topology as None."""
        with self._commit_lock:
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

    # -- Filter ----------------------------------------------------------------
    def filter(self, pod: dict, node_names: List[str]) -> FilterResult:
        """Decide (the ``filter`` span), then write the decision (the
        ``decision-write`` span) with no scheduler lock held; the tentative
        grant is rolled back if the write fails."""
        tid = trace.trace_id_of(pod)
        tr = trace.tracer()
        # The expiry sweep first, outside every lock (it reads the
        # apiserver).
        if self.gangs.groups():
            self._release_expired_gangs()
        with tr.span("filter", trace_id=tid, pod=pod_name(pod),
                     candidates=len(node_names), qos=pod_qos(pod)) as sp:
            result = self._decide(pod, node_names, sp)
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
        return self._finish_decision(pod, result)

    def filter_many(self, items: List[Tuple[dict, List[str]]]
                    ) -> List[FilterResult]:
        """Filter a backlog of pods through batched scheduling cycles: the
        answers of :meth:`filter` a pod, but the batchable pods are decided
        together (one snapshot, one columnar evaluation a request class,
        one revision-validated group commit a node) in chunks of
        ``batch_max``, whatever ``filter_batch`` says.  Gang members,
        multi-container pods, held pods and every pod under
        ``optimistic_commit=False`` go through :meth:`filter` as they
        are."""
        if self.gangs.groups():
            self._release_expired_gangs()
        results: List[Optional[FilterResult]] = [None] * len(items)
        batched: List[Tuple[int, BatchJob]] = []
        # The routed pods' stale grants drop in one acquire, but always
        # before the next decision that could read them: ahead of every
        # inline per-pod filter of the drain (a later pod must not see an
        # earlier routed pod's stale grant still charged), and once after
        # the routing.
        stale_uids: List[str] = []
        drain_t0 = time.monotonic()
        inline_s = 0.0
        for i, (pod, node_names) in enumerate(items):
            routed = self._route_batch(pod, node_names)
            if isinstance(routed, FilterResult):
                results[i] = self._finish_decision(pod, routed)
            elif routed is None:
                if stale_uids:
                    self._del_pods_wt(stale_uids)
                    stale_uids.clear()
                inline_t0 = time.monotonic()
                results[i] = self.filter(pod, node_names)
                # An inline decision records its own phases: left out of
                # the drain, so /perfz's phases sum to the wall time.
                inline_s += time.monotonic() - inline_t0
            else:
                batched.append((i, routed))
                stale_uids.append(routed.uid)
        if stale_uids:
            self._del_pods_wt(stale_uids)
        # The drain phase: parsing and routing the backlog into jobs.
        perf.registry().record(
            "drain", max(0.0, time.monotonic() - drain_t0 - inline_s))
        step = max(1, self.cfg.batch_max)
        for at in range(0, len(batched), step):
            chunk = batched[at:at + step]
            decided = self.batch.decide_many([j for _i, j in chunk])
            finished = self._finish_decisions_bulk(
                [(job.pod, res) for (_i, job), res in zip(chunk, decided)])
            for (i, _job), fr in zip(chunk, finished):
                results[i] = fr
        if batched:
            # Every job of the backlog is decided: the drain age (a
            # current wait) is zero again.
            perf.registry().set_gauge("drain_age_s", 0.0)
        return results

    def _del_pods_wt(self, uids: List[str]) -> None:
        """Drop many stale grants in one acquire, each release written
        through (so a re-placed pod's old row patches instead of
        reloading)."""
        for info, rev in self.pods.del_pods(uids):
            self._write_through(info.node, info.devices, rev, -1)

    def _route_batch(self, pod: dict, node_names: List[str]):
        """filter_many's router, :meth:`_decide`'s checks in its order: a
        FilterResult where the pod is decided already (a bad request, not
        ours, held in a queue), a BatchJob where it is batchable, None
        where it needs the per-pod path."""
        try:
            requests = container_requests(pod, self.cfg)
        except ValueError as e:
            return FilterResult(error=f"bad resource request: {e}")
        if not any(r.nums > 0 for r in requests):
            return FilterResult()
        hold = self.quota.gate(pod, requests)
        if hold is not None:
            return FilterResult(error=hold)
        self._release_reservation_for(pod)
        if gang_of(pod) is not None or not self.cfg.optimistic_commit \
                or not self._batchable(requests):
            return None
        return self._make_batch_job(pod, requests, node_names,
                                    del_stale=False)

    @staticmethod
    def _batchable(requests) -> bool:
        """Exactly one container asks for cards: a multi-container pod
        keeps the per-pod path (its containers place against each other's
        tentative grants)."""
        return len(requests) == 1 and requests[0].nums >= 1

    def _make_batch_job(self, pod: dict, requests, node_names: List[str],
                        del_stale: bool = True) -> Optional[BatchJob]:
        """The pod's BatchJob, or None where its priority cannot be read
        (the per-pod path decides it).  ``del_stale`` drops a retried
        Filter's grant first, as the per-pod paths do; filter_many drops
        its backlog's in one acquire instead."""
        try:
            priority = pod_priority(pod, self.cfg)
        except Exception:  # noqa: BLE001 — the per-pod path decides
            return None
        if del_stale:
            self._del_pod_wt(pod_uid(pod))
        return BatchJob(
            pod=pod, uid=pod_uid(pod), name=pod_name(pod),
            namespace=pod_namespace(pod), trace_id=trace.trace_id_of(pod),
            requests=requests,
            anns=pod.get("metadata", {}).get("annotations", {}) or {},
            node_names=node_names, priority=priority,
            enqueued_at=time.monotonic())

    def _finish_decision(self, pod: dict,
                         result: FilterResult) -> FilterResult:
        """Everything after the in-memory decision: the rejection's events
        and signals, or the decision write (rolled back on failure)."""
        patch = self._prepare_decision(pod, result)
        if patch is None:
            return result
        err = self._write_decision_single(pod, result, patch)
        return self._conclude_decision(pod, result, err)

    def _finish_decisions_bulk(self, pairs: List[Tuple[dict, FilterResult]]
                               ) -> List[FilterResult]:
        """A batched cycle's epilogue: every decision prepared, then the
        patches written in chunks the decision writer's adaptive sizer
        steers, one ``write_many`` call a chunk, or with the shard layer on
        one fenced ``cas_commit_many`` a chunk (a CAS for each entry).  A
        failed entry rolls back only its own grant."""
        out: List[Optional[FilterResult]] = [None] * len(pairs)
        writes: List[tuple] = []   # (index, pod, result, patch)
        for i, (pod, result) in enumerate(pairs):
            patch = self._prepare_decision(pod, result)
            if patch is None:
                out[i] = result
            else:
                writes.append((i, pod, result, patch))
        reg = perf.registry()
        sizer = self._decisions.sizer
        at = 0
        while at < len(writes):
            chunk = writes[at:at + sizer.size()]
            at += len(chunk)
            write_t0 = time.monotonic()
            if self.shards.enabled:
                errs = shard_commit.cas_commit_many(
                    self.client, self.shards,
                    [(pod, result.node, patch)
                     for _i, pod, result, patch in chunk])
                seconds = time.monotonic() - write_t0
                sizer.observe(len(chunk), seconds)
            else:
                outcomes = self._decisions.write_many(
                    [(pod_namespace(pod), pod_name(pod), patch)
                     for _i, pod, _result, patch in chunk])
                seconds = time.monotonic() - write_t0
                errs = [None if e is None
                        else f"writing decision failed: {e}"
                        for e in outcomes]
            if reg.enabled:
                # One sample a flush, the amortized unit.
                reg.record("decision-write", seconds)
                reg.set_gauge("decision_write_chunk", len(chunk))
            for (i, pod, result, _patch), err in zip(chunk, errs):
                if err is not None:
                    log.error("failed to write the decision for %s: %s",
                              pod_name(pod), err)
                out[i] = self._conclude_decision(pod, result, err)
        return out

    def _prepare_decision(self, pod: dict,
                          result: FilterResult) -> Optional[dict]:
        """A rejection's side effects (returns None: nothing to write), or
        the placement's decision patch."""
        uid = pod_uid(pod)
        tid = trace.trace_id_of(pod)
        tr = trace.tracer()
        if result.node is None:
            if result.error or result.failed:
                tr.event(uid, "filter-rejected", trace_id=tid,
                         pod=pod_name(pod), error=result.error,
                         preempting=result.preempt is not None)
            self._note_slice_rejection(pod, result)
            if result.failed and any(not r.startswith("shard-")
                                     for r in result.failed.values()):
                # A released governed pod that found no seat: the reclaim
                # trigger's signal (borrowers may hold its cards).  Shard
                # ownership refusals alone are not: the pod's next retry
                # lands on the owning replica.
                self.quota.note_unplaced(uid)
            if result.preempt is not None:
                self._request_preemptions(pod, result.preempt)
            return None
        tr.event(uid, "filter-assigned", trace_id=tid, pod=pod_name(pod),
                 node=result.node)
        # A placement settles any slice demand this pod (or its gang) had
        # recorded: the defragmenter must not compact for it.
        self.defrag.demand_satisfied(self._reservation_key(pod))
        self.elastic.demand_satisfied(self._reservation_key(pod))
        if self._preempt_by_requester.get(uid):
            # Placed after all (room freed elsewhere): its eviction
            # requests are pointless now.
            self._rescind_preemptions(uid)
        encoded = codec.encode_pod_devices(self.pods.get(uid).devices)
        patch = {
            ASSIGNED_NODE_ANNOTATION: result.node,
            ASSIGNED_IDS_ANNOTATION: encoded,
            TO_ALLOCATE_ANNOTATION: encoded,
            ASSIGNED_TIME_ANNOTATION: str(int(time.time())),
        }
        if pod_qos(pod):
            patch[QOS_DUTY_SPLIT_ANNOTATION] = self._qos_duty_split(
                result.node)
        rank = self.gangs.rank_of(uid)
        if rank is not None:
            # The member's process rank, stable across replacements: the
            # node agent passes it on as VTPU_GANG_RANK.
            patch[GANG_RANK_ANNOTATION] = str(rank)
        return patch

    def _write_decision_single(self, pod: dict, result: FilterResult,
                               patch: dict) -> Optional[str]:
        """One pod's decision write through the group-commit batcher, or
        with the shard layer on as a fenced CAS (``shard/commit.py``),
        which bypasses the batcher: it carries its own resourceVersion.
        The error, or None.  One write in four is timed into the
        ``decision-write`` phase (the span records every one)."""
        tid = trace.trace_id_of(pod)
        reg = perf.registry()
        write_rec = reg.enabled and (self._decisions.writes & 3) == 0
        if write_rec:
            write_t0 = time.monotonic()
        err: Optional[str] = None
        with trace.tracer().span("decision-write", trace_id=tid,
                                 pod=pod_name(pod), node=result.node,
                                 qos=pod_qos(pod)) as wsp:
            if self.shards.enabled:
                # Keyed by (shard epoch, pod resourceVersion): a stale map,
                # lost ownership or a peer's decision fails closed and the
                # pod requeues.
                err = shard_commit.cas_commit(
                    self.client, self.shards, pod, result.node, patch)
                if err is not None:
                    log.warning("decision for %s not committed: %s",
                                pod_name(pod), err)
                    wsp.set("error", err)
            else:
                try:
                    batched = self._decisions.write(
                        pod_namespace(pod), pod_name(pod), patch)
                    if batched > 1:
                        # Rode a group commit with batched - 1 others.
                        wsp.set("batch_size", batched)
                except Exception as e:  # noqa: BLE001 — no grant outlives a failed write
                    err = f"writing decision failed: {e}"
                    log.error("failed to write the decision for %s: %s",
                              pod_name(pod), e)
                    wsp.set("error", str(e))
            if write_rec:
                reg.record("decision-write", time.monotonic() - write_t0)
        return err

    def _conclude_decision(self, pod: dict, result: FilterResult,
                           err: Optional[str]) -> FilterResult:
        """After the write: count it, and on a failure roll the grant back
        and count the failure by reason: the shard commit's ``shard-fence``
        or ``shard-cas`` prefix, else ``transport``."""
        uid = pod_uid(pod)
        with self._dwf_lock:
            self.decision_writes_total += 1
        if err is None:
            return result
        self._del_pod_wt(uid)
        trace.tracer().event(uid, "decision-write-failed",
                             trace_id=trace.trace_id_of(pod), error=err)
        reason = err.split(":", 1)[0].strip() \
            if err.startswith("shard-") else "transport"
        with self._dwf_lock:
            self.decision_write_failures[reason] = \
                self.decision_write_failures.get(reason, 0) + 1
        return FilterResult(error=err)

    def _decide(self, pod: dict, node_names: List[str],
                sp: "trace.Span") -> FilterResult:
        """Parse and dispatch: gang admissions and the serial path decide
        under the commit lock; with ``filter_batch`` a batchable pod goes
        through the batch gate; the default is the optimistic
        snapshot-and-commit protocol."""
        try:
            requests = container_requests(pod, self.cfg)
        except ValueError as e:
            return FilterResult(error=f"bad resource request: {e}")
        if not any(r.nums > 0 for r in requests):
            # Not ours: every candidate passes (the default scheduler
            # decides).
            return FilterResult()
        # The capacity-queue gate, before any fit: a governed pod stays
        # held until the admission loop releases it.
        hold = self.quota.gate(pod, requests)
        if hold is not None:
            return FilterResult(error=hold)
        # A compaction's beneficiary: the cards the defragmenter assembled
        # for this pod or gang rejoin the usage before the decision, so
        # the slice-aware fit lands on the freed box.
        self._release_reservation_for(pod)
        gang = gang_of(pod)
        if gang is not None:
            # A gang admission changes several nodes at once: it keeps the
            # lock, and its grants bump every placed node's rev, so racing
            # optimistic singles conflict and retry.
            with self._commit_lock:
                return self._decide_gang_locked(pod, requests, node_names,
                                                gang)
        if not self.cfg.optimistic_commit:
            with self._commit_lock:
                return self._decide_serial_locked(pod, requests, node_names)
        if self.cfg.filter_batch and self._batchable(requests):
            # The batch gate: concurrent Filters collapse into one cycle
            # (batch.py); other shapes take the per-pod path below.
            job = self._make_batch_job(pod, requests, node_names)
            if job is not None:
                result = self.batch.submit(job)
                if result.node is not None:
                    sp.set("batched", True)
                return result
        return self._decide_optimistic(pod, requests, node_names, sp)

    def _decide_optimistic(self, pod: dict, requests,
                           node_names: List[str],
                           sp: "trace.Span") -> FilterResult:
        """Evaluation without a lock, then a short validated commit.  Each
        attempt takes the immutable snapshot, fits the candidates (the
        pool and the fit cache), and under the commit lock re-checks that
        the winner's (pod rev, inventory rev) is the one it was fitted at.
        A lost race refits on the winner's live usage; failing that it
        retries on a fresh snapshot (the ``conflict-retry`` span), and
        after ``commit_retries`` losses decides serially, so a conflict
        storm degrades to the serial path instead of livelocking."""
        uid = pod_uid(pod)
        anns = pod.get("metadata", {}).get("annotations", {}) or {}
        tid = trace.trace_id_of(pod)
        tr = trace.tracer()
        # A retried Filter replaces its grant (reference Filter deletes
        # first, scheduler.go:284).
        self._del_pod_wt(uid)
        retries = max(0, self.cfg.commit_retries)
        attempt = 0
        while True:
            retry_span = (tr.span("conflict-retry", trace_id=tid,
                                  pod=pod_name(pod), attempt=attempt)
                          if attempt else nullcontext())
            with retry_span:
                eval_t0 = time.monotonic()
                snap = self.snapshot()
                best, failed = self._evaluate_candidates(
                    uid, requests, anns, node_names, snap)
                perf.registry().record("opt-evaluate",
                                       time.monotonic() - eval_t0)
            if best is None:
                plan = self._plan_preemption(pod, requests, anns,
                                             node_names, snap)
                return FilterResult(error=NO_FIT, failed=failed,
                                    preempt=plan)
            _, node, placement = best
            commit_t0 = time.monotonic()
            with tr.span("commit", trace_id=tid, pod=pod_name(pod),
                         node=node, attempt=attempt):
                with self._commit_lock:
                    entry = snap[node]
                    live = (self.pods.rev_of(node), self.nodes.rev_of(node))
                    conflicted = live != entry.key
                    if conflicted:
                        # Lost the race, most often to one grant on this
                        # node: refit on its live usage (one node's fit
                        # under the lock) before a whole new sweep.
                        entry, placement = self._commit_refit(
                            node, requests, anns, sp)
                    committed = False
                    while entry is not None:
                        pod_rev = self.pods.add_pod(PodInfo(
                            uid=uid, name=pod_name(pod),
                            namespace=pod_namespace(pod), node=node,
                            devices=placement,
                            priority=pod_priority(pod, self.cfg),
                            trace_id=tid, qos=pod_qos(pod)))
                        if pod_rev == entry.key[0] + 1:
                            self._publish_grants(node, entry,
                                                 [placement], pod_rev)
                            committed = True
                            break
                        # An informer event (the commit lock does not
                        # exclude the watch thread) landed between the rev
                        # read and the insert: the placement was fitted
                        # blind to it.  Undo and refit on the live view,
                        # which includes it.  Each pass needs another
                        # interleave inside the held lock, and a failed
                        # refit leaves for the outer retry.
                        self.pods.del_pod(uid)
                        conflicted = True
                        entry, placement = self._commit_refit(
                            node, requests, anns, sp)
            perf.registry().record("opt-commit",
                                   time.monotonic() - commit_t0)
            if conflicted:
                with self._busy_lock:
                    self.commit_conflicts += 1
                tr.event(uid, "commit-conflict", trace_id=tid, node=node,
                         attempt=attempt, refit=committed)
            if committed:
                if attempt:
                    sp.set("commit_retries", attempt)
                return FilterResult(node=node, failed=failed)
            attempt += 1
            if attempt > retries:
                sp.set("commit_fallback", True)
                with self._commit_lock:
                    return self._decide_serial_locked(
                        pod, requests, node_names)

    def _commit_refit(self, node: str, requests, anns: Dict[str, str],
                      sp: "trace.Span"):
        """:meth:`_refit_live_locked` for the commit section: ``(entry,
        placement)`` or ``(None, None)``, the span stamped on a refit."""
        got = self._refit_live_locked(node, requests, anns)
        if got is None:
            return None, None
        sp.set("commit_refit", True)
        return got

    def _refit_live_locked(self, node: str, requests,
                           anns: Dict[str, str]):
        """The commit lock's holder lost the race on ``node``: fit the pod
        on the node's live usage (from the cache at the current revs, or
        rebuilt) instead of dropping the decision.  ``(entry, placement)``,
        or None where the node's lease no longer takes placements, the
        node is gone or the pod no longer fits (the caller retries on a
        fresh snapshot)."""
        if self.leases.reject_reason(node) is not None:
            return None
        if self.shards.enabled \
                and self.shards.reject_reason(node) is not None:
            # The node's ownership moved between snapshot and commit (an
            # epoch bump): the retry decides again under the new map.
            return None
        with self._usage_cache_lock:
            entry = self._refresh_entry_locked(node)
        if entry is None:
            return None
        cow = score_mod.CowUsage(entry.usage)
        placement = score_mod.fit_pod(requests, cow, entry.info.topology,
                                      anns, self.cfg.topology_policy)
        if placement is None:
            return None
        return entry, placement

    def _publish_grants(self, node: str, entry: SnapEntry,
                        placements: List, final_rev: int) -> None:
        """After validated adds (commit lock held): publish the grants'
        effect on ``entry.usage`` into the cache at the new generation, so
        the next snapshot reuses it instead of rebuilding the node.  Only
        where nothing else interleaved: the rev chain must be unbroken
        (``final_rev`` is the validated rev plus the grants), and the
        inventory half of the key stays the validated one, so a racing
        re-registration's newer rev still forces a rebuild."""
        if final_rev != entry.key[0] + len(placements):
            return
        new_usage = self._grants_delta(entry, placements)
        if new_usage is None:
            return
        with self._usage_cache_lock:
            self._publish_usage_locked(node, entry, final_rev, new_usage)

    def _publish_usage_locked(self, node: str, entry: SnapEntry,
                              final_rev: int, new_usage: dict) -> None:
        cached = self._usage_cache.get(node)
        # Only over the exact map the grants were computed on: a racing
        # snapshot() that rebuilt it either has them already or still has
        # the node's dirty mark pending.
        if cached is not None and cached[1] is entry.usage:
            self._usage_cache[node] = ((final_rev, entry.key[1]),
                                       new_usage)

    def _publish_grants_many(self, publishes: List[Tuple]) -> None:
        """A batched commit chunk's publish: every node group under one
        usage-cache acquire.  Each item is ``(node, entry, placements,
        final_rev)`` with :meth:`_publish_grants`' chain proof
        (``add_pods_group`` makes ``final_rev`` the validated rev plus the
        group); the deltas are computed outside the lock."""
        staged = []
        for node, entry, placements, final_rev in publishes:
            new_usage = self._grants_delta(entry, placements)
            if new_usage is not None:
                staged.append((node, entry, final_rev, new_usage))
        if not staged:
            return
        with self._usage_cache_lock:
            for node, entry, final_rev, new_usage in staged:
                self._publish_usage_locked(node, entry, final_rev,
                                           new_usage)

    def _grants_delta(self, entry: SnapEntry, placements: List):
        """The grants' combined delta over ``entry.usage`` as a fresh map,
        or None where a card is unknown (the inventory shrank in flight;
        the dirty rebuild recomputes)."""
        return self._delta_usage(entry.usage, [
            container for placement in placements
            for container in placement], 1)

    @staticmethod
    def near_best_key(uid: str, node: str) -> int:
        """The near-best scatter's key: a digest of (pod, node) that is the
        same in every process.  The JAX scheduler keys on Python's
        ``hash((uid, node))``, which is salted per process, so its pick
        among near-equal nodes changes from run to run; the port's is
        stable (a stated departure, ``tests/test_torch_concurrency.py``)."""
        return zlib.crc32(f"{uid}\0{node}".encode())

    def _evaluate_candidates(self, uid: str, requests, anns: Dict[str, str],
                             node_names: List[str],
                             snap: Dict[str, SnapEntry]):
        """Score every candidate on the shared snapshot: ``(best, failed)``
        with ``best = (score, node, placement)`` or None.  Three tiers a
        candidate: the type prefilter (no copy, no scan), a fit-cache hit
        at the node's generation, a full ``CowUsage`` fit; only the last
        goes to the pool."""
        affinity = score_mod.parse_affinity(anns)
        policy = anns.get(score_mod.TOPOLOGY_POLICY_ANNOTATION,
                          self.cfg.topology_policy)
        failed: Dict[str, str] = {}
        candidates: List[str] = []
        # The shard gate, resolved once a decision: None when the layer is
        # inert; fail-closed shard-no-map refusals when it is on but has
        # seen no map.
        shard_gate = self.shards.candidate_gate()
        for name in node_names:
            entry = snap.get(name)
            if entry is None:
                failed[name] = "no GPU inventory registered"
                continue
            # The lease gate before any fit: a suspect or dead node takes
            # no new placement.
            why = self.leases.reject_reason(name)
            if why is not None:
                failed[name] = why
                continue
            # Another replica owns the node's placements.
            if shard_gate is not None:
                why = shard_gate(name)
                if why is not None:
                    failed[name] = why
                    continue
            # A type list that excludes every card of the node is decided
            # on the shared snapshot: no copy, no fit.
            why = score_mod.type_excluded(affinity, entry.usage)
            if why is not None:
                failed[name] = why
                continue
            candidates.append(name)

        # Everything a fit reads off the pod: its requests, type lists,
        # topology policy and declared mesh.  (The JAX fingerprint leaves
        # the mesh out, so there a mesh pod's cached rejection is served
        # to a plain pod of the same request: a stated departure,
        # tests/test_torch_concurrency.py.)
        fp = (tuple((r.nums, r.type, r.memreq, r.mem_percentage_req,
                     r.coresreq) for r in requests),
              None if affinity[0] is None else tuple(affinity[0]),
              tuple(affinity[1]), policy, anns.get(MESH_ANNOTATION, ""))

        outcomes: Dict[str, tuple] = {}
        misses: List[str] = []
        with self._fit_cache_lock:
            for name in candidates:
                hit = self._fit_cache.get((name, fp))
                if hit is not None and hit[0] == snap[name].key:
                    outcomes[name] = hit[1]
                else:
                    misses.append(name)

        def eval_one(name: str) -> tuple:
            entry = snap[name]
            cow = score_mod.CowUsage(entry.usage)
            why: Dict[str, str] = {}
            placement = score_mod.fit_pod(
                requests, cow, entry.info.topology, anns,
                self.cfg.topology_policy, reasons=why)
            if placement is None:
                return ("reject", why.get("reason",
                                          "insufficient GPU capacity"))
            s = score_mod.node_score(cow, self.cfg.node_scheduler_policy)
            return ("fit", s, placement)

        pool = self._eval_pool() if len(misses) >= 4 else None
        if pool is None:
            computed = [eval_one(n) for n in misses]
        else:
            computed = list(pool.map(self._count_busy(eval_one), misses))
        with self._fit_cache_lock:
            if len(self._fit_cache) > 8192:
                # Dropped whole at the cap: at worst a cold decision.
                self._fit_cache.clear()
            for name, outcome in zip(misses, computed):
                self._fit_cache[(name, fp)] = (snap[name].key, outcome)
                outcomes[name] = outcome

        fits: List[Tuple[float, str, List]] = []
        for name in candidates:
            outcome = outcomes[name]
            if outcome[0] == "reject":
                failed[name] = outcome[1]
                continue
            _, s, placement = outcome
            if self.cfg.score_by_actual:
                # Added at selection, never cached with the fit: the
                # ledger moves on its report cadence, not on the revs.
                s += eff_mod.actual_idle_bonus(
                    self.ledger, name, len(snap[name].usage))
            fits.append((s, name, placement))
        if not fits:
            return None, failed
        # The near-best scatter: a strict argmax sends every concurrent
        # Filter to the same node, where all but one lose the commit race.
        # Candidates within 1% of the best are taken as equal, and each pod
        # picks among them by its (pod, node) digest, so concurrent Filters
        # fan out; a node better by more than that always wins.
        s_max = max(f[0] for f in fits)
        eps = 0.01 * max(1.0, abs(s_max))
        best = min((f for f in fits if f[0] >= s_max - eps),
                   key=lambda f: self.near_best_key(uid, f[1]))
        # Fresh grant objects for the winner: cached fit outcomes are
        # shared across hits, and a grant must never alias them.
        return (best[0], best[1], self._copy_placement(best[2])), failed

    @staticmethod
    def _copy_placement(placement: List) -> List:
        return [[ContainerDevice(uuid=d.uuid, type=d.type,
                                 usedmem=d.usedmem, usedcores=d.usedcores)
                 for d in container] for container in placement]

    def _count_busy(self, fn):
        """Wrap a pool task with busy-worker accounting (the saturation
        gauge is the high-water mark)."""
        def wrapped(*a):
            with self._busy_lock:
                self._busy += 1
                if self._busy > self.workers_busy_peak:
                    self.workers_busy_peak = self._busy
            try:
                return fn(*a)
            finally:
                with self._busy_lock:
                    self._busy -= 1
        return wrapped

    def _eval_pool(self) -> Optional[ThreadPoolExecutor]:
        """The candidate-evaluation pool, made on first need; None fits in
        the calling thread (``filter_workers`` 1, or auto on one core).
        The fits are pure Python, so the threads overlap little under the
        GIL: on an 8-core H100 host the Filter storm ran as fast with
        ``filter_workers`` 1 (``tools/storm_workers.py``, PERF.md)."""
        if self._pool_unavailable:
            return None
        pool = self._pool
        if pool is None:
            with self._pool_lock:
                if self._pool is None and not self._pool_unavailable:
                    n = self.cfg.filter_workers
                    if n <= 0:
                        n = min(8, os.cpu_count() or 1)
                    if n <= 1:
                        self._pool_unavailable = True
                        return None
                    self._pool = ThreadPoolExecutor(
                        max_workers=n, thread_name_prefix="filter-eval")
                    self.worker_pool_size = n
                pool = self._pool
        return pool

    def _plan_preemption(self, pod: dict, requests, anns: Dict[str, str],
                         node_names: List[str],
                         snap: Dict[str, SnapEntry]
                         ) -> Optional[PreemptionPlan]:
        """The eviction plan for a pod that fits nowhere, on the decision's
        snapshot (the planner is pure and may scan every node's pods; it
        fits on usage it rebuilds from the registry).  Only the offered
        nodes that take placements count: room freed elsewhere is no use to
        the pod."""
        if not self.cfg.enable_preemption:
            return None
        # Gang members are never victims: evicting one hangs the rest of
        # its collective and frees a fraction of the gang's cards.
        gang_uids = {u for g in self.gangs.groups().values()
                     for u in (*g.members, *g.placements)}
        offered = set(node_names)
        # Nor the nodes another replica owns: the requester could not be
        # committed there.
        shard_gate = self.shards.candidate_gate()
        entries = {name: (e.info, e.usage) for name, e in snap.items()
                   if name in offered
                   and self.leases.reject_reason(name) is None
                   and (shard_gate is None or shard_gate(name) is None)}
        return plan_preemption(
            requests, pod_priority(pod, self.cfg), entries,
            self.pods.by_node(), anns, self.cfg.topology_policy,
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

    def _decide_serial_locked(self, pod: dict, requests,
                              node_names: List[str]) -> FilterResult:
        """The serial path (``optimistic_commit=False``, and the last resort
        after the optimistic retries), under the commit lock: every
        candidate fitted on a copy of its snapshot usage; the highest score
        wins, the first of equals in the candidates' order."""
        uid = pod_uid(pod)
        self.pods.del_pod(uid)  # a retried Filter replaces its grant
        anns = pod.get("metadata", {}).get("annotations", {}) or {}
        affinity = score_mod.parse_affinity(anns)
        snap = self.snapshot()
        clone = score_mod.clone_usage
        failed: Dict[str, str] = {}
        best: Optional[Tuple[float, str, list]] = None
        shard_gate = self.shards.candidate_gate()
        for name in node_names:
            entry = snap.get(name)
            if entry is None:
                failed[name] = "no GPU inventory registered"
                continue
            why = self.leases.reject_reason(name)
            if why is not None:
                failed[name] = why
                continue
            if shard_gate is not None:
                why = shard_gate(name)
                if why is not None:
                    failed[name] = why
                    continue
            why = score_mod.type_excluded(affinity, entry.usage)
            if why is not None:
                failed[name] = why
                continue
            usage = {cid: clone(u) for cid, u in entry.usage.items()}
            reasons: Dict[str, str] = {}
            placement = score_mod.fit_pod(requests, usage,
                                          entry.info.topology, anns,
                                          self.cfg.topology_policy, reasons)
            if placement is None:
                failed[name] = reasons.get("reason",
                                           "insufficient GPU capacity")
                continue
            s = score_mod.node_score(usage, self.cfg.node_scheduler_policy)
            if self.cfg.score_by_actual:
                s += eff_mod.actual_idle_bonus(self.ledger, name,
                                               len(entry.usage))
            if best is None or s > best[0]:
                best = (s, name, placement)
        if best is None:
            return FilterResult(
                error=NO_FIT, failed=failed,
                preempt=self._plan_preemption(pod, requests, anns,
                                              node_names, snap))
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

        # The immutable snapshot's entries: place_gang lays CowUsage views
        # over them.
        offered = set(node_names) if node_names else None
        shard_gate = self.shards.candidate_gate()
        usage = {name: (e.info, e.usage)
                 for name, e in self.snapshot().items()
                 if (offered is None or name in offered)
                 and self.leases.reject_reason(name) is None
                 and (shard_gate is None or shard_gate(name) is None)}
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

    # -- placement hooks (placement/) ------------------------------------------
    @staticmethod
    def _reservation_key(pod: dict) -> str:
        """Identity a slice demand / reservation is recorded under: the
        gang key for gang members (any member's arrival delivers the
        whole gang's box), else the pod uid."""
        g = gang_of(pod)
        if g is not None:
            return f"{pod_namespace(pod)}/{g[0]}"
        return pod_uid(pod)

    def _release_reservation_for(self, pod: dict) -> None:
        """If the defragmenter assembled a box for this pod or gang,
        return its cards to the usage before deciding."""
        key = self._reservation_key(pod)
        if self.reservations.holds_for(key):
            if not self.defrag.ready_for(key):
                # Mid-compaction (or a gang still short of boxes):
                # releasing now would let bystanders squat in the
                # partially-assembled hole.  The pod fails this Filter
                # and retries; the defrag loop keeps assembling.
                return
            released = self.reservations.release_for(key)
            log.info("placement: released reserved slice on %s for %s",
                     ",".join(sorted({r.node for r in released})), key)
            trace.tracer().event(pod_uid(pod), "slice-reservation-released",
                                 trace_id=trace.trace_id_of(pod),
                                 pod=pod_name(pod),
                                 chips=sum(len(r.chips) for r in released))

    def _note_slice_rejection(self, pod: dict, result: FilterResult) -> None:
        """Feed the defragmenter's demand registry: a multi-card pod that
        fit nowhere because no contiguous box exists (per-node
        ``no-ici-slice``/``no-mesh-slice`` reasons, or a gang whose atomic
        placement failed on a fleet with a fabric) is exactly the blocked
        demand compaction can unblock; a gang's rejection also feeds the
        resize controller's admission downgrade."""
        try:
            requests = container_requests(pod, self.cfg)
        except ValueError:
            return
        chips = max((r.nums for r in requests), default=0)
        if chips <= 1:
            return
        gang = gang_of(pod)
        slice_blocked = False
        if result.failed:
            # Explicit slice tokens are certain fragmentation; card-
            # availability tokens are how fragmentation presents when
            # eligible whole cards run short.  Resource-shaped tokens
            # (insufficient-hbm/-cores, type-mismatch, unhealthy) are NOT
            # demand: compaction assembles free cards, it cannot mint
            # memory or card types.
            frag_tokens = ("no-ici-slice", "no-mesh-slice",
                           "too-few-chips", "exclusive-chip-busy",
                           "slots-exhausted", "cores-exhausted")
            slice_blocked = any(
                r.startswith(frag_tokens)
                for r in result.failed.values())
        elif gang is not None and result.error \
                and "no atomic placement" in result.error:
            # Gang admission reports no per-node reasons; quota holds and
            # waiting gangs carry neither a failed map nor this error.
            slice_blocked = any(
                e.info.topology is not None
                for e in self.snapshot().values())
        if not slice_blocked:
            return
        # A declared mesh travels with the demand: the defragmenter must
        # assemble a box REALIZING its axes, not just its volume.
        mesh_local = None
        mesh_value = pod.get("metadata", {}).get(
            "annotations", {}).get(MESH_ANNOTATION, "")
        if mesh_value:
            try:
                mesh_local, _why = local_mesh_for(
                    parse_mesh(mesh_value), chips)
            except ValueError:
                mesh_local = None
        self.defrag.observe_rejection(
            self._reservation_key(pod), pod_namespace(pod),
            pod_name(pod), chips,
            count=gang[1] if gang is not None else 1,
            mesh=mesh_local)
        if gang is not None:
            # A blocked PENDING elastic gang is stepped down a rung once
            # the defragmenter has had its shot (a no-op for other gangs
            # and with enable_elastic off).
            self.elastic.observe_rejection(self._reservation_key(pod))

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

    def close(self) -> None:
        """Stop the background loops, drain the solve workers (unlinking
        their shared-memory segments) and release the candidate-evaluation
        pool (idempotent).  The daemon calls it on exit; embedders and
        tests that build and discard schedulers call it so no loop or pool
        thread outlives its scheduler."""
        self.rescuer.stop()
        self.admission.stop()
        self.defrag.stop()
        self.elastic.stop()
        self.shards.stop()
        self.batch.close()
        with self._pool_lock:
            pool, self._pool = self._pool, None
            self._pool_unavailable = False
        if pool is not None:
            pool.shutdown(wait=False)

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
