"""The ResizeController: mesh shape as a scheduler-managed variable (the
port's copy of the JAX package's ``elastic/controller.py``).

A gang that declared a mesh range (:mod:`.ranges`) is *elastic*: the
scheduler may move it between the range's rungs instead of treating its
admission shape as forever.  Three movers exist, all funneled through
one protocol:

- **Shrink on demand**: the quota-reclaim pass and the defragmenter,
  when they need cards an elastic gang holds, ask for a shrink instead
  of an eviction (requester keys ``rescue:reclaim:…`` /
  ``rescue:defrag:…``).  The gang checkpoints and re-admits one rung
  down; the net freed cards go to the beneficiary.  Cheaper than a
  kill: the job keeps running at reduced width rather than queueing.
- **Grow on surplus**: the controller's own tick (requester key
  ``elastic:grow:…``) steps a below-max gang one rung up when the
  reserved-stripped fleet already holds enough member-local boxes for
  the larger shape, after a hysteresis window so a gang never thrashes
  between shapes (a suppressed flip increments the thrash counter
  instead of resizing).
- **Admission downgrade**: a PENDING elastic gang whose atomic
  placement keeps failing is stepped down a rung (requester key
  ``elastic:admission:…``) until it fits: "admit at the largest shape
  that fits", a feedback loop on Filter rejections.

The resize protocol is a whole-gang checkpoint-restart: members each
request a fixed ``nums`` cards, so changing shape means changing the
member count.  The controller patches ``vtpu.dev/mesh-assigned`` on
every member, then routes the members through the scheduler's OWN
preemption machinery (``_request_preemptions`` with a synthetic
requester).  The victims land in the shared preemption ledger, so quota
reclaim, the defragmenter, priority preemption and the rescuer all see
them as in-flight and never stack a second eviction or resize on the
same gang (the no-double-evict contract).  The in-container watch
checkpoints at a step boundary and exits; the workload controller
observes ``mesh-assigned`` on the terminated members and recreates the
gang at the new shape (new ``vtpu.dev/mesh``, new ``pod-group-total``,
fresh uids); re-admission flows through the ordinary gang path and
resumes bit for bit from the checkpoint.

Where the port departs from the JAX module, each place says so: the
resize records the JAX controller sends to its provenance store
(``resize-shrink``/``-grow`` on every member) are left out until the
provenance slice (ROADMAP A.5), as the rescuer's and the admission
loop's are.  Under active replicas (``shard/``) one elected replica plans
(``shards.leads("elastic")``); resizes in flight drain on the replica
that started them.  This module imports no torch, grpc or protobuf.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..placement.frag import fleet_views
from ..util import perf
from ..placement.mesh import (
    MESH_ANNOTATION,
    local_mesh_for,
    mesh_box_shapes,
    mesh_volume,
    parse_mesh,
    shaped_box_availability,
)
from .ranges import (
    MESH_ASSIGNED_ANNOTATION,
    MESH_MAX_ANNOTATION,
    MESH_MIN_ANNOTATION,
    format_mesh,
    mesh_ladder,
    next_larger,
    next_smaller,
)

log = logging.getLogger(__name__)

#: Requester-key namespace for resize requests the controller itself
#: originates.  Like ``rescue:``, these uids never belong to a real pod:
#: preemption-ledger reconciliation must leave their annotations to
#: their owner (``core._reconcile_preemptions`` skips the prefix).
ELASTIC_VALUE_PREFIX = "elastic:"
#: Grow restarts (controller tick; surplus capacity).
GROW_REQUESTER_PREFIX = "elastic:grow:"
#: Pending-gang admission downgrades (no preemption ledger involved:
#: nothing is placed).
ADMISSION_REQUESTER_PREFIX = "elastic:admission:"
#: Quota-reclaim shrinks (``quota/admission.py``'s shrink pass).  Shares
#: the rescuer's ``rescue:`` namespace for the same reconciliation
#: reason.
RECLAIM_SHRINK_PREFIX = "rescue:reclaim:"


def requester_label(requester_key: str) -> str:
    """Bounded-cardinality requester class for the metrics: the key's
    namespace, never the per-gang suffix."""
    for prefix, lab in ((RECLAIM_SHRINK_PREFIX, "reclaim"),
                        ("rescue:defrag:", "defrag"),
                        (GROW_REQUESTER_PREFIX, "grow"),
                        (ADMISSION_REQUESTER_PREFIX, "admission")):
        if requester_key.startswith(prefix):
            return lab
    return "other"


@dataclasses.dataclass(frozen=True)
class ElasticConfig:
    #: Master gate (``--enable-elastic``).  Off: the controller never
    #: plans, shrink offers are empty, and every existing path is
    #: byte-identical to a build without the subsystem.
    enabled: bool = False
    #: Background tick period (``vgpu-scheduler --elastic-interval``).
    interval_s: float = 10.0
    #: Minimum quiet time after any resize before the SAME gang may
    #: grow (``--resize-hysteresis``).  A grow attempt inside the window
    #: right after a shrink is thrash: suppressed and counted.
    hysteresis_s: float = 300.0
    #: How long resized members get to checkpoint and exit before the
    #: resize aborts and mesh-assigned is rolled back.
    checkpoint_grace_s: float = 120.0
    #: A pending gang must stay Filter-rejected this long before the
    #: controller steps it down a rung (gives defrag the first shot at
    #: assembling the larger shape).
    downgrade_after_s: float = 30.0


@dataclasses.dataclass
class ElasticGang:
    """One elastic gang's rung position, derived from the gang registry
    (members carry their annotations from observe time)."""

    key: str                      # "<namespace>/<group>"
    namespace: str
    group: str
    nums: int                     # per-member cards (fixed for life)
    current: Tuple[int, ...]      # the generation's vtpu.dev/mesh
    ladder: List[Tuple[int, ...]]
    member_uids: List[str]
    admitted: bool

    @property
    def at_max(self) -> bool:
        return bool(self.ladder) and \
            mesh_volume(self.current) >= mesh_volume(self.ladder[0])


@dataclasses.dataclass
class _Demand:
    """A pending elastic gang's Filter keeps rejecting: the admission-
    downgrade feedback signal (``core._note_slice_rejection`` feeds it)."""

    key: str
    first_seen: float
    last_seen: float
    rejections: int = 1


@dataclasses.dataclass
class _Resize:
    key: str
    direction: str                # "shrink" | "grow"
    requester_key: str
    mesh_from: Tuple[int, ...]
    mesh_to: Tuple[int, ...]
    victims: List[Tuple[str, str, str]]   # (uid, namespace, name)
    asked_at: float


class ResizeController:
    """Owns elastic gang resizes.  The Defragmenter's lifecycle: a plain
    ``tick()`` the simulator and tests drive on a virtual clock, and
    ``start()`` wrapping it in a daemon thread."""

    def __init__(self, scheduler, cfg: Optional[ElasticConfig] = None,
                 clock=None) -> None:
        self.s = scheduler
        self.cfg = cfg or ElasticConfig()
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._in_flight: Dict[str, _Resize] = {}
        self._demand: Dict[str, _Demand] = {}
        #: key -> (stamp, direction, thrash_counted): the hysteresis
        #: record a grow attempt is paced against.
        self._last_resize: Dict[str, Tuple[float, str, bool]] = {}
        #: key -> no-replan-before time (aborted resizes back off).
        self._backoff: Dict[str, float] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: Lifetime counters (exporter and simulator report):
        #: (direction, requester label) -> count.
        self.resizes_total: Dict[Tuple[str, str], int] = {}
        self.thrash_total = 0
        self.completed_total = 0
        self.aborted_total = 0

    # -- discovery ------------------------------------------------------------
    def elastic_gangs(self) -> List[ElasticGang]:
        """Every registered gang that declared a valid mesh range, with
        its rung ladder against the fleet's current topologies.  A pure
        read over the gang registry: the controller keeps no membership
        state of its own, so recreated generations (fresh uids, same
        group name) are picked up the moment they are observed."""
        topos = self.s.known_topologies()
        out: List[ElasticGang] = []
        for key, g in sorted(self.s.gangs.groups().items()):
            chosen = None
            for uid in sorted(g.members):
                m = g.members[uid]
                if MESH_MIN_ANNOTATION in m.annotations \
                        and MESH_MAX_ANNOTATION in m.annotations:
                    chosen = m
                    break
            if chosen is None:
                continue
            anns = chosen.annotations
            try:
                mn = parse_mesh(anns[MESH_MIN_ANNOTATION])
                mx = parse_mesh(anns[MESH_MAX_ANNOTATION])
                cur = parse_mesh(anns.get(MESH_ANNOTATION, ""))
            except ValueError:
                continue  # a malformed range that bypassed the webhook
            nums = max((r.nums for r in chosen.requests), default=0)
            if nums <= 0:
                continue
            ladder = mesh_ladder(mn, mx, nums, topos)
            if tuple(cur) not in ladder:
                continue  # not on a rung: never resize what is not modelled
            namespace, _, group = key.partition("/")
            out.append(ElasticGang(
                key=key, namespace=namespace, group=group, nums=nums,
                current=tuple(cur), ladder=ladder,
                member_uids=sorted(g.members), admitted=g.admitted))
        return out

    def shrinkable_uids(self) -> Dict[str, str]:
        """uid -> gang key for every member of an admitted elastic gang
        that can step down a rung right now: the defragmenter's and the
        reclaim planner's eligibility set.  Empty when disabled, so the
        off switch keeps both planners byte-identical."""
        if not self.cfg.enabled:
            return {}
        now = self._clock()
        with self._lock:
            in_flight = set(self._in_flight)
            backoff = dict(self._backoff)
        out: Dict[str, str] = {}
        for g in self.elastic_gangs():
            if not g.admitted or g.key in in_flight:
                continue
            if backoff.get(g.key, 0.0) > now:
                continue
            if next_smaller(g.ladder, g.current) is None:
                continue
            if self._members_busy(g):
                continue
            for uid in g.member_uids:
                out[uid] = g.key
        return out

    def _members_busy(self, g: ElasticGang) -> bool:
        """True when any member is already mid-eviction elsewhere (a
        rescuer sweep or another requester's preemption): the symmetric
        half of the no-double-evict contract."""
        pending = set(self.s.rescuer.pending())
        with self.s._preempt_lock:
            pending |= set(self.s._preempt_requested)
        return any(uid in pending for uid in g.member_uids)

    def gang(self, key: str) -> Optional[ElasticGang]:
        for g in self.elastic_gangs():
            if g.key == key:
                return g
        return None

    # -- demand (admission downgrade feedback) --------------------------------
    def observe_rejection(self, key: str) -> None:
        """``core._note_slice_rejection`` saw a gang member fit nowhere.
        Only the gang key is recorded: the tick re-derives everything
        else from the registry."""
        if not self.cfg.enabled:
            return
        now = self._clock()
        with self._lock:
            d = self._demand.get(key)
            if d is None:
                self._demand[key] = _Demand(key=key, first_seen=now,
                                            last_seen=now)
            else:
                d.last_seen = now
                d.rejections += 1

    def demand_satisfied(self, key: str) -> None:
        """The gang placed: stop considering it for downgrade."""
        with self._lock:
            self._demand.pop(key, None)

    def in_flight(self) -> Dict[str, _Resize]:
        with self._lock:
            return dict(self._in_flight)

    def pod_states(self) -> Dict[str, int]:
        """Member-pod counts by elastic state (``vtpu_elastic_pods``)."""
        states = {"at-max": 0, "shrunk": 0, "resizing": 0, "pending": 0}
        with self._lock:
            in_flight = set(self._in_flight)
        for g in self.elastic_gangs():
            n = len(g.member_uids)
            if g.key in in_flight:
                states["resizing"] += n
            elif not g.admitted:
                states["pending"] += n
            elif g.at_max:
                states["at-max"] += n
            else:
                states["shrunk"] += n
        return states

    # -- the resize protocol --------------------------------------------------
    def begin_shrink(self, key: str, requester_key: str,
                     reason: str = "") -> Optional[dict]:
        """Step gang ``key`` one rung down on behalf of
        ``requester_key`` (reclaim, defrag, or the controller itself).
        Patches ``mesh-assigned`` on every member and routes the members
        through the shared preemption ledger under the requester key.
        Returns the action record (net freed cards for the caller's
        demand accounting), or None when the gang cannot shrink now."""
        if not self.cfg.enabled:
            return None
        g = self.gang(key)
        if g is None or not g.admitted:
            return None
        now = self._clock()
        with self._lock:
            if key in self._in_flight or \
                    self._backoff.get(key, 0.0) > now:
                return None
        target = next_smaller(g.ladder, g.current)
        if target is None:
            return None
        if self._members_busy(g):
            return None
        return self._execute_resize(g, target, "shrink", requester_key,
                                    reason, now)

    def begin_grow(self, key: str, reason: str = "") -> Optional[dict]:
        """Step gang ``key`` one rung up (controller-originated; the
        tick has already checked hysteresis and capacity)."""
        g = self.gang(key)
        if g is None or not g.admitted:
            return None
        target = next_larger(g.ladder, g.current)
        if target is None:
            return None
        if self._members_busy(g):
            return None
        return self._execute_resize(g, target, "grow",
                                    GROW_REQUESTER_PREFIX + key,
                                    reason, self._clock())

    def _execute_resize(self, g: ElasticGang, target: Tuple[int, ...],
                        direction: str, requester_key: str, reason: str,
                        now: float) -> Optional[dict]:
        from ..scheduler.preempt import PreemptionPlan

        members = [self.s.pods.get(uid) for uid in g.member_uids]
        members = [m for m in members if m is not None]
        if len(members) != len(g.member_uids):
            # A member vanished between plan and execute: the gang is
            # already churning (crash, completion); replan next tick.
            return None
        assigned = format_mesh(target)
        for m in members:
            try:
                self.s.client.patch_pod_annotations(
                    m.namespace, m.name,
                    {MESH_ASSIGNED_ANNOTATION: assigned})
            except Exception as e:  # noqa: BLE001 — next tick retries
                log.error("elastic: mesh-assigned patch for %s/%s "
                          "failed: %s", m.namespace, m.name, e)
                return None
            # The JAX controller records resize-<direction> for each
            # member in its provenance store here; the port has none yet.
        node = getattr(members[0], "node", "") or ""
        requester = {"metadata": {
            "uid": requester_key, "name": f"resize:{g.group}",
            "namespace": g.namespace}}
        self.s._request_preemptions(
            requester, PreemptionPlan(node=node, victims=members))
        with self._lock:
            self._in_flight[g.key] = _Resize(
                key=g.key, direction=direction,
                requester_key=requester_key, mesh_from=g.current,
                mesh_to=tuple(target),
                victims=[(m.uid, m.namespace, m.name) for m in members],
                asked_at=now)
            self._last_resize[g.key] = (now, direction, False)
            lab = (direction, requester_label(requester_key))
            self.resizes_total[lab] = self.resizes_total.get(lab, 0) + 1
        freed = mesh_volume(g.current) - mesh_volume(target)
        log.warning(
            "elastic: %s gang %s %s -> %s (%d member(s), net %+d cards) "
            "for %s%s", direction, g.key, format_mesh(g.current),
            assigned, len(members), -freed, requester_key,
            f" ({reason})" if reason else "")
        return {"kind": f"resize-{direction}", "gang": g.key,
                "from": format_mesh(g.current), "to": assigned,
                "freed_chips": freed, "members": len(members),
                "requester": requester_key}

    def _downgrade_pending(self, g: ElasticGang, now: float
                           ) -> Optional[dict]:
        """Step a still-pending gang one rung down: patch mesh-assigned
        on the unplaced members so the workload controller resubmits at
        the smaller shape.  No preemption ledger (nothing holds cards);
        the counters record the move (the JAX controller's provenance
        record of it is left out, as in ``_execute_resize``)."""
        target = next_smaller(g.ladder, g.current)
        if target is None:
            return None
        requester_key = ADMISSION_REQUESTER_PREFIX + g.key
        assigned = format_mesh(target)
        patched = 0
        for uid in g.member_uids:
            m = self.s.pods.get(uid)
            gm = self.s.gangs.groups().get(g.key)
            name = m.name if m is not None else (
                gm.members[uid].name if gm and uid in gm.members else "")
            if not name:
                continue
            try:
                self.s.client.patch_pod_annotations(
                    g.namespace, name,
                    {MESH_ASSIGNED_ANNOTATION: assigned})
                patched += 1
            except Exception as e:  # noqa: BLE001 — next tick retries
                log.info("elastic: downgrade patch for %s/%s not "
                         "written (%s)", g.namespace, name, e)
                continue
        if patched == 0:
            return None
        with self._lock:
            self._last_resize[g.key] = (now, "shrink", False)
            self._demand.pop(g.key, None)
            # The registry keeps the pending members until the workload
            # controller recreates them; without a backoff the next tick
            # would step the SAME generation down again.
            self._backoff[g.key] = now + self.cfg.downgrade_after_s
            lab = ("shrink", "admission")
            self.resizes_total[lab] = self.resizes_total.get(lab, 0) + 1
        log.warning(
            "elastic: pending gang %s cannot place at %s; downgrading "
            "to %s", g.key, format_mesh(g.current), assigned)
        return {"kind": "resize-downgrade", "gang": g.key,
                "from": format_mesh(g.current), "to": assigned,
                "requester": requester_key}

    # -- the tick -------------------------------------------------------------
    def tick(self) -> List[dict]:
        """One elastic pass: progress in-flight resizes, downgrade
        blocked pending gangs, then plan at most ONE grow.  Returns the
        actions taken (tests, the simulator report).  Timed into the
        ``elastic-tick`` phase of the performance observatory."""
        with perf.phase_timer("elastic-tick"):
            return self._tick()

    def _tick(self) -> List[dict]:
        now = self._clock()
        actions: List[dict] = []
        self._progress_in_flight(now, actions)
        self._prune(now)
        if not self.cfg.enabled:
            return actions
        shards = getattr(self.s, "shards", None)
        if shards is not None and not shards.leads("elastic"):
            # One elected replica plans resizes (a grow's capacity check
            # spans the whole fleet); those in flight above drain here.
            return actions
        gangs = self.elastic_gangs()
        with self._lock:
            in_flight = set(self._in_flight)
            demand = dict(self._demand)
            backoff = dict(self._backoff)
        for g in gangs:
            if g.admitted or g.key in in_flight:
                continue
            if backoff.get(g.key, 0.0) > now:
                continue
            d = demand.get(g.key)
            if d is None or d.rejections < 2 \
                    or now - d.first_seen < self.cfg.downgrade_after_s:
                continue
            act = self._downgrade_pending(g, now)
            if act is not None:
                actions.append(act)
        grew = False
        for g in gangs:
            if grew or not g.admitted or g.key in in_flight:
                continue
            if backoff.get(g.key, 0.0) > now or g.at_max:
                continue
            target = next_larger(g.ladder, g.current)
            if target is None:
                continue
            # Capacity BEFORE hysteresis: a grow that has no room is not
            # thrash, just a full fleet.  Only a grow the fleet could
            # satisfy right now, suppressed because the gang JUST shrank,
            # is the oscillation signal.
            if not self._grow_capacity_ok(g, target):
                continue
            if not self._hysteresis_open(g.key, now):
                continue
            act = self.begin_grow(g.key, reason="capacity freed")
            if act is not None:
                actions.append(act)
                grew = True  # one grow restart per tick is disruption enough
        return actions

    def _hysteresis_open(self, key: str, now: float) -> bool:
        """May ``key`` grow now?  Inside the quiet window after a
        shrink the attempt is thrash: suppressed and counted ONCE per
        resize (a per-tick count would just measure the tick rate)."""
        with self._lock:
            last = self._last_resize.get(key)
            if last is None:
                return True
            stamp, direction, counted = last
            if now - stamp >= self.cfg.hysteresis_s:
                return True
            if direction == "shrink" and not counted:
                self.thrash_total += 1
                self._last_resize[key] = (stamp, direction, True)
            return False

    def _grow_capacity_ok(self, g: ElasticGang,
                          target: Tuple[int, ...]) -> bool:
        """Conservative pre-flight: the reserved-stripped fleet must
        already hold enough free member-local boxes for the WHOLE larger
        gang, without counting the cards the gang itself will free, so
        the restarted generation admits first try instead of gambling
        its running incarnation on a maybe."""
        nums = g.nums
        local, _why = local_mesh_for(target, nums)
        if local is None:
            return False
        new_total = mesh_volume(target) // nums
        boxes = 0
        for v in fleet_views(self.s.snapshot()):
            shapes = mesh_box_shapes(local, v.topo.mesh)
            if shapes:
                boxes += shaped_box_availability(
                    v.topo, frozenset(v.free), shapes)
            if boxes >= new_total:
                return True
        return boxes >= new_total

    def _progress_in_flight(self, now: float,
                            actions: List[dict]) -> None:
        with self._lock:
            flights = list(self._in_flight.items())
        for key, fl in flights:
            remaining = [(uid, ns, name) for uid, ns, name in fl.victims
                         if self.s.pods.get(uid) is not None]
            if not remaining:
                with self._lock:
                    self._in_flight.pop(key, None)
                    self.completed_total += 1
                self.s._rescind_preemptions(fl.requester_key)
                actions.append({
                    "kind": "resize-complete", "gang": key,
                    "direction": fl.direction,
                    "to": format_mesh(fl.mesh_to)})
                log.info("elastic: %s of %s to %s checkpointed; "
                         "awaiting re-admission", fl.direction, key,
                         format_mesh(fl.mesh_to))
                continue
            if now - fl.asked_at > self.cfg.checkpoint_grace_s:
                with self._lock:
                    self._in_flight.pop(key, None)
                    self.aborted_total += 1
                    self._backoff[key] = now + self.cfg.checkpoint_grace_s
                self.s._rescind_preemptions(fl.requester_key)
                for _uid, ns, name in remaining:
                    try:
                        self.s.client.patch_pod_annotations(
                            ns, name, {MESH_ASSIGNED_ANNOTATION: ""})
                    except Exception as e:  # noqa: BLE001 — pod may be gone
                        log.info("elastic: mesh-assigned rollback for "
                                 "%s/%s not written (%s)", ns, name, e)
                actions.append({
                    "kind": "resize-abort", "gang": key,
                    "direction": fl.direction,
                    "stuck": [uid for uid, _, _ in remaining]})
                log.warning(
                    "elastic: %d member(s) of %s did not checkpoint "
                    "within %.0fs; aborting %s", len(remaining), key,
                    self.cfg.checkpoint_grace_s, fl.direction)

    def _prune(self, now: float) -> None:
        with self._lock:
            stale = [k for k, d in self._demand.items()
                     if now - d.last_seen > 10 * self.cfg.interval_s]
            for k in stale:
                del self._demand[k]
            for k in [k for k, t in self._backoff.items() if t <= now]:
                del self._backoff[k]
            horizon = max(self.cfg.hysteresis_s * 4, 3600.0)
            for k in [k for k, (t, _, _) in self._last_resize.items()
                      if now - t > horizon]:
                del self._last_resize[k]

    # -- background thread -----------------------------------------------------
    def start(self, interval_s: Optional[float] = None) -> None:
        if self._thread is not None:
            return
        period = interval_s if interval_s is not None \
            else self.cfg.interval_s

        def loop() -> None:
            while not self._stop.wait(period):
                try:
                    self.tick()
                except Exception:  # noqa: BLE001 — keep resizing through glitches
                    log.exception("elastic tick failed")

        self._thread = threading.Thread(target=loop, name="elastic-resize",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
