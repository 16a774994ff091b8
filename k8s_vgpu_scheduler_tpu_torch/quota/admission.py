"""The admission loop: releases held pods in weighted fair-share order (the
port's copy of the JAX package's ``quota/admission.py``).

Each tick (a plain method: tests drive it on a virtual clock; ``start()``
runs it in the daemon's thread, as the rescuer runs):

1. prune the entries whose pod placed or vanished;
2. per-queue usage (granted plus released-unplaced) and the fleet release
   throttle (cards registered less cards outstanding: releasing far past
   the fleet would only move the waiting line into Filter, where fairness
   no longer orders it);
3. release admissible pods, the lowest weighted dominant share first,
   re-sorted after every release; a ready gang releases all its members
   at once, and while a gang accumulates members the backfill rule may
   release smaller pods ahead of it: those that fit outside the gang's
   estimated footprint, or that declare a runtime ending inside the
   gang's reservation window (``scheduler/gang.py``'s expiry), so the
   gang is never starved by its own queue;
4. reclaim for starved in-quota queues (``reclaim.py``) through the
   scheduler's checkpoint-first preemption requests;
5. publish ``vtpu.dev/queue-position`` and events, so ``kubectl describe
   pod`` explains the wait.

Apiserver writes happen with no scheduler lock held; the release in
memory is the gate's truth, and a failed patch is retried next tick.

Left out until their slices of ROADMAP A.5: the elastic shrink pass and
the provenance records.  The last tick's blocked heads stay readable
(``blocked``): the queue, the head's uid and the reason.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

from .fairshare import fair_share_order, queue_efficiencies
from .queues import (
    QUEUE_POSITION_ANNOTATION,
    QUEUE_STATE_ANNOTATION,
    STATE_ADMITTED,
    STATE_HELD,
    QueueEntry,
    QueueUsage,
    grant_chips,
)
from .reclaim import plan_reclaim

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    #: Background tick period (--admission-interval).
    interval_s: float = 2.0
    #: How long a released pod may sit unplaced before its queue (if under
    #: nominal) reclaims borrowed grants, and the per-queue floor between
    #: reclaim plans (--queue-reclaim-grace).
    reclaim_grace_s: float = 15.0
    #: Fold measured grant efficiency into the weights
    #: (--fair-share-usage-informed).
    usage_informed: bool = False
    #: Gang-aware backfill on or off (--no-queue-backfill).
    backfill: bool = True
    #: Reclaim on or off (--no-reclaim).
    reclaim: bool = True
    #: The release throttle's multiplier over registered cards; above 1.0
    #: where split-count sharing packs many grants on a card.
    fleet_headroom: float = 1.0


class AdmissionLoop:
    def __init__(self, scheduler, cfg: Optional[AdmissionConfig] = None,
                 clock=None) -> None:
        self.s = scheduler
        self.cfg = cfg or AdmissionConfig()
        self._clock = clock or time.monotonic
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: The last tick's blocked heads: queue -> (uid, reason).
        self.blocked: Dict[str, Tuple[str, str]] = {}
        #: queue name -> clock time of its last reclaim plan.
        self._last_reclaim: Dict[str, float] = {}

    # -- one tick --------------------------------------------------------------
    def tick(self, now: Optional[float] = None) -> List[dict]:
        """One admission pass; returns the actions taken (``admit`` and
        ``reclaim`` records, the loop's observable log)."""
        mgr = self.s.quota
        if not mgr.enabled:
            return []
        now = self._clock() if now is None else now
        actions: List[dict] = []
        registry = self.s.pods
        mgr.prune_with(lambda uid: registry.get(uid) is not None, now)
        self._retry_unwritten_releases(mgr)

        # Aggregates and granted membership of one instant: a grant
        # recorded between two separate reads would count in neither.
        entries = mgr.entries()
        admitted_uids = [e.uid for e in entries
                         if e.state == STATE_ADMITTED]
        ns_usage, granted = registry.ns_usage_snapshot(admitted_uids)
        usage = mgr.usage_from(ns_usage, granted.__contains__)
        fleet_cap = self._fleet_chip_cap()
        outstanding = sum(chips for chips, _ in ns_usage.values())
        for e in entries:
            if e.state == STATE_ADMITTED and e.uid not in granted:
                outstanding += e.chips

        effs = None
        if self.cfg.usage_informed:
            by_ns = {ns: q.name for q in mgr.queues.values()
                     for ns in q.namespaces}
            try:
                effs = queue_efficiencies(self.s.grant_efficiency(now),
                                          by_ns)
            except Exception:  # noqa: BLE001 — the ledger never blocks admission
                log.exception("usage-informed fair share: efficiency join "
                              "failed; using the configured weights")

        # One release a pass, shares re-sorted after each, so contended
        # capacity goes in weight proportion.
        held_by_queue: Dict[str, List[QueueEntry]] = {
            qname: [] for qname in mgr.queues}
        for e in sorted(entries, key=lambda e: (e.enqueued_at, e.uid)):
            if e.state == STATE_HELD and e.queue in held_by_queue:
                held_by_queue[e.queue].append(e)
        blocked: Dict[str, Tuple[QueueEntry, str]] = {}
        state = {"outstanding": outstanding}
        for _ in range(256):
            order = fair_share_order(mgr.queues, usage, effs,
                                     self.cfg.usage_informed)
            if not self._release_next(order, held_by_queue, usage,
                                      fleet_cap, state, blocked, actions,
                                      now):
                break
        self.blocked = {q: (e.uid, why) for q, (e, why) in blocked.items()}

        if self.cfg.reclaim:
            self._reclaim_pass(usage, blocked, actions, now)
        self._publish_positions()
        return actions

    # -- fleet throttle --------------------------------------------------------
    def _fleet_chip_cap(self) -> Optional[float]:
        """Cards registered fleet-wide times the headroom (None: no
        inventory yet, so a cold control plane gates on quota alone)."""
        if self.s.nodes.count() == 0:
            return None
        return max(0.0, self.s.nodes.total_chips() * self.cfg.fleet_headroom)

    @staticmethod
    def _fits_fleet(chips: int, fleet_cap: Optional[float],
                    state: dict) -> bool:
        return fleet_cap is None or \
            state["outstanding"] + chips <= fleet_cap

    # -- the backfill's QoS interlock ------------------------------------------
    def _measured_idle_chips(self) -> Optional[float]:
        """Cards of the fleet with no dispatching container, from the
        usage ledger's fresh reports (``node_busy_chips``); None where no
        node was measured (an unmonitored fleet: the interlock stands
        down)."""
        idle: Optional[float] = None
        for name, info in self.s.nodes.list_nodes().items():
            busy = self.s.ledger.node_busy_chips(name)
            if busy is None:
                continue
            idle = (idle or 0.0) + max(0.0, len(info.devices) - busy)
        return idle

    def _backfill_idle_ok(self, entry: QueueEntry, state: dict) -> bool:
        """A best-effort backfill lands next to running pods at once, so
        it must fit in the measured idle cards; other classes, and an
        unmeasured fleet, pass."""
        if entry.qos != "best-effort":
            return True
        if "qos_idle" not in state:
            state["qos_idle"] = self._measured_idle_chips()
        idle = state["qos_idle"]
        return idle is None or idle >= entry.chips

    # -- release ---------------------------------------------------------------
    def _release_next(self, order, held_by_queue, usage, fleet_cap, state,
                      blocked, actions, now: float) -> bool:
        mgr = self.s.quota
        for _share, qname in order:
            q = mgr.queues[qname]
            held = held_by_queue[qname]
            if not held:
                continue
            head = held[0]
            if head.gang is not None:
                if self._release_gang(q, head, held, usage, fleet_cap,
                                      state, blocked, actions, now):
                    return True
                continue
            ok, why = mgr.fits_quota(q, usage, head.chips, head.mem_mib)
            if ok and not self._fits_fleet(head.chips, fleet_cap, state):
                ok, why = False, "fleet capacity exhausted"
            if not ok:
                blocked.setdefault(qname, (head, why))
                continue
            self._release_one(q, head, held, usage, state, actions)
            return True
        return False

    def _release_gang(self, q, head: QueueEntry, held: List[QueueEntry],
                      usage, fleet_cap, state, blocked, actions,
                      now: float) -> bool:
        """The queue's head is a gang member.  A ready gang (every member
        held) releases all its members at once; an accumulating gang holds
        the head, and the backfill rule tries the entries behind it."""
        # Deferred: the scheduler package imports the queues.
        from ..scheduler.gang import GANG_EXPIRE_SECONDS

        mgr = self.s.quota
        members = [e for e in held if e.gang == head.gang]
        if len(members) >= head.gang_total > 0:
            members = members[:head.gang_total]
            chips = sum(e.chips for e in members)
            mem = sum(e.mem_mib for e in members)
            ok, why = mgr.fits_quota(q, usage, chips, mem)
            if ok and not self._fits_fleet(chips, fleet_cap, state):
                ok, why = False, "fleet capacity exhausted"
            if not ok:
                blocked.setdefault(q.name, (head, why))
                return False
            for e in members:
                self._release_one(q, e, held, usage, state, actions,
                                  gang=head.gang)
            return True
        accumulating = (f"gang {head.gang} accumulating "
                        f"({len(members)}/{head.gang_total})")
        if not self.cfg.backfill:
            blocked.setdefault(q.name, (head, accumulating))
            return False
        # The gang's eventual footprint from the members seen so far.
        known = sum(e.chips for e in members)
        avg = known / max(1, len(members))
        footprint = known + avg * max(0, head.gang_total - len(members))
        window_left = head.enqueued_at + GANG_EXPIRE_SECONDS - now
        gang_uids = {e.uid for e in members}
        for e in held:
            if e.uid in gang_uids or e.gang is not None:
                continue
            ok, _why = mgr.fits_quota(q, usage, e.chips, e.mem_mib)
            if not ok:
                continue
            fits_hole = (
                fleet_cap is not None
                and state["outstanding"] + footprint + e.chips <= fleet_cap)
            short_lived = 0.0 < e.runtime_estimate_s <= window_left
            if (fits_hole or short_lived) and \
                    self._fits_fleet(e.chips, fleet_cap, state) and \
                    self._backfill_idle_ok(e, state):
                self._release_one(q, e, held, usage, state, actions,
                                  backfilled=True)
                if e.qos == "best-effort" and state.get("qos_idle") \
                        is not None:
                    state["qos_idle"] -= e.chips
                return True
        blocked.setdefault(q.name, (head, accumulating))
        return False

    def _release_one(self, q, entry: QueueEntry, held: List[QueueEntry],
                     usage, state, actions, gang: Optional[str] = None,
                     backfilled: bool = False) -> None:
        mgr = self.s.quota
        released = mgr.release(entry.uid)
        if released is None:
            return
        held[:] = [e for e in held if e.uid != entry.uid]
        usage.setdefault(q.name, QueueUsage())
        usage[q.name].chips += entry.chips
        usage[q.name].mem_mib += entry.mem_mib
        state["outstanding"] += entry.chips
        borrowed = usage[q.name].borrowed_chips(q)
        actions.append({"kind": "admit", "queue": q.name,
                        "pod": f"{entry.namespace}/{entry.name}",
                        "uid": entry.uid, "chips": entry.chips,
                        "gang": gang, "backfilled": backfilled,
                        "borrowed_after": borrowed})
        log.info("queue %s: admitted %s/%s (%d card(s)%s%s; queue now "
                 "holds %d, %d borrowed)", q.name, entry.namespace,
                 entry.name, entry.chips, f", gang {gang}" if gang else "",
                 ", backfilled" if backfilled else "",
                 usage[q.name].chips, borrowed)
        self._write_release(mgr, released)

    def _write_release(self, mgr, entry: QueueEntry) -> None:
        """The log write and the user-visible event of one release; a
        failed patch parks the uid for a retry."""
        try:
            self.s.client.patch_pod_annotations(
                entry.namespace, entry.name,
                {QUEUE_STATE_ANNOTATION: STATE_ADMITTED,
                 QUEUE_POSITION_ANNOTATION: ""})
        except Exception as e:  # noqa: BLE001 — retried next tick
            log.warning("queue %s: admitted-state patch for %s/%s not "
                        "written (%s); will retry", entry.queue,
                        entry.namespace, entry.name, e)
            with mgr._lock:
                mgr._release_unwritten.add(entry.uid)
        self._event(entry.namespace, entry, "Admitted",
                    f"released from capacity queue {entry.queue} by "
                    "fair-share admission")

    def _retry_unwritten_releases(self, mgr) -> None:
        with mgr._lock:
            uids = list(mgr._release_unwritten)
        for uid in uids:
            e = mgr.entry(uid)
            if e is None or e.state != STATE_ADMITTED:
                with mgr._lock:
                    mgr._release_unwritten.discard(uid)
                continue
            try:
                self.s.client.patch_pod_annotations(
                    e.namespace, e.name,
                    {QUEUE_STATE_ANNOTATION: STATE_ADMITTED,
                     QUEUE_POSITION_ANNOTATION: ""})
                with mgr._lock:
                    mgr._release_unwritten.discard(uid)
            except Exception:  # noqa: BLE001 — keep retrying
                pass

    # -- reclaim ---------------------------------------------------------------
    def _reclaim_pass(self, usage, blocked, actions, now: float) -> None:
        """Starved in-quota queues take back borrowed grants.  Two
        triggers: the release loop could not admit an entitled head, or a
        released pod sat unplaced past the grace.  The victims' eviction
        requests go through the scheduler's preemption path, so the
        re-ask throttle, the requester -> victims ledger and the
        rescission on placement are the scheduler's own.  The pod list is
        read only once a trigger fires."""
        mgr = self.s.quota
        pods = None
        for qname, q in mgr.queues.items():
            u = usage.get(qname, QueueUsage())
            if now - self._last_reclaim.get(qname, float("-inf")) \
                    < self.cfg.reclaim_grace_s:
                continue
            entry = self._reclaim_trigger(mgr, qname, blocked, now)
            if entry is None:
                continue
            demand = entry.chips
            if entry.gang is not None:
                # A gang reclaims only once it has all its members (an
                # incomplete one is the backfill's business: evicting for
                # members that may never come wastes checkpoints), and for
                # its whole footprint.
                members = sorted(
                    (e for e in mgr.entries()
                     if e.gang == entry.gang and e.queue == qname
                     and e.state == STATE_HELD),
                    key=lambda e: (e.enqueued_at, e.uid))
                if len(members) < entry.gang_total:
                    continue
                demand = sum(e.chips for e in members[:entry.gang_total])
            # The entitlement check leaves out the trigger's own
            # reservation: a released entry is already in the usage.
            held_excl = u.chips
            if entry.state == STATE_ADMITTED:
                held_excl -= entry.chips
            if held_excl + demand > q.nominal_chips:
                continue  # the pod itself would borrow: no reclaim
            if pods is None:
                pods = self.s.pods.list_pods()
            # Gang members are never victims.  Never evict twice: victims
            # the rescuer holds, or with an eviction request in flight,
            # are off the table, and the cards on their way back count
            # against the demand.
            protected = {uid for g in self.s.gangs.groups().values()
                         for uid in (*g.members, *g.placements)}
            protected |= set(self.s.rescuer.pending())
            with self.s._preempt_lock:
                in_flight = set(self.s._preempt_requested)
            protected |= in_flight
            cohort_names = {m.name for m in mgr.cohort_members(q)}
            pending_free = sum(
                grant_chips(p)[0] for p in pods
                if p.uid in in_flight
                and mgr.governed(p.namespace) is not None
                and mgr.governed(p.namespace).name in cohort_names)
            if pending_free >= demand:
                continue
            plan = plan_reclaim(demand - pending_free, q, mgr.queues,
                                usage, pods, protected_uids=protected)
            if plan is None:
                continue
            self._last_reclaim[qname] = now
            mgr.reclaims_total += 1
            requester = {"metadata": {"uid": entry.uid, "name": entry.name,
                                      "namespace": entry.namespace}}
            self.s._request_preemptions(requester, plan)
            # Each victim with its donor's borrowed amount at plan time:
            # the record that reclaim never touched an in-quota grant.
            victims = []
            for v in plan.victims:
                vq = mgr.governed(v.namespace)
                victims.append({
                    "pod": f"{v.namespace}/{v.name}", "uid": v.uid,
                    "node": v.node, "chips": grant_chips(v)[0],
                    "queue": vq.name if vq else None,
                    "donor_borrowed": (
                        usage.get(vq.name, QueueUsage()).borrowed_chips(vq)
                        if vq else 0),
                })
            actions.append({"kind": "reclaim", "queue": qname,
                            "for": f"{entry.namespace}/{entry.name}",
                            "chips": demand, "victims": victims})
            log.warning(
                "queue %s under nominal (%d/%d cards) with %s waiting: "
                "reclaiming %d borrowed card(s) from %d victim(s)",
                qname, held_excl, q.nominal_chips,
                f"{entry.namespace}/{entry.name}", demand,
                len(plan.victims))
            self._event(entry.namespace, entry, "QuotaReclaim",
                        f"reclaiming {demand} borrowed chip(s) from "
                        f"{len(plan.victims)} over-quota pod(s) in cohort "
                        f"{q.cohort or qname}")
            for v in plan.victims:
                self._event(
                    v.namespace,
                    QueueEntry(uid=v.uid, name=v.name,
                               namespace=v.namespace, queue=qname,
                               chips=0, mem_mib=0),
                    "BorrowedGrantReclaimed",
                    "checkpoint requested: this grant is borrowed "
                    f"capacity reclaimed for queue {qname}")

    def _reclaim_trigger(self, mgr, qname: str, blocked,
                         now: float) -> Optional[QueueEntry]:
        """The queue's blocked head, else its oldest released entry (not a
        gang member) left unplaced past the grace, else None."""
        if qname in blocked:
            return blocked[qname][0]
        for e in sorted((e for e in mgr.entries()
                         if e.queue == qname and e.state == STATE_ADMITTED
                         and e.gang is None),
                        key=lambda e: (e.released_at or 0.0, e.uid)):
            if e.released_at is not None and \
                    now - e.released_at > self.cfg.reclaim_grace_s:
                return e
        return None

    # -- user-facing state -----------------------------------------------------
    def _publish_positions(self) -> None:
        """Patch ``vtpu.dev/queue-position`` on held pods whose position
        changed, and send the one Queued event of each."""
        mgr = self.s.quota
        entries = mgr.entries()
        for qname in mgr.queues:
            held = sorted((e for e in entries
                           if e.queue == qname and e.state == STATE_HELD),
                          key=lambda e: (e.enqueued_at, e.uid))
            for i, e in enumerate(held):
                label = f"{i + 1}/{len(held)}"
                if e.published_position == label and e.hold_event_sent:
                    continue
                try:
                    self.s.client.patch_pod_annotations(
                        e.namespace, e.name,
                        {QUEUE_POSITION_ANNOTATION: label})
                except Exception:  # noqa: BLE001 — the position is advisory
                    continue
                if not e.hold_event_sent:
                    self._event(
                        e.namespace, e, "Queued",
                        f"held in capacity queue {qname} at position "
                        f"{label}; released in fair-share order")
                mgr.set_published_position(e.uid, label, hold_event=True)

    def _event(self, namespace: str, entry: QueueEntry, reason: str,
               message: str) -> None:
        try:
            self.s.client.create_event(
                namespace,
                {"kind": "Pod", "name": entry.name,
                 "namespace": namespace, "uid": entry.uid},
                reason, message)
        except NotImplementedError:
            pass  # a client without an events surface
        except Exception as e:  # noqa: BLE001 — events are best-effort
            log.debug("event %s for %s/%s not written: %s", reason,
                      namespace, entry.name, e)

    # -- background thread -----------------------------------------------------
    def start(self, interval_s: Optional[float] = None) -> None:
        if self._thread is not None or not self.s.quota.enabled:
            return
        period = interval_s if interval_s is not None \
            else self.cfg.interval_s

        def loop() -> None:
            while not self._stop.wait(period):
                try:
                    self.tick()
                except Exception:  # noqa: BLE001 — keep admitting through glitches
                    log.exception("admission tick failed")

        self._thread = threading.Thread(target=loop, name="quota-admission",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
