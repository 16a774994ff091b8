"""Stranded-grant rescue: find placements the fleet can no longer honour
and rescind them so the pods reschedule (the port's copy of the JAX
package's ``health/rescuer.py``).

A grant is rescuable when its node's lease is **Dead**
(``health/lease.py``), or when one of its cards is **quarantined**
(``health/quarantine.py``) or has **vanished** from a re-registration
(each registration replaces the node's inventory, ``scheduler/nodes.py``).

Rescission reuses what exists:

1. **Checkpoint first** (a quarantined card on a live node): the victim
   gets the annotation priority preemption writes
   (``scheduler/preempt.py``), with the value ``rescue:<reason>``.  The
   in-container watch (``shim/preempt.py``) stops on any non-empty value,
   the training loop checkpoints at the next step boundary and exits, and
   the pod's delete frees the grant.  A victim that has not exited after
   ``checkpoint_grace_s`` is rescinded anyway (it may be wedged on the
   broken card).
2. **Rescind**: clear the decision annotations (``assigned-node`` and the
   rest, to empty values; the informer then drops the grant) and drop the
   registry's entry at once.  The rescuer holds none of the scheduler's
   locks.

Chronically idle oversubscribed grants (``grant_efficiency``, from the
usage ledger) are flagged, never rescinded: a sweep action, a journal
event and ``vtpu_idle_grants``.  A rescued pod leaves its gang
(``gangs.drop_member``, without a tombstone: the pod reschedules under
its own uid and may join its group again).  The ownership gate of a sharded control plane
(``shards``) waits for the shard slice (ROADMAP A.5).  The JAX
rescuer's provenance records go to the port's tracer (``util/trace``)
under the same event names until the provenance slice (A.5).

``sweep`` is a plain method, so tests drive it on their own clock;
``start()`` runs it in the daemon's background thread.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Callable, Dict, List, Optional

from ..k8s.client import NotFound, is_pod_terminated, pod_uid
from ..util import trace
from ..util.types import (
    ASSIGNED_IDS_ANNOTATION,
    ASSIGNED_NODE_ANNOTATION,
    BIND_PHASE_ANNOTATION,
    TO_ALLOCATE_ANNOTATION,
)
from .lease import LeaseState

log = logging.getLogger(__name__)

#: Value prefix of the rescuer's eviction requests: the in-container watch
#: needs only a non-empty value, and the preemption ledger's reconcile
#: skips these (they are not requester uids).
RESCUE_VALUE_PREFIX = "rescue:"


@dataclasses.dataclass(frozen=True)
class RescueConfig:
    #: Background sweep period (vgpu-scheduler --rescue-interval).
    interval_s: float = 5.0
    #: How long a victim asked to checkpoint gets to exit on its own
    #: before its grant is rescinded from under it.
    checkpoint_grace_s: float = 120.0
    #: How long a Dead lease is kept once its inventory is gone and no
    #: grant remains; a node that returns starts a fresh lease.
    lease_retention_s: float = 900.0


@dataclasses.dataclass
class RescueItem:
    uid: str
    namespace: str
    name: str
    node: str
    reason: str
    enqueued_at: float
    #: When the checkpoint request was written; None until it is.
    asked_at: Optional[float] = None


class Rescuer:
    def __init__(self, scheduler, cfg: Optional[RescueConfig] = None,
                 clock: Optional[Callable[[], float]] = None) -> None:
        self.s = scheduler
        self.cfg = cfg or RescueConfig()
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._queue: Dict[str, RescueItem] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: Grants rescinded since the start.
        self.rescued_total = 0
        #: uid -> first flag time of a chronically idle OVERSUBSCRIBED
        #: grant (accounting/efficiency.py).  Flag only: an idle pod is
        #: not a broken one.
        self.idle_flagged: Dict[str, float] = {}

    # -- queue -----------------------------------------------------------------
    def enqueue(self, uid: str, reason: str, namespace: str = "",
                name: str = "", node: str = "") -> bool:
        """Queue one grant for rescue (once per uid).  A caller with no
        registry entry (the informer's route for a dead node's grant)
        passes the pod's identity; otherwise it is read from the
        registry."""
        info = self.s.pods.get(uid)
        if info is not None:
            namespace = namespace or info.namespace
            name = name or info.name
            node = node or info.node
        with self._lock:
            if uid in self._queue:
                return False
            self._queue[uid] = RescueItem(
                uid=uid, namespace=namespace, name=name, node=node,
                reason=reason, enqueued_at=self._clock())
        trace.tracer().event(uid, "rescue-queued", namespace=namespace,
                             name=name, node=node, reason=reason,
                             requester=RESCUE_VALUE_PREFIX + reason)
        log.warning("rescue queued for %s/%s (uid %s): %s", namespace,
                    name, uid, reason)
        return True

    def pending(self) -> Dict[str, RescueItem]:
        with self._lock:
            return dict(self._queue)

    # -- the sweep -------------------------------------------------------------
    def sweep(self) -> List[dict]:
        """One pass: lease transitions, quarantine probation, the scan for
        stranded grants, then the queue.  Returns the actions taken."""
        now = self._clock()
        actions: List[dict] = []
        tr = trace.tracer()
        leases, pods = self.s.leases, self.s.pods

        # 1. Lease transitions, each edge once.
        for node, old, new in leases.sweep(now):
            actions.append({"kind": "lease", "node": node,
                            "from": old.name, "to": new.name})
            tr.event(node, f"lease-{new.name.lower()}", node=node,
                     previous=old.name)
            if new is LeaseState.DEAD:
                # The inventory is no longer trusted (a partitioned agent
                # may still hold its stream open).
                age = leases.age_of(node)
                log.error("node %s lease expired (no heartbeat for %.0fs); "
                          "removing inventory and rescuing its pods",
                          node, age if age is not None else -1.0)
                self.s.nodes.rm_node(node)
                for info in pods.pods_on_node(node):
                    self.enqueue(info.uid, "node-dead")
            elif old is LeaseState.DEAD:
                log.warning("node %s lease recovered (%s); awaiting "
                            "re-registration", node, new.name)

        # 1b. A lease Dead past the retention, with nothing left on it to
        # rescue, is forgotten.  A rescind that keeps failing keeps its
        # node Dead, so the scan below finds the grant again.
        for node, state in leases.states().items():
            if state is not LeaseState.DEAD:
                continue
            age = leases.age_of(node)
            if age is None or age < self.cfg.lease_retention_s:
                continue
            if self.s.nodes.get_node(node) is not None \
                    or pods.pods_on_node(node):
                continue
            leases.forget(node)
            actions.append({"kind": "lease-forgotten", "node": node})
            log.info("forgot lease of %s (Dead for %.0fs, nothing left "
                     "to rescue)", node, age)

        # 2. Quarantine probation releases.
        for node, chip in self.s.quarantine.sweep(now):
            actions.append({"kind": "quarantine-release", "node": node,
                            "chip": chip})

        # 3. Stranded grants.
        for info in pods.list_pods():
            if leases.state_of(info.node) is LeaseState.DEAD:
                self.enqueue(info.uid, "node-dead")
                continue
            uuids = {d.uuid for container in info.devices for d in container}
            quarantined = uuids & self.s.quarantine.quarantined_on(info.node)
            if quarantined:
                # The other cards of a multi-card grant share whatever
                # broke the one: quarantine them too, or the next pod gets
                # the same broken set.
                if len(uuids) > 1:
                    for other in sorted(uuids - quarantined):
                        if self.s.quarantine.quarantine(
                                info.node, other, "slice-neighbor"):
                            actions.append({"kind": "quarantine",
                                            "node": info.node,
                                            "chip": other,
                                            "reason": "slice-neighbor"})
                self.enqueue(info.uid, "chip-quarantined")
                continue
            node_info = self.s.nodes.get_node(info.node)
            if node_info is not None \
                    and uuids - {d.id for d in node_info.devices}:
                # A re-registration dropped a card this grant holds.
                self.enqueue(info.uid, "chip-vanished")

        # 3b. Chronically idle oversubscribed grants: flagged, never
        # evicted.  Such a grant holds memory beyond the card while it
        # launches nothing, but idleness is not brokenness: the action is
        # a finding an operator sees (journal event, sweep action,
        # vtpu_idle_grants), not a rescind.
        idle_now = set()
        for pe in self.s.grant_efficiency(now).idle:
            if not pe.oversubscribe:
                continue
            idle_now.add(pe.uid)
            if pe.uid in self.idle_flagged:
                continue
            self.idle_flagged[pe.uid] = now
            actions.append({"kind": "idle-grant", "pod": pe.name,
                            "uid": pe.uid, "node": pe.node,
                            "idle_for_s": round(pe.idle_for_s, 1)})
            log.warning(
                "idle grant: %s/%s holds %d card(s) on %s "
                "(oversubscribed) but has launched nothing for %.0fs "
                "— capacity wasted, not rescinding", pe.namespace,
                pe.name, pe.granted_chips, pe.node, pe.idle_for_s)
            tr.event(pe.uid, "idle-grant", pod=pe.name, node=pe.node,
                     idle_for_s=round(pe.idle_for_s, 1),
                     granted_chips=pe.granted_chips)
        # A pod that launches again (or left) clears its flag, so a
        # later relapse is reported again.
        for uid in [u for u in self.idle_flagged if u not in idle_now]:
            del self.idle_flagged[uid]

        # 4. The queue.
        with self._lock:
            items = list(self._queue.values())
        for item in items:
            action = self._process(item, now)
            if action is not None:
                actions.append(action)
        return actions

    # -- one item --------------------------------------------------------------
    def _process(self, item: RescueItem, now: float) -> Optional[dict]:
        pod = None
        if item.namespace and item.name:
            try:
                pod = self.s.client.get_pod(item.namespace, item.name)
                if pod_uid(pod) != item.uid:
                    pod = None  # a successor reused the name
            except NotFound:
                pod = None
            except Exception as e:  # noqa: BLE001 — retried next sweep
                log.warning("rescue: cannot read %s/%s (%s); retrying",
                            item.namespace, item.name, e)
                return None
        if pod is None or is_pod_terminated(pod):
            # Gone or done: its delete frees the grant; drop the entry
            # (and its gang seat) in case no watch runs.
            self.s.gangs.drop_member(item.uid, tombstone=False)
            self.s.pods.del_pod(item.uid)
            self._done(item)
            return {"kind": "rescued", "pod": item.name, "uid": item.uid,
                    "reason": item.reason, "via": "pod-gone"}

        if item.reason == "chip-quarantined" and self._bound(pod):
            # A live node, a broken card: ask for a checkpointed exit.
            if item.asked_at is None:
                if not self._ask_checkpoint(item):
                    return None  # not written; retried next sweep
                return {"kind": "checkpoint-requested", "pod": item.name,
                        "uid": item.uid, "reason": item.reason}
            if now - item.asked_at < self.cfg.checkpoint_grace_s:
                return None
            log.warning("rescue: %s/%s did not exit within %.0fs of the "
                        "checkpoint request; rescinding its grant",
                        item.namespace, item.name,
                        self.cfg.checkpoint_grace_s)

        if not self._rescind(item):
            return None
        return {"kind": "rescued", "pod": item.name, "uid": item.uid,
                "reason": item.reason, "via": "rescind"}

    @staticmethod
    def _bound(pod: dict) -> bool:
        return bool(pod.get("spec", {}).get("nodeName"))

    def _ask_checkpoint(self, item: RescueItem) -> bool:
        from ..scheduler.preempt import PREEMPT_ANNOTATION

        try:
            self.s.client.patch_pod_annotations(
                item.namespace, item.name,
                {PREEMPT_ANNOTATION: RESCUE_VALUE_PREFIX + item.reason})
        except NotFound:
            return True  # gone already: the next pass takes pod-gone
        except Exception as e:  # noqa: BLE001 — retried next sweep
            log.warning("rescue: checkpoint request for %s/%s not "
                        "written (%s)", item.namespace, item.name, e)
            return False
        with self._lock:
            queued = self._queue.get(item.uid)
            if queued is not None:
                queued.asked_at = self._clock()
        item.asked_at = self._clock()
        trace.tracer().event(
            item.uid, "rescue-checkpoint-requested",
            namespace=item.namespace, name=item.name, node=item.node,
            reason=item.reason, requester=RESCUE_VALUE_PREFIX + item.reason)
        log.warning("rescue: asked %s/%s to checkpoint and exit (%s)",
                    item.namespace, item.name, item.reason)
        return True

    def _rescind(self, item: RescueItem) -> bool:
        from ..scheduler.preempt import PREEMPT_ANNOTATION

        # Empty values, not deletions: deleting a key is not portable
        # across patch types, and the informer reads an empty
        # assigned-node as no grant.
        clear = {ASSIGNED_NODE_ANNOTATION: "", ASSIGNED_IDS_ANNOTATION: "",
                 TO_ALLOCATE_ANNOTATION: "", BIND_PHASE_ANNOTATION: "",
                 PREEMPT_ANNOTATION: ""}
        if item.namespace and item.name:
            try:
                self.s.client.patch_pod_annotations(
                    item.namespace, item.name, clear)
            except NotFound:
                pass
            except Exception as e:  # noqa: BLE001 — no half-rescinded grant
                log.warning("rescue: rescind patch for %s/%s failed "
                            "(%s); retrying next sweep", item.namespace,
                            item.name, e)
                return False
        self.s.gangs.drop_member(item.uid, tombstone=False)
        self.s.pods.del_pod(item.uid)
        self._done(item)
        log.warning("rescued %s/%s off %s (%s): grant rescinded, pod "
                    "will reschedule", item.namespace, item.name,
                    item.node, item.reason)
        trace.tracer().event(item.uid, "rescued", pod=item.name,
                             node=item.node, reason=item.reason,
                             requester=RESCUE_VALUE_PREFIX + item.reason)
        return True

    def _done(self, item: RescueItem) -> None:
        with self._lock:
            if self._queue.pop(item.uid, None) is not None:
                self.rescued_total += 1

    # -- background thread -----------------------------------------------------
    def start(self, interval_s: Optional[float] = None) -> None:
        if self._thread is not None:
            return
        period = interval_s if interval_s is not None else self.cfg.interval_s

        def loop() -> None:
            while not self._stop.wait(period):
                try:
                    self.sweep()
                except Exception:  # noqa: BLE001 — sweep through glitches
                    log.exception("rescue sweep failed")

        self._thread = threading.Thread(target=loop, name="fleet-rescuer",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.cfg.interval_s + 5.0)
