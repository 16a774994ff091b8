"""Replica-kill rebalancing: the surviving replicas adopt the orphaned
nodes (the port's copy of the JAX package's ``shard/rebalance.py``).

When an epoch bump hands this replica nodes it did not own, each goes
through three steps before it is placeable:

1. **Grace**: the node stays unplaceable for ``adoption_grace_s`` after
   the new map was published.  The previous owner may still hold
   decisions computed under the old epoch; by the grace's end they have
   either landed (and the replay below reads them) or fail the commit
   fence's staleness check (``shardmap.py``), so the replay sees a
   quiescent node.
2. **WAL replay**: the decision annotations are the write-ahead log.  The
   pods assigned to the adopted nodes go through
   ``Scheduler.on_pod_event``, which rebuilds the registry's slice
   (grants, gang members, priorities) as a restart's resync would; a pod
   the informer already delivered with the same node is skipped.
3. **Lease adoption**: the node's lease is reset to untracked (the state
   a restarted scheduler boots with): the node is placeable, and the
   failure detector's deadline starts from the agent's next beat.  (A
   synthetic beat instead would fault nodes of embedders without agents:
   it decays to Suspect with nobody to refresh it.)

Orphaned pending pods need no adoption: they carry no decision, so the
next kube-scheduler retry lands on a surviving replica.  The simulator's
``ha`` section (``cmd/simulate.py``) drives that loop.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Set

from ..k8s.client import pod_uid
from ..util.types import ASSIGNED_NODE_ANNOTATION

log = logging.getLogger(__name__)


class Rebalancer:
    def __init__(self, scheduler, shards,
                 clock: Optional[Callable[[], float]] = None) -> None:
        self.s = scheduler
        self.shards = shards
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        # node -> (placeable_at, orphaned_at): pending adoptions.
        self._pending: Dict[str, tuple] = {}
        #: Nodes adopted over this replica's lifetime, and the per-node
        #: handoff latencies (orphan → placeable) the HA report publishes.
        self.adopted_total = 0
        self.last_adoption_latency_s: List[float] = []
        #: The adoption replay's accounting: pods replayed through
        #: on_pod_event, and pods skipped because the live informer had
        #: already delivered that grant (with a healthy watch the replay
        #: is O(missed events), not O(pods on the adopted nodes)).
        self.wal_replayed_total = 0
        self.wal_skipped_total = 0

    def has_pending(self) -> bool:
        """Lock-free emptiness probe (the steady-state tick's fast
        path: one dict-truthiness read)."""
        return bool(self._pending)

    # -- gates -----------------------------------------------------------------
    def adopting_reason(self, node: str) -> Optional[str]:
        """Non-None while ``node`` is mid-handoff (grace not elapsed or
        WAL not replayed yet) — both the Filter gate and the commit
        fence consult this.  The no-pending fast path is one dict read."""
        if not self._pending:
            return None
        with self._lock:
            entry = self._pending.get(node)
        if entry is None:
            return None
        return (f"shard-adopting: {node} mid-handoff "
                f"({max(0.0, entry[0] - self._clock()):.1f}s grace left)")

    # -- transitions -----------------------------------------------------------
    def on_map_change(self, old, new, now: float) -> Set[str]:
        """Epoch transition: compute the nodes this replica GAINED and
        queue their handoff.  The very first map (epoch 1, no previous)
        is the boot partition — nobody else ever owned those nodes, so
        they are placeable immediately."""
        me = self.shards.replica
        gained: Set[str] = set()
        for node in self.s.nodes.list_nodes():
            if new.owner_of(node) != me:
                continue
            if old is None:
                if new.epoch <= 1:
                    continue        # boot partition: no previous owner
                gained.add(node)    # unknown history: conservative grace
            elif old.owner_of(node) != me:
                gained.add(node)
        if not gained:
            return gained
        grace = self.shards.cfg.adoption_grace_s
        with self._lock:
            for node in gained:
                if node not in self._pending:
                    self._pending[node] = (now + grace, now)
        sample = sorted(gained)[:8]
        log.warning("epoch %d: adopting %d orphaned shard(s): %s%s",
                    new.epoch, len(gained), sample,
                    "…" if len(gained) > len(sample) else "")
        return gained

    def adopt_due(self, now: float) -> List[dict]:
        """Finish handoffs whose grace elapsed: one pod list, replay the
        decision-annotation WAL for every due node, seed the node
        leases, mark placeable."""
        with self._lock:
            due = [n for n, (ready_at, _t0) in self._pending.items()
                   if now >= ready_at]
        if not due:
            return []
        actions: List[dict] = []
        try:
            pods = self.s.client.list_pods()
        except Exception as e:  # noqa: BLE001 — next tick retries
            log.warning("adoption WAL list failed: %s", e)
            return []
        due_set = set(due)
        replayed = skipped = 0
        for pod in pods:
            anns = pod.get("metadata", {}).get("annotations", {})
            node = anns.get(ASSIGNED_NODE_ANNOTATION, "")
            if node not in due_set:
                continue
            # Skip what the live informer already delivered with this
            # node: replaying it buys nothing, and at fleet scale an
            # adoption would replay a large share of the fleet's pods in
            # one tick.  A pod the registry does not hold (a replica
            # without a watch, a missed event) replays in full.
            tracked = self.s.pods.get(pod_uid(pod))
            if tracked is not None and tracked.node == node:
                skipped += 1
                continue
            self.s.on_pod_event("ADDED", pod)
            replayed += 1
        self.wal_replayed_total += replayed
        self.wal_skipped_total += skipped
        for node in due:
            self.s.leases.forget(node)
            with self._lock:
                entry = self._pending.pop(node, None)
                if entry is None:
                    continue
                self.adopted_total += 1
                latency = now - entry[1]
                self.last_adoption_latency_s.append(latency)
                if len(self.last_adoption_latency_s) > 256:
                    del self.last_adoption_latency_s[:-256]
            actions.append({"kind": "shard-adopted", "node": node,
                            "latency_s": round(latency, 3)})
        if actions:
            log.warning("adopted %d shard(s) (last %.1fs after "
                        "orphaning); %d WAL pod(s) replayed this pass",
                        len(actions), actions[-1]["latency_s"], replayed)
        return actions

    def pending_nodes(self) -> List[str]:
        with self._lock:
            return sorted(self._pending)
