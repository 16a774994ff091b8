"""The registry of scheduled pods and their grants (the port's copy of the
JAX package's ``scheduler/pods.py``).

Reference: pkg/scheduler/pods.go:357–378.  Fed by the pod informer: the
decoded ``assigned-ids`` annotation is the durable record, so a restarted
scheduler rebuilds this map from the apiserver.

Beside the grants it keeps a by-node index and a revision per node,
bumped by every change to the node's pod set: the scheduler's usage
snapshot caches each node's usage under (pod rev, inventory rev) and
rebuilds only the nodes ``drain_dirty`` names, and an optimistic commit
validates the winning node's pair.  ``add_pod`` and ``del_pod`` return
the node's new rev, so the committer (and the informer's write-through)
can publish a grant's delta under exactly that generation.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterable, List, Optional, Set, Tuple

from ..util import perf
from ..util.types import PodDevices


@dataclasses.dataclass
class PodInfo:
    uid: str
    name: str
    namespace: str
    node: str
    devices: PodDevices
    # The pod's task priority (0 = highest).
    priority: int = 0
    # The webhook-issued trace id: Bind gets only namespace, name and uid,
    # and stamps its span with this.
    trace_id: str = ""
    # vtpu.dev/qos ("" = unclassed), for the decision's duty split.
    qos: str = ""
    # Monotonic time of the last add or refresh: a resync must not prune a
    # grant recorded after its list was taken.
    touched_at: float = dataclasses.field(default_factory=time.monotonic)


class PodManager:
    def __init__(self) -> None:
        # Wait/hold telemetry under lock="pods" on /perfz; add_pod and the
        # informer's upsert ride every decision, so hold samples are
        # 1-in-32.
        self._lock = perf.TimedLock("pods", sample_shift=5)
        self._pods: Dict[str, PodInfo] = {}
        self._by_node: Dict[str, Dict[str, PodInfo]] = {}
        self._rev: Dict[str, int] = {}
        # Nodes whose pod set changed since the last drain_dirty().
        self._dirty: Set[str] = set()
        # (cards, MiB) per namespace, kept on every add and delete: the
        # quota tick reads them without walking the registry.
        self._ns_usage: Dict[str, List[int]] = {}

    def _bump(self, node: str) -> None:
        self._rev[node] = self._rev.get(node, 0) + 1
        self._dirty.add(node)

    def _charge(self, info: PodInfo, sign: int) -> None:
        chips = mem = 0
        for container in info.devices:
            for d in container:
                chips += 1
                mem += d.usedmem
        row = self._ns_usage.get(info.namespace)
        if row is None:
            row = self._ns_usage[info.namespace] = [0, 0]
        row[0] += sign * chips
        row[1] += sign * mem
        if sign < 0 and row[0] == 0 and row[1] == 0:
            # A namespace whose pods all left gives up its row.
            del self._ns_usage[info.namespace]

    def _add_locked(self, info: PodInfo) -> int:
        prev = self._pods.get(info.uid)
        if prev is not None:
            self._charge(prev, -1)
            if prev.node != info.node:
                bucket = self._by_node.get(prev.node)
                if bucket:
                    bucket.pop(info.uid, None)
                self._bump(prev.node)
        self._pods[info.uid] = info
        self._by_node.setdefault(info.node, {})[info.uid] = info
        self._charge(info, 1)
        self._bump(info.node)
        return self._rev[info.node]

    def add_pod(self, info: PodInfo) -> int:
        """Record (or move) a grant; returns ``info.node``'s new rev, the
        generation the committer publishes the node's updated usage
        under."""
        with self._lock:
            return self._add_locked(info)

    def add_pods_group(self, infos: List[PodInfo], node: str,
                       expected_rev: int) -> Optional[int]:
        """A batched cycle's group commit: one node's whole grant group
        added under one acquire, the node's rev checked against
        ``expected_rev`` inside the lock (the commit lock does not exclude
        the informer, so an event between two single adds would break the
        chain the publish relies on).  Returns the final rev
        (``expected_rev + len(infos)``), or None with nothing added where
        the rev moved."""
        with self._lock:
            if self._rev.get(node, 0) != expected_rev:
                return None
            for info in infos:
                self._add_locked(info)
            return self._rev[node]

    def _refresh_locked(self, info: PodInfo) -> bool:
        prev = self._pods.get(info.uid)
        if prev is None or prev.node != info.node \
                or prev.devices != info.devices:
            return False
        prev.priority = info.priority
        if info.trace_id:
            prev.trace_id = info.trace_id
        if info.qos:
            prev.qos = info.qos
        prev.touched_at = info.touched_at
        return True

    def upsert(self, info: PodInfo) -> Optional[int]:
        """The informer's apply, under one acquire.  An event that carries
        the grant already recorded (the scheduler's own decision write
        echoed back) refreshes the pod's other fields and its liveness in
        place, with no rev bump (which would rebuild the node's usage for
        a state that did not change); any other grant is added.  Returns
        the node's new rev where the grant is new to the registry (the
        caller writes its delta through); None for a refresh and for a
        move (a move touches two nodes, which the dirty rebuild
        squares)."""
        with self._lock:
            if self._refresh_locked(info):
                return None
            fresh = info.uid not in self._pods
            rev = self._add_locked(info)
            return rev if fresh else None

    def del_pod(self, uid: str) -> Optional[Tuple[PodInfo, int]]:
        """Drop one grant; returns (the dropped info, its node's new rev),
        or None where the uid held none."""
        with self._lock:
            return self._del_locked(uid)

    def del_pods(self, uids: Iterable[str]) -> List[Tuple[PodInfo, int]]:
        """:meth:`del_pod` for many uids under one acquire."""
        dropped: List[Tuple[PodInfo, int]] = []
        with self._lock:
            for uid in uids:
                got = self._del_locked(uid)
                if got is not None:
                    dropped.append(got)
        return dropped

    def _del_locked(self, uid: str) -> Optional[Tuple[PodInfo, int]]:
        info = self._pods.pop(uid, None)
        if info is None:
            return None
        self._charge(info, -1)
        bucket = self._by_node.get(info.node)
        if bucket is not None:
            bucket.pop(uid, None)
            if not bucket:
                del self._by_node[info.node]
        self._bump(info.node)
        return info, self._rev[info.node]

    def get(self, uid: str) -> Optional[PodInfo]:
        # One dict read, no lock: the lock never made it fresher.
        return self._pods.get(uid)

    def list_pods(self) -> List[PodInfo]:
        with self._lock:
            return list(self._pods.values())

    def pods_on_node(self, node: str) -> List[PodInfo]:
        with self._lock:
            return list(self._by_node.get(node, {}).values())

    def by_node(self) -> Dict[str, List[PodInfo]]:
        with self._lock:
            return {n: list(b.values()) for n, b in self._by_node.items()}

    def ns_usage_snapshot(self, uids: Iterable[str]
                          ) -> Tuple[Dict[str, Tuple[int, int]], Set[str]]:
        """Per-namespace (cards, MiB) of the granted pods, and which of
        ``uids`` hold a grant, read under one lock hold: the quota tick
        needs both of the same instant (a grant recorded between two reads
        would count in neither)."""
        with self._lock:
            pods = self._pods
            return ({ns: (row[0], row[1])
                     for ns, row in self._ns_usage.items()},
                    {u for u in uids if u in pods})

    def rev_of(self, node: str) -> int:
        """``node``'s pod revision: one dict read, no lock.  It only says
        whether a cached view is current; a view is built from
        :meth:`node_view`, whose rev keys exactly the pods it returns."""
        return self._rev.get(node, 0)

    def node_view(self, node: str) -> Tuple[int, List[PodInfo]]:
        """``node``'s pod revision and its grants, under one acquire.  A
        usage map built from these pods is exactly the node's at that rev,
        which the informer's write-through relies on: it applies rev
        ``k + 1``'s delta over a map keyed ``k``, so a map holding a
        change newer than its key would count that change twice."""
        with self._lock:
            return (self._rev.get(node, 0),
                    list(self._by_node.get(node, {}).values()))

    def drain_dirty(self) -> Set[str]:
        """Return and clear the nodes whose pod set changed since the last
        drain.  The caller refreshes them, or hands them back through
        :meth:`mark_dirty`."""
        with self._lock:
            dirty, self._dirty = self._dirty, set()
            return dirty

    def mark_dirty(self, nodes: Iterable[str]) -> None:
        with self._lock:
            self._dirty.update(nodes)
