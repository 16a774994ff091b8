"""The registry of scheduled pods and their grants (the port's copy of the
JAX package's ``scheduler/pods.py``).

Reference: pkg/scheduler/pods.go:357–378.  Fed by the pod informer: the
decoded ``assigned-ids`` annotation is the durable record, so a restarted
scheduler rebuilds this map from the apiserver.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Iterable, List, Optional, Set, Tuple

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
        self._lock = threading.Lock()
        self._pods: Dict[str, PodInfo] = {}

    def add_pod(self, info: PodInfo) -> None:
        """Record (or move) a grant."""
        with self._lock:
            self._pods[info.uid] = info

    def refresh_if_unchanged(self, info: PodInfo) -> bool:
        """An informer event that carries the grant already recorded (the
        scheduler's own decision write echoed back): refresh the pod's
        other fields and its liveness in place; False where the grant
        differs or is unknown."""
        with self._lock:
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

    def del_pod(self, uid: str) -> Optional[PodInfo]:
        with self._lock:
            return self._pods.pop(uid, None)

    def get(self, uid: str) -> Optional[PodInfo]:
        with self._lock:
            return self._pods.get(uid)

    def list_pods(self) -> List[PodInfo]:
        with self._lock:
            return list(self._pods.values())

    def pods_on_node(self, node: str) -> List[PodInfo]:
        with self._lock:
            return [p for p in self._pods.values() if p.node == node]

    def ns_usage_snapshot(self, uids: Iterable[str]
                          ) -> Tuple[Dict[str, Tuple[int, int]], Set[str]]:
        """Per-namespace (cards, MiB) of the granted pods, and which of
        ``uids`` hold a grant, read under one lock hold: the quota tick
        needs both of the same instant (a grant recorded between two reads
        would count in neither)."""
        out: Dict[str, List[int]] = {}
        with self._lock:
            for p in self._pods.values():
                row = out.setdefault(p.namespace, [0, 0])
                for container in p.devices:
                    for d in container:
                        row[0] += 1
                        row[1] += d.usedmem
            granted = {u for u in uids if u in self._pods}
        return {ns: (c, m) for ns, (c, m) in out.items() if c or m}, granted
