"""In-memory fake apiserver for tests (the port's copy of the JAX
package's ``k8s/fake.py``).

Implements the :class:`KubeClient` slice.  Nodes carry a monotonically
increasing ``metadata.resourceVersion`` that is bumped on every annotation
patch, and a patch supplying ``resource_version`` fails with
:class:`Conflict` when it does not match — mirroring the apiserver's
optimistic concurrency so the node-lock CAS path (util/nodelock.py) can be
tested for multi-writer contention, a scenario SURVEY.md §4 notes the
reference never tests.
"""

from __future__ import annotations


import marshal
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from .client import Conflict, Gone, KubeClient, NotFound

# Journal depth before old events are compacted away (watchers further back
# get Gone and must re-list — apiserver etcd-compaction semantics).
JOURNAL_LIMIT = 1024


def _copy_py(obj):
    """Recursive structural copy — the fallback for objects marshal
    cannot serialize (a test stashing a non-JSON value).  Non-container
    values are shared — they are immutable in any object that
    round-trips a real apiserver."""
    if isinstance(obj, dict):
        return {k: _copy_py(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_copy_py(v) for v in obj]
    return obj


def _copy(obj):
    """Structural copy for the JSON-shaped objects an apiserver stores
    (dicts/lists of scalars).  copy.deepcopy spends most of its time on
    memo bookkeeping these objects never need, and a recursive Python
    copy is slower than a C-level marshal round-trip."""
    try:
        return marshal.loads(marshal.dumps(obj))
    except ValueError:
        return _copy_py(obj)


def _apply_annotation_patch(obj: dict, annotations: Dict[str, Optional[str]]) -> None:
    anns = obj.setdefault("metadata", {}).setdefault("annotations", {})
    for k, v in annotations.items():
        if v is None:
            anns.pop(k, None)
        else:
            anns[k] = v


class FakeKube(KubeClient):
    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._pods: Dict[str, dict] = {}  # "ns/name" -> pod
        self._nodes: Dict[str, dict] = {}
        self.bindings: List[dict] = []
        # v1.Events recorded via create_event (tests assert the quota
        # admission loop's hold/admit/reclaim trail here).
        self.events: List[dict] = []
        self._rv = 0
        # Informer-style subscribers: fn(event, pod) with event in
        # {"ADDED", "MODIFIED", "DELETED"}.
        self._pod_watchers: List[Callable[[str, dict], None]] = []
        # Watch journal: (rv int, event, pod snapshot), bounded; _cond wakes
        # blocked watch_pods_events callers on every append.
        self._journal: List[Tuple[int, str, dict]] = []
        self._compacted_below = 0  # rv of the newest compacted-away event
        self._cond = threading.Condition(self._lock)

    def _next_rv(self) -> str:
        self._rv += 1
        return str(self._rv)

    def _journal_append(self, event: str, snapshot: dict) -> None:
        """Under self._lock: journal the event, wake watchers.
        ``snapshot`` must be a copy already detached from the stored
        object — the journal keeps that same snapshot, and direct
        watch_pods subscribers receive it too (informers treat events as
        read-only, like a real client's decoded response); a caller that
        needs a mutable copy owns making one.  watch_pods_events
        replayers still get per-yield copies, so journal history cannot
        be rewritten through the REST-shaped surface."""
        rv = int(snapshot.get("metadata", {}).get("resourceVersion", "0"))
        self._journal.append((rv, event, snapshot))
        if len(self._journal) > JOURNAL_LIMIT:
            drop = len(self._journal) - JOURNAL_LIMIT
            self._compacted_below = self._journal[drop - 1][0]
            del self._journal[:drop]
        self._cond.notify_all()

    # -- test setup helpers ---------------------------------------------------
    def add_node(self, node: dict) -> None:
        # Store a copy: the real apiserver never shares memory with callers,
        # so later local mutation of the argument must not change server state.
        with self._lock:
            node = _copy(node)
            node.setdefault("metadata", {}).setdefault(
                "resourceVersion", self._next_rv()
            )
            self._nodes[node["metadata"]["name"]] = node

    def create_pod(self, pod: dict) -> dict:
        with self._lock:
            pod = _copy(pod)
            key = f"{pod['metadata'].get('namespace', 'default')}/{pod['metadata']['name']}"
            pod.setdefault("metadata", {})["resourceVersion"] = self._next_rv()
            self._pods[key] = pod
            watchers = list(self._pod_watchers)
            snapshot = _copy(pod)
            self._journal_append("ADDED", snapshot)
        for w in watchers:
            w("ADDED", snapshot)
        return snapshot

    def delete_pod(self, namespace: str, name: str) -> None:
        snapshot = None
        with self._lock:
            pod = self._pods.pop(f"{namespace}/{name}", None)
            watchers = list(self._pod_watchers)
            if pod is not None:
                pod["metadata"]["resourceVersion"] = self._next_rv()
                snapshot = _copy(pod)
                self._journal_append("DELETED", snapshot)
        if snapshot is not None:
            for w in watchers:
                w("DELETED", snapshot)

    def watch_pods(self, fn: Callable[[str, dict], None]) -> None:
        with self._lock:
            self._pod_watchers.append(fn)
            existing = [_copy(p) for p in self._pods.values()]
        for p in existing:
            fn("ADDED", p)

    def unwatch_pods(self, fn: Callable[[str, dict], None]) -> None:
        """Detach a watch_pods subscriber (a disconnecting informer).
        The multi-replica benchmark uses this to scope whose informer
        runs on whose clock; missed events are re-learned by resync,
        exactly like a real watch disconnect."""
        with self._lock:
            try:
                self._pod_watchers.remove(fn)
            except ValueError:
                pass

    # -- KubeClient -----------------------------------------------------------
    def list_pods(self, namespace: Optional[str] = None,
                  node_name: Optional[str] = None) -> List[dict]:
        if node_name == "":     # same loud rule as RestKube
            raise ValueError("node_name must be non-empty")
        with self._lock:
            pods = [
                _copy(p)
                for k, p in self._pods.items()
                if (namespace is None or k.split("/", 1)[0] == namespace)
                and (node_name is None
                     or p.get("spec", {}).get("nodeName") == node_name)
            ]
        return pods

    def list_pods_with_rv(self) -> Tuple[List[dict], str]:
        with self._lock:
            return ([_copy(p) for p in self._pods.values()],
                    str(self._rv))

    def watch_pods_events(self, resource_version: str,
                          timeout_seconds: float = 50.0):
        """Informer ListWatch semantics: yield journal events newer than
        ``resource_version``; block (condition wait) when caught up; end
        after ``timeout_seconds`` total.  Raises :class:`Gone` when the rv
        predates the journal (compacted) — the caller must re-list."""
        try:
            since = int(resource_version or "0")
        except ValueError:
            since = 0
        deadline = time.monotonic() + timeout_seconds
        while True:
            with self._cond:
                if since < self._compacted_below:
                    raise Gone(f"resourceVersion {since} compacted")
                batch = [(ev, _copy(p), rv)
                         for rv, ev, p in self._journal if rv > since]
                if not batch:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return
                    self._cond.wait(timeout=min(remaining, 1.0))
                    continue
            for ev, pod, rv in batch:
                yield ev, pod, str(rv)
                since = rv

    def get_pod(self, namespace: str, name: str) -> dict:
        with self._lock:
            pod = self._pods.get(f"{namespace}/{name}")
            if pod is None:
                raise NotFound(f"pod {namespace}/{name}")
            return _copy(pod)

    def patch_pod_annotations(
        self, namespace: str, name: str,
        annotations: Dict[str, Optional[str]],
        resource_version: Optional[str] = None,
    ) -> dict:
        with self._lock:
            pod = self._pods.get(f"{namespace}/{name}")
            if pod is None:
                raise NotFound(f"pod {namespace}/{name}")
            if (
                resource_version is not None
                and pod["metadata"].get("resourceVersion")
                != resource_version
            ):
                # True CAS semantics (apiserver optimistic concurrency):
                # a stale resourceVersion is a 409, NOT last-writer-wins
                # — the sharded commit protocol tests exercise real
                # contention through this path.
                raise Conflict(
                    f"pod {namespace}/{name}: resourceVersion "
                    f"{resource_version} is stale")
            _apply_annotation_patch(pod, annotations)
            pod["metadata"]["resourceVersion"] = self._next_rv()
            snapshot = _copy(pod)
            watchers = list(self._pod_watchers)
            self._journal_append("MODIFIED", snapshot)
        for w in watchers:
            w("MODIFIED", snapshot)
        return snapshot

    def patch_pod_annotations_many(self, patches):
        """Bulk annotation apply under ONE lock acquisition (the real
        apiserver analogue is a pipelined connection): per-entry CAS
        semantics identical to the single-patch path — a 3-tuple writes
        unconditionally, a 4-tuple's stale resourceVersion yields a
        :class:`Conflict` in that entry's slot.  Watcher fan-out happens
        after the lock drops, in journal order, exactly like the
        per-call path.

        A subclass that overrides ``patch_pod_annotations`` (the test
        fakes' standard way to inject write failures) gets the base
        per-entry loop instead, so its override still governs every
        write."""
        if type(self).patch_pod_annotations \
                is not FakeKube.patch_pod_annotations:
            return KubeClient.patch_pod_annotations_many(self, patches)
        results = []
        notify = []
        with self._lock:
            for entry in patches:
                namespace, name, annotations = entry[:3]
                rv = entry[3] if len(entry) > 3 else None
                pod = self._pods.get(f"{namespace}/{name}")
                if pod is None:
                    results.append(NotFound(f"pod {namespace}/{name}"))
                    continue
                if rv is not None \
                        and pod["metadata"].get("resourceVersion") != rv:
                    results.append(Conflict(
                        f"pod {namespace}/{name}: resourceVersion "
                        f"{rv} is stale"))
                    continue
                _apply_annotation_patch(pod, annotations)
                pod["metadata"]["resourceVersion"] = self._next_rv()
                snapshot = _copy(pod)
                self._journal_append("MODIFIED", snapshot)
                notify.append(snapshot)
                results.append(None)
            watchers = list(self._pod_watchers)
        for snapshot in notify:
            for w in watchers:
                w("MODIFIED", snapshot)
        return results

    def bind_pod(self, namespace: str, name: str, node: str) -> None:
        with self._lock:
            pod = self._pods.get(f"{namespace}/{name}")
            if pod is None:
                raise NotFound(f"pod {namespace}/{name}")
            pod["spec"]["nodeName"] = node
            self.bindings.append({"namespace": namespace, "name": name, "node": node})

    def create_event(self, namespace: str, involved: dict, reason: str,
                     message: str, type_: str = "Normal") -> None:
        with self._lock:
            self.events.append({
                "namespace": namespace,
                "involvedObject": dict(involved),
                "reason": reason,
                "message": message,
                "type": type_,
            })

    def list_nodes(self) -> List[dict]:
        with self._lock:
            return [_copy(n) for n in self._nodes.values()]

    def create_node(self, node: dict) -> dict:
        with self._lock:
            name = node.get("metadata", {}).get("name", "")
            if name in self._nodes:
                raise Conflict(f"node {name} already exists")
            node = _copy(node)
            node.setdefault("metadata", {}).setdefault(
                "resourceVersion", self._next_rv())
            self._nodes[name] = node
            return _copy(node)

    def get_node(self, name: str) -> dict:
        with self._lock:
            node = self._nodes.get(name)
            if node is None:
                raise NotFound(f"node {name}")
            return _copy(node)

    def patch_node_annotations(
        self,
        name: str,
        annotations: Dict[str, Optional[str]],
        resource_version: Optional[str] = None,
    ) -> dict:
        with self._lock:
            node = self._nodes.get(name)
            if node is None:
                raise NotFound(f"node {name}")
            if (
                resource_version is not None
                and node["metadata"].get("resourceVersion") != resource_version
            ):
                raise Conflict(
                    f"node {name}: resourceVersion {resource_version} is stale"
                )
            _apply_annotation_patch(node, annotations)
            node["metadata"]["resourceVersion"] = self._next_rv()
            return _copy(node)
