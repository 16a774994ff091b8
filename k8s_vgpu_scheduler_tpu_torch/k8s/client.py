"""Kubernetes client abstraction (the port's copy of the JAX package's
``k8s/client.py``).

The reference links the full client-go machinery (pkg/k8sutil/client.go); this
rebuild needs only a narrow slice of the API — pods/nodes get/list/patch plus
Binding — so we define that slice as an interface and provide two
implementations: :class:`~.rest.RestKube` (raw
apiserver REST, in-cluster) and :class:`~.fake.FakeKube`
(in-memory, for tests — the envtest/fake-clientset pattern SURVEY.md §4 says
the reference lacks).

Kubernetes objects are represented as plain dicts in their JSON wire shape.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple


class Conflict(Exception):
    """409 from the apiserver (optimistic-concurrency loss)."""


class NotFound(Exception):
    """404 from the apiserver."""


class Gone(Exception):
    """410 from the apiserver: the requested watch resourceVersion has been
    compacted out of the event journal — the watcher must re-list."""


class KubeClient:
    """The narrow apiserver surface this framework consumes."""

    # -- pods -----------------------------------------------------------------
    def list_pods(self, namespace: Optional[str] = None,
                  node_name: Optional[str] = None) -> List[dict]:
        """``node_name`` maps to the apiserver's
        ``fieldSelector=spec.nodeName=<node>`` — the node agent's pending
        -pod scan is O(pods-on-node), not O(cluster) (improves on the
        reference's full LIST per Allocate, util.go:49–74)."""
        raise NotImplementedError

    def list_pods_with_rv(self) -> "tuple[List[dict], str]":
        """List all pods plus the list-level resourceVersion — the watch
        bookmark (reference informer ListWatch, scheduler.go:66–86)."""
        raise NotImplementedError

    def watch_pods_events(self, resource_version: str,
                          timeout_seconds: float = 50.0):
        """Yield ``(event, pod, resource_version)`` tuples newer than
        ``resource_version`` until ``timeout_seconds`` of quiet elapse
        (the generator then ends; re-call with the last rv to resume).
        Raises :class:`Gone` when the rv is too old — re-list then."""
        raise NotImplementedError

    def get_pod(self, namespace: str, name: str) -> dict:
        raise NotImplementedError

    def patch_pod_annotations(
        self, namespace: str, name: str,
        annotations: Dict[str, Optional[str]],
        resource_version: Optional[str] = None,
    ) -> dict:
        """Merge-patch metadata.annotations; a None value deletes the key.
        When ``resource_version`` is given it rides in the patch body,
        turning the write into a compare-and-swap: the apiserver rejects
        it with 409 (:class:`Conflict`) if the pod changed since that
        version — the sharded decision commit (shard/commit.py) depends
        on this, exactly like the node-lock CAS depends on the node
        variant below."""
        raise NotImplementedError

    def patch_pod_annotations_many(
        self, patches: List[tuple]
    ) -> List[Optional[Exception]]:
        """Apply many annotation merge-patches; per-entry outcome (None =
        applied, else the exception) so one failed pod never poisons the
        rest of a batch.  Each entry is ``(namespace, name, annotations)``
        or ``(namespace, name, annotations, resource_version)`` — the
        4-tuple form makes that entry a CAS exactly like the single-call
        ``resource_version`` argument (a stale version yields a
        :class:`Conflict` in that entry's slot), so the sharded bulk
        commit (shard/commit.py cas_commit_many) can amortize a whole
        cycle's fenced writes.  The base implementation loops; transports
        with a cheaper amortized path (a pipelined connection, a
        server-side batch endpoint, FakeKube's one-acquire bulk apply)
        override it — util/decisionwriter.py feeds whole decision-write
        batches through here."""
        out: List[Optional[Exception]] = []
        for entry in patches:
            namespace, name, annotations = entry[:3]
            rv = entry[3] if len(entry) > 3 else None
            try:
                if rv is None:
                    # No kwarg on the plain form: test fakes (and thin
                    # embedder clients) override patch_pod_annotations
                    # without the resource_version parameter.
                    self.patch_pod_annotations(namespace, name,
                                               annotations)
                else:
                    self.patch_pod_annotations(namespace, name,
                                               annotations,
                                               resource_version=rv)
                out.append(None)
            except Exception as e:  # noqa: BLE001 — per-entry isolation
                out.append(e)
        return out

    def bind_pod(self, namespace: str, name: str, node: str) -> None:
        """POST a v1.Binding (reference scheduler.go:250)."""
        raise NotImplementedError

    def create_event(self, namespace: str, involved: dict, reason: str,
                     message: str, type_: str = "Normal") -> None:
        """POST a v1.Event about ``involved`` (a partial objectReference:
        kind/name/namespace/uid) — how the quota admission loop makes
        hold/admit/reclaim visible to `kubectl describe pod`.  Events are
        best-effort observability; callers treat any failure (including
        this NotImplementedError on clients without an events surface)
        as non-fatal."""
        raise NotImplementedError

    # -- nodes ----------------------------------------------------------------
    def list_nodes(self) -> List[dict]:
        raise NotImplementedError

    def create_node(self, node: dict) -> dict:
        """POST a v1.Node.  Raises :class:`Conflict` when it already
        exists (the apiserver's AlreadyExists is a 409).  Used only for
        the shard-coordination object (shard/shardmap.py) — real nodes
        register themselves via the kubelet."""
        raise NotImplementedError

    def get_node(self, name: str) -> dict:
        raise NotImplementedError

    def patch_node_annotations(
        self,
        name: str,
        annotations: Dict[str, Optional[str]],
        resource_version: Optional[str] = None,
    ) -> dict:
        """Merge-patch node annotations.  When ``resource_version`` is given it
        is included in the patch body, turning the patch into a compare-and-swap:
        the apiserver rejects it with 409 (:class:`Conflict`) if the node changed
        since that version.  The node-lock acquire path depends on this.
        """
        raise NotImplementedError


# --- dict-pod helpers (shared by scheduler + plugin) -------------------------

def pod_meta(pod: dict) -> dict:
    return pod.setdefault("metadata", {})


def pod_annotations(pod: dict) -> dict:
    return pod_meta(pod).setdefault("annotations", {})


def pod_name(pod: dict) -> str:
    return pod_meta(pod).get("name", "")


def pod_namespace(pod: dict) -> str:
    return pod_meta(pod).get("namespace", "default")


def pod_uid(pod: dict) -> str:
    return pod_meta(pod).get("uid", "")


def pod_qos(pod: dict) -> str:
    """The pod's ``vtpu.dev/qos`` class ("" = unclassed: flat limiter).
    Values are webhook-validated at admission (scheduler/webhook.py)."""
    from ..util.types import QOS_ANNOTATION

    return pod.get("metadata", {}).get(
        "annotations", {}).get(QOS_ANNOTATION, "") or ""


def pod_phase(pod: dict) -> str:
    return pod.get("status", {}).get("phase", "")


def is_pod_terminated(pod: dict) -> bool:
    """Reference k8sutil.IsPodInTerminatedState (pod.go)."""
    return pod_phase(pod) in ("Succeeded", "Failed")
