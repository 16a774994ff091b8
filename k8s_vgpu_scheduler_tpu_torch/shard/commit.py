"""The fenced decision commit: a compare-and-swap across replicas (the
port's copy of the JAX package's ``shard/commit.py``).

Within one replica the optimistic commit already records a grant only
against a validated (pod rev, inventory rev) generation.  Across replicas
the apiserver is the shared store, so the decision write becomes the
transaction: a merge-patch of the pod's decision annotations carrying the
pod's ``metadata.resourceVersion``, which the apiserver (and ``FakeKube``,
which keeps its semantics) refuses with 409 when the pod changed since.
With the shard fence, a commit is a compare-and-swap keyed by (shard
epoch, pod resourceVersion):

- **epoch fence** (``ShardManager.commit_fence``): the map must be fresh
  and this replica must still own the chosen node; a stale or disowned
  commit fails closed before any I/O;
- **pod CAS**: two replicas deciding the same pod at once race on the
  resourceVersion; one patch lands, the loser rolls its tentative grant
  back and the pod requeues.

Every failure requeues rather than retries in place: the next Filter
decides again on a fresh map and a fresh pod.  Failures are counted by
token (``vtpu_commit_cas_failures_total{reason}``): ``no-map``,
``stale-map``, ``lost-ownership``, ``adopting``, ``already-decided``,
``rv-conflict``, ``pod-gone``, ``read-failed``, ``write-failed``.  Each
one is also a ``commit-cas-failed`` event in the tracer (``util/trace``),
under the JAX package's provenance record's name, with the same token.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..k8s.client import Conflict, NotFound, pod_name, pod_namespace
from ..util import trace
from ..util.types import ASSIGNED_NODE_ANNOTATION


#: Stamped on every sharded decision: the epoch the commit was fenced at,
#: and the replica that wrote it.  The adoption replay and the HA
#: simulator's no-grant-lost audit read them back.
SHARD_EPOCH_ANNOTATION = "vtpu.dev/shard-epoch"
SHARD_OWNER_ANNOTATION = "vtpu.dev/shard-owner"


def _decision_of(pod: dict):
    """(assigned node, shard owner) already on a pod, read only."""
    anns = pod.get("metadata", {}).get("annotations", {}) or {}
    return (anns.get(ASSIGNED_NODE_ANNOTATION, ""),
            anns.get(SHARD_OWNER_ANNOTATION, ""))


def _failer(shards, pod: dict, node: str):
    """The failure recorder of one pod's commit: counts the token, puts a
    ``commit-cas-failed`` event in the tracer, and returns the requeue
    reason."""
    meta = pod.get("metadata", {})
    namespace, name = pod_namespace(pod), pod_name(pod)

    def fail(token: str, reason: str) -> str:
        shards.note_cas_failure(token)
        trace.tracer().event(meta.get("uid", ""), "commit-cas-failed",
                             namespace=namespace, name=name, node=node,
                             token=token, epoch=shards.epoch())
        return reason
    return fail


def cas_commit(client, shards, pod: dict, node: str,
               patch: Dict[str, str]) -> Optional[str]:
    """Write ``patch`` (the decision annotations) as a fenced CAS: None on
    success, else the requeue reason (the caller rolls the tentative
    grant back, as after a failed plain write)."""
    namespace, name = pod_namespace(pod), pod_name(pod)
    fail = _failer(shards, pod, node)
    staged = _stage(client, shards, pod, node, patch, fail)
    if isinstance(staged, str):
        return staged
    full, rv = staged
    try:
        client.patch_pod_annotations(namespace, name, full,
                                     resource_version=rv)
    except Conflict:
        # The pod moved under us (a peer's decision, a delete, any
        # write); which one does not matter: fail closed.
        return fail("rv-conflict",
                    f"shard-cas: {namespace}/{name} changed since rv "
                    f"{rv}; decision not committed, pod requeued")
    except NotFound:
        return fail("pod-gone",
                    f"shard-cas: {namespace}/{name} gone before commit")
    except Exception as e:  # noqa: BLE001 — no decision outlives a failed write
        return fail("write-failed",
                    f"shard-cas: writing decision failed: {e}")
    return None


def _stage(client, shards, pod: dict, node: str, patch: Dict[str, str],
           fail):
    """The pre-write half of one fenced CAS: the fence, the epoch and
    owner stamps, the peer-decision guard, the resourceVersion.  Returns
    ``(full patch, rv)`` ready to send, or the requeue reason (``fail``
    has recorded it)."""
    namespace, name = pod_namespace(pod), pod_name(pod)
    fence, epoch = shards.commit_fence(node)
    if fence is not None:
        return fail(fence, f"shard-fence: {fence} — decision on {node} "
                           "not committed, pod requeued")
    full = dict(patch)
    full[SHARD_EPOCH_ANNOTATION] = str(epoch)
    full[SHARD_OWNER_ANNOTATION] = shards.replica
    assigned, owner = _decision_of(pod)
    if assigned and owner and owner != shards.replica:
        # The offered pod already carries a peer's committed decision.
        # Deciding our own earlier assignment again is legitimate (Filter
        # drops the stale grant first); overwriting a peer's is not, even
        # with a current resourceVersion.  A pod that must change owners
        # goes through rescission (the annotations cleared first) or
        # adoption.
        return fail("already-decided",
                    f"shard-cas: {namespace}/{name} already assigned to "
                    f"{assigned} by {owner}")
    rv = pod.get("metadata", {}).get("resourceVersion")
    if rv is None:
        # The Filter's pod carried no resourceVersion (in-process callers
        # and the fakes): read, then CAS on what was read.
        try:
            current = client.get_pod(namespace, name)
        except NotFound:
            return fail("pod-gone",
                        f"shard-cas: {namespace}/{name} gone before "
                        "commit")
        except Exception as e:  # noqa: BLE001 — requeue; the next Filter retries
            return fail("read-failed",
                        f"shard-cas: cannot read {namespace}/{name}: {e}")
        assigned, owner = _decision_of(current)
        if assigned and owner and owner != shards.replica:
            # The same rule on the live pod: a peer's decision landed
            # since the view we decided on.
            return fail("already-decided",
                        f"shard-cas: {namespace}/{name} already "
                        f"assigned to {assigned} by {owner}")
        rv = current.get("metadata", {}).get("resourceVersion")
    return full, rv


def cas_commit_many(client, shards, items: List[Tuple[dict, str, dict]]
                    ) -> List[Optional[str]]:
    """The bulk form of :func:`cas_commit` for a batched cycle: each item
    (pod, node, patch) staged as on the single path, then the stageable
    ones sent in one ``patch_pod_annotations_many`` call with a CAS for
    each entry (one round trip; each pod keeps its own 409).  One requeue
    reason (or None) an item, in order."""
    results: List[Optional[str]] = [None] * len(items)
    sendable: List[tuple] = []   # (index, namespace, name, full, rv)
    fails = []
    for idx, (pod, node, patch) in enumerate(items):
        fail = _failer(shards, pod, node)
        fails.append(fail)
        staged = _stage(client, shards, pod, node, patch, fail)
        if isinstance(staged, str):
            results[idx] = staged
            continue
        full, rv = staged
        sendable.append((idx, pod_namespace(pod), pod_name(pod), full, rv))
    if not sendable:
        return results
    try:
        outcomes = client.patch_pod_annotations_many(
            [(ns, name, full, rv) for _i, ns, name, full, rv in sendable])
        if len(outcomes) != len(sendable):
            # A short list would zip-truncate and mark unsent writes
            # successful.
            raise RuntimeError(
                f"patch_pod_annotations_many returned {len(outcomes)} "
                f"outcomes for {len(sendable)} patches")
    except Exception as e:  # noqa: BLE001 — a failed transport fails every entry closed
        outcomes = [e] * len(sendable)
    for (idx, namespace, name, _full, rv), err in zip(sendable, outcomes):
        if err is None:
            continue
        fail = fails[idx]
        if isinstance(err, Conflict):
            results[idx] = fail(
                "rv-conflict",
                f"shard-cas: {namespace}/{name} changed since rv "
                f"{rv}; decision not committed, pod requeued")
        elif isinstance(err, NotFound):
            results[idx] = fail(
                "pod-gone",
                f"shard-cas: {namespace}/{name} gone before commit")
        else:
            results[idx] = fail(
                "write-failed",
                f"shard-cas: writing decision failed: {err}")
    return results
