"""The annotation-mediated scheduler ↔ node-agent handshake (the port's
copy of the JAX package's ``util/protocol.py``; the same transitions).

Flow (reference pkg/util/util.go:49–220; SURVEY.md §3.2/§3.4):

1. Filter patches ``assigned-node``, ``assigned-ids``, ``devices-to-allocate``.
2. Bind takes the node lock, sets ``bind-phase=allocating`` + ``bind-time``,
   and POSTs the Binding.
3. The node agent's Allocate() finds the pending pod for its node, pops the
   next device list of its type from ``devices-to-allocate``, and finishes
   with ``bind-phase=success`` + lock release (or ``failed`` on error, which
   also releases the lock so the pod can reschedule).
"""

from __future__ import annotations

import logging
import time
from typing import Optional

from ..k8s.client import (
    KubeClient,
    NotFound,
    pod_annotations,
    pod_name,
    pod_namespace,
)
from . import codec
from .types import (
    ASSIGNED_NODE_ANNOTATION,
    BIND_ALLOCATING,
    BIND_FAILED,
    BIND_PHASE_ANNOTATION,
    BIND_SUCCESS,
    BIND_TIME_ANNOTATION,
    TO_ALLOCATE_ANNOTATION,
    ContainerDevices,
)
from .nodelock import release_node

log = logging.getLogger(__name__)


def get_pending_pod(client: KubeClient, node: str) -> Optional[dict]:
    """Find the pod currently mid-handshake on ``node``.

    Reference GetPendingPod (util.go:49–74): LIST all pods, match
    bind-time present + bind-phase==allocating + assigned-node==node.
    The node lock guarantees at most one such pod per node.  Unlike the
    reference, the LIST is node-scoped (fieldSelector spec.nodeName) —
    Allocate is O(pods-on-node), not O(cluster); Bind has already
    created the Binding by the time kubelet calls Allocate, so the
    pending pod always carries its nodeName.  The annotation checks
    below stay as the actual protocol match.
    """
    for pod in client.list_pods(node_name=node):
        anns = pod.get("metadata", {}).get("annotations", {})
        if BIND_TIME_ANNOTATION not in anns:
            continue
        if anns.get(BIND_PHASE_ANNOTATION) != BIND_ALLOCATING:
            continue
        if anns.get(ASSIGNED_NODE_ANNOTATION) == node:
            return pod
    return None


def get_next_device_request(device_type: str, pod: dict) -> ContainerDevices:
    """Pop-preview: first container device list whose devices are all of
    ``device_type`` (reference GetNextDeviceRequest, util.go:134–160)."""
    pd = codec.decode_pod_devices(
        pod.get("metadata", {}).get("annotations", {}).get(TO_ALLOCATE_ANNOTATION, "")
    )
    for container in pd:
        if container and all(d.type.startswith(device_type) for d in container):
            return container
    raise LookupError(f"no pending {device_type} request in pod {pod_name(pod)}")


def erase_next_device_type(client: KubeClient, device_type: str, pod: dict) -> None:
    """Remove the first container entry of ``device_type`` from
    devices-to-allocate (multi-container pods hand each container's grant to
    successive Allocate() calls — reference util.go:162–181)."""
    anns = pod_annotations(pod)
    pd = codec.decode_pod_devices(anns.get(TO_ALLOCATE_ANNOTATION, ""))
    out = []
    erased = False
    for container in pd:
        if (
            not erased
            and container
            and all(d.type.startswith(device_type) for d in container)
        ):
            erased = True
            out.append([])
        else:
            out.append(container)
    encoded = codec.encode_pod_devices(out)
    anns[TO_ALLOCATE_ANNOTATION] = encoded
    client.patch_pod_annotations(
        pod_namespace(pod), pod_name(pod), {TO_ALLOCATE_ANNOTATION: encoded}
    )


def _finalize(client: KubeClient, pod: dict, phase: str) -> None:
    client.patch_pod_annotations(
        pod_namespace(pod), pod_name(pod), {BIND_PHASE_ANNOTATION: phase}
    )


def pod_allocation_try_success(client: KubeClient, pod: dict) -> None:
    """If every device list has been consumed, mark success and release the
    node lock (reference PodAllocationTrySuccess, util.go:183–207).

    The pod may be deleted out from under the handshake (kubectl delete,
    controller GC); the node lock must still be released or the node stays
    unschedulable until the 5-minute expiry.
    """
    node = pod.get("metadata", {}).get("annotations", {}).get(
        ASSIGNED_NODE_ANNOTATION, ""
    )
    try:
        refreshed = client.get_pod(pod_namespace(pod), pod_name(pod))
        remaining = refreshed.get("metadata", {}).get("annotations", {}).get(
            TO_ALLOCATE_ANNOTATION, ""
        )
        if any(codec.decode_pod_devices(remaining)):
            log.info("pod %s still has pending allocations", pod_name(pod))
            return
        _finalize(client, pod, BIND_SUCCESS)
        node = refreshed.get("metadata", {}).get("annotations", {}).get(
            ASSIGNED_NODE_ANNOTATION, node
        )
    except NotFound:
        log.warning("pod %s vanished mid-handshake; releasing lock", pod_name(pod))
    if node:
        release_node(client, node)


def pod_allocation_failed(client: KubeClient, pod: dict) -> None:
    """Mark failed + release lock so the scheduler can retry elsewhere
    (reference PodAllocationFailed, util.go:209–220)."""
    try:
        _finalize(client, pod, BIND_FAILED)
    except NotFound:
        log.warning("pod %s vanished before failure mark", pod_name(pod))
    node = pod.get("metadata", {}).get("annotations", {}).get(
        ASSIGNED_NODE_ANNOTATION, ""
    )
    if node:
        release_node(client, node)


def bind_timestamp() -> str:
    return str(int(time.time() * 1e9))
