"""Node-annotation mutex (the port's copy of the JAX package's
``util/nodelock.py``).

The bind → allocate handshake is a two-phase commit between the scheduler
extender and the node agent (two processes on two machines).  It is serialized
per node by a lock stored in a node annotation — acquire writes a timestamp,
release deletes it; a stale lock (holder crashed mid-allocate) expires after 5
minutes.  Reference: pkg/util/nodelock.go:144–230.
"""

from __future__ import annotations

import datetime
import logging
import time
from typing import Optional

from ..k8s.client import Conflict, KubeClient
from .types import MAX_LOCK_RETRY, NODE_LOCK_ANNOTATION, NODE_LOCK_EXPIRE_SECONDS

log = logging.getLogger(__name__)

_TIME_FORMAT = "%Y-%m-%dT%H:%M:%SZ"


class NodeLockError(Exception):
    pass


def _now() -> datetime.datetime:
    return datetime.datetime.now(datetime.timezone.utc)


def _parse(stamp: str) -> Optional[datetime.datetime]:
    try:
        return datetime.datetime.strptime(stamp, _TIME_FORMAT).replace(
            tzinfo=datetime.timezone.utc
        )
    except ValueError:
        return None


def lock_node(client: KubeClient, node_name: str,
              retries: int = MAX_LOCK_RETRY, backoff: float = 1.0) -> None:
    """Acquire the per-node lock, breaking stale locks older than 5 minutes.

    Mirrors the reference's retry loop (nodelock.go:207–230: up to ``retries``
    attempts with linear backoff) but acquires with a true compare-and-swap:
    the lock patch carries the resourceVersion observed while the lock was
    seen free, so two concurrent acquirers cannot both win (the reference uses
    Nodes().Update with the same property, nodelock.go:59).
    """
    for attempt in range(retries):
        node = client.get_node(node_name)
        meta = node.get("metadata", {})
        holder = meta.get("annotations", {}).get(NODE_LOCK_ANNOTATION)
        if holder:
            stamp = _parse(holder)
            if stamp is not None and (
                (_now() - stamp).total_seconds() < NODE_LOCK_EXPIRE_SECONDS
            ):
                log.info("node %s locked since %s; retry %d", node_name, holder, attempt)
                if attempt + 1 < retries:
                    time.sleep(backoff * (attempt + 1))
                continue
            log.warning("breaking stale/invalid lock on node %s (%s)", node_name, holder)
        try:
            client.patch_node_annotations(
                node_name,
                {NODE_LOCK_ANNOTATION: _now().strftime(_TIME_FORMAT)},
                resource_version=meta.get("resourceVersion"),
            )
        except Conflict:
            log.info("lost lock CAS race on node %s; retry %d", node_name, attempt)
            if attempt + 1 < retries:
                time.sleep(backoff * (attempt + 1))
            continue
        return
    raise NodeLockError(f"could not lock node {node_name} after {retries} attempts")


def release_node(client: KubeClient, node_name: str) -> None:
    client.patch_node_annotations(node_name, {NODE_LOCK_ANNOTATION: None})


def is_locked(client: KubeClient, node_name: str) -> bool:
    node = client.get_node(node_name)
    return NODE_LOCK_ANNOTATION in node.get("metadata", {}).get("annotations", {})
