"""Group commit of Filter's decision writes (the port's copy of the JAX
package's ``util/decisionwriter.py``).

Every placement ends in one apiserver merge-patch (the decision
annotations).  With N concurrent Filters that is N round-trips, each
paying the client's overhead for one small patch.  Here concurrent
callers enqueue their patch, exactly one of them (the leader) drains the
queue and pushes the whole batch through
:meth:`KubeClient.patch_pod_annotations_many`, and every caller gets its
own entry's outcome.

The contract of the direct write stands:

- ``write`` returns only after this caller's patch was applied (or
  raises its failure): Filter never reports a node whose decision write
  did not land, because the tentative grant is rolled back on failure;
- one pod's failure never fails another's write in the same batch
  (per-entry outcomes);
- no scheduler lock is held in here.

Leadership rides a caller's thread (no writer thread to start or leak):
the first writer into an idle batcher leads, drains until the queue is
empty, picking up the patches that arrived while it wrote, and resigns.
A client without its own ``patch_pod_annotations_many`` (the base loop)
gains nothing from a batch, so its writes go straight through on the
caller's thread.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from ..k8s.client import KubeClient
from . import perf


class _Pending:
    __slots__ = ("namespace", "name", "patch", "done", "error", "batch_size")

    def __init__(self, namespace: str, name: str,
                 patch: Dict[str, Optional[str]]) -> None:
        self.namespace = namespace
        self.name = name
        self.patch = patch
        self.done = threading.Event()
        self.error: Optional[Exception] = None
        self.batch_size = 0


class AdaptiveSizer:
    """Write-chunk size controller, adapted from observed flush latency:
    per-call overhead wants big chunks, but a chunk must stay under a
    latency target or its tail decisions wait behind the flush.

    Rule per observation: project the next flush at the current size
    from the measured per-entry cost; over ``target_s`` → halve, under
    half the target → double, both clamped to [lo, hi].  Multiplicative
    moves converge in O(log range) flushes and never oscillate more
    than one step around the target."""

    __slots__ = ("lo", "hi", "target_s", "_size")

    def __init__(self, lo: int = 16, hi: int = 512, start: int = 64,
                 target_s: float = 0.005) -> None:
        self.lo = lo
        self.hi = hi
        self.target_s = target_s
        self._size = max(lo, min(hi, start))

    def size(self) -> int:
        return self._size

    def observe(self, n: int, seconds: float) -> None:
        if n <= 0:
            return
        projected = (seconds / n) * self._size
        if projected > self.target_s and self._size > self.lo:
            self._size = max(self.lo, self._size // 2)
        elif projected < self.target_s / 2 and self._size < self.hi:
            self._size = min(self.hi, self._size * 2)


class DecisionBatcher:
    """Leader/follower group commit over ``patch_pod_annotations_many``.
    Batch size is adaptive: the sizer grows chunks while flushes stay
    cheap and shrinks them when a flush blows the latency target, so
    the amortization tracks what the transport actually delivers."""

    def __init__(self, client, max_batch: int = 512) -> None:
        self._client = client
        self._max_batch = max_batch
        self.sizer = AdaptiveSizer(hi=max_batch)
        self._lock = threading.Lock()
        self._queue: List[_Pending] = []
        self._leader_active = False
        # Group commit only pays when the transport actually amortizes a
        # batch (a pipelined connection, a server-side batch endpoint).
        # Against the base KubeClient loop it is pure serialization:
        # previously-parallel writes would funnel through one leader at
        # batch_size × RTT each.  No override → write directly on the
        # caller's thread, exactly the pre-batcher behavior.
        self._passthrough = (
            type(client).patch_pod_annotations_many
            is KubeClient.patch_pod_annotations_many)
        # Lifetime stats (read by tests and the saturation-curious):
        # batches <= writes; writes/batches is the amortization factor.
        self.batches = 0
        self.writes = 0

    def write(self, namespace: str, name: str,
              patch: Dict[str, Optional[str]]) -> int:
        """Apply one decision patch, possibly batched with concurrent
        callers'.  Returns the size of the batch it rode in (1 = wrote
        alone); raises this entry's failure."""
        if self._passthrough:
            # 1-in-4 sampled flush timing (per-write on this path; the
            # grouped path below times every real batch flush).
            reg = perf.registry()
            rec = reg.enabled and (self.writes & 3) == 0
            if rec:
                t0 = time.monotonic()
            self._client.patch_pod_annotations(namespace, name, patch)
            if rec:
                reg.record("decision-flush", time.monotonic() - t0)
            with self._lock:
                self.batches += 1
                self.writes += 1
            return 1
        p = _Pending(namespace, name, patch)
        with self._lock:
            self._queue.append(p)
            lead = not self._leader_active
            if lead:
                self._leader_active = True
        if lead:
            self._drain()
        # The leader's own entry is resolved by its drain; followers wait
        # for the leader that covered their entry.
        p.done.wait()
        if p.error is not None:
            raise p.error
        return p.batch_size

    def write_many(self, entries: List[tuple]) -> List[Optional[Exception]]:
        """A whole batched cycle's patches in one
        ``patch_pod_annotations_many`` call, with no queue (the caller is
        the batch): one outcome an entry (None, or its failure; one
        entry's failure never fails another), the flush timed and fed to
        the sizer."""
        reg = perf.registry()
        reg.set_gauge("decision_flush_last_size", len(entries))
        t0 = time.monotonic()
        try:
            results = self._client.patch_pod_annotations_many(entries)
            if len(results) != len(entries):
                raise RuntimeError(
                    f"patch_pod_annotations_many returned {len(results)} "
                    f"outcomes for {len(entries)} patches")
        except Exception as e:  # noqa: BLE001 — wholesale transport failure
            results = [e] * len(entries)
        seconds = time.monotonic() - t0
        reg.record("decision-flush", seconds)
        self.sizer.observe(len(entries), seconds)
        with self._lock:
            self.batches += 1
            self.writes += len(entries)
        return results

    def _drain(self) -> None:
        batch: List[_Pending] = []
        try:
            while True:
                with self._lock:
                    take = min(self._max_batch, self.sizer.size())
                    batch = self._queue[:take]
                    del self._queue[:len(batch)]
                    if not batch:
                        self._leader_active = False
                        return
                self._write_batch(batch)
        except BaseException:
            # A failure the batch loop itself did not absorb (it absorbs
            # Exception, but a KeyboardInterrupt/MemoryError can escape
            # mid-batch) must not leave followers waiting forever or the
            # batcher leaderless-but-marked-active.  The IN-FLIGHT batch
            # was already dequeued — resolve it too, or its followers
            # block in write() with no timeout.
            with self._lock:
                orphans, self._queue = self._queue, []
                self._leader_active = False
            for p in batch + orphans:
                if not p.done.is_set():
                    p.error = RuntimeError("decision batch leader died")
                    p.done.set()
            raise

    def _write_batch(self, batch: List[_Pending]) -> None:
        self.batches += 1
        self.writes += len(batch)
        # Flush telemetry (util/perf.py → /perfz, the "decision-flush"
        # phase): per-flush latency ring + the last flush size gauge.
        reg = perf.registry()
        reg.set_gauge("decision_flush_last_size", len(batch))
        t0 = time.monotonic()
        entries: List[Tuple[str, str, Dict[str, Optional[str]]]] = [
            (p.namespace, p.name, p.patch) for p in batch
        ]
        try:
            results = self._client.patch_pod_annotations_many(entries)
            if len(results) != len(batch):  # defensive: malformed override
                raise RuntimeError(
                    f"patch_pod_annotations_many returned {len(results)} "
                    f"outcomes for {len(batch)} patches")
        except Exception as e:  # noqa: BLE001 — wholesale transport failure
            results = [e] * len(batch)
        seconds = time.monotonic() - t0
        reg.record("decision-flush", seconds)
        # Observed flush latency drives the next batch's size (the
        # adaptive half of the group commit).
        self.sizer.observe(len(batch), seconds)
        for p, err in zip(batch, results):
            p.error = err
            p.batch_size = len(batch)
            p.done.set()
