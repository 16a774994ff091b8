"""Slice reservations — cards held back for a compaction beneficiary (the
port's copy of the JAX package's ``placement/reserve.py``).

When the defragmenter evicts victims to assemble a contiguous box, the
freed cards must reach the pod (or gang) that was blocked — not the next
best-effort single that happens to Filter first, or the compaction
bought nothing.  A reservation takes the box's cards out of the
schedulable set the same way quarantine does: stripped from the usage
the scheduler caches for its snapshot
(``core.Scheduler._refresh_entry_locked``), which
every fit path — per-pod, gang, the defragmenter's views — reads, so
nothing can place on a reserved card.

Every reservation change calls ``on_change(node)``: the scheduler passes
``NodeManager.touch``, so the node's inventory rev moves, its cached
usage rebuilds, and an optimistic commit computed before the change
fails its revision validation.

When the beneficiary's own Filter arrives, the scheduler releases the
reservation first (release_for) — the cards return to the usage and the
mesh/slice-aware fit finds the assembled box (it is the only contiguous
run large enough, which is the pin).  A beneficiary that never returns
must not strand capacity: reservations expire after ``ttl_s`` and the
sweep (driven by the defrag loop's tick) returns the cards to the pool.

Quota interplay: reserved cards are REAL capacity the admission loop
must not hand out — total_chips() feeds the fleet release throttle, so
backfill around an accumulating gang cannot fill the hole compaction
just opened.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Set


@dataclasses.dataclass
class SliceReservation:
    node: str
    chips: Set[str]
    #: Beneficiary identity: a pod uid, or a gang key ("namespace/group")
    #: — whatever the blocked demand was recorded under.
    for_key: str
    reserved_at: float
    expires_at: float


class SliceReservations:
    """Registry of active reservations.  Internally locked (the defrag
    loop writes, Filter paths and the metrics scrape read)."""

    def __init__(self, clock: Optional[Callable[[], float]] = None,
                 on_change: Optional[Callable[[str], None]] = None,
                 ttl_s: float = 300.0) -> None:
        self._clock = clock or time.monotonic
        self._on_change = on_change
        self.ttl_s = ttl_s
        self._lock = threading.Lock()
        self._by_node: Dict[str, List[SliceReservation]] = {}
        #: Lifetime counts for the exporter.
        self.reserved_total = 0
        self.expired_total = 0

    def reserve(self, node: str, chips: Set[str], for_key: str,
                ttl_s: Optional[float] = None) -> SliceReservation:
        now = self._clock()
        r = SliceReservation(
            node=node, chips=set(chips), for_key=for_key, reserved_at=now,
            expires_at=now + (self.ttl_s if ttl_s is None else ttl_s))
        with self._lock:
            self._by_node.setdefault(node, []).append(r)
            self.reserved_total += 1
        self._changed(node)
        return r

    def reserved_on(self, node: str) -> Set[str]:
        """Card ids currently reserved on ``node`` (the usage-strip read —
        same shape as quarantine.quarantined_on)."""
        with self._lock:
            rs = self._by_node.get(node)
            if not rs:
                return set()
            return {c for r in rs for c in r.chips}

    def release(self, reservation: SliceReservation) -> bool:
        """Drop exactly one reservation (an aborted plan must return
        ITS box, never its gang's previously assembled ones)."""
        with self._lock:
            rs = self._by_node.get(reservation.node)
            if not rs or reservation not in rs:
                return False
            rs.remove(reservation)
            if not rs:
                del self._by_node[reservation.node]
        self._changed(reservation.node)
        return True

    def release_for(self, for_key: str) -> List[SliceReservation]:
        """Drop every reservation held for ``for_key`` (the beneficiary
        arrived); returns what was released."""
        released: List[SliceReservation] = []
        with self._lock:
            for node in list(self._by_node):
                keep = []
                for r in self._by_node[node]:
                    (released if r.for_key == for_key else keep).append(r)
                if keep:
                    self._by_node[node] = keep
                else:
                    del self._by_node[node]
        for r in released:
            self._changed(r.node)
        return released

    def sweep(self, now: Optional[float] = None) -> List[SliceReservation]:
        """Expire overdue reservations; returns what expired."""
        now = self._clock() if now is None else now
        expired: List[SliceReservation] = []
        with self._lock:
            for node in list(self._by_node):
                keep = []
                for r in self._by_node[node]:
                    (expired if r.expires_at <= now else keep).append(r)
                if keep:
                    self._by_node[node] = keep
                else:
                    del self._by_node[node]
            self.expired_total += len(expired)
        for r in expired:
            self._changed(r.node)
        return expired

    def active(self) -> List[SliceReservation]:
        with self._lock:
            return [r for rs in self._by_node.values() for r in rs]

    def holds_for(self, for_key: str) -> bool:
        with self._lock:
            return any(r.for_key == for_key
                       for rs in self._by_node.values() for r in rs)

    def count_for(self, for_key: str) -> int:
        """Boxes currently reserved for ``for_key`` — a gang of N needs
        N disjoint boxes, assembled one compaction at a time."""
        with self._lock:
            return sum(1 for rs in self._by_node.values() for r in rs
                       if r.for_key == for_key)

    def total_chips(self) -> int:
        """Cards currently held out of the pool — the quota admission
        loop subtracts this from the fleet release throttle."""
        with self._lock:
            return sum(len(r.chips)
                       for rs in self._by_node.values() for r in rs)

    def _changed(self, node: str) -> None:
        if self._on_change is not None:
            self._on_change(node)
