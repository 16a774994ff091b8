"""Node heartbeat leases: a deadline-based failure detector (the port's
copy of the JAX package's ``health/lease.py``).

Node agents piggyback heartbeats on the channel they already hold open:
every message on the register stream (the first advertisement, a health
flip, a periodic keepalive of ``deviceplugin/cache.py``) is one beat.  A
partitioned agent stops sending and its lease decays.

State machine, computed from the last beat's age when asked (so gating a
Filter needs no thread):

    Healthy  ── ttl_s without a beat ──▶  Suspect
    Suspect  ── grace_beats more ttl_s ──▶  Dead
    any      ── beat arrives ──▶  Healthy

A Suspect or Dead node takes no new placements; its existing grants stand
until it is Dead, when the rescuer (``health/rescuer.py``) takes them.
Nodes that never beat are untracked (``state_of`` answers None) and
placeable: embedders and tests register inventory without node agents.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..util import perf


class LeaseState(enum.IntEnum):
    HEALTHY = 0
    SUSPECT = 1
    DEAD = 2


@dataclasses.dataclass(frozen=True)
class LeaseConfig:
    #: Seconds without a heartbeat before a node turns Suspect: well above
    #: the agents' beat interval (the device plugin's 5 s heartbeat).
    ttl_s: float = 15.0
    #: How many more ttl_s periods a Suspect node gets before it is Dead.
    grace_beats: int = 2

    @property
    def dead_after_s(self) -> float:
        return self.ttl_s * (1 + max(0, self.grace_beats))


@dataclasses.dataclass
class NodeLease:
    node: str
    last_beat: float
    beats: int = 1
    #: Cumulative per-card error counters (agents may report deltas with
    #: each beat; the quarantine reads them as flap equivalents).
    errors: Dict[str, int] = dataclasses.field(default_factory=dict)


class LeaseTracker:
    """Thread-safe lease registry.  ``state_of`` is computed from the
    clock; ``sweep`` also reports each transition exactly once (for the
    rescuer's handling of a node's death)."""

    def __init__(self, cfg: Optional[LeaseConfig] = None,
                 clock: Optional[Callable[[], float]] = None) -> None:
        self.cfg = cfg or LeaseConfig()
        self._clock = clock or time.monotonic
        # Wait/hold telemetry under lock="leases" on /perfz; every
        # register message and every candidate's gate take it, so hold
        # samples are 1-in-64.
        self._lock = perf.TimedLock("leases", sample_shift=6)
        self._leases: Dict[str, NodeLease] = {}
        # The state sweep() last reported for each node: the edge
        # detector.  Between sweeps a node may already be Dead (state_of
        # says so and Filter gates on it) before the edge is acted on.
        self._reported: Dict[str, LeaseState] = {}

    # -- writes ----------------------------------------------------------------
    def beat(self, node: str, error_deltas: Optional[Dict[str, int]] = None,
             now: Optional[float] = None) -> None:
        """One heartbeat (one register-stream message) from ``node``."""
        now = self._clock() if now is None else now
        with self._lock:
            lease = self._leases.get(node)
            if lease is None:
                self._leases[node] = lease = NodeLease(node=node,
                                                       last_beat=now)
            else:
                lease.last_beat = now
                lease.beats += 1
            for card, delta in (error_deltas or {}).items():
                lease.errors[card] = lease.errors.get(card, 0) + delta

    def forget(self, node: str) -> None:
        """Stop tracking a node (decommissioned; never on a stream break,
        which is what the lease must outlive)."""
        with self._lock:
            self._leases.pop(node, None)
            self._reported.pop(node, None)

    # -- reads -----------------------------------------------------------------
    def _state(self, lease: NodeLease, now: float) -> LeaseState:
        age = now - lease.last_beat
        if age <= self.cfg.ttl_s:
            return LeaseState.HEALTHY
        if age <= self.cfg.dead_after_s:
            return LeaseState.SUSPECT
        return LeaseState.DEAD

    def state_of(self, node: str) -> Optional[LeaseState]:
        """Live state, or None for an untracked node (placeable)."""
        now = self._clock()
        with self._lock:
            lease = self._leases.get(node)
            return None if lease is None else self._state(lease, now)

    def age_of(self, node: str) -> Optional[float]:
        now = self._clock()
        with self._lock:
            lease = self._leases.get(node)
            return None if lease is None else now - lease.last_beat

    def errors_of(self, node: str) -> Dict[str, int]:
        with self._lock:
            lease = self._leases.get(node)
            return dict(lease.errors) if lease else {}

    def reject_reason(self, node: str) -> Optional[str]:
        """Filter's read: non-None when the node must take no new
        placement.  The leading token is the rejection counter's key."""
        now = self._clock()
        with self._lock:
            lease = self._leases.get(node)
            if lease is None:
                return None
            st = self._state(lease, now)
        if st is LeaseState.HEALTHY:
            return None
        return (f"lease-{st.name.lower()}: no heartbeat for "
                f"{now - lease.last_beat:.1f}s (ttl {self.cfg.ttl_s:.0f}s)")

    def alive_map(self, names) -> List[bool]:
        """``reject_reason(n) is None`` for every name, under one lock."""
        now = self._clock()
        with self._lock:
            return [(lease := self._leases.get(n)) is None
                    or self._state(lease, now) is LeaseState.HEALTHY
                    for n in names]

    def states(self) -> Dict[str, LeaseState]:
        """Every tracked node's live state."""
        now = self._clock()
        with self._lock:
            return {n: self._state(lease, now)
                    for n, lease in self._leases.items()}

    def sweep(self, now: Optional[float] = None
              ) -> List[Tuple[str, LeaseState, LeaseState]]:
        """The transitions since the previous sweep, each reported once:
        ``(node, previous, current)``."""
        now = self._clock() if now is None else now
        out: List[Tuple[str, LeaseState, LeaseState]] = []
        with self._lock:
            for node, lease in self._leases.items():
                st = self._state(lease, now)
                prev = self._reported.get(node, LeaseState.HEALTHY)
                if st != prev:
                    self._reported[node] = st
                    out.append((node, prev, st))
        return out
