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

A Suspect or Dead node takes no new placements; its existing grants stand.
Nodes that never beat are untracked (``state_of`` answers None) and
placeable: embedders and tests register inventory without node agents.
"""

from __future__ import annotations

import dataclasses
import enum
import threading
import time
from typing import Callable, Dict, Optional


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


class LeaseTracker:
    """Thread-safe lease registry; every read is computed from the clock."""

    def __init__(self, cfg: Optional[LeaseConfig] = None,
                 clock: Optional[Callable[[], float]] = None) -> None:
        self.cfg = cfg or LeaseConfig()
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._last_beat: Dict[str, float] = {}

    def beat(self, node: str, now: Optional[float] = None) -> None:
        """One heartbeat (one register-stream message) from ``node``."""
        now = self._clock() if now is None else now
        with self._lock:
            self._last_beat[node] = now

    def _state(self, age: float) -> LeaseState:
        if age <= self.cfg.ttl_s:
            return LeaseState.HEALTHY
        if age <= self.cfg.dead_after_s:
            return LeaseState.SUSPECT
        return LeaseState.DEAD

    def state_of(self, node: str) -> Optional[LeaseState]:
        """Live state, or None for an untracked node (placeable)."""
        now = self._clock()
        with self._lock:
            last = self._last_beat.get(node)
        return None if last is None else self._state(now - last)

    def reject_reason(self, node: str) -> Optional[str]:
        """Filter's read: non-None when the node must take no new
        placement.  The leading token is the rejection counter's key."""
        now = self._clock()
        with self._lock:
            last = self._last_beat.get(node)
        if last is None:
            return None
        st = self._state(now - last)
        if st is LeaseState.HEALTHY:
            return None
        return (f"lease-{st.name.lower()}: no heartbeat for "
                f"{now - last:.1f}s (ttl {self.cfg.ttl_s:.0f}s)")
