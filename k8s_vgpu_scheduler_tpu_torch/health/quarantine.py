"""Per-card quarantine with flap damping (the port's copy of the JAX
package's ``health/quarantine.py``).

A card whose health oscillates is worse than a dead one: every flip of the
plain ``health`` bit re-registers it in and out of the schedulable set, so
pods land on it in the healthy half-cycles and die in the others.  The
quarantine adds hysteresis on top of the bit:

    ACTIVE  ── flap_threshold flips inside flap_window_s ──▶ QUARANTINED
    QUARANTINED ── continuously healthy for probation_s ──▶ ACTIVE

A quarantined card is stripped from the usage every Filter fits against
(``Scheduler._refresh_entry_locked``), so no fit can see it, and grants that hold it
become rescuable (``health/rescuer.py``).  Release needs a sustained
healthy probation: an unhealthy reading during it restarts the clock.

The health readings arrive on the register stream (the device plugin's
health poll re-registers on every flip, ``deviceplugin/cache.py``).
Agents may also report per-card error counter deltas; ``error_threshold``
errors inside the flap window quarantine a card whose bit never flipped.

Every quarantine and release calls ``on_change(node)``, outside the lock:
the scheduler passes ``NodeManager.touch``, so the node's inventory rev
moves, its cached usage rebuilds and an optimistic commit validated
before the change fails, as in the JAX scheduler.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import threading
import time
from typing import Callable, Deque, Dict, List, Optional, Set, Tuple

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class QuarantineConfig:
    #: Health flips inside flap_window_s that quarantine a card.
    flap_threshold: int = 3
    flap_window_s: float = 60.0
    #: How long a quarantined card must stay healthy to return.
    probation_s: float = 30.0
    #: Error-counter sum inside flap_window_s that also quarantines
    #: (0 = off; agents that report no counters are unaffected).
    error_threshold: int = 0


@dataclasses.dataclass
class _ChipRecord:
    node: str
    chip: str
    last_health: Optional[bool] = None
    flips: Deque[float] = dataclasses.field(default_factory=collections.deque)
    errors: Deque[Tuple[float, int]] = dataclasses.field(
        default_factory=collections.deque)
    quarantined_at: Optional[float] = None
    #: The last moment the card was not trustworthy (read unhealthy,
    #: flipped, errored or quarantined): probation counts from here.
    last_bad: float = 0.0
    reason: str = ""


class ChipQuarantine:
    """Thread-safe per-card state machine.  ``quarantined_on`` is a pure
    read; state changes only in ``observe*``, ``quarantine``, ``release``
    and ``sweep``."""

    def __init__(self, cfg: Optional[QuarantineConfig] = None,
                 clock: Optional[Callable[[], float]] = None,
                 on_change: Optional[Callable[[str], None]] = None) -> None:
        self.cfg = cfg or QuarantineConfig()
        self._clock = clock or time.monotonic
        self._on_change = on_change
        self._lock = threading.Lock()
        self._chips: Dict[Tuple[str, str], _ChipRecord] = {}
        # node -> the ids quarantined there, kept by the transitions, so
        # quarantined_on costs what that node holds.
        self._active: Dict[str, Set[str]] = {}
        # node -> the ids whose record says healthy: a keepalive whose
        # every card is healthy and already so recorded changes nothing,
        # and observe_node skips it.
        self._healthy: Dict[str, Set[str]] = {}
        #: Quarantines entered since the start.
        self.quarantines_total = 0

    # -- observations ----------------------------------------------------------
    def observe(self, node: str, chip: str, healthy: bool,
                now: Optional[float] = None) -> bool:
        """One health reading of one card; True when its quarantine state
        changed."""
        now = self._clock() if now is None else now
        changed_node = None
        with self._lock:
            rec = self._record(node, chip)
            flipped = (rec.last_health is not None
                       and healthy != rec.last_health)
            rec.last_health = healthy
            if healthy:
                self._healthy.setdefault(node, set()).add(chip)
            else:
                self._healthy.get(node, set()).discard(chip)
                rec.last_bad = now
            if flipped:
                rec.flips.append(now)
                rec.last_bad = now
                self._prune(rec.flips, now)
                if (rec.quarantined_at is None
                        and len(rec.flips) >= self.cfg.flap_threshold):
                    self._quarantine_locked(
                        rec, now,
                        f"{len(rec.flips)} health flips in "
                        f"{self.cfg.flap_window_s:.0f}s")
                    changed_node = node
        if changed_node is not None:
            self._notify(changed_node)
        return changed_node is not None

    def observe_node(self, node: str, health: Dict[str, bool],
                     now: Optional[float] = None) -> bool:
        """One register message's readings, ``{card id: healthy}``."""
        with self._lock:
            if self._healthy.get(node) == health.keys() \
                    and all(health.values()):
                return False  # a keepalive: nothing would change
        changed = False
        for chip, healthy in health.items():
            changed |= self.observe(node, chip, healthy, now=now)
        with self._lock:
            healthy_set = self._healthy.get(node)
            if healthy_set is not None:
                # Ids that left the inventory would fail the keepalive
                # comparison for ever.
                healthy_set.intersection_update(health.keys())
        return changed

    def observe_errors(self, node: str, chip: str, delta: int,
                       now: Optional[float] = None) -> bool:
        """An error-counter delta from a heartbeat; quarantines on
        sustained errors even where the health bit never flips."""
        if delta <= 0 or self.cfg.error_threshold <= 0:
            return False
        now = self._clock() if now is None else now
        changed_node = None
        with self._lock:
            rec = self._record(node, chip)
            rec.errors.append((now, delta))
            rec.last_bad = now
            while rec.errors and \
                    rec.errors[0][0] < now - self.cfg.flap_window_s:
                rec.errors.popleft()
            total = sum(d for _, d in rec.errors)
            if rec.quarantined_at is None \
                    and total >= self.cfg.error_threshold:
                self._quarantine_locked(
                    rec, now,
                    f"{total} chip errors in {self.cfg.flap_window_s:.0f}s")
                changed_node = node
        if changed_node is not None:
            self._notify(changed_node)
        return changed_node is not None

    # -- direct transitions ----------------------------------------------------
    def quarantine(self, node: str, chip: str, reason: str,
                   now: Optional[float] = None) -> bool:
        """Quarantine at once (containment of a grant's other cards, fault
        injection, an operator)."""
        now = self._clock() if now is None else now
        with self._lock:
            rec = self._record(node, chip)
            if rec.quarantined_at is not None:
                return False
            self._quarantine_locked(rec, now, reason)
        self._notify(node)
        return True

    def release(self, node: str, chip: str) -> bool:
        """Release at once (an operator; the normal way out is the
        probation in :meth:`sweep`)."""
        with self._lock:
            rec = self._chips.get((node, chip))
            if rec is None or rec.quarantined_at is None:
                return False
            self._release_locked(rec)
        self._notify(node)
        return True

    def sweep(self, now: Optional[float] = None) -> List[Tuple[str, str]]:
        """Release the cards whose healthy probation has passed; returns
        the ``(node, card)`` pairs released."""
        now = self._clock() if now is None else now
        released: List[Tuple[str, str]] = []
        with self._lock:
            for rec in self._chips.values():
                if rec.quarantined_at is None or rec.last_health is False:
                    continue
                if now - rec.last_bad >= self.cfg.probation_s:
                    self._release_locked(rec)
                    released.append((rec.node, rec.chip))
        for node, _chip in released:
            self._notify(node)
        return released

    # -- reads -----------------------------------------------------------------
    def is_quarantined(self, node: str, chip: str) -> bool:
        with self._lock:
            rec = self._chips.get((node, chip))
            return rec is not None and rec.quarantined_at is not None

    def quarantined_on(self, node: str) -> Set[str]:
        """The card ids quarantined on ``node`` (a copy)."""
        with self._lock:
            return set(self._active.get(node, ()))

    def active(self) -> Dict[str, Set[str]]:
        with self._lock:
            return {node: set(chips) for node, chips in self._active.items()}

    def count(self) -> int:
        with self._lock:
            return sum(len(chips) for chips in self._active.values())

    # -- internals -------------------------------------------------------------
    def _record(self, node: str, chip: str) -> _ChipRecord:
        rec = self._chips.get((node, chip))
        if rec is None:
            self._chips[(node, chip)] = rec = _ChipRecord(node=node, chip=chip)
        return rec

    def _prune(self, dq: Deque[float], now: float) -> None:
        while dq and dq[0] < now - self.cfg.flap_window_s:
            dq.popleft()

    def _quarantine_locked(self, rec: _ChipRecord, now: float,
                           reason: str) -> None:
        rec.quarantined_at = now
        rec.last_bad = now
        rec.reason = reason
        self._active.setdefault(rec.node, set()).add(rec.chip)
        self.quarantines_total += 1
        log.warning("quarantined card %s on %s: %s", rec.chip, rec.node,
                    reason)

    def _release_locked(self, rec: _ChipRecord) -> None:
        log.info("released card %s on %s from quarantine (was: %s)",
                 rec.chip, rec.node, rec.reason)
        rec.quarantined_at = None
        rec.reason = ""
        rec.flips.clear()
        rec.errors.clear()
        chips = self._active.get(rec.node)
        if chips is not None:
            chips.discard(rec.chip)
            if not chips:
                del self._active[rec.node]

    def _notify(self, node: str) -> None:
        if self._on_change is not None:
            try:
                self._on_change(node)
            except Exception:  # noqa: BLE001 — a callback never wedges health
                log.exception("quarantine change callback failed for %s",
                              node)
