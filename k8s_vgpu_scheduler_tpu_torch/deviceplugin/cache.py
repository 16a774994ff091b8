"""Device cache + health watch + lease heartbeat source.

The port's copy of the JAX package's ``deviceplugin/cache.py``.
Reference: pkg/device-plugin/cache.go (DeviceCache.Start/notify, 325–353)
and the NVML XID health loop (nvidia.go:173–244).  Health is polled from
the backend — on a node, NVML (``tpulib.NvmlBackend.refresh_health``: a
card's handle and memory queries, and its critical Xid events drained at
each poll) — and fanned out to named subscribers (the kubelet
ListAndWatch feed and the scheduler registration stream).

Two fan-out triggers, same subscriber set:

- **Health flip** → immediate full re-registration.  The register
  subscriber pushes the COMPLETE inventory down the live stream
  (register.push_update), so the scheduler's ``NodeManager`` actually
  learns about the dead chip (full-inventory replace, nodes.py) and its
  quarantine gets the per-chip health feed — a flip that is only logged
  node-side is a flip the control plane never contains.
- **Heartbeat** (``heartbeat_seconds``, default one per poll) → periodic
  re-advertisement even when NOTHING changed — delivered ONLY to
  subscribers that opted in (``subscribe(..., heartbeat=True)``, i.e. the
  register stream).  The scheduler counts every register-stream message as
  a lease beat (health/lease.py); a cache that stays silent while healthy
  looks exactly like a partitioned node to the failure detector.  The
  kubelet/annotation subscribers stay flip-only: re-sending an unchanged
  device list to every kubelet watch queue and re-PATCHing the node
  annotation once per beat would be pure apiserver churn.  Scheduler-side,
  an unchanged inventory is detected (``NodeManager.same_inventory``) and
  does NOT invalidate the usage snapshot, so the keepalive cadence is
  free.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, Optional

from ..tpulib.backend import Backend
from ..tpulib.types import NodeInventory

log = logging.getLogger(__name__)


class DeviceCache:
    def __init__(self, backend: Backend, poll_seconds: float = 5.0,
                 heartbeat_seconds: float = 5.0) -> None:
        self.backend = backend
        self.poll_seconds = poll_seconds
        #: Max quiet time before an unchanged inventory is re-broadcast
        #: anyway (the lease beat).  0 disables heartbeats (flip-only
        #: fan-out, the pre-lease behavior).
        self.heartbeat_seconds = heartbeat_seconds
        self.inventory: NodeInventory = backend.inventory()
        self._subs: Dict[str, Callable[[NodeInventory], None]] = {}
        self._beat_subs: set = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_broadcast = time.monotonic()

    def subscribe(self, name: str, fn: Callable[[NodeInventory], None],
                  heartbeat: bool = False) -> None:
        """``heartbeat=True`` opts the subscriber into the periodic
        keepalive re-broadcast (the register stream wants it; the kubelet
        and annotation feeds only want real changes)."""
        self._subs[name] = fn
        if heartbeat:
            self._beat_subs.add(name)

    def poll_once(self, now: Optional[float] = None) -> bool:
        """One health poll + fan-out decision (the loop body, factored out
        so tests drive it deterministically).  Returns True when any
        subscriber was notified."""
        now = time.monotonic() if now is None else now
        try:
            changed = self.backend.refresh_health(self.inventory)
        except Exception:  # noqa: BLE001 — keep polling through glitches
            # Only the health READ failed — the agent itself is alive.
            # The keepalive below must still go out with the last-known
            # inventory: suppressing it would let the scheduler's failure
            # detector declare this node Dead (and rescind every grant on
            # it) over a transient probe glitch.
            log.exception("health refresh failed (keepalive continues)")
            changed = False
        beat_due = (self.heartbeat_seconds > 0
                    and now - self._last_broadcast >= self.heartbeat_seconds)
        if not changed and not beat_due:
            return False
        if changed:
            unhealthy = [c.uuid for c in self.inventory.chips if not c.healthy]
            log.warning("chip health changed; re-registering full inventory "
                        "(unhealthy=%s)", unhealthy)
        self._last_broadcast = now
        targets = (self._subs if changed else
                   {n: f for n, f in self._subs.items()
                    if n in self._beat_subs})
        for name, fn in targets.items():
            try:
                fn(self.inventory)
            except Exception:
                log.exception("health notify to %s failed", name)
        return bool(targets)

    def _poll_loop(self) -> None:
        while not self._stop.wait(self.poll_seconds):
            self.poll_once()

    def start(self) -> None:
        self._thread = threading.Thread(target=self._poll_loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
