"""Seeded, deterministic fault injection for the fleet health subsystem
(the port's copy of the JAX package's ``health/faults.py``).

The harness plays the fleet's node agents: it owns a ground-truth copy of
every node's inventory (taken from the scheduler's registry) and feeds the
scheduler what real agents would, register messages with each card's
health, through ``Scheduler.observe_registration``, the entry the gRPC
stream handler uses.  Faults are distortions of that feed:

- ``partition-node``  the agent stops beating (Healthy → Suspect → Dead);
- ``heal-node``       beats resume and the inventory re-registers;
- ``drop-heartbeats`` skip the next N beats;
- ``kill-chip`` / ``revive-chip`` flip a card's ground-truth health;
- ``flap-chip``       oscillate a card's health, which the flap-damping
  quarantine exists for.

Everything runs on an injectable clock (:class:`SimClock`), so a failure
scenario of minutes runs in microseconds and replays exactly: the same
seed and plan give the same events and the same scheduler state.  The
port's tests replay the same seeded scripts through both schedulers.
"""

from __future__ import annotations

import dataclasses
import logging
import random
from typing import Callable, Dict, List, Optional, Set, Tuple

log = logging.getLogger(__name__)


class SimClock:
    """Deterministic monotonic clock: a callable (drop-in for
    ``time.monotonic``) advanced explicitly by the test/simulator."""

    def __init__(self, start: float = 1000.0) -> None:
        self._now = start

    def __call__(self) -> float:
        return self._now

    def advance(self, dt: float) -> float:
        self._now += dt
        return self._now


@dataclasses.dataclass
class FaultEvent:
    at_s: float            # offset from the chaos phase's start
    kind: str              # one of KINDS
    node: str = ""
    chip: str = ""
    count: int = 0         # drop-heartbeats: beats to skip; flap-chip: flips


KINDS = ("partition-node", "heal-node", "drop-heartbeats",
         "kill-chip", "revive-chip", "flap-chip")


class FaultInjector:
    def __init__(self, scheduler, clock: SimClock, seed: int = 0,
                 beat_interval_s: float = 5.0) -> None:
        self.s = scheduler
        self.clock = clock
        self.rng = random.Random(seed)
        self.seed = seed
        self.beat_interval_s = beat_interval_s
        # Ground truth, owned by the harness: node -> chip id -> the
        # DeviceInfo advertised when healthy.  Health state is tracked
        # separately so kill/flap distort the feed without losing the
        # original advertisement.
        self._truth: Dict[str, List] = {}
        self._health: Dict[Tuple[str, str], bool] = {}
        self._topology: Dict[str, object] = {}
        self._partitioned: Set[str] = set()
        self._drop: Dict[str, int] = {}
        self._last_beat: Dict[str, float] = {}
        self.log: List[dict] = []

    # -- attach ----------------------------------------------------------------
    def attach(self, nodes: Optional[List[str]] = None) -> None:
        """Snapshot ground truth from the scheduler's current registry and
        send every node one initial beat (a freshly-connected agent)."""
        registry = self.s.nodes.list_nodes()
        for name in (nodes if nodes is not None else sorted(registry)):
            info = registry.get(name)
            if info is None:
                continue
            self._truth[name] = list(info.devices)
            self._topology[name] = info.topology
            for d in info.devices:
                self._health[(name, d.id)] = d.health
        self.heartbeat_all()

    # -- the agent feed --------------------------------------------------------
    def heartbeat(self, node: str) -> bool:
        """One register-stream message from ``node``'s agent, carrying the
        harness's current ground-truth health.  Honors partitions and
        pending heartbeat drops; returns True when a beat was delivered."""
        if node not in self._truth or node in self._partitioned:
            return False
        pending = self._drop.get(node, 0)
        if pending > 0:
            self._drop[node] = pending - 1
            return False
        from ..scheduler.nodes import DeviceInfo, NodeInfo

        devices = [
            DeviceInfo(id=d.id, count=d.count, devmem=d.devmem, type=d.type,
                       health=self._health.get((node, d.id), d.health),
                       coords=d.coords, cores=d.cores)
            for d in self._truth[node]
        ]
        self.s.observe_registration(
            node, NodeInfo(name=node, devices=devices,
                           topology=self._topology.get(node)))
        self._last_beat[node] = self.clock()
        return True

    def heartbeat_all(self) -> int:
        return sum(1 for n in list(self._truth) if self.heartbeat(n))

    def tick(self, dt: float, beats: bool = True) -> None:
        """Advance virtual time by ``dt``, delivering agent beats on the
        regular cadence along the way (so a long advance doesn't silently
        starve healthy nodes into Suspect)."""
        remaining = dt
        while remaining > 0:
            step = min(remaining, self.beat_interval_s)
            self.clock.advance(step)
            remaining -= step
            if beats:
                now = self.clock()
                for node in list(self._truth):
                    if now - self._last_beat.get(node, 0.0) \
                            >= self.beat_interval_s:
                        self.heartbeat(node)

    # -- fault primitives ------------------------------------------------------
    def partition_node(self, node: str) -> None:
        self._partitioned.add(node)
        self._note("partition-node", node=node)

    def heal_node(self, node: str) -> None:
        self._partitioned.discard(node)
        self._drop.pop(node, None)
        self.heartbeat(node)
        self._note("heal-node", node=node)

    def drop_heartbeats(self, node: str, count: int) -> None:
        self._drop[node] = self._drop.get(node, 0) + count
        self._note("drop-heartbeats", node=node, count=count)

    def kill_chip(self, node: str, chip: str) -> None:
        self._health[(node, chip)] = False
        self.heartbeat(node)  # the health flip re-registers immediately
        self._note("kill-chip", node=node, chip=chip)

    def revive_chip(self, node: str, chip: str) -> None:
        self._health[(node, chip)] = True
        self.heartbeat(node)
        self._note("revive-chip", node=node, chip=chip)

    def flap_chip(self, node: str, chip: str, flips: int,
                  gap_s: float = 1.0) -> None:
        """Oscillate a chip's health ``flips`` times, one re-registration
        per flip — the pattern the flap-damping quarantine exists for."""
        for _ in range(max(0, flips)):
            cur = self._health.get((node, chip), True)
            self._health[(node, chip)] = not cur
            self.heartbeat(node)
            self.clock.advance(gap_s)
        self._note("flap-chip", node=node, chip=chip, count=flips)

    # -- plans -----------------------------------------------------------------
    def random_plan(self, n_events: int,
                    horizon_s: float = 60.0) -> List[FaultEvent]:
        """A seeded, reproducible event schedule over the attached fleet.
        Pure function of the injector's RNG state — same seed, same plan."""
        nodes = sorted(self._truth)
        if not nodes or n_events <= 0:
            return []
        plan: List[FaultEvent] = []
        for _ in range(n_events):
            kind = self.rng.choice(KINDS)
            node = self.rng.choice(nodes)
            chips = [d.id for d in self._truth[node]]
            ev = FaultEvent(
                at_s=round(self.rng.uniform(0.0, horizon_s), 3),
                kind=kind, node=node,
                chip=self.rng.choice(chips) if chips and "chip" in kind
                else "",
                count=self.rng.randint(1, 5)
                if kind in ("drop-heartbeats", "flap-chip") else 0,
            )
            plan.append(ev)
        plan.sort(key=lambda e: e.at_s)
        return plan

    def apply(self, ev: FaultEvent) -> None:
        if ev.kind == "partition-node":
            self.partition_node(ev.node)
        elif ev.kind == "heal-node":
            self.heal_node(ev.node)
        elif ev.kind == "drop-heartbeats":
            self.drop_heartbeats(ev.node, ev.count or 1)
        elif ev.kind == "kill-chip":
            self.kill_chip(ev.node, ev.chip)
        elif ev.kind == "revive-chip":
            self.revive_chip(ev.node, ev.chip)
        elif ev.kind == "flap-chip":
            self.flap_chip(ev.node, ev.chip, ev.count or 1)
        else:
            raise ValueError(f"unknown fault kind: {ev.kind!r}")

    def run_plan(self, plan: List[FaultEvent],
                 sweep: Optional[Callable[[], list]] = None,
                 settle_s: float = 0.0) -> List[dict]:
        """Play a schedule against virtual time: advance (with regular
        agent beats) to each event's offset, apply it, and run ``sweep``
        (normally ``scheduler.rescuer.sweep``) so detection interleaves
        with injection the way the production loop would.  ``settle_s``
        extends the run past the last event (e.g. beyond the lease death
        deadline).  Returns every sweep action observed."""
        start = self.clock()
        actions: List[dict] = []
        for ev in sorted(plan, key=lambda e: e.at_s):
            gap = start + ev.at_s - self.clock()
            if gap > 0:
                self.tick(gap)
            self.apply(ev)
            if sweep is not None:
                actions.extend(sweep())
        horizon = (max((e.at_s for e in plan), default=0.0)
                   + max(0.0, settle_s))
        while self.clock() < start + horizon:
            self.tick(min(self.beat_interval_s,
                          start + horizon - self.clock()))
            if sweep is not None:
                actions.extend(sweep())
        return actions

    def _note(self, kind: str, **kw) -> None:
        entry = {"at": round(self.clock(), 3), "kind": kind, **kw}
        self.log.append(entry)
        log.info("fault injected: %s", entry)
