"""Shard map: epoch-numbered node-to-replica ownership, converged by
compare-and-swap (the port's copy of the JAX package's
``shard/shardmap.py``).

The map is a small piece of shared state every replica agrees on:

    {"epoch": 7, "replicas": ["sched-0", "sched-1", "sched-2"]}

published as an annotation on one coordination object (a Node named
``vtpu-shard-coordination``: Nodes are the kind the bind lock already
compare-and-swaps, ``util/nodelock.py``).  Ownership itself is not
stored: it is a function of (node name, live replica set) by rendezvous
hashing over a blake2b digest, so the map stays O(replicas) bytes at any
fleet size, every replica in every process (and the JAX package's)
computes the same partition, and a membership change moves only the
dead replica's nodes.

Replica liveness is ``health/lease.py``'s: each replica bumps a beat
counter annotation on the coordination object every tick, each replica
folds the counters it observes into its own ``LeaseTracker``, and the
Healthy, Suspect, Dead deadline machine decides membership.  A change
of membership is proposed as a compare-and-swap on the coordination
object's resourceVersion; the loser of a concurrent bump re-reads the
winner's map (the assignment is deterministic: nothing to merge).

Fencing:

- **Filter gate**: a replica evaluates only the nodes it owns under its
  current map (``reject_reason``).
- **Commit fence**: a decision write must pass ``commit_fence``: the
  map read within ``stale_ttl_s``, the node still owned, and not
  mid-adoption.  Otherwise the commit fails closed and the pod requeues.
- **Adoption grace**: a node gained at an epoch bump is placeable only
  ``adoption_grace_s`` after the new map was published, at least the
  stale TTL, so the previous owner has either seen the new map or its
  in-flight commits fail the staleness fence.  Two replicas never place
  on one node at once, across an ownership transfer too.

One bound on that guarantee: the fence is checked before the patch, so a
single apiserver write that stalls in flight from the fence until after
the previous owner's lease died and the adoption grace elapsed would
land unfenced.  With the defaults that window cannot open: the REST
client aborts a request at 30 s (``k8s/rest.py``), below the
ttl_s x (1 + grace_beats) + adoption_grace_s = 57 s of silence an
adoption takes.  Timings tuned down must keep death detection plus the
adoption grace above the apiserver client's timeout.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import threading
import time
from typing import Callable, Dict, Optional, Tuple

from ..health.lease import LeaseConfig, LeaseState, LeaseTracker
from ..k8s.client import Conflict, NotFound

log = logging.getLogger(__name__)

#: The coordination object (a Node) every replica CASes the map on.
COORD_OBJECT = "vtpu-shard-coordination"
SHARD_MAP_ANNOTATION = "vtpu.dev/shard-map"
REPLICA_BEAT_PREFIX = "vtpu.dev/replica-beat."


def _digest(key: str) -> int:
    """Stable 64-bit digest (NOT Python's salted hash(): every replica
    in every process must rank candidates identically)."""
    return int.from_bytes(
        hashlib.blake2b(key.encode(), digest_size=8).digest(), "big")


@dataclasses.dataclass(frozen=True)
class ShardMap:
    """One epoch of the fleet partition.  Immutable; replaced wholesale
    on every membership change."""

    epoch: int
    replicas: Tuple[str, ...]   # sorted live replica names

    def owner_of(self, node: str) -> Optional[str]:
        """Rendezvous hash: the replica with the highest digest of
        (node, replica) owns the node.  Stable: removing one replica
        reassigns only the nodes it owned."""
        if not self.replicas:
            return None
        return max(self.replicas,
                   key=lambda r: (_digest(f"{node}\x00{r}"), r))

    def singleton_owner(self, role: str) -> Optional[str]:
        """Single-owner election for fleet-wide loops (quota admission,
        defrag): same rendezvous rule over a role token, so exactly one
        live replica runs each loop and the ownership survives epochs
        that don't change membership."""
        if not self.replicas:
            return None
        return max(self.replicas,
                   key=lambda r: (_digest(f"role:{role}\x00{r}"), r))

    def encode(self) -> str:
        return json.dumps({"epoch": self.epoch,
                           "replicas": list(self.replicas)},
                          sort_keys=True)

    @classmethod
    def decode(cls, raw: str) -> Optional["ShardMap"]:
        if not raw:
            return None
        try:
            doc = json.loads(raw)
            return cls(epoch=int(doc["epoch"]),
                       replicas=tuple(str(r) for r in doc["replicas"]))
        except (ValueError, KeyError, TypeError):
            log.error("undecodable shard map: %r", raw)
            return None


@dataclasses.dataclass(frozen=True)
class ShardConfig:
    #: This replica's name (the pod name under the chart).  Empty = the
    #: shard layer is INERT: no coordination traffic, no gates, no CAS —
    #: the single-replica hot path, bit-for-bit.
    replica: str = ""
    #: Replica-lease deadline detector (same semantics as node leases):
    #: a replica missing beats for ttl_s turns Suspect (keeps its
    #: shards), for ttl_s*(1+grace_beats) turns Dead (epoch bump, its
    #: shards are adopted).
    ttl_s: float = 15.0
    grace_beats: int = 2
    #: A commit whose map was read more than this long ago fails closed
    #: (the fence half of the adoption-grace handshake).
    stale_ttl_s: float = 10.0
    #: How long after an epoch bump an adopted shard stays unplaceable
    #: while its previous owner's in-flight commits drain into the
    #: staleness fence.  Must be ≥ stale_ttl_s — enforced at build.
    adoption_grace_s: float = 12.0
    #: Coordination-object name (one per scheduler fleet).
    coord_object: str = COORD_OBJECT

    def __post_init__(self) -> None:
        if self.replica and self.adoption_grace_s < self.stale_ttl_s:
            raise ValueError(
                "shard adoption_grace_s must be >= stale_ttl_s "
                f"({self.adoption_grace_s} < {self.stale_ttl_s}): a "
                "shorter grace lets the previous owner's stale-map "
                "commits land on an adopted shard")


class ShardManager:
    """Per-replica view of the shard layer.  ``tick()`` is the whole
    protocol (heartbeat → observe → membership → CAS → adopt); the
    daemon runs it on a thread, tests and the simulator call it
    directly on virtual time, exactly like the rescuer/admission/defrag
    loops."""

    def __init__(self, scheduler, cfg: Optional[ShardConfig] = None,
                 clock: Optional[Callable[[], float]] = None) -> None:
        from .rebalance import Rebalancer

        self.s = scheduler
        self.cfg = cfg or ShardConfig()
        self.enabled = bool(self.cfg.replica)
        self.replica = self.cfg.replica
        self._clock = clock or time.monotonic
        # Replica leases: the SAME deadline detector that watches node
        # agents, fed from the beat counters on the coordination object.
        self.leases = LeaseTracker(
            LeaseConfig(ttl_s=self.cfg.ttl_s,
                        grace_beats=self.cfg.grace_beats),
            clock=clock)
        self.rebalancer = Rebalancer(scheduler, self, clock=clock)
        self._lock = threading.Lock()
        self._map: Optional[ShardMap] = None
        self._map_read_at: Optional[float] = None
        # Per-map ownership memo: owner_of is a rendezvous digest per
        # (node, replica) and the gates consult it per candidate per
        # decision — at control-plane scale that is millions of digests
        # per drain.  Keyed on MAP IDENTITY (maps are immutable and
        # replaced wholesale on epoch bumps), so invalidation is free.
        # A racy swap recomputes at worst; never serves a stale owner.
        self._owner_memo: tuple = (None, {})
        self._beat = 0
        self._seen_beats: Dict[str, str] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: Lifetime count of epoch transitions this replica acted on
        #: (vtpu_shard_rebalances_total).
        self.rebalances_total = 0
        #: CAS-commit failures by reason (vtpu_commit_cas_failures_total).
        self.cas_failures: Dict[str, int] = {}
        #: Lifetime count of tick passes that did O(fleet)-or-worse work
        #: (an epoch change's node walk, an adoption's WAL replay).  The
        #: STEADY-STATE tick is pinned to O(replicas) — beat patch, beat
        #: observe, membership compare — by the regression test; this
        #: counter is how the pin reads the difference.
        self.tick_fleet_walks = 0

    # -- read surface (the hot-path gates) ------------------------------------
    @property
    def active(self) -> bool:
        """True only when sharding is configured AND a map has been
        observed.  NOT the gate-engagement signal — gates engage on
        ``enabled`` (see :meth:`candidate_gate`): a replica with
        sharding configured but no map yet must fail CLOSED, not place
        unfenced on the whole fleet."""
        return self.enabled and self._map is not None

    def candidate_gate(self):
        """The per-candidate gate the decision paths install, or None
        when the layer is inert (the single-replica hot path pays one
        attribute read per decision, not per node).  Returned whenever
        sharding is ENABLED — with no map observed yet every node gets
        the fail-closed ``shard-no-map`` rejection, so a replica that
        lost the coordination object can never place unfenced."""
        return self.reject_reason if self.enabled else None

    @property
    def map(self) -> Optional[ShardMap]:
        return self._map

    def epoch(self) -> int:
        m = self._map
        return m.epoch if m is not None else 0

    def note_cas_failure(self, reason: str) -> None:
        with self._lock:
            self.cas_failures[reason] = self.cas_failures.get(reason, 0) + 1

    def _owner_of(self, m: ShardMap, node: str) -> Optional[str]:
        memo_map, memo = self._owner_memo
        if memo_map is not m:
            memo = {}
            self._owner_memo = (m, memo)
        owner = memo.get(node)
        if owner is None:
            owner = memo[node] = m.owner_of(node)
        return owner

    def owns(self, node: str) -> bool:
        """Placement-agnostic ownership (sweep gating): True when this
        replica is the node's owner under the current map — or when the
        layer is inert (everyone owns everything).  Enabled with no map
        observed = own NOTHING (fail closed: a replica that cannot see
        the map must not rescind grants it may not own)."""
        if not self.enabled:
            return True
        m = self._map
        if m is None:
            return False
        return self._owner_of(m, node) == self.replica

    def placeable(self, node: str) -> bool:
        """Boolean twin of :meth:`reject_reason` for bulk gates (the
        batch engine sweeps the whole fleet per cycle): same decision,
        no reason-string construction for the ~(N-1)/N of the fleet
        this replica does not own."""
        m = self._map
        if m is None:
            return not self.enabled
        if self._owner_of(m, node) != self.replica:
            return False
        return self.rebalancer.adopting_reason(node) is None

    def reject_reason(self, node: str) -> Optional[str]:
        """Filter-gating read, shaped like LeaseTracker.reject_reason:
        non-None when this replica must not place on ``node``.  The
        leading token feeds the low-cardinality rejection counters."""
        m = self._map
        if m is None:
            if self.enabled:
                return ("shard-no-map: sharding enabled but no shard "
                        "map observed yet")
            return None
        owner = self._owner_of(m, node)
        if owner != self.replica:
            return (f"shard-not-owned: {owner} owns {node} "
                    f"(epoch {m.epoch})")
        why = self.rebalancer.adopting_reason(node)
        if why is not None:
            return why
        return None

    def commit_fence(self, node: str) -> Tuple[Optional[str], int]:
        """The write-side fence: ``(error, epoch)``.  An error means the
        commit must fail closed and the pod requeue; epoch is what the
        decision annotation is stamped with on success."""
        if not self.enabled:
            return None, 0
        with self._lock:
            m, read_at = self._map, self._map_read_at
        if m is None or read_at is None:
            return "no-map", 0
        if self._clock() - read_at > self.cfg.stale_ttl_s:
            return "stale-map", m.epoch
        if self._owner_of(m, node) != self.replica:
            return "lost-ownership", m.epoch
        if self.rebalancer.adopting_reason(node) is not None:
            return "adopting", m.epoch
        return None, m.epoch

    def leads(self, role: str) -> bool:
        """Single-owner election for fleet-wide loops; the inert layer
        keeps the single-replica behavior (lead everything).  Enabled
        with no map = lead nothing (fail closed — a blind replica must
        not run fleet-wide reclaim/compaction)."""
        if not self.enabled:
            return True
        m = self._map
        if m is None:
            return False
        return m.singleton_owner(role) == self.replica

    def orphaned_nodes(self) -> list:
        """Registered nodes whose CURRENT owner's replica lease is Dead
        — the window between a replica's death and the epoch bump that
        reassigns its shards (vtpu_shards_orphaned; the alert)."""
        if not self.active:
            return []
        m = self._map
        dead = {r for r in m.replicas
                if self.leases.state_of(r) is LeaseState.DEAD}
        if not dead:
            return []
        return [n for n in self.s.nodes.list_nodes()
                if self._owner_of(m, n) in dead]

    def owned_count(self) -> int:
        names = self.s.nodes.list_nodes()
        if not self.active:
            return len(names)
        return sum(1 for n in names
                   if self._owner_of(self._map, n) == self.replica)

    # -- the protocol ----------------------------------------------------------
    def tick(self) -> list:
        """One coordination pass; returns the actions taken (tests, the
        simulator's HA report).  Safe to call concurrently with Filters:
        the hot paths read ``_map`` by reference and the fence re-checks
        under ``_lock``.  Timed into the ``shard-tick`` perf ring
        (util/perf.py; inert replicas record nothing)."""
        if not self.enabled:
            return []
        from ..util import perf

        with perf.phase_timer("shard-tick"):
            return self._tick()

    def _tick(self) -> list:
        from ..util import perf

        reg = perf.registry()
        actions: list = []
        now = self._clock()
        # Three sub-rings: the beat's read-modify-write round (which
        # queues behind other apiserver traffic), the map's CAS, and the
        # adoption's WAL replay (the only O(fleet) piece).
        t0 = time.monotonic()
        coord = self._publish_beat()
        reg.record("shard-tick-beat", time.monotonic() - t0)
        if coord is None:
            return actions
        anns = coord.get("metadata", {}).get("annotations", {})
        self._observe_beats(anns)
        current = ShardMap.decode(anns.get(SHARD_MAP_ANNOTATION, ""))
        desired = self._desired_membership()
        # GC: Dead replicas leave the coordination object WITH their
        # beat-counter annotations — Deployment pod names are unique
        # per rollout, so without this the object grows one stale key
        # per restart forever (and eventually hits the apiserver's
        # annotation size cap, stalling coordination fleet-wide).
        dropped = [n for n in list(self._seen_beats)
                   if n not in desired
                   and self.leases.state_of(n) is LeaseState.DEAD]
        if current is None or tuple(current.replicas) != desired \
                or dropped:
            cas_t0 = time.monotonic()
            proposed = ShardMap(
                epoch=(current.epoch + 1) if current is not None else 1,
                replicas=desired)
            if current is not None \
                    and tuple(current.replicas) == desired:
                proposed = current     # GC-only patch: no epoch bump
            patch: Dict[str, Optional[str]] = {
                SHARD_MAP_ANNOTATION: proposed.encode()}
            for name in dropped:
                patch[REPLICA_BEAT_PREFIX + name] = None
            rv = coord.get("metadata", {}).get("resourceVersion")
            try:
                self.s.client.patch_node_annotations(
                    self.cfg.coord_object, patch, resource_version=rv)
                for name in dropped:
                    self.leases.forget(name)
                    self._seen_beats.pop(name, None)
                if current is not proposed:
                    current = proposed
                    actions.append({"kind": "epoch-bump",
                                    "epoch": proposed.epoch,
                                    "replicas": list(desired)})
                    log.warning("shard map bumped to epoch %d: "
                                "replicas %s", proposed.epoch,
                                list(desired))
                if dropped:
                    actions.append({"kind": "beats-gced",
                                    "replicas": sorted(dropped)})
            except Conflict:
                # A peer proposed first; its map is deterministic over
                # the same membership — re-read next tick.
                actions.append({"kind": "epoch-bump-lost"})
            except Exception as e:  # noqa: BLE001 — next tick retries
                log.warning("shard-map CAS failed: %s", e)
            reg.record("shard-tick-cas", time.monotonic() - cas_t0)
        with self._lock:
            previous = self._map
            if current is not None:
                if previous is not None and current == previous:
                    # Same epoch, same membership: keep the PREVIOUS
                    # object so identity-keyed consumers (the ownership
                    # memo, the batch engine's per-cycle gates) stay
                    # valid — a steady-state tick must not invalidate
                    # millions of memoized rendezvous digests.
                    current = previous
                self._map = current
                self._map_read_at = now
        if current is not None and (previous is None
                                    or previous.epoch != current.epoch):
            # Epoch transition: the ONE tick shape allowed an O(fleet)
            # walk (computing the gained partition).
            self.tick_fleet_walks += 1
            moved = self.rebalancer.on_map_change(previous, current, now)
            if moved:
                with self._lock:
                    self.rebalances_total += 1
                actions.append({"kind": "rebalance", "epoch": current.epoch,
                                "adopting": sorted(moved)})
        if self.rebalancer.has_pending():
            adopt_t0 = time.monotonic()
            adopted = self.rebalancer.adopt_due(now)
            if adopted:
                self.tick_fleet_walks += 1
                reg.record("shard-tick-adopt",
                           time.monotonic() - adopt_t0)
            actions.extend(adopted)
        return actions

    def _publish_beat(self) -> Optional[dict]:
        """Bump this replica's beat counter on the coordination object
        (creating the object on first contact) and return the object's
        CURRENT state — one read-modify round per tick."""
        self._beat += 1
        patch = {REPLICA_BEAT_PREFIX + self.replica: str(self._beat)}
        client = self.s.client
        for attempt in (0, 1):
            try:
                return client.patch_node_annotations(
                    self.cfg.coord_object, patch)
            except NotFound:
                if attempt:
                    return None
                try:
                    client.create_node({
                        "metadata": {"name": self.cfg.coord_object,
                                     "labels": {
                                         "vtpu.dev/coordination": "true"},
                                     "annotations": {}}})
                except Conflict:
                    pass  # a peer created it first — retry the patch
                except Exception as e:  # noqa: BLE001
                    log.warning("cannot create shard coordination "
                                "object: %s", e)
                    return None
            except Exception as e:  # noqa: BLE001 — next tick retries
                log.warning("shard beat publish failed: %s", e)
                return None
        return None

    def _observe_beats(self, anns: Dict[str, str]) -> None:
        """Counter deltas → replica-lease beats.  A replica we have
        never seen starts a fresh lease on its first observed counter;
        an unchanged counter is NOT a beat (that is the whole point —
        a wedged replica keeps patching nothing and its lease decays)."""
        for key, value in anns.items():
            if not key.startswith(REPLICA_BEAT_PREFIX):
                continue
            name = key[len(REPLICA_BEAT_PREFIX):]
            if not name:
                continue
            if self._seen_beats.get(name) != value:
                self._seen_beats[name] = value
                self.leases.beat(name)

    def _desired_membership(self) -> Tuple[str, ...]:
        """Live replicas = every replica whose lease is not Dead, plus
        self (a replica that can reach the coordination object is alive
        by definition).  Suspect replicas KEEP their shards — the grace
        half-step, exactly like node leases."""
        live = {self.replica}
        for name, state in self.leases.states().items():
            if state is not LeaseState.DEAD:
                live.add(name)
        return tuple(sorted(live))

    # -- daemon thread ---------------------------------------------------------
    def start(self, interval_s: float = 3.0) -> None:
        if self._thread is not None or not self.enabled:
            return

        def loop() -> None:
            while not self._stop.wait(interval_s):
                try:
                    self.tick()
                except Exception:  # noqa: BLE001 — keep coordinating
                    log.exception("shard tick failed")

        self._thread = threading.Thread(target=loop, name="shard-coord",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
