"""Background fleet defragmentation via checkpointed migration (the port's
copy of the JAX package's ``placement/defrag.py``).

Long-running fleets fragment: fractional singles land mid-mesh, gangs
come and go, and eventually a large slice request fits NOWHERE even
though the fleet has the cards.  The health subsystem already proves the
cure is safe — checkpoint-first eviction resumes a victim bit for bit
elsewhere (``models/train.py``'s ``run_preemptible``) — so migration is
just eviction with a purpose: move the FEWEST, CHEAPEST checkpointable
pods so the freed cells assemble into the contiguous box a blocked
demand needs.

The loop (a plain ``tick()`` the simulator and tests drive on a virtual
clock; ``start()`` wraps it in the daemon thread, the health/rescuer
shape):

1. **Demand**: Filter records every slice/mesh rejection here
   (``observe_rejection``).  A demand stays live while the pod keeps
   retrying (kube-scheduler re-queues unschedulable pods) and ages out
   when it stops.
2. **Detect**: a demand is *blocked* when no node's largest contiguous
   free box can hold it — plain fragmentation math over the scheduler's
   snapshot (placement/frag.py).
3. **Plan** (:func:`plan_compaction`, pure — the property-test surface):
   per node, find the cheapest box of free+movable cells whose eviction
   strictly grows the node's largest free box to at least the demand.
   Movable = every resident is checkpointable (opted into preemptible
   priority), not a gang member, not already being evicted by the
   rescuer, quota reclaim or priority preemption.  Cost = victim count,
   then victim GPU-seconds from the accounting ledger (sunk work — the
   cheapest migration loses the least progress), then stable name/coord
   tie-breaks (plans must replay identically under the simulator).
4. **Execute**: reserve the target box (placement/reserve.py — cards
   leave the usage so nobody squats in the hole), then request
   checkpoints through the scheduler's own preemption machinery
   (``_request_preemptions`` with a ``rescue:defrag:``-prefixed
   requester key): victims get the standard ``vtpu.dev/preempt-
   requested`` downward-API flag, the in-container watch checkpoints at
   a step boundary and exits, the delete frees the grant, and — because
   the requester key lives in the scheduler's preemption ledger — quota
   reclaim and the rescuer see these victims as in-flight and never
   stack a second eviction on them (the no-deadlock contract).
5. **Deliver**: the beneficiary's next Filter releases the reservation
   (core.py) and the slice-aware fit lands it on the assembled box.
   Victims re-place through the ordinary scheduling path and resume
   from their checkpoints.  Overdue victims (grace exceeded) abort the
   plan: requests rescinded, reservation dropped — a wedged victim must
   not strand reserved capacity.

Elastic gangs (``elastic/``) are the one exception to gang protection:
the members the resize controller can step down a rung are movable, and
a plan that needs them asks the controller for a shrink instead of an
eviction.  With ``--enable-elastic`` off the shrink set is empty and the
plans are those of a build without the controller.

The pods are grouped by node through the scheduler's pod registry
(``pods.by_node``), where the JAX module calls the scheduler's
``_pods_by_node`` wrapper of it.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from ..topology.torus import box_coords, box_coords_origins, factor_shapes
from ..tpulib.types import Coord, TopologyDesc
from ..util import perf
from .frag import fleet_views, node_free_view
from .mesh import (
    max_free_box_volume,
    mesh_box_shapes,
    shaped_box_availability,
)

log = logging.getLogger(__name__)

#: Requester-key prefix for defrag-issued eviction requests.  Shares the
#: rescuer's ``rescue:`` namespace so preemption-ledger reconciliation
#: (core._reconcile_preemptions) leaves the annotations to their owner.
DEFRAG_REQUESTER_PREFIX = "rescue:defrag:"


@dataclasses.dataclass(frozen=True)
class DefragConfig:
    #: Master gate (--enable-defrag).  Off = the loop never plans; the
    #: demand registry and availability metrics still work.
    enabled: bool = False
    #: Background tick period (cmd/scheduler --defrag-interval).
    interval_s: float = 10.0
    #: A demand with no fresh rejection for this long is forgotten (its
    #: pod stopped retrying: deleted, placed, or gave up).
    demand_fresh_s: float = 120.0
    #: How long an asked victim gets to checkpoint and exit before the
    #: plan aborts (mirrors rescue_checkpoint_grace_s).
    checkpoint_grace_s: float = 120.0
    #: How long an assembled reservation waits for its beneficiary.
    reservation_ttl_s: float = 300.0
    #: Only pods at this priority or lower (numerically >=; 0 is
    #: highest) are movable — priority >= 1 is the preemptible tier the
    #: webhook wires the checkpoint watch into (docs/preemption.md).
    min_victim_priority: int = 1
    #: A plan asking more victims than this is too disruptive to be
    #: "minimal compaction" — skip the node.
    max_victims_per_plan: int = 8


@dataclasses.dataclass
class Demand:
    """One blocked slice/mesh request, keyed by pod uid (singles) or
    gang key (gangs — any member's rejection refreshes it)."""

    key: str
    namespace: str
    name: str
    #: Per-pod contiguous need (the ICI-local box volume).
    chips: int
    first_seen: float
    last_seen: float
    rejections: int = 1
    #: Disjoint boxes of ``chips`` the demand needs — 1 for singles,
    #: the member count for gangs (atomic admission needs them ALL,
    #: assembled one compaction at a time).
    count: int = 1
    #: The pod's ICI-local mesh shape when it declared ``vtpu.dev/mesh``
    #: — detection and planning then require boxes REALIZING the mesh's
    #: axes, not just its volume (a 4x1 strip is a 4-box but no 2x2).
    mesh: Optional[Tuple[int, ...]] = None


@dataclasses.dataclass
class DefragPlan:
    node: str
    #: Target box: coord -> chip id (free cells + cells victims vacate).
    box: Dict[Coord, str]
    #: Victims to migrate, with identity for the annotation patch.
    victims: List["VictimRef"]
    demand_key: str
    demand_chips: int
    #: Node's largest free box before / predicted after the migration.
    max_box_before: int
    max_box_after: int
    #: Total victim chip-seconds (ledger) — the plan's disruption cost.
    cost_chip_seconds: float


@dataclasses.dataclass(frozen=True)
class VictimRef:
    uid: str
    namespace: str
    name: str
    node: str
    priority: int
    chips: int
    chip_seconds: float


@dataclasses.dataclass
class _InFlight:
    plan: DefragPlan
    requester_key: str
    asked_at: float
    #: THIS plan's reservation — an abort returns only this box, never
    #: the demand's previously assembled ones.
    reservation: object = None


def plan_compaction(
    demand_chips: int,
    snapshot: Dict[str, object],
    pods_by_node: Dict[str, list],
    *,
    protected_uids: Set[str],
    min_victim_priority: int = 1,
    max_victims: int = 8,
    chip_seconds_of=lambda uid: 0.0,
    mesh: Optional[Tuple[int, ...]] = None,
    allow_existing: bool = False,
    shrink_uids: FrozenSet[str] = frozenset(),
) -> Optional[DefragPlan]:
    """Cheapest single-node compaction that assembles a contiguous box
    of ``demand_chips`` — or None when no node can be compacted to it.

    Pure: reads the immutable snapshot entries and the pod lists, holds
    no locks, performs no I/O.  Guarantees (the property-test surface):

    - victims are always checkpointable (priority >= the preemptible
      tier) and never in ``protected_uids`` (gang members, rescuer
      queue, any in-flight eviction);
    - the plan's predicted post-migration free set holds a box the
      demand can actually use — of at least ``demand_chips``, REALIZING
      ``mesh`` when one is declared — where none existed before, and
      (for shapeless demands) the node's largest free box strictly
      grows: a move that frees nothing new is never planned;
    - victim sets are minimal-first: fewest KILLS (a victim in
      ``shrink_uids`` — an elastic gang member the resize controller
      can step down a rung, keeping the job alive — is cheaper than any
      eviction and charges no sunk work), then fewest victims, then
      least sunk chip-seconds, with deterministic tie-breaks.
      ``shrink_uids`` members bypass the priority gate (an elastic gang
      opted into checkpoint-restart by declaring the range) but still
      honor ``protected_uids``; with the elastic subsystem off the set
      is empty and plans are byte-identical to before it existed.
    """
    best: Optional[Tuple[tuple, DefragPlan]] = None
    for name in sorted(snapshot):
        entry = snapshot[name]
        view = node_free_view(name, entry)
        if view is None:
            continue
        topo: TopologyDesc = view.topo
        if demand_chips > topo.num_chips:
            continue
        shapes = (mesh_box_shapes(mesh, topo.mesh) if mesh is not None
                  else factor_shapes(demand_chips, topo.mesh))
        if not shapes:
            continue  # this node's fabric can never host the demand
        free = frozenset(view.free)
        before_boxes = (shaped_box_availability(topo, free, shapes)
                        if (mesh is not None or allow_existing) else 0)
        if not allow_existing:
            # ``allow_existing`` (multi-box gang demands) plans MORE
            # boxes on a node that already holds one; single-box
            # demands skip such nodes — fragmentation is not what
            # blocks them there (HBM/cores/policy might, but
            # compaction cannot fix those).
            if mesh is not None:
                if before_boxes > 0:
                    continue  # a realizing box is already free here
            elif view.max_box >= demand_chips:
                continue
        cells: Dict[Coord, str] = {}
        for cid, u in entry.usage.items():
            if u.coords:
                cells[u.coords] = cid
        # Chip -> resident pods; a chip is movable iff EVERY resident is
        # an eligible victim (one pinned sharer pins the chip).
        residents: Dict[str, List[object]] = {}
        eligible: Dict[str, VictimRef] = {}
        movable_ok = True
        for pod in pods_by_node.get(name, []):
            uids_chips = {d.uuid for c in pod.devices for d in c}
            for cid in uids_chips:
                residents.setdefault(cid, []).append(pod)
            if (pod.priority >= min_victim_priority
                    or pod.uid in shrink_uids) \
                    and pod.uid not in protected_uids:
                eligible[pod.uid] = VictimRef(
                    uid=pod.uid, namespace=pod.namespace, name=pod.name,
                    node=name, priority=pod.priority,
                    chips=len(uids_chips),
                    chip_seconds=float(chip_seconds_of(pod.uid)))
        movable: Set[Coord] = set()
        for coord, cid in cells.items():
            if coord in free:
                continue
            pods_here = residents.get(cid)
            u = entry.usage.get(cid)
            if not pods_here:
                continue  # used per usage but unattributed: not movable
            if u is not None and not u.health:
                continue  # broken chip: the rescuer's business, not ours
            if all(p.uid in eligible for p in pods_here):
                movable.add(coord)
        if not movable:
            continue
        usable = free | movable
        for shape in shapes:
            for origin in box_coords_origins(topo):
                box = box_coords(origin, shape, topo)
                if box is None or not usable.issuperset(box):
                    continue
                box_set = set(box)
                victim_uids: Set[str] = set()
                for coord in box_set & movable:
                    for pod in residents.get(cells[coord], []):
                        victim_uids.add(pod.uid)
                if not victim_uids or len(victim_uids) > max_victims:
                    continue
                victims = sorted((eligible[u] for u in victim_uids),
                                 key=lambda v: v.uid)
                # Predicted free set: current free plus EVERY cell the
                # victims vacate node-wide (their chips may lie outside
                # the box too — eviction frees them all).  A used cell
                # with NO attributed residents (unhealthy-idle, or
                # usage ahead of the pod cache) vacates nothing.
                vacated = set()
                for coord, cid in cells.items():
                    if coord in free:
                        continue
                    pods_here = residents.get(cid)
                    if pods_here and all(p.uid in victim_uids
                                         for p in pods_here):
                        vacated.add(coord)
                after = frozenset(free | vacated)
                max_after = max_free_box_volume(topo, after)
                if mesh is not None or allow_existing:
                    # Box-count currency: the move must yield MORE
                    # usable boxes than the node already has (for a
                    # mesh, realizing boxes — pure volume may not grow:
                    # turning a 4x1 strip's worth of cells into a 2x2
                    # is exactly the point).
                    if shaped_box_availability(topo, after, shapes) \
                            <= before_boxes:
                        continue
                elif max_after < demand_chips \
                        or max_after <= view.max_box:
                    continue  # the move would not strictly improve
                kills = [v for v in victims if v.uid not in shrink_uids]
                # Sunk work is only LOST on a kill: a shrunk gang keeps
                # running one rung down, so its chip-seconds don't
                # count against the plan.
                cost = sum(v.chip_seconds for v in kills)
                key = (len(kills), len(victims), cost, name,
                       sorted(box_set))
                if best is None or key < best[0]:
                    best = (key, DefragPlan(
                        node=name,
                        box={c: cells[c] for c in sorted(box_set)},
                        victims=victims,
                        demand_key="", demand_chips=demand_chips,
                        max_box_before=view.max_box,
                        max_box_after=max_after,
                        cost_chip_seconds=cost))
            # Unlike placement, do NOT break after the first fitting
            # shape: a less compact box with fewer victims is the better
            # compaction (cost, not compactness, ranks plans).
    return best[1] if best is not None else None


class Defragmenter:
    def __init__(self, scheduler, cfg: Optional[DefragConfig] = None,
                 clock=None) -> None:
        self.s = scheduler
        self.cfg = cfg or DefragConfig()
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._demand: Dict[str, Demand] = {}
        self._in_flight: Dict[str, _InFlight] = {}
        #: key -> no-replan-before time.  An aborted plan's victims were
        #: wedged; re-asking them the very next tick would thrash
        #: checkpoint requests against the same stuck pods.
        self._backoff: Dict[str, float] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: Lifetime counters (exporter + simulator report).
        self.plans_total = 0
        self.migrations_total = 0
        self.completed_total = 0
        self.aborted_total = 0

    # -- demand ---------------------------------------------------------------
    def observe_rejection(self, key: str, namespace: str, name: str,
                          chips: int, count: int = 1,
                          mesh: Optional[Tuple[int, ...]] = None) -> None:
        """Filter saw a slice/mesh request fit nowhere — record (or
        refresh) the demand.  ``key`` is the pod uid, or the gang key
        for gang members (any member refreshes the whole gang's
        demand); ``chips`` is the per-pod contiguous need, ``count``
        how many disjoint such boxes the demand needs (gang size), and
        ``mesh`` the pod's ICI-local mesh shape when declared."""
        if chips <= 1:
            return
        now = self._clock()
        with self._lock:
            d = self._demand.get(key)
            if d is None:
                self._demand[key] = Demand(
                    key=key, namespace=namespace, name=name, chips=chips,
                    first_seen=now, last_seen=now, count=max(1, count),
                    mesh=tuple(mesh) if mesh is not None else None)
            else:
                d.last_seen = now
                d.chips = max(d.chips, chips)
                d.count = max(d.count, count)
                if mesh is not None:
                    d.mesh = tuple(mesh)
                d.rejections += 1

    def demand_satisfied(self, key: str) -> None:
        """The demand's pod placed (or released its reservation)."""
        with self._lock:
            self._demand.pop(key, None)
            self._backoff.pop(key, None)

    def pending_demand(self) -> List[Demand]:
        with self._lock:
            return sorted(self._demand.values(),
                          key=lambda d: (-d.chips, d.first_seen, d.key))

    def in_flight(self) -> Dict[str, _InFlight]:
        with self._lock:
            return dict(self._in_flight)

    def ready_for(self, key: str) -> bool:
        """May the beneficiary's Filter release ``key``'s reservations?
        Only when nothing is mid-compaction for it AND every box it
        needs is available — reserved, or already free on the
        (reserved-stripped) fleet: a demand partially satisfied by a
        pre-existing free box must not wait for a reservation nobody
        will ever take out for it.  Releasing a gang's first box while
        the second is still being evicted would return it to the pool,
        where any single can squat in it before the gang's atomic
        attempt ever sees both."""
        with self._lock:
            if key in self._in_flight:
                return False
            d = self._demand.get(key)
        need = d.count if d is not None else 1
        held = self.s.reservations.count_for(key)
        if held >= need:
            return True
        if d is None:
            return False
        return held + self._free_boxes(d) >= need

    def _free_boxes(self, d: Demand) -> int:
        """Disjoint FREE boxes usable by ``d`` on the reserved-stripped
        fleet (its own reservations are stripped too, so this never
        double-counts a held box)."""
        avail = 0
        for v in fleet_views(self.s.snapshot()):
            shapes = (mesh_box_shapes(d.mesh, v.topo.mesh)
                      if d.mesh is not None
                      else factor_shapes(d.chips, v.topo.mesh))
            if shapes:
                avail += shaped_box_availability(
                    v.topo, frozenset(v.free), shapes)
        return avail

    # -- the tick -------------------------------------------------------------
    def tick(self) -> List[dict]:
        """One defrag pass: expire reservations, progress in-flight
        plans, then plan at most ONE new compaction (single-writer over
        the fleet's movable set keeps plans from fighting each other).
        Returns the actions taken (tests, the simulator report).  Timed
        into the ``defrag-tick`` phase of the performance observatory."""
        with perf.phase_timer("defrag-tick"):
            return self._tick()

    def _tick(self) -> List[dict]:
        now = self._clock()
        actions: List[dict] = []
        res = self.s.reservations
        for r in res.sweep(now):
            actions.append({"kind": "reservation-expired", "node": r.node,
                            "for": r.for_key, "chips": len(r.chips)})
        self._prune_demand(now)
        self._progress_in_flight(now, actions)
        if not self.cfg.enabled:
            return actions
        shards = getattr(self.s, "shards", None)
        if shards is not None and not shards.leads("defrag"):
            # Sharded control plane: compaction plans span the whole
            # fleet's movable set, so the single-writer rule becomes a
            # single-OWNER rule — one elected replica PLANS new
            # compactions (shard/shardmap.py); the election moves with
            # the epoch if the leader dies.  The sweeps above stay
            # replica-local and always run: a demoted ex-leader must
            # still expire its reservations and drive its in-flight
            # plan to completion or checkpoint-grace abort, or the
            # reserved chips never return to the pool.
            return actions
        if self._in_flight:
            return actions  # one compaction at a time
        demand = self._blocked_demand()
        if demand is None:
            return actions
        plan = self._plan_locked_out(demand)
        if plan is None:
            return actions
        self._execute(plan, demand, now, actions)
        return actions

    def _prune_demand(self, now: float) -> None:
        """Forget demands whose pod stopped retrying — EXCEPT while a
        compaction is in flight or reservations are held for them: the
        demand record carries the box count ready_for gates partial
        releases on, and kube-scheduler's retry backoff (minutes at the
        tail) can legitimately exceed the freshness window
        mid-assembly.  Such demands die when their reservations expire
        or deliver."""
        res = self.s.reservations
        with self._lock:
            stale = [k for k, d in self._demand.items()
                     if now - d.last_seen > self.cfg.demand_fresh_s
                     and k not in self._in_flight
                     and res.count_for(k) == 0]
            for k in stale:
                del self._demand[k]
            # Lapsed abort backoffs go with them (churning uids must
            # not accumulate in this map over the scheduler's life).
            for k in [k for k, t in self._backoff.items() if t <= now]:
                del self._backoff[k]

    def _blocked_demand(self) -> Optional[Demand]:
        """Largest live demand fragmentation currently blocks: fewer
        disjoint free boxes of its size — realizing its mesh, when one
        is declared — exist (reservations it already holds count toward
        it; the views are reserved-stripped) than the boxes it still
        needs."""
        now = self._clock()
        with self._lock:
            if not self._demand:
                return None   # idle fleets must not pay the box search
            backoff = dict(self._backoff)
        res = self.s.reservations
        for d in self.pending_demand():
            if backoff.get(d.key, 0.0) > now:
                continue
            needed = d.count - res.count_for(d.key)
            if needed <= 0:
                continue
            if self._free_boxes(d) < needed:
                return d
        return None

    def _plan_locked_out(self, demand: Demand) -> Optional[DefragPlan]:
        snapshot = self.s.snapshot()
        pods_by_node = self.s.pods.by_node()
        protected = {
            uid for g in self.s.gangs.groups().values()
            for uid in (*g.members, *g.placements)
        }
        protected |= set(self.s.rescuer.pending())
        with self.s._preempt_lock:
            protected |= set(self.s._preempt_requested)
        # Elastic gang members the resize controller can step down a
        # rung are the one exception to gang protection: they don't die,
        # they come back one rung smaller.  Empty dict (and therefore
        # byte-identical plans) whenever --enable-elastic is off.
        shrink_map = self.s.elastic.shrinkable_uids()
        protected -= set(shrink_map)

        def chip_seconds_of(uid: str) -> float:
            acct = self.s.ledger.get(uid)
            return acct.chip_seconds if acct is not None else 0.0

        plan = plan_compaction(
            demand.chips, snapshot, pods_by_node,
            protected_uids=protected,
            min_victim_priority=self.cfg.min_victim_priority,
            max_victims=self.cfg.max_victims_per_plan,
            chip_seconds_of=chip_seconds_of,
            mesh=demand.mesh,
            allow_existing=demand.count > 1,
            shrink_uids=frozenset(shrink_map))
        if plan is not None:
            plan.demand_key = demand.key
        return plan

    def _execute(self, plan: DefragPlan, demand: Demand, now: float,
                 actions: List[dict]) -> None:
        from ..scheduler.preempt import PreemptionPlan

        requester_key = DEFRAG_REQUESTER_PREFIX + demand.key
        reservation = self.s.reservations.reserve(
            plan.node, set(plan.box.values()), demand.key,
            ttl_s=self.cfg.reservation_ttl_s)
        # Route the checkpoint requests through the scheduler's own
        # preemption machinery: throttling, the requester→victims
        # ledger (which is exactly what makes quota reclaim and repeat
        # plans treat these victims as in-flight) and the annotation
        # write all come for free.  The synthetic requester "pod" never
        # exists — its rescue:-prefixed uid keeps reconciliation away.
        requester = {"metadata": {
            "uid": requester_key, "name": f"defrag:{demand.name}",
            "namespace": demand.namespace}}
        victims = [self.s.pods.get(v.uid) for v in plan.victims]
        victims = [v for v in victims if v is not None]
        if len(victims) != len(plan.victims):
            # A victim vanished between plan and execute: replan next
            # tick rather than evicting a stale set.  Only THIS box
            # returns — the demand's previously assembled ones stand.
            self.s.reservations.release(reservation)
            return
        # Elastic gang members shrink instead of dying.  Each gang gets
        # its OWN requester key (suffixed with the gang key) under the
        # resize controller's ledger entry — sharing defrag's key would
        # let the resize completion rescind clear the plain victims'
        # annotations mid-checkpoint.  begin_shrink re-checks its own
        # guards; if any gang refuses (raced into another resize), the
        # box can't fully free, so abort this plan and replan next tick.
        shrink_map = self.s.elastic.shrinkable_uids()
        gang_keys = sorted({shrink_map[v.uid] for v in victims
                            if v.uid in shrink_map})
        shrunk = []
        for gk in gang_keys:
            act = self.s.elastic.begin_shrink(
                gk, f"{requester_key}/{gk}",
                reason=f"defrag for {demand.key}")
            if act is None:
                self.s.reservations.release(reservation)
                return
            shrunk.append(act)
        plain = [v for v in victims if v.uid not in shrink_map]
        if plain:
            self.s._request_preemptions(
                requester,
                PreemptionPlan(node=plan.node, victims=plain))
        with self._lock:
            self._in_flight[demand.key] = _InFlight(
                plan=plan, requester_key=requester_key, asked_at=now,
                reservation=reservation)
            self.plans_total += 1
            self.migrations_total += len(plan.victims)
        log.warning(
            "defrag: compacting %s for %s (%d chips): migrating %d "
            "victim(s) (%.0f chip-seconds sunk), max contiguous box "
            "%d -> %d", plan.node, demand.key, plan.demand_chips,
            len(plan.victims), plan.cost_chip_seconds,
            plan.max_box_before, plan.max_box_after)
        actions.append({
            "kind": "defrag-plan", "node": plan.node,
            "for": demand.key, "chips": plan.demand_chips,
            "victims": [v.uid for v in plan.victims],
            "shrinks": [a["gang"] for a in shrunk],
            "max_box_before": plan.max_box_before,
            "max_box_after": plan.max_box_after})
        actions.extend(shrunk)

    def _progress_in_flight(self, now: float,
                            actions: List[dict]) -> None:
        with self._lock:
            flights = list(self._in_flight.items())
        for key, fl in flights:
            remaining = [v for v in fl.plan.victims
                         if self.s.pods.get(v.uid) is not None]
            if not remaining:
                with self._lock:
                    self._in_flight.pop(key, None)
                    self.completed_total += 1
                # Clear the requester ledger so the victims' uids leave
                # the in-flight set (they are gone; nothing to rescind,
                # but the bookkeeping must not leak).
                self.s._rescind_preemptions(fl.requester_key)
                actions.append({"kind": "defrag-complete", "for": key,
                                "node": fl.plan.node})
                log.info("defrag: compaction on %s for %s complete; "
                         "slice reserved for the beneficiary",
                         fl.plan.node, key)
                continue
            if now - fl.asked_at > self.cfg.checkpoint_grace_s:
                with self._lock:
                    self._in_flight.pop(key, None)
                    self.aborted_total += 1
                    self._backoff[key] = \
                        now + self.cfg.checkpoint_grace_s
                self.s._rescind_preemptions(fl.requester_key)
                if fl.reservation is not None:
                    self.s.reservations.release(fl.reservation)
                actions.append({
                    "kind": "defrag-abort", "for": key,
                    "node": fl.plan.node,
                    "stuck": [v.uid for v in remaining]})
                log.warning(
                    "defrag: %d victim(s) on %s did not checkpoint "
                    "within %.0fs; aborting compaction for %s",
                    len(remaining), fl.plan.node,
                    self.cfg.checkpoint_grace_s, key)

    # -- background thread -----------------------------------------------------
    def start(self, interval_s: Optional[float] = None) -> None:
        if self._thread is not None:
            return
        period = interval_s if interval_s is not None \
            else self.cfg.interval_s

        def loop() -> None:
            while not self._stop.wait(period):
                try:
                    self.tick()
                except Exception:  # noqa: BLE001 — keep compacting through glitches
                    log.exception("defrag tick failed")

        self._thread = threading.Thread(target=loop, name="fleet-defrag",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
