"""Reclaim borrowed grants for a starved in-quota tenant (the port's copy
of the JAX package's ``quota/reclaim.py``).

When a queue under its nominal quota cannot admit or place a pod because
its cohort's capacity is held by tenants over their nominal, the planner
picks victims from exactly the *borrowed* slice of those tenants' usage;
the admission loop routes them through the scheduler's checkpoint-first
preemption requests.  In-quota grants are never victims.  Before any
eviction, ``plan_shrinks`` picks elastic gangs of the same donors to step
down a rung instead (``elastic/``): the cheaper action.  Both planners
are pure: inputs in, victims out.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set

from .queues import QueueConfig, QueueUsage, grant_chips


@dataclasses.dataclass(frozen=True)
class ShrinkCandidate:
    """One elastic gang the resize controller could step down a rung
    right now (``ResizeController.shrinkable_uids``), as the reclaim
    planner sees it: where it lives, what the step frees, and how much
    work it has sunk (the least-sunk-first ordering key)."""

    gang_key: str          # "<namespace>/<group>"
    namespace: str
    freed_chips: int       # net cards one rung down frees
    sunk_chip_seconds: float


def plan_shrinks(
    demand_chips: int,
    target: QueueConfig,
    queues: Dict[str, QueueConfig],
    usage: Dict[str, QueueUsage],
    candidates: List[ShrinkCandidate],
) -> List[ShrinkCandidate]:
    """The CHEAPER reclaim action: elastic gangs to shrink before any
    eviction is planned.  The donor discipline of :func:`plan_reclaim`
    (only cohort peers of ``target`` running over nominal donate, and a
    shrink may never free more than the donor's borrowed slice, which
    would dip an in-quota grant) and its determinism: donors
    most-borrowed first (name tie-break), gangs within a donor
    least-sunk-work first (GPU-seconds ascending, key tie-break).

    Unlike plan_reclaim, a PARTIAL result is returned: every shrunk card
    shrinks the eviction plan the admission loop tops up with, so
    shrinking what can be shrunk is strictly better than shrinking
    nothing.  Selection only; the caller executes through the resize
    controller so the victims ride the shared preemption ledger."""
    if demand_chips <= 0 or not candidates:
        return []
    by_ns = {ns: q for q in queues.values() for ns in q.namespaces}
    budgets: Dict[str, int] = {}
    donor_of: Dict[str, QueueConfig] = {}
    for c in candidates:
        q = by_ns.get(c.namespace)
        if q is None or q.name == target.name or not target.cohort \
                or q.cohort != target.cohort:
            continue
        if q.name not in budgets:
            budgets[q.name] = usage.get(
                q.name, QueueUsage()).borrowed_chips(q)
        if budgets[q.name] > 0:
            donor_of[c.gang_key] = q
    ordered = sorted(
        (c for c in candidates if c.gang_key in donor_of),
        key=lambda c: (-budgets[donor_of[c.gang_key].name],
                       donor_of[c.gang_key].name,
                       c.sunk_chip_seconds, c.gang_key))
    chosen: List[ShrinkCandidate] = []
    freed = 0
    for c in ordered:
        if freed >= demand_chips:
            break
        donor = donor_of[c.gang_key]
        if c.freed_chips <= 0 or c.freed_chips > budgets[donor.name]:
            continue  # one rung down would dip the donor below nominal
        chosen.append(c)
        freed += c.freed_chips
        budgets[donor.name] -= c.freed_chips
    return chosen


def plan_reclaim(
    demand_chips: int,
    target: QueueConfig,
    queues: Dict[str, QueueConfig],
    usage: Dict[str, QueueUsage],
    pods,
    protected_uids: Optional[Set[str]] = None,
):
    """Victims freeing >= ``demand_chips``, drawn only from borrowed
    capacity of ``target``'s cohort peers, as a ``PreemptionPlan``.

    Deterministic: donor queues most-borrowed first (name tie-break),
    victims within a queue youngest grant first (``touched_at`` desc, uid
    tie-break).  A donor gives at most its borrowed amount.  None when the
    borrowed capacity cannot cover the demand: a partial reclaim would
    evict without unblocking the requester."""
    from ..scheduler.preempt import PreemptionPlan

    if demand_chips <= 0:
        return None
    protected = protected_uids or set()
    by_ns = {ns: q for q in queues.values() for ns in q.namespaces}
    # An empty cohort is private: no donors, and never a donor.
    donors = sorted(
        (q for q in queues.values()
         if q.name != target.name and target.cohort
         and q.cohort == target.cohort
         and usage.get(q.name, QueueUsage()).borrowed_chips(q) > 0),
        key=lambda q: (-usage[q.name].borrowed_chips(q), q.name))
    if not donors:
        return None
    pods_by_queue: Dict[str, List] = {}
    for p in pods:
        q = by_ns.get(p.namespace)
        if q is not None:
            pods_by_queue.setdefault(q.name, []).append(p)
    victims: List = []
    freed = 0
    for donor in donors:
        budget = usage[donor.name].borrowed_chips(donor)
        candidates = sorted(
            (p for p in pods_by_queue.get(donor.name, [])
             if p.uid not in protected),
            key=lambda p: (-p.touched_at, p.uid))
        for p in candidates:
            if freed >= demand_chips or budget <= 0:
                break
            chips, _ = grant_chips(p)
            if chips <= 0 or chips > budget:
                continue  # evicting it would dip the donor below nominal
            victims.append(p)
            freed += chips
            budget -= chips
        if freed >= demand_chips:
            break
    if freed < demand_chips or not victims:
        return None
    return PreemptionPlan(node=victims[0].node, victims=victims)
