"""Reclaim borrowed grants for a starved in-quota tenant (the port's copy
of the JAX package's ``quota/reclaim.py`` ``plan_reclaim``).

When a queue under its nominal quota cannot admit or place a pod because
its cohort's capacity is held by tenants over their nominal, the planner
picks victims from exactly the *borrowed* slice of those tenants' usage;
the admission loop routes them through the scheduler's checkpoint-first
preemption requests.  In-quota grants are never victims.  The planner is
pure: inputs in, victims out.  ``plan_shrinks`` (elastic gangs stepping
down a rung instead of dying) waits for the elastic slice (ROADMAP A.5).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set

from .queues import QueueConfig, QueueUsage, grant_chips


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
