"""Weighted dominant-resource fair share across capacity queues (the
port's copy of the JAX package's ``quota/fairshare.py``).

DRF (Ghodsi et al., NSDI'11) on quota-relative shares: a queue's dominant
share is its held fraction of NOMINAL quota, maximized across resource
dimensions, divided by its weight; the admission loop releases next from
the queue with the lowest weighted share.  The opt-in usage-informed mode
scales a weight down toward a floor by the queue's measured grant
efficiency (``accounting/efficiency.py``): holding cards you do not use
demotes your next admission.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .queues import QueueConfig, QueueUsage

#: Usage-informed demotion never scales a weight below this fraction: a
#: fully idle tenant is deprioritized, not starved out of its quota.
USAGE_WEIGHT_FLOOR = 0.25


def dominant_share(usage: QueueUsage, q: QueueConfig) -> float:
    """Held / nominal, maximized over dimensions.  A dimension with zero
    nominal and nonzero held reads as infinite on cards (no entitlement:
    everything is borrowed) and is ignored on memory (unconstrained)."""
    shares: List[float] = []
    if q.nominal_chips > 0:
        shares.append(usage.chips / q.nominal_chips)
    elif usage.chips > 0:
        shares.append(float("inf"))
    if q.nominal_hbm_mib > 0:
        shares.append(usage.mem_mib / q.nominal_hbm_mib)
    return max(shares) if shares else 0.0


def effective_weight(q: QueueConfig, efficiency: Optional[float],
                     usage_informed: bool) -> float:
    """The queue's weight, demoted by measured efficiency in the
    usage-informed mode.  ``efficiency`` None (no usage reports: an
    unmonitored tenant is not punished) leaves the weight as configured."""
    if not usage_informed or efficiency is None:
        return q.weight
    return q.weight * max(USAGE_WEIGHT_FLOOR, min(1.0, efficiency))


def fair_share_order(
    queues: Dict[str, QueueConfig],
    usage: Dict[str, QueueUsage],
    efficiencies: Optional[Dict[str, Optional[float]]] = None,
    usage_informed: bool = False,
) -> List[Tuple[float, str]]:
    """Queues lowest weighted dominant share first; the name breaks ties,
    so the order replays identically."""
    effs = efficiencies or {}
    out = []
    for name, q in queues.items():
        w = effective_weight(q, effs.get(name), usage_informed)
        share = dominant_share(usage.get(name, QueueUsage()), q) / w
        out.append((share, name))
    out.sort(key=lambda t: (t[0], t[1]))
    return out


def queue_efficiencies(fleet, by_ns: Dict[str, str]
                       ) -> Dict[str, Optional[float]]:
    """Per-queue actual / granted card-seconds from the per-pod efficiency
    join (``fleet``: a ``FleetEfficiency``; ``by_ns``: namespace -> queue
    name).  A queue with no measured grant maps to None (unknown is not
    idle)."""
    granted: Dict[str, float] = {}
    actual: Dict[str, float] = {}
    for pe in fleet.pods:
        qname = by_ns.get(pe.namespace)
        if qname is None or pe.efficiency is None:
            continue
        granted[qname] = granted.get(qname, 0.0) + pe.granted_chip_seconds
        actual[qname] = actual.get(qname, 0.0) + pe.actual_chip_seconds
    return {qname: (actual.get(qname, 0.0) / g if g > 0 else None)
            for qname, g in granted.items()}
