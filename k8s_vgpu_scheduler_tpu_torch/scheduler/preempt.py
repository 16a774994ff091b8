"""Priority preemption with checkpointed resume (the port's copy of the
JAX package's ``scheduler/preempt.py``).

The reference's priority story stops at throttling: an active
higher-priority sharer flips ``utilization_switch`` and low-priority
processes are held to their core grant.  A high-priority pod that fits
nowhere simply pends.  Here, since the train state is explicit
(``models/train.TrainState``), eviction loses nothing:

1. Filter finds no node, and the requester has a strictly higher priority
   (a lower ``nvidia.com/priority``) than some placed pods.
2. :func:`plan_preemption` picks the cheapest node and victims whose
   release makes the pod fit.
3. The scheduler writes ``vtpu.dev/preempt-requested=<requester uid>`` on
   each victim, outside the Filter lock; it reaches the container through
   the downward-API annotations file.
4. In the container ``shim/preempt.PreemptionWatch`` sees it,
   ``models/train.run_preemptible`` checkpoints at the next step boundary
   and exits; the pod's delete frees its grant and the requester places on
   its next Filter.
5. The victim is rescheduled later and resumes from its checkpoint on the
   same trajectory.

The planner is pure (no I/O, no locks) and works on the usage Filter
builds.  It has no topology or policy argument: the port's ``fit_pod``
takes the plain choice of cards, which is the JAX planner's on a node
without a ``TopologyDesc``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from . import score as score_mod
from .nodes import NodeInfo
from .pods import PodInfo

#: Set on a victim pod; the value is the requesting pod's uid (who evicted
#: it, for ``kubectl describe``).
PREEMPT_ANNOTATION = "vtpu.dev/preempt-requested"


@dataclasses.dataclass
class PreemptionPlan:
    # No placement is carried: the victims take a while to checkpoint and
    # exit, and the requester's next Filter fits afresh.
    node: str
    victims: List[PodInfo]


def _fits_without(requests, info: NodeInfo, pods: List[PodInfo],
                  excluded: set, anns: Dict[str, str]):
    remaining = [p for p in pods if p.uid not in excluded]
    usage = score_mod.build_usage(info, remaining)
    return score_mod.fit_pod(requests, usage, anns)


def plan_preemption(
    requests,
    requester_priority: int,
    entries: Dict[str, Tuple[NodeInfo, object]],
    pods_by_node: Dict[str, List[PodInfo]],
    anns: Dict[str, str],
    protected_uids: Optional[set] = None,
    node_policy: str = "spread",
) -> Optional[PreemptionPlan]:
    """The cheapest ``(node, victims)`` whose eviction admits ``requests``.

    A victim has a strictly lower priority than the requester (a greater
    number: 0 is the highest) and is not in ``protected_uids``.  Inside a
    node: the lowest priority first, then the youngest grant (the least
    work lost), then the uid, so a plan replays the same whatever the
    registry's order.  Across nodes: the fewest victims, then the node
    score after the eviction, then the node's name.  None when nothing
    helps: the pod pends as it would without preemption.
    """
    protected = protected_uids or set()
    best: Optional[Tuple[int, float, str, List[PodInfo]]] = None
    for node, (info, _usage) in entries.items():
        pods = pods_by_node.get(node, [])
        candidates = [p for p in pods
                      if p.priority > requester_priority
                      and p.uid not in protected]
        if not candidates:
            continue
        candidates.sort(key=lambda p: (-p.priority, -p.touched_at, p.uid))
        chosen: Optional[List[PodInfo]] = None
        # One victim first: the cheapest plan a node can offer.
        for c in candidates:
            if _fits_without(requests, info, pods, {c.uid},
                             anns) is not None:
                chosen = [c]
                break
        if chosen is None:
            # Then victims added in preference order until the pod fits.
            acc: List[PodInfo] = []
            excluded: set = set()
            for c in candidates:
                acc.append(c)
                excluded.add(c.uid)
                if _fits_without(requests, info, pods, excluded,
                                 anns) is not None:
                    chosen = list(acc)
                    break
        if chosen is None:
            continue  # evicting every lower-priority pod does not fit it
        gone = {v.uid for v in chosen}
        usage_after = score_mod.build_usage(
            info, [p for p in pods if p.uid not in gone])
        key = (len(chosen), -score_mod.node_score(usage_after, node_policy),
               node)
        if best is None or key < best[:3]:
            best = (*key, chosen)
    if best is None:
        return None
    return PreemptionPlan(node=best[2], victims=best[3])
