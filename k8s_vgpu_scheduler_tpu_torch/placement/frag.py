"""Fleet-wide contiguous-slice availability over the usage snapshot (the
port's copy of the JAX package's ``placement/frag.py``).

The scheduler's snapshot (``core.SnapEntry``) is the single source of
truth for what is free; this module reduces it to the two numbers the
defragmenter and the exporter need:

- per node: the set of WHOLE free cards with coords (a card any pod
  shares is not slice material — slice grants want virgin cards, the
  exclusive-card rule of score.py), and the largest contiguous box over
  them;
- per fleet: how many disjoint free boxes of each canonical size could
  be granted right now (``vtpu_slice_availability{shape=...}``).

Pure reads — no locks, no mutation; callers pass the snapshot entries
they already hold.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

from ..tpulib.types import Coord, TopologyDesc
from .mesh import box_availability, max_free_box_volume

#: Canonical slice sizes the availability gauge reports (powers of two
#: up to the largest per-host mesh we serve) — a FIXED label set so the
#: dashboard's series never vanish as fleets grow and shrink.
CANONICAL_SIZES: Tuple[int, ...] = (2, 4, 8, 16, 32, 64)


@dataclasses.dataclass
class NodeFreeView:
    """One node's slice-relevant free state."""

    node: str
    topo: TopologyDesc
    #: coord -> card id for every healthy, completely-unused card.
    free: Dict[Coord, str]
    #: Largest contiguous free box volume on this node right now.
    max_box: int


def node_free_view(name: str, entry) -> Optional[NodeFreeView]:
    """Reduce one snapshot entry to its free-coordinate view (None when
    the node advertises no usable topology or coords)."""
    topo = entry.info.topology
    if topo is None:
        return None
    free: Dict[Coord, str] = {}
    seen = set()
    for cid, u in entry.usage.items():
        if not u.coords:
            return None  # agent reports no coords: topology unverifiable
        if u.coords in seen:
            return None  # duplicate coords: same
        seen.add(u.coords)
        if u.health and u.used_slots == 0 and u.used_mem == 0 \
                and u.used_cores == 0:
            free[u.coords] = cid
    return NodeFreeView(
        node=name, topo=topo, free=free,
        max_box=max_free_box_volume(topo, frozenset(free)))


def fleet_views(snapshot: Dict[str, object]) -> List[NodeFreeView]:
    return [v for name in sorted(snapshot)
            for v in (node_free_view(name, snapshot[name]),)
            if v is not None]


def slice_availability(views: Iterable[NodeFreeView],
                       sizes: Iterable[int] = CANONICAL_SIZES
                       ) -> Dict[int, int]:
    """Disjoint free boxes of each size, summed fleet-wide.  The number
    for size n answers "how many n-card contiguous grants could be
    admitted back to back without any eviction"."""
    sizes = list(sizes)
    out: Dict[int, int] = {n: 0 for n in sizes}
    for v in views:
        per = box_availability(v.topo, frozenset(v.free), sizes)
        for n, c in per.items():
            out[n] += c
    return out


def largest_free_box(views: Iterable[NodeFreeView]) -> int:
    """The fleet's largest contiguous free box — the single number that
    says which gang sizes can admit without compaction."""
    return max((v.max_box for v in views), default=0)
