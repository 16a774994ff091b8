"""Closed-form slice placement on a node's device fabric (the port's copy
of the JAX package's ``topology/torus.py``).

The reference finds rings of well-linked devices with an external
brute-force solver (``cntopo find -R 1000000``, pkg/device-plugin/mlu/
cntopo/cntopo.go:194–234) and one ring allocator per MLU model
(allocator/{spider,board}.go).  Where a fabric is a regular mesh or
torus, "devices that must communicate fast" are axis-aligned sub-boxes
(slices), enumerable in closed form.  On a GPU node the fabric is what
NVML's NVLink peer-to-peer matrix shows (``tpulib.backend.NvmlBackend``):
cards that all reach each other over NVLink form one axis with
wraparound, a ring; on a node without that the cards have no coordinates,
so no slice.

Policies (reference types.go:44–46):

- ``guaranteed``: the grant must be a contiguous slice, else fail;
- ``restricted``: contiguous whenever the card count *can* form a slice on
  this mesh; only impossible counts may scatter;
- ``best-effort``: prefer contiguous, fall back to scattered.

The packing score and the tie order are the JAX module's: results are
compared with it as lists.  No torch, grpc or protobuf.
"""

from __future__ import annotations

import itertools
from typing import FrozenSet, Iterable, List, Optional, Sequence, Set, Tuple

from ..tpulib.types import Coord, TopologyDesc
from ..util.types import BEST_EFFORT, GUARANTEED, RESTRICTED


def factor_shapes(n: int, mesh: Sequence[int]) -> List[Tuple[int, ...]]:
    """All axis-aligned box shapes with volume ``n`` fitting inside ``mesh``,
    most compact first (minimal surface area ⇒ best fabric bisection)."""
    dims = len(mesh)
    shapes: Set[Tuple[int, ...]] = set()

    def rec(prefix: Tuple[int, ...], remaining: int, axis: int):
        if axis == dims - 1:
            if remaining <= mesh[axis]:
                shapes.add(prefix + (remaining,))
            return
        for d in range(1, min(remaining, mesh[axis]) + 1):
            if remaining % d == 0:
                rec(prefix + (d,), remaining // d, axis + 1)

    if n >= 1:
        rec((), n, 0)
    # Tie-break equal-surface-area shapes by the shape tuple itself: the
    # candidate set comes out of a set(), and set iteration order is an
    # implementation detail — an unpinned tie would let two Python
    # builds (or two scheduler replicas) enumerate, and therefore PLACE,
    # differently on identical fleets.
    return sorted(shapes, key=lambda s: (_surface_area(s), s))


def _surface_area(shape: Tuple[int, ...]) -> int:
    vol = 1
    for d in shape:
        vol *= d
    area = 0
    for d in shape:
        area += 2 * (vol // d)
    return area


def box_coords(origin: Coord, shape: Tuple[int, ...], topo: TopologyDesc
               ) -> Optional[List[Coord]]:
    """Cells of the box at ``origin``; wraps on wraparound axes, else None if
    the box sticks out of the mesh."""
    wrap = topo.wrap()
    axes: List[List[int]] = []
    for ax, (o, s) in enumerate(zip(origin, shape)):
        dim = topo.mesh[ax]
        if o + s <= dim:
            axes.append(list(range(o, o + s)))
        elif wrap[ax] and s <= dim:
            axes.append([(o + i) % dim for i in range(s)])
        else:
            return None
    return [tuple(c) for c in itertools.product(*axes)]


def box_coords_origins(topo: TopologyDesc):
    """All candidate box origins on the mesh."""
    return itertools.product(*(range(d) for d in topo.mesh))


def _packing_score(cells: Iterable[Coord], free: FrozenSet[Coord],
                   topo: TopologyDesc) -> int:
    """How well a placement packs against occupied cards / mesh walls: count
    neighbor cells outside the box that are NOT free.  Higher = less
    fragmentation left behind (corner-seeking)."""
    cellset = set(cells)
    wrap = topo.wrap()
    score = 0
    for c in cellset:
        for ax in range(len(topo.mesh)):
            for delta in (-1, 1):
                n = list(c)
                n[ax] += delta
                if wrap[ax]:
                    n[ax] %= topo.mesh[ax]
                elif not (0 <= n[ax] < topo.mesh[ax]):
                    score += 1  # mesh wall
                    continue
                nt = tuple(n)
                if nt not in cellset and nt not in free:
                    score += 1  # occupied or unhealthy neighbor
    return score


def find_slice(topo: TopologyDesc, free: Iterable[Coord], n: int,
               policy: str = BEST_EFFORT,
               must: Iterable[Coord] = ()) -> Optional[List[Coord]]:
    """Choose ``n`` cards from ``free``.

    Returns the chosen coords (contiguous slice when possible), or None when
    the request cannot be satisfied under ``policy``.  Placement prefers the
    most compact shape, then the best-packed position, so large future
    requests keep finding contiguous room — the fragmentation concern behind
    the reference's "best ring by non-conflict count" heuristic
    (allocator/default.go via SURVEY C23).

    ``must`` constrains the choice to boxes containing every listed coord —
    the analog of kubelet's must_include_deviceIDs in GetPreferredAllocation.
    """
    freeset = frozenset(free)
    mustset = frozenset(must)
    if n <= 0:
        return []
    if n > len(freeset) or len(mustset) > n or not freeset >= mustset:
        return None

    best: Optional[Tuple[int, List[Coord]]] = None
    for shape in factor_shapes(n, topo.mesh):
        for origin in box_coords_origins(topo):
            cells = box_coords(origin, shape, topo)
            if cells is None or not freeset.issuperset(cells):
                continue
            if mustset and not mustset.issubset(cells):
                continue
            score = _packing_score(cells, freeset, topo)
            if best is None or score > best[0]:
                best = (score, cells)
        if best is not None:
            break  # shapes are ordered most-compact-first; take the first that fits

    if best is not None:
        return best[1]

    if policy == GUARANTEED:
        return None
    if policy == RESTRICTED and factor_shapes(n, topo.mesh):
        # A slice of this size exists on this mesh in principle — refusing to
        # scatter lets the scheduler try another node with contiguous room.
        return None
    # Scattered fallback: pack around existing allocations.
    ranked = sorted(
        freeset - mustset,
        key=lambda c: _packing_score([c], freeset - {c}, topo),
        reverse=True,
    )
    return sorted(mustset) + ranked[: n - len(mustset)]


def find_capacitated_slice(
    topo: TopologyDesc,
    cap: "dict[Coord, int]",
    size: int,
    must: Iterable[Coord] = (),
    policy: str = BEST_EFFORT,
) -> Optional[List[Coord]]:
    """Smallest contiguous box of cards carrying ``size`` capacity units.

    Generalizes :func:`find_slice` to cards with varying capacity (virtual
    devices left per card): the box volume grows from the theoretical minimum
    until one box both fits in the free set (``cap``'s keys) and carries
    enough units.  Under guaranteed/restricted the box volume may not exceed
    ``size`` — every cell must be able to contribute, so a round-robin fill
    uses the WHOLE box and the card-level grant stays contiguous; a larger
    box would leave unused cells and an L-shaped grant.

    Scatter fallback (best-effort, plus restricted for counts that cannot
    form a box on this mesh even when empty) prefers a single fabric
    component: a grant spanning a partitioned fabric cannot communicate
    at all.
    """
    free = frozenset(cap)
    mustset = frozenset(must)
    if size <= 0:
        return []
    if sum(cap.values()) < size or not free >= mustset:
        return None
    max_cap = max(cap.values())
    n_min = max(len(mustset), -(-size // max_cap))  # ceil division
    n_max = len(free)
    if policy in (GUARANTEED, RESTRICTED):
        n_max = min(n_max, size)

    for n in range(n_min, n_max + 1):
        for shape in factor_shapes(n, topo.mesh):
            best = None
            for origin in box_coords_origins(topo):
                cells = box_coords(origin, shape, topo)
                if cells is None:
                    continue
                cellset = set(cells)
                if not cellset.issubset(free):
                    continue
                if not mustset.issubset(cellset):
                    continue
                if sum(cap[c] for c in cells) < size:
                    continue
                score = _packing_score(cells, free, topo)
                if best is None or score > best[0]:
                    best = (score, cells)
            # Shapes are ordered most-compact-first: the first shape with any
            # fit wins (compactness beats wall-packing, like find_slice),
            # position chosen by packing score within it.
            if best is not None:
                return best[1]

    # No usable box.  Restricted keeps find_slice's mesh-impossible escape
    # hatch: when NO candidate volume can form a box on this mesh even empty,
    # the count is structurally slice-less and may scatter; otherwise refuse
    # so the pod can try a less fragmented node.
    if policy == GUARANTEED:
        return None
    if policy == RESTRICTED and any(
        factor_shapes(n, topo.mesh) for n in range(n_min, n_max + 1)
    ):
        return None
    groups = link_groups(topo, free)
    groups.sort(key=lambda g: sum(cap[c] for c in g), reverse=True)
    for g in groups:
        if not mustset.issubset(g):
            continue
        if sum(cap[c] for c in g) < size:
            continue
        ranked = sorted(
            (c for c in g if c not in mustset),
            key=lambda c: _packing_score([c], free - {c}, topo),
            reverse=True,
        )
        out = sorted(mustset)
        for c in ranked:
            if sum(cap[x] for x in out) >= size:
                break
            out.append(c)
        return out
    # Last resort: span components (still better than no preference).
    ranked = sorted(
        (c for c in free if c not in mustset), key=lambda c: cap[c], reverse=True
    )
    out = sorted(mustset)
    for c in ranked:
        if sum(cap[x] for x in out) >= size:
            break
        out.append(c)
    return out if sum(cap[x] for x in out) >= size else None


def exists_slice(topo: TopologyDesc, free: Iterable[Coord], n: int) -> bool:
    """Existence-only contiguity check: is there ANY free box of volume ``n``?

    Early-exits on the first fit with no placement scoring — cheap enough for
    per-health-change sweeps over every slice size (publish_unsatisfiable).
    """
    freeset = frozenset(free)
    if n <= 0:
        return True
    if n > len(freeset):
        return False
    for shape in factor_shapes(n, topo.mesh):
        for origin in box_coords_origins(topo):
            cells = box_coords(origin, shape, topo)
            if cells is not None and freeset.issuperset(cells):
                return True
    return False


def is_contiguous(coords: Sequence[Coord], topo: TopologyDesc) -> bool:
    """True iff ``coords`` is exactly some axis-aligned (possibly wrapped) box."""
    want = sorted(tuple(c) for c in coords)
    n = len(want)
    for shape in factor_shapes(n, topo.mesh):
        for origin in box_coords_origins(topo):
            cells = box_coords(origin, shape, topo)
            if cells is not None and sorted(cells) == want:
                return True
    return False


def link_groups(topo: TopologyDesc, healthy: Iterable[Coord]) -> List[Set[Coord]]:
    """Connected components of the healthy cards' link graph — the analog
    of the reference's MLULink neighbor BFS (cndev/bindings.go:70–119).  A
    dead card can partition a mesh; multi-card grants must come from one
    component."""
    healthyset = set(healthy)
    wrap = topo.wrap()
    seen: Set[Coord] = set()
    groups: List[Set[Coord]] = []
    for start in sorted(healthyset):
        if start in seen:
            continue
        comp: Set[Coord] = set()
        stack = [start]
        while stack:
            c = stack.pop()
            if c in comp:
                continue
            comp.add(c)
            for ax in range(len(topo.mesh)):
                for delta in (-1, 1):
                    nb = list(c)
                    nb[ax] += delta
                    if wrap[ax]:
                        nb[ax] %= topo.mesh[ax]
                    elif not (0 <= nb[ax] < topo.mesh[ax]):
                        continue
                    nbt = tuple(nb)
                    if nbt in healthyset and nbt not in comp:
                        stack.append(nbt)
        seen |= comp
        groups.append(comp)
    return groups
