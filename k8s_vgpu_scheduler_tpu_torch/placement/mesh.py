"""Logical device meshes mapped onto boxes of a node's fabric (the port's
copy of the JAX package's ``placement/mesh.py``).

A job that declares a named mesh (``batch`` x ``model``) runs a collective
along each axis every step, so the placement question is not "n
contiguous cards" (topology/torus.py's contract) but "a box whose axes
realize the logical mesh": each logical axis must map onto a product of
distinct physical axes, the way a device grid is folded onto the fabric.
A 2x4 mesh on an (8,) line has the right volume and is contiguous, yet
one of its axes would hop cards at stride 4.

Pods declare the mesh with ``vtpu.dev/mesh: "2x4"`` (row-major, axis 0
outermost, the data axis).  Two scopes:

- **single pod**: mesh volume == the pod's card request; the whole mesh
  must land on one axis-realizing box of one node's fabric;
- **gang member** (``vtpu.dev/pod-group``): mesh volume == the gang's
  total cards; axis 0 divides across the members and each member's local
  mesh must land inside one node's fabric (the webhook passes the gang's
  total, Filter places each member's local mesh).

Everything here is pure math over coordinates: no scheduler state, no
locks, no torch, grpc or protobuf.  Filter and the webhook call the same
functions.  The JAX module's shaped-box availability helpers serve its
defragmenter and wait with it (ROADMAP A.5).
"""

from __future__ import annotations

from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence, Tuple

from ..topology.torus import (
    _packing_score,
    box_coords,
    box_coords_origins,
    factor_shapes,
)
from ..tpulib.types import Coord, TopologyDesc
# The pod annotation declaring the logical device mesh, e.g. "2x4" or
# "2x2x2" (row-major, axis 0 outermost): validated at admission
# (scheduler/webhook.py) and honored by fit_container.
from ..util.types import MESH_ANNOTATION  # noqa: F401


def parse_mesh(value: str) -> Tuple[int, ...]:
    """``"2x4"`` → ``(2, 4)``.  Raises ValueError with a user-facing
    message (the webhook puts it verbatim in the AdmissionReview
    rejection)."""
    parts = [p.strip() for p in str(value).lower().split("x")]
    if not parts or any(not p for p in parts):
        raise ValueError(f"mesh {value!r} must look like '2x4'")
    try:
        dims = tuple(int(p) for p in parts)
    except ValueError:
        raise ValueError(
            f"mesh {value!r} must be 'x'-separated integers") from None
    if any(d < 1 for d in dims):
        raise ValueError(f"mesh {value!r} axes must be >= 1")
    if len(dims) > 4:
        raise ValueError(f"mesh {value!r} has too many axes (max 4)")
    return dims


def mesh_volume(mesh: Sequence[int]) -> int:
    v = 1
    for d in mesh:
        v *= d
    return v


def assign_axes(mesh: Sequence[int],
                box: Sequence[int]) -> Optional[List[List[int]]]:
    """Map logical mesh axes onto physical box axes.

    Returns, per logical axis, the list of physical axis indices whose
    dims multiply to that logical dim (every physical axis used exactly
    once, size-1 physical axes attachable anywhere) — or None when no
    assignment exists.  This is the mesh-fit predicate: a box passing it
    can host the mesh with each logical axis living on whole fabric axes
    (``mesh_utils``-style folding), so axis collectives ride neighbor
    links only.
    """
    mesh = [d for d in mesh]
    n_phys = len(box)

    def rec(li: int, used: FrozenSet[int]) -> Optional[List[List[int]]]:
        if li == len(mesh):
            # Every non-trivial physical axis must be consumed (a spare
            # axis of size > 1 means the box's volume exceeds the mesh).
            if all(i in used or box[i] == 1 for i in range(n_phys)):
                return []
            return None

        def pick(target: int, start: int, used: FrozenSet[int],
                 acc: Tuple[int, ...]):
            if target == 1:
                rest = rec(li + 1, used)
                if rest is not None:
                    return [list(acc)] + rest
                return None
            for i in range(start, n_phys):
                if i in used or box[i] == 1:
                    continue
                if target % box[i] == 0:
                    got = pick(target // box[i], i + 1, used | {i},
                               acc + (i,))
                    if got is not None:
                        return got
            return None

        return pick(mesh[li], 0, used, ())

    return rec(0, frozenset())


def mesh_box_shapes(mesh: Sequence[int],
                    topo_mesh: Sequence[int]) -> List[Tuple[int, ...]]:
    """Physical box shapes (inside ``topo_mesh``) that realize ``mesh``,
    most compact first — factor_shapes' deterministic order filtered by
    the axis-assignment predicate."""
    n = mesh_volume(mesh)
    return [s for s in factor_shapes(n, topo_mesh)
            if assign_axes(mesh, s) is not None]


def local_mesh_for(mesh: Sequence[int], nums: int
                   ) -> Tuple[Optional[Tuple[int, ...]], str]:
    """The per-pod (fabric-local) mesh for a pod requesting ``nums`` chips
    under a declared ``mesh``.  Returns ``(local_shape, "")`` or
    ``(None, reason)``.

    - volume == nums: single-pod mesh; local shape is the mesh itself.
    - volume == N × nums with mesh[0] % N == 0: a gang of N members
      splits axis 0 over DCN; the local shape is the member's stripe
      ``(mesh[0]//N, *mesh[1:])`` (a stripe of 1 drops the DCN axis —
      the remaining axes are the fabric-local mesh that must stay inside
      one slice).
    """
    vol = mesh_volume(mesh)
    if nums <= 0:
        return None, "mesh requires a positive chip request"
    if vol == nums:
        return tuple(mesh), ""
    if vol % nums != 0:
        return None, (f"mesh volume {vol} is not a multiple of the "
                      f"per-pod chip request {nums}")
    members = vol // nums
    if mesh[0] % members != 0:
        return None, (f"mesh axis 0 ({mesh[0]}) does not divide across "
                      f"{members} gang members")
    stripe = mesh[0] // members
    local = (stripe,) + tuple(mesh[1:])
    if stripe == 1 and len(local) > 1:
        local = tuple(mesh[1:])
    return local, ""


def find_mesh_slice(topo: TopologyDesc, free: Iterable[Coord],
                    mesh: Sequence[int]) -> Optional[List[Coord]]:
    """Choose a physical box realizing ``mesh`` out of ``free``.

    Placement is fragmentation-aware: among positions of the most
    compact realizing shape, prefer the one whose REMAINING free set
    keeps the largest contiguous box (the defragmenter's currency), then
    the torus packing score (hug occupied cells and walls).  Returns the
    box's coords, or None when no realizing box fits — deliberately no
    policy parameter: a mesh is a contiguity CONTRACT, so unlike plain
    ``find_slice`` there is no scattered fallback under ANY topology
    policy (the pod asked for axis structure, not just chips).
    """
    freeset = frozenset(free)
    n = mesh_volume(mesh)
    if n == 0:
        return []
    if n > len(freeset):
        return None
    best: Optional[Tuple[Tuple[int, int], List[Coord]]] = None
    for shape in mesh_box_shapes(mesh, topo.mesh):
        for origin in box_coords_origins(topo):
            cells = box_coords(origin, shape, topo)
            if cells is None or not freeset.issuperset(cells):
                continue
            rest = freeset - set(cells)
            key = (max_free_box_volume(topo, rest),
                   _packing_score(cells, freeset, topo))
            if best is None or key > best[0]:
                best = (key, cells)
        if best is not None:
            break  # shapes are most-compact-first, same rule as find_slice
    return best[1] if best is not None else None


def mesh_fits_topology(mesh: Sequence[int], topo: TopologyDesc,
                       nums: Optional[int] = None) -> bool:
    """Can SOME box on an EMPTY ``topo`` realize the pod's local mesh?
    The webhook's fleet-feasibility check (``nums`` = the pod's chip
    request; None = treat the whole mesh as local)."""
    local = tuple(mesh)
    if nums is not None:
        got, _why = local_mesh_for(mesh, nums)
        if got is None:
            return False
        local = got
    return bool(mesh_box_shapes(local, topo.mesh))


def max_free_box_volume(topo: TopologyDesc,
                        free: FrozenSet[Coord]) -> int:
    """Volume of the largest contiguous axis-aligned box inside ``free``
    — the fragmentation currency: the defragmenter moves victims to make
    this number grow, and mesh placement avoids shrinking it.

    Walks candidate volumes largest-first; for each, the first shape ×
    origin hit wins (existence only, no scoring), so the common case —
    a mostly-free mesh — exits on the first probe.
    """
    nfree = len(free)
    if nfree == 0:
        return 0
    for n in range(nfree, 0, -1):
        for shape in factor_shapes(n, topo.mesh):
            for origin in box_coords_origins(topo):
                cells = box_coords(origin, shape, topo)
                if cells is not None and free.issuperset(cells):
                    return n
    return 0


def box_availability(topo: TopologyDesc, free: FrozenSet[Coord],
                     sizes: Iterable[int]) -> Dict[int, int]:
    """How many DISJOINT free boxes of each volume fit right now —
    greedy count with the same placement preference as find_slice, so
    the number answers "how many n-chip slice grants could be admitted
    back to back".  Feeds ``vtpu_slice_availability`` and the
    defragmenter's blocked-demand check."""
    out: Dict[int, int] = {}
    for n in sizes:
        remaining = set(free)
        count = 0
        while len(remaining) >= n:
            got = _first_box(topo, remaining, n)
            if got is None:
                break
            count += 1
            remaining -= set(got)
        out[n] = count
    return out


def _first_box(topo: TopologyDesc, free: Iterable[Coord],
               n: int) -> Optional[List[Coord]]:
    return _first_shaped_box(topo, free, factor_shapes(n, topo.mesh))


def _first_shaped_box(topo: TopologyDesc, free: Iterable[Coord],
                      shapes: Sequence[Tuple[int, ...]]
                      ) -> Optional[List[Coord]]:
    freeset = frozenset(free)
    for shape in shapes:
        for origin in box_coords_origins(topo):
            cells = box_coords(origin, shape, topo)
            if cells is not None and freeset.issuperset(cells):
                return cells
    return None


def validate_mesh(value: str, nums: int, gang_total: int,
                  topologies: Iterable[TopologyDesc]) -> Optional[str]:
    """Admission-time validation of the ``vtpu.dev/mesh`` annotation.
    Returns a user-facing rejection message, or None when valid.

    Checks, in order: the shape parses; the volume matches the request
    (``nums`` chips, times ``gang_total`` members when gang-scoped, with
    axis 0 dividing across the members); and the per-pod local mesh is
    realizable on at least one node topology in the fleet (an empty
    fleet skips this check — admission must not reject the first pod of
    a cold-booting cluster for lacking inventory).
    """
    try:
        mesh = parse_mesh(value)
    except ValueError as e:
        return str(e)
    if nums <= 0:
        return (f"mesh {value!r} declared but the pod requests no GPU "
                "chips")
    vol = mesh_volume(mesh)
    total = max(1, gang_total)
    if vol != nums * total:
        if total > 1:
            return (f"mesh {value!r} has volume {vol} but the gang "
                    f"requests {nums} chip(s) × {total} members = "
                    f"{nums * total}")
        return (f"mesh {value!r} has volume {vol} but the pod requests "
                f"{nums} chip(s)")
    local, why = local_mesh_for(mesh, nums)
    if local is None:
        return f"mesh {value!r}: {why}"
    topos = [t for t in topologies if t is not None]
    if topos and not any(mesh_fits_topology(local, t) for t in topos):
        shapes = sorted({t.mesh for t in topos})
        return (f"mesh {value!r}: per-pod local mesh "
                f"{'x'.join(map(str, local))} fits no node topology in "
                f"the fleet (meshes: "
                f"{', '.join('x'.join(map(str, m)) for m in shapes)})")
    return None
