"""Elastic mesh ranges: the pure shape grammar under resize (the port's
copy of the JAX package's ``elastic/ranges.py``).

A pod opts its gang into elastic resizing by declaring a mesh *range*
alongside the usual ``vtpu.dev/mesh``::

    vtpu.dev/mesh:      4x8      # the CURRENT shape (admission target)
    vtpu.dev/mesh-min:  2x2      # never shrink below this
    vtpu.dev/mesh-max:  4x8      # never grow past this

The range spans a discrete **ladder** of rungs, enumerated per axis:
``min`` is right-padded with 1s to ``max``'s rank, and axis ``i`` may
take any size ``s`` with ``min_i | s``, ``s | max_i`` and
``min_i <= s <= max_i``: divisor steps, so every rung folds the way a
device mesh reshapes (halving or doubling an axis), never through shapes
the axis assignment cannot realize.  A rung is *valid* when its volume is
a whole number of gang members (``volume % nums == 0``), the per-member
stripe exists (:func:`local_mesh_for`), and at least one fleet topology
can realize the member-local mesh: the same cold-boot rule as
:func:`validate_mesh`, so an empty fleet skips the fold check rather than
rejecting the first pod of a bootstrapping cluster.

Resizing a gang means re-admitting it at another rung: the member count
becomes ``volume // nums`` (per-member cards never change: the
container's resource limits are immutable), so the scheduler writes the
chosen rung to ``vtpu.dev/mesh-assigned`` and the workload controller
recreates the gang at that shape (new ``vtpu.dev/mesh`` and
``pod-group-total``), resuming from the checkpoint.  The mechanics live
in :mod:`.controller`; this module is pure shape math and imports no
torch, grpc or protobuf.
"""

from __future__ import annotations

import itertools
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from ..placement.mesh import (
    MESH_ANNOTATION,
    local_mesh_for,
    mesh_fits_topology,
    mesh_volume,
    parse_mesh,
)
from ..util.types import (
    MESH_ASSIGNED_ANNOTATION,
    MESH_MAX_ANNOTATION,
    MESH_MIN_ANNOTATION,
)

__all__ = [
    "MESH_ASSIGNED_ANNOTATION",
    "MESH_MAX_ANNOTATION",
    "MESH_MIN_ANNOTATION",
    "elastic_range_of",
    "format_mesh",
    "mesh_ladder",
    "mesh_range_shapes",
    "next_larger",
    "next_smaller",
    "validate_mesh_range",
]


def format_mesh(shape: Sequence[int]) -> str:
    """``(2, 4)`` → ``"2x4"``: the annotation spelling."""
    return "x".join(str(d) for d in shape)


def mesh_range_shapes(min_mesh: Sequence[int],
                      max_mesh: Sequence[int]) -> List[Tuple[int, ...]]:
    """Every shape in the range grammar (no fleet or gang filtering),
    largest volume first with a deterministic axis-lexicographic
    tie-break.  Empty when the grammar admits nothing (an axis where no
    multiple of ``min_i`` divides ``max_i``)."""
    if len(min_mesh) > len(max_mesh):
        return []
    lo = tuple(min_mesh) + (1,) * (len(max_mesh) - len(min_mesh))
    per_axis: List[List[int]] = []
    for lo_i, hi_i in zip(lo, max_mesh):
        opts = [s for s in range(lo_i, hi_i + 1)
                if hi_i % s == 0 and s % lo_i == 0]
        if not opts:
            return []
        per_axis.append(opts)
    shapes = [tuple(s) for s in itertools.product(*per_axis)]
    shapes.sort(key=lambda s: (-mesh_volume(s), tuple(-d for d in s)))
    return shapes


def mesh_ladder(min_mesh: Sequence[int], max_mesh: Sequence[int],
                nums: int, topologies: Iterable) -> List[Tuple[int, ...]]:
    """The VALID rungs of the range, largest first: grammar shapes whose
    volume is a whole member count, whose member-local stripe exists,
    and that fold onto at least one known topology (skipped when the
    fleet is empty: the webhook's cold-boot rule)."""
    topos = list(topologies)
    rungs: List[Tuple[int, ...]] = []
    for shape in mesh_range_shapes(min_mesh, max_mesh):
        if nums <= 0 or mesh_volume(shape) % nums != 0:
            continue
        local, _why = local_mesh_for(shape, nums)
        if local is None:
            continue
        if topos and not any(mesh_fits_topology(shape, t, nums)
                             for t in topos):
            continue
        rungs.append(shape)
    return rungs


def next_smaller(ladder: Sequence[Tuple[int, ...]],
                 current: Sequence[int]) -> Optional[Tuple[int, ...]]:
    """The next rung DOWN from ``current``: the largest-volume valid
    shape strictly smaller than it (the ladder is volume-descending, so
    the first such entry)."""
    vol = mesh_volume(current)
    for shape in ladder:
        if mesh_volume(shape) < vol:
            return shape
    return None


def next_larger(ladder: Sequence[Tuple[int, ...]],
                current: Sequence[int]) -> Optional[Tuple[int, ...]]:
    """The next rung UP from ``current``: the smallest-volume valid
    shape strictly larger than it (growth is one rung at a time; the
    hysteresis window paces successive steps)."""
    vol = mesh_volume(current)
    for shape in reversed(ladder):
        if mesh_volume(shape) > vol:
            return shape
    return None


def elastic_range_of(annotations: Dict[str, str]
                     ) -> Optional[Tuple[str, str]]:
    """The raw (min, max) annotation values when EITHER is present (the
    caller validates); ``None`` means the pod is not elastic."""
    mn = annotations.get(MESH_MIN_ANNOTATION, "")
    mx = annotations.get(MESH_MAX_ANNOTATION, "")
    if not mn and not mx:
        return None
    return mn, mx


def validate_mesh_range(min_value: str, max_value: str, mesh_value: str,
                        nums: int, gang_total: int,
                        topologies: Iterable) -> Optional[str]:
    """Admission-time validation of an elastic mesh range.  Returns a
    user-facing rejection message (the webhook's 422 body), or None
    when valid.  Callers invoke this only when at least one range
    annotation is present: a bare ``vtpu.dev/mesh`` never reaches
    here, so a mesh without a range stays exactly as it was.

    Checks, in order: both bounds present; both parse; the pod is a
    gang member (a single pod has no member count to vary); it requests
    cards; a current ``vtpu.dev/mesh`` is declared; min does not exceed
    max (axis rank and volume); the grammar and the fleet leave at least
    one valid rung; and the current mesh IS one of those rungs (the
    resize protocol only ever moves the gang between rungs, so it must
    start on one).  The messages are the JAX package's, "GPU" for "TPU".
    """
    if not min_value or not max_value:
        present, missing = (
            (MESH_MIN_ANNOTATION, MESH_MAX_ANNOTATION) if min_value
            else (MESH_MAX_ANNOTATION, MESH_MIN_ANNOTATION))
        return (f"{present} declared without {missing}: an elastic range "
                "needs both bounds")
    try:
        mn = parse_mesh(min_value)
    except ValueError as e:
        return f"{MESH_MIN_ANNOTATION}: {e}"
    try:
        mx = parse_mesh(max_value)
    except ValueError as e:
        return f"{MESH_MAX_ANNOTATION}: {e}"
    if gang_total < 1:
        # total == 1 is a legitimate resize endpoint (a fully-shrunk
        # generation whose rung is one member's worth of cards); only a
        # pod with NO gang membership has no member count to vary.
        return (f"{MESH_MIN_ANNOTATION}/{MESH_MAX_ANNOTATION} declared on "
                "a non-gang pod: elastic resize re-admits the gang at a "
                "new member count, so the pod must declare "
                "vtpu.dev/pod-group membership")
    if nums <= 0:
        return (f"{MESH_MIN_ANNOTATION} declared but the pod requests no "
                "GPU chips")
    if not mesh_value:
        return (f"{MESH_MIN_ANNOTATION}/{MESH_MAX_ANNOTATION} declared "
                f"without {MESH_ANNOTATION}: the range needs a current "
                "shape to admit at")
    try:
        cur = parse_mesh(mesh_value)
    except ValueError:
        # validate_mesh already rejects the malformed current mesh with
        # its own message; do not double-report.
        return None
    if len(mn) > len(mx):
        return (f"{MESH_MIN_ANNOTATION} {min_value!r} has more axes than "
                f"{MESH_MAX_ANNOTATION} {max_value!r}")
    if mesh_volume(mn) > mesh_volume(mx):
        return (f"{MESH_MIN_ANNOTATION} {min_value!r} (volume "
                f"{mesh_volume(mn)}) exceeds {MESH_MAX_ANNOTATION} "
                f"{max_value!r} (volume {mesh_volume(mx)})")
    ladder = mesh_ladder(mn, mx, nums, topologies)
    if not ladder:
        return (f"no valid mesh shape exists between {min_value!r} and "
                f"{max_value!r}: no rung has a whole member count at "
                f"{nums} chip(s)/pod and folds onto a known topology")
    if tuple(cur) not in ladder:
        rungs = ", ".join(format_mesh(s) for s in ladder)
        return (f"{MESH_ANNOTATION} {mesh_value!r} is not a valid rung of "
                f"the declared range (valid: {rungs})")
    return None
