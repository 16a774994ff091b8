"""Placement subsystem of the port (its copy of the JAX package's
``placement/``): mesh-aware gang placement and fleet defragmentation via
checkpointed migration.

- mesh.py    — ``vtpu.dev/mesh`` logical meshes mapped onto boxes of a
               node's fabric (axis-realizing placement, admission
               validation);
- frag.py    — contiguous-slice availability over the usage snapshot
               (``vtpu_slice_availability``, the defrag trigger);
- reserve.py — slice reservations: cards held out of the usage for a
               compaction beneficiary;
- defrag.py  — the background compaction loop: demand registry, pure
               planner, checkpoint-first execution.
"""

from .defrag import (
    DEFRAG_REQUESTER_PREFIX,
    Defragmenter,
    DefragConfig,
    DefragPlan,
    plan_compaction,
)
from .frag import (
    CANONICAL_SIZES,
    NodeFreeView,
    fleet_views,
    largest_free_box,
    node_free_view,
    slice_availability,
)
from .mesh import (
    MESH_ANNOTATION,
    assign_axes,
    find_mesh_slice,
    local_mesh_for,
    max_free_box_volume,
    mesh_box_shapes,
    mesh_fits_topology,
    mesh_volume,
    parse_mesh,
    validate_mesh,
)
from .reserve import SliceReservation, SliceReservations

__all__ = [
    "CANONICAL_SIZES",
    "DEFRAG_REQUESTER_PREFIX",
    "Defragmenter",
    "DefragConfig",
    "DefragPlan",
    "MESH_ANNOTATION",
    "NodeFreeView",
    "SliceReservation",
    "SliceReservations",
    "assign_axes",
    "find_mesh_slice",
    "fleet_views",
    "largest_free_box",
    "local_mesh_for",
    "max_free_box_volume",
    "mesh_box_shapes",
    "mesh_fits_topology",
    "mesh_volume",
    "node_free_view",
    "parse_mesh",
    "plan_compaction",
    "slice_availability",
    "validate_mesh",
]
