"""Mesh-aware placement of the port (``mesh.py``, the JAX package's
``placement/mesh.py``): ``vtpu.dev/mesh`` logical meshes mapped onto
boxes of a node's fabric, and their admission validation.  The JAX
package's reservations, defragmenter and fragmentation views
(``reserve.py``, ``defrag.py``, ``frag.py``) wait for ROADMAP A.5."""

from .mesh import (
    MESH_ANNOTATION,
    box_availability,
    find_mesh_slice,
    local_mesh_for,
    max_free_box_volume,
    mesh_fits_topology,
    parse_mesh,
    validate_mesh,
)

__all__ = [
    "MESH_ANNOTATION",
    "box_availability",
    "find_mesh_slice",
    "local_mesh_for",
    "max_free_box_volume",
    "mesh_fits_topology",
    "parse_mesh",
    "validate_mesh",
]
