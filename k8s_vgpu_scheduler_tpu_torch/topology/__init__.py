"""The port's closed-form slice engine over a node's device fabric
(``torus.py``, the JAX package's ``topology/``)."""

from .torus import (
    box_coords,
    factor_shapes,
    find_slice,
    is_contiguous,
    link_groups,
)

__all__ = [
    "box_coords",
    "factor_shapes",
    "find_slice",
    "is_contiguous",
    "link_groups",
]
