"""Elastic mesh resizing of the port (its copy of the JAX package's
``elastic/``): grow and shrink running gangs instead of killing them.

``ranges.py`` holds the pure mesh-range grammar (the webhook's 422
surface and the rung ladder both planners walk); ``controller.py`` holds
the ResizeController that turns mesh shape into a scheduler-managed
variable behind the shared preemption ledger.  Neither imports torch,
grpc or protobuf.
"""

from .ranges import (  # noqa: F401
    MESH_ASSIGNED_ANNOTATION,
    MESH_MAX_ANNOTATION,
    MESH_MIN_ANNOTATION,
    elastic_range_of,
    format_mesh,
    mesh_ladder,
    mesh_range_shapes,
    next_larger,
    next_smaller,
    validate_mesh_range,
)
from .controller import (  # noqa: F401
    ADMISSION_REQUESTER_PREFIX,
    ELASTIC_VALUE_PREFIX,
    ElasticConfig,
    GROW_REQUESTER_PREFIX,
    RECLAIM_SHRINK_PREFIX,
    ResizeController,
    requester_label,
)
