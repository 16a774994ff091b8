"""Device-inventory data model of the PyTorch/CUDA port.

The port's copy of the JAX package's ``tpulib/types.py``, the same types
with the same fields (the control plane that consumes them is shared).
Here a *chip* is one GPU, the schedulable physical unit, and the fabric
is the node's NVLink/NVSwitch domain: GPUs behind one NVSwitch reach each
other all to all, so the mesh is one axis of the domain's GPUs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

Coord = Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class TopologyDesc:
    """Shape of the node's device fabric.

    ``mesh`` is the per-host device grid: for GPUs in one NVLink/NVSwitch
    domain, one axis of the domain's GPUs, e.g. (8,) on an HGX H100 board.
    ``wraparound`` marks axes with wrap links.
    """

    generation: str  # e.g. "h100"
    mesh: Tuple[int, ...]
    wraparound: Tuple[bool, ...] = ()

    def __post_init__(self):
        if self.wraparound and len(self.wraparound) != len(self.mesh):
            raise ValueError("wraparound arity must match mesh arity")

    @property
    def num_chips(self) -> int:
        n = 1
        for d in self.mesh:
            n *= d
        return n

    def wrap(self) -> Tuple[bool, ...]:
        return self.wraparound or tuple(False for _ in self.mesh)


@dataclasses.dataclass
class ChipInfo:
    """One physical GPU as seen by the node agent."""

    index: int
    uuid: str
    type: str  # device-type string used by type-affinity filters, e.g. "NVIDIA-h100"
    hbm_mib: int
    coords: Coord
    healthy: bool = True
    cores: int = 100  # compute capacity expressed as a percentage, like SM %
    serial: str = ""
    board: str = ""


@dataclasses.dataclass
class NodeInventory:
    """Everything the node agent reports: devices + fabric shape."""

    chips: List[ChipInfo]
    topology: TopologyDesc

    def chip_by_uuid(self, uuid: str) -> Optional[ChipInfo]:
        for c in self.chips:
            if c.uuid == uuid:
                return c
        return None

    def coord_map(self) -> Dict[Coord, ChipInfo]:
        return {c.coords: c for c in self.chips}

    def healthy_chips(self) -> List[ChipInfo]:
        return [c for c in self.chips if c.healthy]
