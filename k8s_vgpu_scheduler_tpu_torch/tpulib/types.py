"""Device-inventory data model of the PyTorch/CUDA port.

The port's copy of the JAX package's ``tpulib/types.py``, the same types
with the same fields (the control plane that consumes them is shared),
but for a card's MIG mode and devices (``ChipInfo.mig_enabled``,
``ChipInfo.mig``, :class:`MigDevice`): on
an H100 the hardware splits a card, where the JAX package splits a TPU
chip by its generation.
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
    On a node without a fabric ``NvmlBackend`` sends one axis of its cards
    and no card coordinates.  ``wraparound`` marks axes with wrap links.
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


@dataclasses.dataclass(frozen=True)
class MigDevice:
    """One MIG device of a card, as NVML reports it: its UUID
    (``MIG-...``), its GPU and compute instance slice counts and its
    memory size (``nvmlDeviceGetAttributes_v2``), and the memory a CUDA
    process on it can get (``hbm_mib``: total less reserved, the rule of a
    whole card, ``backend.advertised_mib``)."""

    uuid: str
    slices: int
    compute_slices: int
    memory_mib: int
    hbm_mib: int

    @property
    def profile(self) -> str:
        """The profile name, ``<g>g.<gb>gb`` (``<c>c.<g>g.<gb>gb`` where
        the compute instance holds fewer slices than its GPU instance),
        the memory rounded up to whole GiB.  NVIDIA's device plugin
        (go-nvlib) derives ``<gb>`` from the instance's share of the
        card's memory instead; the two rules agree on the six H100 80GB
        profiles, which a test pins.  On other memory sizes (H100 94GB,
        H200) agreement is not checked."""
        name = f"{self.slices}g.{-(-self.memory_mib // 1024)}gb"
        if self.compute_slices != self.slices:
            name = f"{self.compute_slices}c.{name}"
        return name


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
    # NVML's current MIG mode is on (False where off or not supported).
    # A card with MIG on runs no CUDA context of its own, devices or not.
    mig_enabled: bool = False
    # The card's MIG devices; empty where MIG is off, or on with none made.
    mig: Tuple[MigDevice, ...] = ()

    def __post_init__(self):
        if self.mig and not self.mig_enabled:
            raise ValueError(f"{self.uuid}: MIG devices with MIG off")


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
