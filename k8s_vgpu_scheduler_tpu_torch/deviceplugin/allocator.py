"""Topology-aware preferred allocation: kubelet's placement path (the
port's copy of the JAX package's ``deviceplugin/allocator.py``).

The reference's counterpart is its MLU topology allocators
(pkg/device-plugin/mlu/allocator/{allocator,default,spider,board}.go) and
the ``GetPreferredAllocation`` server path (pkg/device-plugin/mlu/
server.go:441–491).  There are two placement paths, as in the reference:

- the extender path: the scheduler's Filter picks the cards and Allocate
  obeys the annotations; it serves fractional and managed requests;
- this kubelet path: a pod that asks for whole cards through the plain
  device-plugin resource is packed by kubelet's ``GetPreferredAllocation``
  call, without the extender.

Under a ``restricted`` or ``guaranteed`` policy the card counts that
cannot form a contiguous slice now are published as a node annotation,
the reference's "MLULink policy unsatisfiable" annotation
(server.go:493–522): advisory, for kubelet-path consumers; Filter runs the
same slice search per node with live usage.

**A node without a fabric.**  ``tpulib.backend.NvmlBackend`` gives every
card ``coords=()`` on a ``mesh=(n,)`` where NVML's NVLink matrix does not
show every pair of cards connected (PCIe only, bridged pairs among more
than two cards, P2P not supported): the JAX engine's form for coordinates
missing.  ``NodeInventory.coord_map()`` keys cards by their coordinates,
so there it would collapse to one card.  So where any card lacks
coordinates, or two share them, :meth:`SliceAllocator.preferred` answers
``[]`` and kubelet chooses for itself.  :func:`unsatisfiable_sizes` is
the JAX function: no box of the mesh is free there, so under
``restricted`` and ``guaranteed`` it names every count from 1 to the
healthy cards, a single card included.

No torch, grpc or protobuf.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence

from ..topology import torus
from ..tpulib.types import ChipInfo, Coord, NodeInventory
from ..util.types import BEST_EFFORT, GUARANTEED, RESTRICTED

log = logging.getLogger(__name__)

# Node annotation listing the card counts this node could not place
# contiguously under a restricted or guaranteed policy (reference
# server.go:493–522).
UNSATISFIABLE_ANNOTATION = "vtpu.dev/ici-unsatisfiable-sizes"


def has_fabric(inventory: NodeInventory) -> bool:
    """Whether every card sits at a coordinate of its own, so that
    ``coord_map()`` keys each card."""
    coords = [c.coords for c in inventory.chips]
    return () not in coords and len(set(coords)) == len(coords)


class SliceAllocator:
    """Chooses virtual device IDs whose cards form a slice of the fabric.

    Virtual IDs are ``<card-uuid>-<k>`` (the apiDevices fan-out); the
    allocator packs a request onto as few cards as it can, those cards
    forming a contiguous axis-aligned slice wherever the policy or the
    capacity allows.
    """

    def __init__(self, inventory: NodeInventory, policy: str = BEST_EFFORT):
        self.inventory = inventory
        self.policy = policy

    def _chips_by_vid(self, vids: Sequence[str]) -> Dict[str, List[str]]:
        """uuid -> its available virtual IDs (input order kept)."""
        by_chip: Dict[str, List[str]] = {}
        for vid in vids:
            uuid = vid.rsplit("-", 1)[0]
            by_chip.setdefault(uuid, []).append(vid)
        return by_chip

    def preferred(
        self,
        available: Sequence[str],
        must_include: Sequence[str],
        size: int,
    ) -> List[str]:
        """Pick ``size`` IDs from ``available`` that include
        ``must_include``.

        Returns [] where no valid preference exists (kubelet then makes
        its own choice), the reference's empty-answer path
        (server.go:455–466), and on a node without a fabric.
        """
        if size <= 0:
            return []
        if not has_fabric(self.inventory):
            return []
        avail_by_chip = self._chips_by_vid(available)
        must_by_chip = self._chips_by_vid(must_include)
        if len(must_include) > size:
            return []

        chip_by_uuid = {c.uuid: c for c in self.inventory.chips}

        # Free: cards offering at least one available ID and healthy.  A
        # card in `available` but unhealthy here (its health flipped since
        # kubelet's last ListAndWatch) is left out.
        free_coords: Dict[Coord, ChipInfo] = {}
        for uuid in avail_by_chip:
            chip = chip_by_uuid.get(uuid)
            if chip is not None and chip.healthy:
                free_coords[chip.coords] = chip
        must_coords = []
        for uuid in must_by_chip:
            chip = chip_by_uuid.get(uuid)
            if chip is None or chip.coords not in free_coords:
                return []  # a must-include card unknown or unhealthy
            must_coords.append(chip.coords)

        cap = {
            c: len(avail_by_chip.get(chip.uuid, ()))
            for c, chip in free_coords.items()
        }
        cells = torus.find_capacitated_slice(
            self.inventory.topology, cap, size, must_coords, self.policy
        )
        if cells is None:
            return []

        # Round-robin across the chosen cells (must-include IDs first):
        # every cell contributes, so where the engine returned a box the
        # card-level grant is that box, contiguous as guaranteed demands.
        chosen: List[str] = list(must_include)
        taken = set(chosen)
        queues = []
        for coord in cells:
            vids = [
                v
                for v in avail_by_chip.get(free_coords[coord].uuid, [])
                if v not in taken
            ]
            if vids:
                queues.append(vids)
        while len(chosen) < size and queues:
            next_round = []
            for q in queues:
                if len(chosen) >= size:
                    break
                chosen.append(q.pop(0))
                if q:
                    next_round.append(q)
            queues = next_round
        return chosen if len(chosen) >= size else []


def unsatisfiable_sizes(inventory: NodeInventory, policy: str = GUARANTEED,
                        max_size: Optional[int] = None) -> List[int]:
    """Card counts (1 to the healthy cards) this node cannot place now
    under ``policy``, for the advisory node annotation (reference
    server.go:493–522).  Restricted tolerates counts that cannot form a
    box on this mesh even when it is empty (they may scatter); guaranteed
    does not."""
    healthy = [c.coords for c in inventory.healthy_chips()]
    limit = max_size or len(healthy)
    topo = inventory.topology
    out = []
    for n in range(1, limit + 1):
        if torus.exists_slice(topo, healthy, n):
            continue
        if policy == RESTRICTED and not torus.factor_shapes(n, topo.mesh):
            continue  # a count no box of the mesh has: restricted scatters it
        out.append(n)
    return out


def publish_unsatisfiable(client, node_name: str, inventory: NodeInventory,
                          policy: str) -> None:
    """Keep the unsatisfiable-sizes node annotation in step (empty:
    removed)."""
    if policy not in (GUARANTEED, RESTRICTED):
        sizes: List[int] = []
    else:
        sizes = unsatisfiable_sizes(inventory, policy)
    value = ",".join(str(s) for s in sizes)
    try:
        client.patch_node_annotations(
            node_name, {UNSATISFIABLE_ANNOTATION: value or None}
        )
    except Exception:  # noqa: BLE001 — the annotation is advisory
        log.exception("failed to publish unsatisfiable sizes on %s", node_name)
