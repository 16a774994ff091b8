"""Device-enumeration backends of the PyTorch/CUDA port.

The port's counterpart of the JAX package's ``tpulib/backend.py``, with
the reference's cornerstone test pattern: a *fake native backend driven by
a JSON fixture* (mock/cndev.c reads ``$MOCK_JSON`` — SURVEY.md §4, N5).

- :class:`MockBackend` reads a JSON fixture (``$VTPU_MOCK_JSON`` or an
  inline dict) describing devices, memory sizes, fabric shape and health,
  in the JAX backend's schema.  :data:`H100_FIXTURE` is an HGX H100 node.
- :class:`TorchBackend` enumerates the real cards through
  ``torch.cuda.get_device_properties``.

``detect()`` picks the mock when ``$VTPU_MOCK_JSON`` is set, else the real
cards; with neither it raises.
"""

from __future__ import annotations

import json
import logging
import os
from itertools import product
from typing import Optional

from .types import ChipInfo, NodeInventory, TopologyDesc

log = logging.getLogger(__name__)

MOCK_ENV = "VTPU_MOCK_JSON"

# A fixture's defaults: an H100 and the memory its driver reports,
# 85,017,493,504 bytes (81,079 MiB) on an H100 80GB HBM3 (chip_smoke.py's
# inventory), not the 80 GiB of its name.
DEFAULT_GENERATION = "h100"
DEFAULT_HBM_MIB = 81079

# An HGX H100 node: eight H100 80GB HBM3 cards in one NVLink/NVSwitch
# domain.
H100_FIXTURE = {"generation": "h100", "mesh": [8], "hbm_mib": DEFAULT_HBM_MIB}


class Backend:
    """Device-discovery interface (reference ResourceManager, nvidia.go:46–49)."""

    def inventory(self) -> NodeInventory:
        raise NotImplementedError

    def refresh_health(self, inv: NodeInventory) -> bool:
        """Re-check health in place; return True if anything changed."""
        return False


class MockBackend(Backend):
    """JSON-fixture backend (reference mock/cndev.c:22–220).

    Fixture schema (the JAX backend's)::

        {
          "generation": "h100",
          "mesh": [8],
          "wraparound": [false],
          "hbm_mib": 81079,              # default per device
          "chips": [                      # optional; defaults to full mesh
            {"coords": [0], "uuid": "...", "healthy": true,
             "hbm_mib": 81079, "type": "NVIDIA-h100"},
            ...
          ]
        }
    """

    def __init__(self, fixture: Optional[dict] = None, path: Optional[str] = None):
        self.path = None
        if fixture is None:
            path = path or os.environ.get(MOCK_ENV)
            if not path:
                raise ValueError(f"MockBackend needs a fixture dict or ${MOCK_ENV}")
            self.path = path
            with open(path) as f:
                fixture = json.load(f)
        self.fixture = fixture

    def inventory(self) -> NodeInventory:
        fx = self.fixture
        gen = fx.get("generation", DEFAULT_GENERATION)
        mesh = tuple(fx.get("mesh", [1]))
        topo = TopologyDesc(
            generation=gen,
            mesh=mesh,
            wraparound=tuple(fx.get("wraparound", [])) or (),
        )
        default_hbm = int(fx.get("hbm_mib", DEFAULT_HBM_MIB))
        chips = []
        if "chips" in fx:
            for i, c in enumerate(fx["chips"]):
                chips.append(
                    ChipInfo(
                        index=i,
                        uuid=c.get("uuid", f"GPU-{gen}-mock-{i}"),
                        type=c.get("type", f"NVIDIA-{gen}"),
                        hbm_mib=int(c.get("hbm_mib", default_hbm)),
                        coords=tuple(c["coords"]),
                        healthy=bool(c.get("healthy", True)),
                        serial=c.get("serial", f"SN{i:04d}"),
                        board=c.get("board", "mock-board"),
                    )
                )
        else:
            for i, coords in enumerate(product(*(range(d) for d in mesh))):
                chips.append(
                    ChipInfo(
                        index=i,
                        uuid=f"GPU-{gen}-mock-{i}",
                        type=f"NVIDIA-{gen}",
                        hbm_mib=default_hbm,
                        coords=coords,
                        serial=f"SN{i:04d}",
                        board="mock-board",
                    )
                )
        return NodeInventory(chips=chips, topology=topo)

    def refresh_health(self, inv: NodeInventory) -> bool:
        """Re-read the fixture (tests mutate ``self.fixture``; multi-process
        drives rewrite the fixture *file* — fault injection, reference
        mock/cndev.c:52–64) and apply health flags by coords."""
        if self.path:
            try:
                with open(self.path) as f:
                    self.fixture = json.load(f)
            except (OSError, json.JSONDecodeError):
                pass  # transient rewrite; keep last good fixture
        changed = False
        by_coords = {tuple(c.get("coords", ())): c for c in self.fixture.get("chips", [])}
        for chip in inv.chips:
            want = bool(by_coords.get(chip.coords, {}).get("healthy", True))
            if chip.healthy != want:
                chip.healthy = want
                changed = True
        return changed


class TorchBackend(Backend):
    """The real cards, through ``torch.cuda.get_device_properties``: name,
    total memory, UUID and SM count.  All visible cards are taken as one
    NVLink/NVSwitch domain (coordinates along one axis)."""

    def inventory(self) -> NodeInventory:
        import torch  # deferred: the control plane must not need torch

        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("no CUDA devices visible to torch")
        chips = []
        for i in range(n):
            p = torch.cuda.get_device_properties(i)
            chips.append(
                ChipInfo(
                    index=i,
                    uuid=device_uuid(p),
                    type=f"NVIDIA-{normalize_kind(p.name)}",
                    hbm_mib=p.total_memory // (1 << 20),
                    coords=(i,),
                    board=f"{p.name}, {p.multi_processor_count} SMs",
                )
            )
        gen = normalize_kind(torch.cuda.get_device_properties(0).name)
        return NodeInventory(chips=chips,
                             topology=TopologyDesc(generation=gen, mesh=(n,)))


def device_uuid(props) -> str:
    """A card's UUID as nvidia-smi and NVIDIA_VISIBLE_DEVICES write it
    (``GPU-`` and the 36-character UUID)."""
    u = str(props.uuid)
    return u if u.startswith("GPU-") else f"GPU-{u}"


def normalize_kind(name: str) -> str:
    """The generation in a card's name ("NVIDIA H100 80GB HBM3" -> "h100")."""
    k = name.lower()
    for gen in ("h200", "h100", "h800", "a100", "a800", "l40s", "b200"):
        if gen in k:
            return gen
    return k.replace("nvidia ", "").replace(" ", "-")


def detect() -> Backend:
    """The mock if $VTPU_MOCK_JSON is set, else the real cards; raises
    when there are none."""
    if os.environ.get(MOCK_ENV):
        log.info("using MockBackend fixture %s", os.environ[MOCK_ENV])
        return MockBackend()
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device is visible; set ${MOCK_ENV} to a fixture file "
            "to run against MockBackend")
    return TorchBackend()
