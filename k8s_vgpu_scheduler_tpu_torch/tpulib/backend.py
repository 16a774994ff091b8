"""Device-enumeration backends of the PyTorch/CUDA port.

The port's counterpart of the JAX package's ``tpulib/backend.py``, with
the reference's cornerstone test pattern: a *fake native backend driven by
a JSON fixture* (mock/cndev.c reads ``$MOCK_JSON`` — SURVEY.md §4, N5).

- :class:`MockBackend` reads a JSON fixture (``$VTPU_MOCK_JSON`` or an
  inline dict) describing devices, memory sizes, fabric shape and health,
  in the JAX backend's schema.  :data:`H100_FIXTURE` is an HGX H100 node.
- :class:`NvmlBackend` enumerates the real cards through NVML
  (``tpulib/nvml.py``), the counterpart of the JAX package's
  ``SysfsBackend``: it opens no CUDA context, so the node agent holds none
  of a card's memory and is no compute process on it.  It reads the
  node's fabric from NVML's NVLink peer-to-peer matrix (:meth:`NvmlBackend.
  fabric`), not from the cards' order.
- :class:`TorchBackend` enumerates the real cards through
  ``torch.cuda.get_device_properties``, which creates a context on each
  (chip_smoke.py holds NVML's inventory to it).

``detect()`` picks the mock when ``$VTPU_MOCK_JSON`` is set, else NVML;
with neither it raises.  It never falls back to torch.
"""

from __future__ import annotations

import json
import logging
import os
from itertools import product
from typing import Optional

from . import nvml
from .types import ChipInfo, MigDevice, NodeInventory, TopologyDesc

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
             "hbm_mib": 81079, "type": "NVIDIA-h100",
             "mig": [{"slices": 3, "mib": 40192, "uuid": "MIG-..."},
                     null, ...]},    # optional: MIG on, one a slot
            ...
          ]
        }

    A chip's ``"mig"`` is the mock NVML's (``csrc/vgpu/mock_nvml.cc``):
    each entry a MIG device (``compute_slices`` defaults to ``slices``,
    the UUID to ``MIG-<gen>-mock-<i>-<slot>``, its memory is ``mib``), a
    null an empty slot; an empty list is MIG on with no device made.
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
                        mig_enabled=c.get("mig") is not None,
                        mig=mock_mig(c.get("mig") or (), gen, i),
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


def mock_mig(entries, gen: str, index: int) -> tuple:
    """A fixture chip's ``"mig"`` list as its MIG devices, as the mock
    NVML answers it."""
    return tuple(
        MigDevice(uuid=m.get("uuid", f"MIG-{gen}-mock-{index}-{k}"),
                  slices=int(m["slices"]),
                  compute_slices=int(m.get("compute_slices", m["slices"])),
                  memory_mib=int(m["mib"]), hbm_mib=int(m["mib"]))
        for k, m in enumerate(entries) if m is not None)


class TorchBackend(Backend):
    """The real cards, through ``torch.cuda.get_device_properties``: name,
    total memory, UUID and SM count.  All visible cards are taken as one
    NVLink/NVSwitch domain (coordinates along one axis).  No card carries
    MIG devices: torch sees a MIG instance only as the one CUDA device of
    its process, not the card's layout."""

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


class NvmlBackend(Backend):
    """The real cards through NVML: per card its index, UUID, name,
    memory, serial, PCI bus id and minor number (:meth:`cards`), and the
    fabric that NVML's NVLink peer-to-peer matrix shows (:meth:`fabric`),
    in the TopologyDesc vocabulary the slice engine reads:

    - one card: ``coords=(0,)`` on ``mesh=(1,)``;
    - every pair of cards reports NVLink P2P ``OK`` (an HGX/DGX board on
      NVSwitch, or a bridged pair): ``coords=(i,)`` on ``mesh=(n,)`` with
      ``wraparound=(n > 2,)``, a ring.  A ring under-states an all-to-all
      switch (a set of cards that is not an arc is refused under
      ``guaranteed``, though NVSwitch would carry it) and never
      over-states it;
    - otherwise (PCIe only, bridged pairs among more than two cards, P2P
      not supported): no fabric, ``coords=()`` on every card of
      ``mesh=(n,)``, the form the slice engine reads as coordinates
      missing.  Filter then refuses a multi-card ``guaranteed`` pod and a
      ``vtpu.dev/mesh`` pod there (``topology-unverifiable``) and takes
      its plain choice of cards for any other, and kubelet's preferred
      allocation leaves the choice to kubelet.

    MIG: a card whose current MIG mode is on carries its MIG devices
    (:meth:`mig`); one with MIG off, or whose driver refuses the MIG
    query as not supported, carries none.

    Health: a card is unhealthy while its handle, UUID or memory query
    fails, and from its first critical Xid event on (an Xid an application
    causes excepted), where the driver delivers events; ``events_error``
    says why it does not.  Raises :class:`OSError` without
    ``libnvidia-ml.so.1`` and :class:`nvml.NvmlError` when NVML fails."""

    def __init__(self, library: Optional[str] = None) -> None:
        self.nvml = nvml.Nvml(library or nvml.LIBRARY)
        self.events = None
        self.events_error = ""
        self._xid: dict = {}  # index -> the first critical Xid
        self.last_fabric: Optional[dict] = None  # inventory()'s fabric()

    def cards(self) -> list:
        """What NVML reports of each card, as dicts.  The index, UUID,
        name and memory must answer; a driver that refuses the serial,
        the PCI bus id, the minor number or ``nvmlDeviceGetMemoryInfo_v2``
        with ``NVML_ERROR_NOT_SUPPORTED`` leaves that field None and the
        call named in ``not_supported``."""
        out = []
        for i in range(self.nvml.device_count()):
            h = self.nvml.handle(i)
            total, free, used = self.nvml.memory(h)
            card = dict(index=self.nvml.index(h), uuid=self.nvml.uuid(h),
                        name=self.nvml.name(h), memory_total=total,
                        memory_free=free, memory_used=used, not_supported=[])
            for field, read in (("serial", self.nvml.serial),
                                ("pci_bus_id", self.nvml.pci_bus_id),
                                ("minor", self.nvml.minor),
                                ("memory_v2", self.nvml.memory_v2)):
                try:
                    card[field] = read(h)
                except nvml.NvmlError as e:
                    if e.code != nvml.ERROR_NOT_SUPPORTED:
                        raise
                    card[field] = None
                    card["not_supported"].append(e.call)
            if card["memory_v2"] is not None:
                card["memory_v2"] = dict(zip(
                    ("total", "reserved", "free", "used"), card["memory_v2"]))
            card["mig"] = self.mig(h, card["not_supported"])
            out.append(card)
        return out

    def mig(self, handle, not_supported: list) -> Optional[dict]:
        """A card's MIG state: ``mode``, [current, pending]
        (``nvml.MIG_ENABLE`` or ``MIG_DISABLE``), and, where the current
        mode is on, ``devices``: per occupied slot its ``slot``, ``uuid``,
        ``slices`` and ``compute_slices`` (the GPU and compute instances'
        slice counts), ``memory_mib`` (the attributes' memory size) and
        ``hbm_mib`` (:func:`advertised_mib` of the MIG handle's memory).
        None where the driver refuses ``nvmlDeviceGetMigMode`` as not
        supported, which is then named in ``not_supported``: MIG off."""
        try:
            mode = self.nvml.mig_mode(handle)
        except nvml.NvmlError as e:
            if e.code != nvml.ERROR_NOT_SUPPORTED:
                raise
            not_supported.append(e.call)
            return None
        out = dict(mode=list(mode), devices=[])
        if mode[0] != nvml.MIG_ENABLE:
            return out
        for slot in range(self.nvml.max_mig_devices(handle)):
            h = self.nvml.mig_handle(handle, slot)
            if h is None:
                continue
            attrs = self.nvml.attributes(h)
            memory = dict(memory_total=self.nvml.memory(h)[0], memory_v2=None)
            try:
                memory["memory_v2"] = dict(zip(
                    ("total", "reserved", "free", "used"),
                    self.nvml.memory_v2(h)))
            except nvml.NvmlError as e:
                if e.code != nvml.ERROR_NOT_SUPPORTED:
                    raise
            out["devices"].append(dict(
                slot=slot, uuid=self.nvml.uuid(h),
                slices=attrs["gpuInstanceSliceCount"],
                compute_slices=attrs["computeInstanceSliceCount"],
                memory_mib=attrs["memorySizeMB"],
                hbm_mib=advertised_mib(memory)))
        return out

    def fabric(self, n: int) -> dict:
        """NVML's NVLink peer-to-peer matrix of cards 0..n-1 and what the
        rule reads from it: ``links``, ``[i, j, status]`` for each pair
        i < j asked (an ``nvmlGpuP2PStatus_t``, ``nvml.P2P_STATUS``
        names it); ``not_supported``, the calls the driver refused as
        not supported (the matrix stops at the first); and ``kind``:
        ``single`` (one card, nothing asked), ``nvlink`` (every pair OK)
        or ``none``.  Any other NVML error raises."""
        out = dict(links=[], not_supported=[], kind="single")
        if n == 1:
            return out
        handles = [self.nvml.handle(i) for i in range(n)]
        out["kind"] = "nvlink"
        for i in range(n):
            for j in range(i + 1, n):
                try:
                    status = self.nvml.p2p_status(handles[i], handles[j])
                except nvml.NvmlError as e:
                    if e.code != nvml.ERROR_NOT_SUPPORTED:
                        raise
                    out["not_supported"].append(e.call)
                    out["kind"] = "none"
                    return out
                out["links"].append([i, j, status])
                if status != nvml.P2P_STATUS_OK:
                    out["kind"] = "none"
        return out

    def inventory(self) -> NodeInventory:
        cards = self.cards()
        if not cards:
            raise RuntimeError("NVML reports no GPU")
        n = len(cards)
        self.last_fabric = self.fabric(n)
        kind = self.last_fabric["kind"]
        chips = [
            ChipInfo(
                index=c["index"],
                uuid=c["uuid"],
                type=f"NVIDIA-{normalize_kind(c['name'])}",
                hbm_mib=advertised_mib(c),
                coords=() if kind == "none" else (i,),
                serial=c["serial"] or "",
                board=c["name"],
                mig_enabled=bool(c["mig"])
                and c["mig"]["mode"][0] == nvml.MIG_ENABLE,
                mig=tuple(MigDevice(**{k: d[k] for k in (
                    "uuid", "slices", "compute_slices", "memory_mib",
                    "hbm_mib")}) for d in (c["mig"] or {}).get("devices", ())),
            )
            for i, c in enumerate(cards)
        ]
        for c in cards:
            if c["mig"] and c["mig"]["mode"][0] == nvml.MIG_ENABLE \
                    and not c["mig"]["devices"]:
                log.warning("GPU %d (%s) has MIG on and no MIG device: "
                            "it can run nothing, and no plugin serves it, "
                            "until one is made",
                            c["index"], c["uuid"])
        if self.events is None and not self.events_error:
            try:
                self.events = nvml.XidEvents(
                    self.nvml, [self.nvml.handle(c.index) for c in chips])
            except nvml.NvmlError as e:
                self.events_error = str(e)
        gen = normalize_kind(cards[0]["name"])
        wrap = (n > 2,) if kind == "nvlink" else ()
        topo = TopologyDesc(generation=gen, mesh=(n,), wraparound=wrap)
        return NodeInventory(chips=chips, topology=topo)

    def refresh_health(self, inv: NodeInventory) -> bool:
        if self.events is not None:
            for index, xid in self.events.drain():
                self._xid.setdefault(index, xid)
                log.warning("critical Xid %d on GPU %d", xid, index)
        changed = False
        for chip in inv.chips:
            try:
                h = self.nvml.handle(chip.index)
                ok = self.nvml.uuid(h) == chip.uuid
                self.nvml.memory(h)
            except nvml.NvmlError as e:
                log.warning("GPU %d (%s): %s", chip.index, chip.uuid, e)
                ok = False
            ok = ok and chip.index not in self._xid
            if chip.healthy != ok:
                chip.healthy = ok
                changed = True
        return changed

    def close(self) -> None:
        if self.events is not None:
            self.events.close()
            self.events = None
        self.nvml.shutdown()


def advertised_mib(card: dict) -> int:
    """The memory a card advertises, in MiB: what a CUDA process on it can
    get, so that a grant of the whole card is one a process can reach.

    NVML's ``total`` counts what the driver reserves for itself, which no
    CUDA process gets: on an H100 80GB HBM3 ``total`` is 81,559 MiB,
    ``reserved`` 480 MiB, and ``total - reserved`` is 85,017,493,504
    bytes, CUDA's ``total_memory`` to the byte (chip_smoke.py's
    ``phase_device_plugin``).  Where the driver refuses
    ``nvmlDeviceGetMemoryInfo_v2``, ``total`` it is, as the reference
    advertises."""
    v2 = card.get("memory_v2")
    if v2 is not None:
        return (v2["total"] - v2["reserved"]) >> 20
    return card["memory_total"] >> 20


def detect() -> Backend:
    """The mock if $VTPU_MOCK_JSON is set, else the cards through NVML;
    raises when NVML cannot be loaded or initialised.  Never torch: the
    node agent must hold no context on the cards it advertises."""
    if os.environ.get(MOCK_ENV):
        log.info("using MockBackend fixture %s", os.environ[MOCK_ENV])
        return MockBackend()
    try:
        return NvmlBackend()
    except (OSError, nvml.NvmlError) as e:
        raise RuntimeError(
            f"no NVML ({e}); set ${MOCK_ENV} to a fixture file to run "
            "against MockBackend") from e
