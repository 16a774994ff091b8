"""Card partitions: the MIG instances of the node's cards, served to kubelet.

The port's counterpart of the JAX package's ``deviceplugin/partition.py``
(reference: pkg/device-plugin/mig-strategy.go, none/single/mixed, 46–210,
and the MIG passthrough allocation path, MIGAllocate, plugin.go:285–315).

The JAX package splits a dual-core TPU chip into equal TensorCore
partitions by generation.  On an H100 the hardware makes the split: a
card's partitions are its MIG devices, as NVML reports them
(``ChipInfo.mig``, filled by ``NvmlBackend``).  A card is partitionable
when its current MIG mode is on (``ChipInfo.mig_enabled``) and it has a
MIG device; one with MIG off, or whose driver refuses the MIG query as not
supported, has none, like a single-core TPU generation.  A partition's flavor is NVIDIA's profile name
(``MigDevice.profile``, e.g. ``3g.40gb``).

Strategies:

- ``none``   — no partition plugin;
- ``single`` — the MIG devices are served under the main resource name
  (``nvidia.com/gpu``, socket ``vgpu-single.sock``) in place of the
  whole-card plugin; a node whose MIG devices have more than one flavor is
  refused (:func:`single_refusal`), since kubelet would count a ``1g.10gb``
  and a ``3g.40gb`` as one resource;
- ``mixed``  — one plugin per flavor beside the whole-card plugin,
  ``nvidia.com/mig-<flavor>`` on socket ``vgpu-<flavor>.sock``.

``--partition-chips`` narrows the MIG cards that get partition plugins.

Allocation is kubelet passthrough (reference MIGAllocate): the scheduler
extender is not in the loop, and the device IDs kubelet picked are the
grant.  Where the answer differs from the JAX package's, by design:

1. memory limits are indexed per MIG device: ``CUDA_DEVICE_MEMORY_LIMIT_<i>``
   is the i-th granted instance's MiB and ``NVIDIA_VISIBLE_DEVICES`` the
   granted MIG UUIDs in the same order, since each instance is a CUDA
   device of its own (the JAX package sums a chip's cores into one limit);
2. no ``CUDA_DEVICE_SM_LIMIT``: an instance already is its share of the
   card's SMs, in hardware, and a duty cap on top would cut it again;
3. a card with MIG on never enters the whole-card view (:func:`
   whole_chip_view`), under any strategy: its parent cannot run a CUDA
   context, so a pod granted it whole would fail.  A MIG card outside
   ``--partition-chips``, or with MIG on and no MIG device made yet, is
   in neither view (:func:`outside_both_views`).

CUDA enumerates one MIG device per process, so a container granted two
instances runs a process on each (``CUDA_VISIBLE_DEVICES`` set to one of
the UUIDs); the port does not work round it.

The core (:meth:`PartitionDevicePlugin.allocate`, :meth:`preferred`,
:meth:`api_devices`) imports neither grpc nor protobuf; the kubelet
servicer methods convert at the edge.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
from typing import Dict, List, Optional, Sequence

from ..tpulib.types import ChipInfo, NodeInventory
from ..util.config import Config
from ..util.types import ENV_MEMORY_LIMIT_PREFIX, ENV_VISIBLE_DEVICES
from .plugin import (HEALTHY, UNHEALTHY, ContainerResponse, Device,
                     GpuDevicePlugin, attach_enforcement)

log = logging.getLogger(__name__)

STRATEGY_NONE = "none"
STRATEGY_SINGLE = "single"
STRATEGY_MIXED = "mixed"
STRATEGIES = (STRATEGY_NONE, STRATEGY_SINGLE, STRATEGY_MIXED)

MIG_RESOURCE_PREFIX = "nvidia.com/mig-"


@dataclasses.dataclass(frozen=True)
class Partition:
    """One MIG device of a physical card."""

    uuid: str          # the MIG UUID, "MIG-..."
    chip_uuid: str
    chip_index: int
    core: int          # its index among the card's MIG devices
    hbm_mib: int       # what a CUDA process on it can get
    healthy: bool      # the card's health
    resource_suffix: str  # the flavor: NVIDIA's profile name


class UnknownPartition(LookupError):
    """An Allocate named a device ID that is no partition of this plugin."""


def designated_chips(inv: NodeInventory, cfg: Config) -> List[ChipInfo]:
    """The cards to partition: those with MIG devices (and so MIG on),
    narrowed to ``cfg.partition_chips`` where it names any."""
    wanted = set(cfg.partition_chips)
    return [c for c in inv.chips
            if c.mig and (not wanted or c.uuid in wanted)]


def whole_chip_view(inv: NodeInventory) -> NodeInventory:
    """The inventory of the whole-card plugin, the register stream and the
    unsatisfiable-sizes annotation: every card but those with MIG on,
    with MIG devices or none yet, under any strategy (reference
    nvidia.go:84–107 skips MIG-enabled GPUs), so the extender path and the
    passthrough path never book the same card.  Shares ChipInfo objects with ``inv`` so in-place health
    refreshes show in the view.  No setting puts a MIG card back in the
    whole-card path, so the view takes no config (the JAX one does)."""
    if not any(c.mig_enabled for c in inv.chips):
        return inv
    return NodeInventory(chips=[c for c in inv.chips if not c.mig_enabled],
                         topology=inv.topology)


def enumerate_partitions(inv: NodeInventory,
                         cfg: Optional[Config] = None) -> List[Partition]:
    """The MIG devices of the designated cards (of every card with MIG
    devices without ``cfg``), in card order and then slot order, each
    with its card's health."""
    chips = designated_chips(inv, cfg) if cfg is not None else [
        c for c in inv.chips if c.mig]
    return [Partition(uuid=m.uuid, chip_uuid=chip.uuid, chip_index=chip.index,
                      core=k, hbm_mib=m.hbm_mib, healthy=chip.healthy,
                      resource_suffix=m.profile)
            for chip in chips for k, m in enumerate(chip.mig)]


class PartitionDevicePlugin:
    """Kubelet plugin serving MIG devices of one flavor (or all, under
    ``single``) by passthrough allocation (reference MIGAllocate,
    plugin.go:285–315): no extender handshake, the device IDs kubelet
    picked are the grant."""

    def __init__(self, resource_name: str, inventory: NodeInventory,
                 cfg: Config, socket_dir: str, socket_name: str,
                 flavor: Optional[str] = None) -> None:
        self.resource_name = resource_name
        # The live inventory: DeviceCache.refresh_health mutates ChipInfo in
        # place, so partitions are derived again at every use — a snapshot
        # taken at start would advertise stale health for ever.
        self.inventory = inventory
        self.flavor = flavor  # one resource_suffix (mixed), None (single)
        self.cfg = cfg
        # The whole-card plugin's serving shell (socket lifecycle,
        # ListAndWatch streams), with the device surface and the
        # allocation replaced.
        self._shell = GpuDevicePlugin(
            client=None, inventory=NodeInventory(chips=[], topology=None),
            cfg=cfg, socket_dir=socket_dir, socket_name=socket_name)
        self._shell.resource_name = resource_name
        self._shell.api_devices = self.api_devices
        self._shell.Allocate = self.Allocate
        self._shell.GetPreferredAllocation = self.GetPreferredAllocation

    # -- the core: plain dataclasses, no grpc ----------------------------------
    @property
    def partitions(self) -> Dict[str, Partition]:
        """The current partitions, health read from the live cards."""
        return {p.uuid: p for p in enumerate_partitions(self.inventory,
                                                        self.cfg)
                if self.flavor is None or p.resource_suffix == self.flavor}

    def api_devices(self) -> List[Device]:
        return [Device(ID=p.uuid, health=HEALTHY if p.healthy else UNHEALTHY)
                for p in self.partitions.values()]

    def preferred(self, available: Sequence[str], must: Sequence[str],
                  size: int) -> List[str]:
        """Partitions packed onto the fewest cards: ``must`` first, then
        the cards with the most available partitions."""
        parts = self.partitions
        by_chip: Dict[str, List[str]] = {}
        for vid in available:
            p = parts.get(vid)
            if p is not None:
                by_chip.setdefault(p.chip_uuid, []).append(vid)
        chosen = list(must)
        for chip_vids in sorted(by_chip.values(), key=len, reverse=True):
            for vid in chip_vids:
                if len(chosen) >= size:
                    break
                if vid not in chosen:
                    chosen.append(vid)
        return chosen[:size]

    def allocate(self, device_ids: Sequence[str]) -> ContainerResponse:
        """One container's answer: the granted MIG devices in kubelet's
        order, each its own CUDA device with its own memory limit.  No
        pod identity on the passthrough path, so the region dir is keyed
        by the granted set, the same for every restart of the container.
        Raises :class:`UnknownPartition` for an ID that is no partition."""
        parts = self.partitions
        resp = ContainerResponse()
        granted = []
        for vid in device_ids:
            p = parts.get(vid)
            if p is None:
                raise UnknownPartition(f"unknown partition {vid}")
            granted.append(p)
        for i, p in enumerate(granted):
            resp.envs[f"{ENV_MEMORY_LIMIT_PREFIX}{i}"] = str(p.hbm_mib)
        resp.envs[ENV_VISIBLE_DEVICES] = ",".join(p.uuid for p in granted)
        grant_key = hashlib.sha1(
            ",".join(sorted(device_ids)).encode()).hexdigest()[:12]
        attach_enforcement(resp, self.cfg, f"part-{grant_key}")
        return resp

    # -- the kubelet servicer (the gRPC edge) ----------------------------------
    def GetPreferredAllocation(self, request, context):  # noqa: N802
        from ..api import deviceplugin_pb2 as pb

        return pb.PreferredAllocationResponse(container_responses=[
            pb.ContainerPreferredAllocationResponse(deviceIDs=self.preferred(
                list(creq.available_deviceIDs),
                list(creq.must_include_deviceIDs), creq.allocation_size))
            for creq in request.container_requests])

    def Allocate(self, request, context):  # noqa: N802
        import grpc

        from ..api import deviceplugin_pb2 as pb

        try:
            out = [self.allocate(list(creq.devicesIDs))
                   for creq in request.container_requests]
        except UnknownPartition as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        return pb.AllocateResponse(
            container_responses=[r.to_proto() for r in out])

    # -- lifecycle, the shell's ------------------------------------------------
    def serve(self) -> None:
        self._shell.serve()

    def serving(self) -> bool:
        return self._shell.serving()

    def register_with_kubelet(self, kubelet_socket: Optional[str] = None):
        return self._shell.register_with_kubelet(kubelet_socket)

    def notify_health_changed(self) -> None:
        self._shell.notify_health_changed()

    def stop(self) -> None:
        self._shell.stop()

    @property
    def socket_path(self) -> str:
        return self._shell.socket_path


def get_partition_plugins(strategy: str, inventory: NodeInventory,
                          cfg: Config, socket_dir: str) -> List[object]:
    """The plugin set of a strategy (NewMigStrategy→GetPlugins analog):
    under ``mixed`` the plugins that run beside the whole-card plugin,
    under ``single`` the one that takes its place, under ``none`` (or with
    no MIG device on a designated card) none.  No client, where the JAX
    signature takes one: passthrough allocation reads no pod."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown partition strategy: {strategy}")
    if strategy == STRATEGY_NONE:
        return []
    parts = enumerate_partitions(inventory, cfg)
    if not parts:
        log.info("partition strategy %s: no designated card has a MIG "
                 "device; no partitions", strategy)
        return []
    if strategy == STRATEGY_SINGLE:
        return [PartitionDevicePlugin(cfg.resources.count, inventory, cfg,
                                      socket_dir,
                                      socket_name="vgpu-single.sock")]
    return [PartitionDevicePlugin(f"{MIG_RESOURCE_PREFIX}{suffix}", inventory,
                                  cfg, socket_dir,
                                  socket_name=f"vgpu-{suffix}.sock",
                                  flavor=suffix)
            for suffix in sorted({p.resource_suffix for p in parts})]


def single_refusal(inv: NodeInventory, cfg: Config) -> Optional[str]:
    """Why the node agent must not start under ``single``, or None.
    ``single`` replaces the whole-card plugin, so a card no partition
    plugin serves would be advertised by no plugin at all (the reference
    panics on mixed single-mode configs, mig-strategy.go:58–66):

    - a ``--partition-chips`` subset strands the other cards (the JAX
      agent's refusal, in its words);
    - MIG devices of more than one flavor would be counted by kubelet as
      one resource;
    - a card with MIG off would be stranded (one with MIG on and no MIG
      device is served by no plugin under any strategy)."""
    if cfg.partition_strategy != STRATEGY_SINGLE:
        return None
    parts = enumerate_partitions(inv, cfg)
    if not parts:
        return None  # the whole-card plugin serves
    if cfg.partition_chips:
        stranded = {c.uuid for c in inv.chips} - set(cfg.partition_chips)
        if stranded:
            return ("--partition-strategy=single with a --partition-chips "
                    f"subset would strand chips {sorted(stranded)}: single "
                    "partitions every chip; use --partition-strategy=mixed "
                    "to partition a subset")
    flavors = sorted({p.resource_suffix for p in parts})
    if len(flavors) > 1:
        return (f"--partition-strategy=single with MIG devices of "
                f"{len(flavors)} flavors {flavors}: kubelet would count them "
                "as one resource; use --partition-strategy=mixed")
    stranded = sorted(c.uuid for c in inv.chips if not c.mig_enabled)
    if stranded:
        return ("--partition-strategy=single would strand cards with MIG "
                f"off {stranded}: single serves MIG devices alone; "
                "use --partition-strategy=mixed")
    return None


def outside_both_views(inv: NodeInventory, cfg: Config) -> List[str]:
    """Cards with MIG on that neither the whole-card view nor a partition
    plugin serves (under ``none``, outside ``--partition-chips``, or with
    no MIG device made yet), by UUID."""
    designated = {c.uuid for c in designated_chips(inv, cfg)}
    if cfg.partition_strategy == STRATEGY_NONE:
        designated = set()
    return [c.uuid for c in inv.chips
            if c.mig_enabled and c.uuid not in designated]
