"""The registry of node card inventories (the port's copy of the JAX
package's ``scheduler/nodes.py``).

Reference: pkg/scheduler/nodes.go (addNode, and rmNodeDevice, which drops a
node's devices when its register stream breaks, nodes.go:269–305).  Each
card carries its fabric coordinates (none on a node without a fabric)
and the node its ``TopologyDesc`` where its agent sent one: Filter's slice
search reads them.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

from ..tpulib.types import TopologyDesc


@dataclasses.dataclass
class DeviceInfo:
    """One card as a node agent registered it (reference DeviceInfo,
    nodes.go:230–240)."""

    id: str
    count: int        # virtual-device slots
    devmem: int       # advertised MiB
    type: str
    health: bool
    coords: Tuple[int, ...] = ()
    cores: int = 100


@dataclasses.dataclass
class NodeInfo:
    name: str
    devices: List[DeviceInfo]
    topology: Optional[TopologyDesc] = None


class NodeManager:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._nodes: Dict[str, NodeInfo] = {}

    def add_node(self, name: str, info: NodeInfo) -> None:
        """Each registration carries the node's whole inventory, so it
        replaces the stored list: a card missing from it is gone.  (The
        reference merges by id, nodes.go:269–281, which keeps a dead card
        schedulable; the JAX package's deliberate deviation, kept.)"""
        with self._lock:
            existing = self._nodes.get(name)
            if existing is None or not existing.devices:
                self._nodes[name] = NodeInfo(name, list(info.devices),
                                             info.topology)
                return
            existing.devices = list(info.devices)
            # A registration without a topology keeps the one stored.
            if info.topology is not None:
                existing.topology = info.topology

    def same_inventory(self, name: str, info: NodeInfo) -> bool:
        """Whether ``info`` is the stored inventory and topology, where it
        sends one (most register-stream messages are keepalives)."""
        with self._lock:
            cur = self._nodes.get(name)
            if cur is None or cur.devices != info.devices:
                return False
            return info.topology is None or cur.topology == info.topology

    def rm_node(self, name: str) -> None:
        """The node agent's stream broke: its inventory is no longer
        trusted (reference rmNodeDevice, nodes.go:283–305)."""
        with self._lock:
            self._nodes.pop(name, None)

    def get_node(self, name: str) -> Optional[NodeInfo]:
        with self._lock:
            return self._nodes.get(name)

    def list_nodes(self) -> Dict[str, NodeInfo]:
        with self._lock:
            return dict(self._nodes)

    def count(self) -> int:
        with self._lock:
            return len(self._nodes)

    def total_chips(self) -> int:
        """Cards registered fleet-wide: the quota release throttle's
        denominator."""
        with self._lock:
            return sum(len(n.devices) for n in self._nodes.values())
