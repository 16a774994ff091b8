"""The registry of node card inventories (the port's copy of the JAX
package's ``scheduler/nodes.py``).

Reference: pkg/scheduler/nodes.go (addNode, and rmNodeDevice, which drops a
node's devices when its register stream breaks, nodes.go:269–305).  Each
card carries its fabric coordinates (none on a node without a fabric)
and the node its ``TopologyDesc`` where its agent sent one: Filter's slice
search reads them.

Each node carries an inventory revision, bumped by every registration
that changes it, by its removal and by ``touch`` (a card's quarantine or
release, a slice reservation): the scheduler's usage snapshot keys each
node's cached usage on (pod rev, inventory rev), and an optimistic commit
validates the winning node's pair.  ``drain_dirty`` hands the snapshot
the nodes changed since its last refresh.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Set, Tuple

from ..tpulib.types import TopologyDesc
from ..util import perf


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
        # Wait/hold telemetry under lock="nodes" on /perfz; rev_of rides
        # every commit, so hold samples are 1-in-16.
        self._lock = perf.TimedLock("nodes", sample_shift=4)
        self._nodes: Dict[str, NodeInfo] = {}
        self._rev: Dict[str, int] = {}
        # Nodes whose inventory changed since the last drain_dirty().
        self._dirty: Set[str] = set()
        # Cards registered fleet-wide, kept on every change.
        self._total_chips: int = 0

    def _bump(self, name: str) -> None:
        self._rev[name] = self._rev.get(name, 0) + 1
        self._dirty.add(name)

    def add_node(self, name: str, info: NodeInfo) -> None:
        """Each registration carries the node's whole inventory, so it
        replaces the stored list: a card missing from it is gone.  (The
        reference merges by id, nodes.go:269–281, which keeps a dead card
        schedulable; the JAX package's deliberate deviation, kept.)"""
        with self._lock:
            self._bump(name)
            existing = self._nodes.get(name)
            self._total_chips += len(info.devices) - (
                len(existing.devices) if existing is not None else 0)
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
            self._bump(name)
            dropped = self._nodes.pop(name, None)
            if dropped is not None:
                self._total_chips -= len(dropped.devices)

    def touch(self, name: str) -> None:
        """Bump ``name``'s revision for a change to what may be placed on
        it that is not an inventory message: a card's quarantine or
        release, a slice reservation.  Cached usage of the node rebuilds,
        and an optimistic commit validated against the old revision
        fails, as after a re-registration."""
        with self._lock:
            self._bump(name)

    def rev_of(self, name: str) -> int:
        """``name``'s inventory revision: one dict read, no lock.  Read it
        before the data it keys (see ``PodManager.rev_of``)."""
        return self._rev.get(name, 0)

    def drain_dirty(self) -> Set[str]:
        """Return and clear the nodes changed since the last drain.  The
        caller refreshes them, or hands them back through
        :meth:`mark_dirty`."""
        with self._lock:
            dirty, self._dirty = self._dirty, set()
            return dirty

    def mark_dirty(self, names: Iterable[str]) -> None:
        with self._lock:
            self._dirty.update(names)

    def get_node(self, name: str) -> Optional[NodeInfo]:
        # One dict read, no lock: the lock never made it fresher.
        return self._nodes.get(name)

    def list_nodes(self) -> Dict[str, NodeInfo]:
        with self._lock:
            return dict(self._nodes)

    def names(self) -> List[str]:
        """The registered nodes in registry order, without the lock (one
        C-level copy of the keys)."""
        return list(self._nodes)

    def count(self) -> int:
        return len(self._nodes)

    def total_chips(self) -> int:
        """Cards registered fleet-wide, the quota release throttle's
        denominator (kept incrementally; one int read)."""
        return self._total_chips
