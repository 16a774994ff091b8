"""Virtual device memory: oversubscribing a GPU grant into host RAM.

The port's counterpart of the JAX package's ``shim/oversub.py``: the
reference's "virtual device memory" mode (``CUDA_OVERSUBSCRIBE``; binary
symbols ``allocate_raw`` / ``handle_remap`` / ``suspend_all`` /
``resume_all`` in libvgpu.so — SURVEY.md N1), buffer-granular over
tensors:

- :class:`HostSwapStore` — registry of swappable tensors (a tensor, or
  lists, tuples and dicts of them, nested) with LRU accounting;
  ``suspend``/``resume`` move them between the card and pinned host
  memory (``torch.empty(..., pin_memory=True)`` plus ``copy_``), and
  ``spill_until`` evicts least-recently-used entries until enough device
  bytes are free.
- :class:`PressureSpiller` — the pressure check: spills registered
  entries when a card's allocated bytes approach its physical size.

A tensor moves *in place*: its storage is swapped (``tensor.data =``), so
every reference the caller holds follows it to the host and back, and a
suspend frees the device memory as long as no other tensor views the same
storage.  A tensor on the CPU (the tests) is "suspended" into a plain host
copy: only memory that comes from the card is pinned.

Because a spill moves tensors that a running step may hold, the shim
spills only between dispatches: the pressure check runs at the gate of a
dispatch unit, before it starts and while no other gated dispatch is in
flight (:meth:`PressureSpiller.before_dispatch`), and the entries the
dispatch's arguments hold come back to the card first (the reference's
``handle_remap``).  Code outside the gate calls :meth:`HostSwapStore.get`
before it uses a registered tree.

``torch`` is imported inside the functions that need it.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import sys
import threading
from typing import Dict, List, Optional

log = logging.getLogger("vgpu.oversub")

MIB = 1024 * 1024


def tree_leaves(tree) -> List:
    """The leaves of nested lists, tuples, dicts and dataclass instances
    (a train state, say): the tensors, and whatever else they hold."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [leaf for f in dataclasses.fields(tree)
                for leaf in tree_leaves(getattr(tree, f.name))]
    return [tree]


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def host_copy(t):
    """A host copy of ``t``, pinned where it comes from the card so the
    copies both ways are plain DMA.  Asynchronous from the card: wait on
    its stream before reading it."""
    import torch

    if t.device.type == "cpu":
        return t.clone()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def _synchronize(devices) -> None:
    import torch

    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


class _Entry:
    __slots__ = ("name", "tree", "ids", "devices", "nbytes", "on_device",
                 "last_use")

    def __init__(self, name: str, tree, nbytes: int):
        self.name = name
        self.tree = tree
        leaves = tree_leaves(tree)
        # The store keeps every leaf alive, so its id stays its own.
        self.ids = frozenset(id(t) for t in leaves)
        self.devices = [t.device for t in leaves]  # home devices
        self.nbytes = nbytes
        self.on_device = True
        self.last_use = 0.0


class HostSwapStore:
    """Registry of tensors that may be transparently spilled to host RAM.

    The reference tracks raw CUDA allocations in a handle table and remaps
    them wholesale; here the unit is a named tree of tensors, moved in
    place.  Thread-safe.
    """

    def __init__(self) -> None:
        self._entries: Dict[str, _Entry] = {}
        self._lock = threading.RLock()
        self._clock = 0.0

    # -- registration ----------------------------------------------------------
    def register(self, name: str, tree) -> None:
        """Track ``tree`` (on its device) as swappable under ``name``."""
        with self._lock:
            e = _Entry(name, tree, tree_bytes(tree))
            e.last_use = self._tick()
            self._entries[name] = e

    def _tick(self) -> float:
        self._clock += 1.0
        return self._clock

    # -- swap primitives -------------------------------------------------------
    def suspend(self, name: str) -> int:
        """Move ``name`` to host RAM; returns the device bytes freed.
        Returns once the copies have landed."""
        with self._lock:
            e = self._entries[name]
            if not e.on_device:
                return 0
            leaves = tree_leaves(e.tree)
            hosts = [host_copy(t) for t in leaves]
            _synchronize(set(e.devices))
            for t, h in zip(leaves, hosts):
                t.data = h
            e.on_device = False
            log.info("oversub: suspended %s (%d MiB -> host)", name,
                     e.nbytes // MIB)
            return e.nbytes

    def resume(self, name: str):
        """Bring ``name`` back to its device; returns the tree."""
        with self._lock:
            e = self._entries[name]
            e.last_use = self._tick()
            if e.on_device:
                return e.tree
            leaves = tree_leaves(e.tree)
            backs = [t.to(d, non_blocking=True) if d.type != "cpu"
                     else t.clone() for t, d in zip(leaves, e.devices)]
            _synchronize(set(e.devices))
            for t, b in zip(leaves, backs):
                t.data = b
            e.on_device = True
            log.info("oversub: resumed %s (%d MiB -> device)", name,
                     e.nbytes // MIB)
            return e.tree

    def get(self, name: str):
        """Access the tree, restoring it to its device if spilled
        (handle_remap)."""
        return self.resume(name)

    def entries_of(self, trees) -> List[str]:
        """The names of the entries that share a tensor with ``trees``."""
        with self._lock:
            if not self._entries:
                return []
            ids = {id(leaf) for leaf in tree_leaves(trees)}
            return [e.name for e in self._entries.values()
                    if not e.ids.isdisjoint(ids)]

    def suspend_all(self) -> int:
        with self._lock:
            return sum(self.suspend(n) for n in list(self._entries))

    def resume_all(self) -> None:
        with self._lock:
            for n in list(self._entries):
                self.resume(n)

    # -- pressure-driven eviction ---------------------------------------------
    def spill_until(self, bytes_needed: int, device=None, keep=()) -> int:
        """Evict least-recently-used entries on their device until at
        least ``bytes_needed`` device bytes have been freed (or nothing is
        left).  With ``device`` set, only bytes on that device count and
        entries with nothing there are skipped: pressure is per device.
        Entries named in ``keep`` stay."""
        freed = 0
        with self._lock:
            order = sorted(
                (e for e in self._entries.values()
                 if e.on_device and e.name not in keep),
                key=lambda e: e.last_use,
            )
            for e in order:
                if freed >= bytes_needed:
                    break
                if device is None:
                    freed += self.suspend(e.name)
                else:
                    local = sum(t.numel() * t.element_size()
                                for t, d in zip(tree_leaves(e.tree),
                                                e.devices) if d == device)
                    if local <= 0:
                        continue  # suspending this relieves nothing here
                    self.suspend(e.name)
                    freed += local
        return freed

    # -- accounting ------------------------------------------------------------
    def device_bytes(self) -> int:
        with self._lock:
            return sum(e.nbytes for e in self._entries.values() if e.on_device)

    def host_bytes(self) -> int:
        with self._lock:
            return sum(
                e.nbytes for e in self._entries.values() if not e.on_device
            )

    def stats(self) -> Dict[str, int]:
        return {
            "entries": len(self._entries),
            "device_bytes": self.device_bytes(),
            "host_bytes": self.host_bytes(),
        }


class PressureSpiller:
    """Device-memory pressure check.

    The reference's libvgpu reacts to cuMemAlloc ENOMEM inline; here the
    caching allocator's allocated bytes are compared with the physical
    size and registered tensors are spilled *before* the allocator runs
    out.  ``headroom_bytes`` is the cushion kept free for scratch and
    fragmentation.  ``sample`` gives (device, allocated bytes) for each
    card in use; by default the caching allocator's counts.  The shim
    calls :meth:`before_dispatch` at each gated dispatch; nothing checks
    in the background, since a spill in the middle of a step would move
    the tensors it is updating.
    """

    def __init__(self, store: HostSwapStore, physical_bytes: int,
                 headroom_bytes: int = 512 * MIB, sample=None) -> None:
        self.store = store
        self.physical = physical_bytes
        self.headroom = headroom_bytes
        self.sample = sample or _devices_bytes_in_use

    def check_once(self, in_use: Optional[int] = None, keep=()) -> int:
        """One pressure check; returns bytes spilled.  Without an explicit
        ``in_use`` sample, every card this process uses is checked and the
        worst overshoot drives the spill.  Entries named in ``keep``
        stay."""
        if self.physical <= 0:
            return 0
        worst_dev = None
        if in_use is not None:
            over = in_use + self.headroom - self.physical
        else:
            over = 0
            for dev, b in self.sample():
                dev_over = b + self.headroom - self.physical
                if dev_over > over:
                    over, worst_dev = dev_over, dev
        if over > 0:
            # Spill against the pressured device specifically.
            spilled = self.store.spill_until(over, device=worst_dev,
                                             keep=keep)
            if spilled:
                log.warning(
                    "oversub: device memory pressure (worst device %d MiB "
                    "over); spilled %d MiB to host",
                    over // MIB, spilled // MIB)
            return spilled
        return 0

    def before_dispatch(self, trees, idle: bool) -> int:
        """The host swap at the gate of one dispatch whose arguments are
        ``trees``: when ``idle`` (no other dispatch in flight, so no step
        holds a registered tensor) the pressure check may spill the
        entries the dispatch does not use; then the entries it does use
        come back to their device.  Returns bytes spilled."""
        names = self.store.entries_of(trees)
        spilled = self.check_once(keep=names) if idle else 0
        for name in names:
            self.store.resume(name)
        return spilled


def _devices_bytes_in_use() -> "list[tuple]":
    """(device, allocated bytes) per card, once this process has brought
    CUDA up; never initializes it."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return []
    return [(torch.device("cuda", i), torch.cuda.memory_allocated(i))
            for i in range(torch.cuda.device_count())]


def enabled_from_env() -> bool:
    # The native parser's accepted values (csrc/vgpu/region.cc
    # apply_env_limits), so the shim and the region agree on whether a pod
    # oversubscribes.
    return os.environ.get("CUDA_OVERSUBSCRIBE", "") in ("true", "1")


_GLOBAL_STORE: Optional[HostSwapStore] = None


def global_store() -> HostSwapStore:
    global _GLOBAL_STORE
    if _GLOBAL_STORE is None:
        _GLOBAL_STORE = HostSwapStore()
    return _GLOBAL_STORE
