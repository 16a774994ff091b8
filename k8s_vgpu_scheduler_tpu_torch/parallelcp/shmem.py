"""Shared-memory columnar fleet segments with a versioned header (the
port's copy of the JAX package's ``parallelcp/shmem.py``).

Layout (two kinds of POSIX shm segments per store):

- ONE header segment, fixed name for the store's lifetime.  Workers
  attach it once and re-read it whenever their mapped generation goes
  stale::

      [0:8)    magic  b"VGPUCOL1"
      [8:16)   generation (uint64, little-endian) — 0 = nothing
               published yet
      [16:24)  manifest length in bytes (uint64)
      [24:..)  manifest JSON: {"generation", "data" (segment name),
               "n", "c", "columns": [[name, dtype, shape, offset], ...]}

- ONE data segment PER GENERATION (``{prefix}-g{gen}``) holding every
  column at 8-byte-aligned offsets.  A fleet rebuild (node set change,
  chip-pad overflow) allocates a fresh segment and publishes it by
  writing the manifest FIRST and the generation counter LAST — a reader
  that sees generation g is guaranteed the manifest bytes for g are
  already in place (the parent is the only writer, and it never reuses
  a generation number).  Readers re-check the generation after parsing
  (seqlock style) so a publish racing the read is retried, never
  half-applied.

Coherence is by construction, not locking: within one generation the
parent mutates column CELLS (write-through deltas, in-batch grants)
only between worker dispatches — the pool sends requests and collects
every reply before the cycle continues, so a worker never reads a row
the parent is concurrently writing.  Across generations the counter is
the fence: a worker asked to evaluate generation g while the header
says g' != g refuses (:class:`StaleGeneration`) rather than serve bits
from the wrong layout.
"""

from __future__ import annotations

import json
import os
import struct
from multiprocessing import resource_tracker, shared_memory
from typing import Dict, List, Tuple

import numpy as np

HEADER_MAGIC = b"VGPUCOL1"
#: Header segment size: magic + generation + length + manifest JSON.
#: 64 KiB bounds the manifest at thousands of columns — we have 13.
HEADER_CAP = 1 << 16
_GEN_OFF = 8
_LEN_OFF = 16
_JSON_OFF = 24

#: Every ColumnarFleet numpy column, in publication order.
#: kind "nc" → shape (N, C); kind "n" → shape (N,).
#: base/alive/bonus are per-row Python lists on the fleet; the store
#: keeps shm mirrors so workers need no per-request gate shipping.
COLUMN_SPECS: List[Tuple[str, str, str]] = [
    ("valid", "bool", "nc"),
    ("health", "bool", "nc"),
    ("type_id", "int32", "nc"),
    ("total_slots", "int64", "nc"),
    ("used_slots", "int64", "nc"),
    ("total_mem", "int64", "nc"),
    ("used_mem", "int64", "nc"),
    ("total_cores", "int64", "nc"),
    ("used_cores", "int64", "nc"),
    ("has_topology", "bool", "n"),
    ("base", "float64", "n"),
    ("alive", "bool", "n"),
    ("bonus", "float64", "n"),
]


class StaleGeneration(RuntimeError):
    """The header publishes a different generation than the caller
    wants: the segment the caller is asking about no longer (or does
    not yet) exist.  Carries what the header said, for telemetry."""

    def __init__(self, wanted: int, published: int) -> None:
        super().__init__(
            f"generation {wanted} requested, header publishes "
            f"{published}")
        self.wanted = wanted
        self.published = published


def _attach(name: str) -> shared_memory.SharedMemory:
    """Attach an existing segment WITHOUT registering it with the
    resource tracker.  Before Python 3.13 SharedMemory has no ``track=``
    parameter: every attach registers the segment, and the
    tracker would unlink it when ANY attacher exits — tearing the name
    out from under the parent that still owns it (and duplicate
    unregisters from several workers raise in the tracker process).
    The parent is the sole owner/unlinker, so attachers suppress
    registration entirely."""
    orig = resource_tracker.register
    resource_tracker.register = lambda *a, **k: None
    try:
        return shared_memory.SharedMemory(name=name)
    finally:
        resource_tracker.register = orig


def _layout(n: int, c: int) -> Tuple[List[Tuple[str, str, list, int]], int]:
    """(name, dtype, shape, offset) per column + total byte size, all
    offsets 8-aligned so every int64/float64 view is naturally
    aligned."""
    cols: List[Tuple[str, str, list, int]] = []
    off = 0
    for name, dtype, kind in COLUMN_SPECS:
        shape = [n, c] if kind == "nc" else [n]
        nbytes = int(np.dtype(dtype).itemsize * max(1, n) *
                     (max(1, c) if kind == "nc" else 1))
        cols.append((name, dtype, shape, off))
        off += (nbytes + 7) & ~7
    return cols, max(off, 8)


def _views(buf, cols) -> Dict[str, np.ndarray]:
    return {name: np.ndarray(tuple(shape), dtype=np.dtype(dtype),
                             buffer=buf, offset=off)
            for name, dtype, shape, off in cols}


class SharedColumnStore:
    """Parent-side owner of the header segment + the per-generation
    data segments.  Single-writer: only the scheduler parent (under its
    cycle lock) calls :meth:`alloc`."""

    _seq = 0

    def __init__(self, prefix: str = None) -> None:
        if prefix is None:
            SharedColumnStore._seq += 1
            # vgpu, where the JAX package's segments say vtpu: the two
            # packages' schedulers on one host never share a name.
            prefix = f"vgpu{os.getpid()}x{SharedColumnStore._seq}"
        self.prefix = prefix
        self.generation = 0
        self.header_name = f"{prefix}-hdr"
        self._hdr = shared_memory.SharedMemory(
            create=True, size=HEADER_CAP, name=self.header_name)
        self._hdr.buf[:8] = HEADER_MAGIC
        struct.pack_into("<Q", self._hdr.buf, _GEN_OFF, 0)
        self._data: shared_memory.SharedMemory = None
        #: Retired data segments whose numpy views may still be alive in
        #: the fleet (rebuild swaps references, GC lags) — unlinked
        #: immediately, closed lazily when their buffers finally free.
        self._retired: List[shared_memory.SharedMemory] = []
        self.arrays: Dict[str, np.ndarray] = {}
        self._closed = False

    def alloc(self, n: int, c: int) -> Dict[str, np.ndarray]:
        """Allocate generation ``gen+1``'s data segment sized for an
        ``[n, c]`` fleet, publish it in the header, and return zeroed
        numpy views over it.  The previous generation's segment is
        unlinked (attached workers keep their mapping alive through the
        fd until they remap)."""
        if self._closed:
            raise RuntimeError("store closed")
        gen = self.generation + 1
        cols, size = _layout(n, c)
        data_name = f"{self.prefix}-g{gen}"
        data = shared_memory.SharedMemory(create=True, size=size,
                                          name=data_name)
        data.buf[:size] = b"\x00" * size
        arrays = _views(data.buf, cols)
        manifest = json.dumps({
            "generation": gen, "data": data_name, "n": n, "c": c,
            "columns": [[nm, dt, shape, off]
                        for nm, dt, shape, off in cols],
        }).encode("utf-8")
        if _JSON_OFF + len(manifest) > HEADER_CAP:  # pragma: no cover
            raise ValueError("column manifest exceeds header segment")
        # Publication order is the protocol: manifest bytes, length,
        # THEN the generation counter.  A reader that observes gen==g
        # is guaranteed g's manifest is fully in place.
        self._hdr.buf[_JSON_OFF:_JSON_OFF + len(manifest)] = manifest
        struct.pack_into("<Q", self._hdr.buf, _LEN_OFF, len(manifest))
        struct.pack_into("<Q", self._hdr.buf, _GEN_OFF, gen)
        old = self._data
        self._data = data
        self.generation = gen
        self.arrays = arrays
        if old is not None:
            try:
                old.unlink()
            except FileNotFoundError:          # pragma: no cover
                pass
            self._retired.append(old)
        self._reap_retired()
        return arrays

    def _reap_retired(self) -> None:
        still = []
        for shm in self._retired:
            try:
                shm.close()
            except BufferError:
                still.append(shm)    # a numpy view still holds the buffer
        self._retired = still

    def close(self) -> None:
        """Unlink every segment this store owns.  Closing the local
        mappings is best-effort — live numpy views (the fleet's own
        columns) keep a buffer exported, which is fine: the unlink
        already removed the names, and the mappings die with the
        process."""
        if self._closed:
            return
        self._closed = True
        for shm in [self._data] + self._retired:
            if shm is None:
                continue
            try:
                shm.unlink()
            except FileNotFoundError:
                pass
            try:
                shm.close()
            except BufferError:                # pragma: no cover
                pass
        try:
            self._hdr.unlink()
        except FileNotFoundError:              # pragma: no cover
            pass
        try:
            self._hdr.close()
        except BufferError:                    # pragma: no cover
            pass


class SharedColumnView:
    """Worker-side read-only mapping of one store's current
    generation.  ``ensure(gen)`` is the fence: it either returns views
    for exactly ``gen`` or raises :class:`StaleGeneration`."""

    def __init__(self, header_name: str) -> None:
        self._hdr = _attach(header_name)
        if bytes(self._hdr.buf[:8]) != HEADER_MAGIC:
            raise ValueError(f"{header_name}: not a column header")
        self.generation = -1
        self._data: shared_memory.SharedMemory = None
        self.arrays: Dict[str, np.ndarray] = {}
        self.n = 0
        self.c = 0

    def header_generation(self) -> int:
        return struct.unpack_from("<Q", self._hdr.buf, _GEN_OFF)[0]

    def ensure(self, want_gen: int) -> Dict[str, np.ndarray]:
        """Return column views for exactly ``want_gen``, remapping if
        the currently-mapped generation differs.  Raises
        :class:`StaleGeneration` when the header publishes any other
        generation — the caller (a solve worker) must refuse to serve
        rather than evaluate the wrong layout."""
        if (want_gen == self.generation
                and self.header_generation() == want_gen):
            return self.arrays
        for _ in range(8):
            published = self.header_generation()
            if published != want_gen:
                raise StaleGeneration(want_gen, published)
            length = struct.unpack_from("<Q", self._hdr.buf, _LEN_OFF)[0]
            raw = bytes(self._hdr.buf[_JSON_OFF:_JSON_OFF + length])
            # Seqlock re-check: a publish racing our read means the
            # manifest bytes may be the NEW generation's — retry.
            if self.header_generation() != published:
                continue
            man = json.loads(raw.decode("utf-8"))
            if man["generation"] != published:  # pragma: no cover
                continue
            try:
                data = _attach(man["data"])
            except FileNotFoundError:
                # Unlinked between publish and attach: a newer
                # generation superseded it already.
                raise StaleGeneration(want_gen, self.header_generation())
            arrays = _views(data.buf, man["columns"])
            for arr in arrays.values():
                arr.flags.writeable = False    # workers are read-only
            self._drop_mapping()
            self._data = data
            self.arrays = arrays
            self.generation = published
            self.n = man["n"]
            self.c = man["c"]
            return self.arrays
        raise StaleGeneration(want_gen, self.header_generation())

    def _drop_mapping(self) -> None:
        old, self._data = self._data, None
        self.arrays = {}
        self.generation = -1
        if old is not None:
            try:
                old.close()
            except BufferError:                # pragma: no cover
                pass

    def close(self) -> None:
        self._drop_mapping()
        try:
            self._hdr.close()
        except BufferError:                    # pragma: no cover
            pass
