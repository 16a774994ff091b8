"""Batched scheduling cycles over a columnar fleet (the port's copy of the
JAX package's ``scheduler/batch.py``).

The per-pod optimistic Filter (``core.py``) decides one pod at a time:
each decision takes a snapshot, sweeps its candidates in Python and
commits.  A cycle here drains every pending pod instead, evaluates the
pods x cards fit and the pods x nodes score as vectorized numpy over a
columnar view of the fleet, solves the placement jointly and commits one
group a node through the same revision-validated commit, so no card is
ever booked past its totals.

Three layers:

- :class:`ColumnarFleet`: padded ``[nodes, max cards]`` numpy columns
  (free MiB, free cores, free slots, type ids, health), one row a node
  (rows in node-name order), kept incrementally: a row reloads only where
  its snapshot entry was replaced, patches in place from the informer's
  write-through deltas, or adopts the entry its own group commit
  published.  Each row also keeps plain Python mirrors of its columns:
  the solver's per-assignment updates run on those (a one-row recompute
  over a few cards is faster in scalar Python than a numpy call chain),
  the cycle-start evaluation runs vectorized, and both do the same
  arithmetic in the same order, so their scores agree bit for bit.
- the class evaluator: pods dedup into request classes
  (:func:`class_fingerprint`); one evaluation a class gives its score
  row over the whole fleet, cached across cycles and patched on the rows
  dirtied since.  Its per-card rules are ``score.fit_pod``'s.
- the solver: ``regret`` (the default) assigns first the pod with the
  largest gap between its best and second-best node, so a pod with one
  feasible node is not starved by a flexible pod taking it; ``fifo``
  reproduces the serial path's sequential argmax.  Ties break toward the
  earlier offer and the earlier submission, which keeps the admission
  loop's fair-share release order.

The columns are numpy arrays and the whole-fleet evaluation is vectorized
(``parallelcp/vector.py``) wherever numpy imports, as on the card's host
and in the tests; this package imports no numpy itself, and without it
(the extender's image installs none) every row is evaluated by the scalar
row evaluator, whose rules and arithmetic order are the vector pass's, so
the decisions are the same bits.

Multi-card requests on a fleet with a fabric, and every pod that declares
a ``vtpu.dev/mesh``, go to the in-cycle slice stage (``score.fit_pod``
over copy-on-write views of the same entries); gang members and
multi-container pods keep the per-pod path; a job the cycle cannot place
or whose group commit loses its revision race is decided by the per-pod
optimistic path outside the cycle lock.  With ``Config.solve_workers`` the
columns live in shared memory and whole-fleet class evaluations run in
worker processes (``parallelcp/``).  Imports no torch and no numpy.
"""

from __future__ import annotations

import dataclasses
import heapq
import logging
import math
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Set, Tuple

from ..placement.mesh import MESH_ANNOTATION
from ..util import perf, trace
from ..util.types import QOS_ANNOTATION, ContainerDevice
from . import score as score_mod

log = logging.getLogger(__name__)

# Chip-choice sort key: (used_slots, used_mem) packed into one integer so
# a single argmax/argsort reproduces fit_container's binpack preference
# (most-used first, ties by chip index — numpy's first-max / stable sort
# matches Python's stable descending sort).  used_mem is MiB and can
# never reach 2^40.  (parallelcp/vector.py keeps the same constant.)
_KEY_BASE = 1 << 40


def _vector_module():
    """``parallelcp.vector`` (numpy columns and the vectorized pass), or
    None where numpy does not import: the fleet then evaluates in scalar
    Python with the same bits."""
    try:
        from ..parallelcp import vector
    except ImportError:
        return None
    return vector
_NEG_INF = float("-inf")
#: The per-card numpy columns (parallelcp/vector.alloc, shmem's card
#: columns).
_CARD_COLUMNS = ("valid", "health", "type_id", "total_slots", "used_slots",
                 "total_mem", "used_mem", "total_cores", "used_cores")


@dataclasses.dataclass
class BatchJob:
    """One pod's slice of a batch cycle (parsed once, outside any lock)."""

    pod: dict
    uid: str
    name: str
    namespace: str
    trace_id: str
    requests: list          # [ContainerDeviceRequest] — exactly one effective
    anns: Dict[str, str]
    node_names: List[str]
    priority: int = 0
    #: Created lazily by the gate (filter_many resolves synchronously).
    done: Optional[threading.Event] = None
    result: Optional[object] = None   # FilterResult, set by the leader
    #: Monotonic stamp at routing time — the cycle's drain-age gauge
    #: (how long the oldest pod waited for its tick) reads these.
    enqueued_at: float = 0.0


class ColumnarFleet:
    """Padded ``[N nodes, C chips]`` columnar mirror of the usage
    snapshot, plus per-row Python mirrors for the solver's scalar hot
    loop.  Node-set membership changes (register/unregister, a node
    outgrowing the chip pad) trigger a full rebuild — rare against the
    grant churn the incremental path absorbs."""

    def __init__(self, store=None) -> None:
        #: Optional parallelcp.SharedColumnStore: when set, the numpy
        #: columns live in shared-memory segments solve worker
        #: processes map read-only (``parallelcp/``).  None (the
        #: default) keeps plain process-private arrays, with the same
        #: bytes.
        self.store = store
        #: Optional parallelcp.SolveWorkerPool installed by the batch
        #: engine when --solve-workers > 0; full class evaluations are
        #: offloaded through it, with in-process fallback.
        self.pool = None
        #: parallelcp.vector where numpy imports (the columns are numpy
        #: arrays, the whole-fleet pass vectorized), else None (no numpy
        #: columns; every row evaluated in scalar Python).
        self.vec = _vector_module()
        self._entries: Dict[str, object] = {}   # name -> SnapEntry (identity)
        self.names: List[str] = []
        self.row_of: Dict[str, int] = {}
        self.chip_ids: List[List[str]] = []
        self.chip_types: List[List[str]] = []
        #: Per-row uuid -> column index (rebuilt with the row): the
        #: delta-apply and slice-commit paths resolve chips through
        #: this instead of building a fresh dict per row per use.
        self.col_of: List[Dict[str, int]] = []
        self._types: List[str] = []
        self._type_id: Dict[str, int] = {}
        self.any_topology = False
        #: Rows the solver charged in-batch grants to since the last
        #: refresh: their mirrors no longer match their (unchanged)
        #: snapshot entries, so the next refresh reloads them even if
        #: the commit never happened (a lost revision race must not
        #: leave phantom grants in the columnar view).
        self.touched: Set[int] = set()
        #: Lifetime full-rebuild count (node-set membership changes or a
        #: chip-pad overflow); decide_many reads the delta to split the
        #: columnar-refresh phase into full-rebuild vs incremental.
        self.rebuilds = 0
        #: row -> the snapshot generation key the last group commit
        #: published for it.  When the next snapshot's entry carries
        #: exactly this key, the entry's usage IS the columnar state
        #: (apply_grant wrote the same deltas through) — the row adopts
        #: the entry without a reload, so a steady-state cycle is O(rows
        #: changed by OTHERS), not O(rows we granted on).
        self.expected_key: Dict[int, tuple] = {}
        #: Per-request-class cached evaluation columns, keyed on the
        #: class fingerprint.  A cached class re-evaluates ONLY rows
        #: dirtied since its last sync (completions, heartbeat flips,
        #: in-batch grants, lease-gate moves) — the steady-state
        #: vector-eval cost becomes O(dirty rows × classes), not
        #: O(fleet × classes) per cycle.  Bounded LRU; a full rebuild
        #: (row indices move) drops it wholesale.
        self._class_cache: "OrderedDict[tuple, _ClassEval]" = OrderedDict()
        #: Lifetime telemetry for /perfz: rows reloaded from snapshot entries, rows patched via
        #: write-through deltas, cached-class rows re-evaluated scalar,
        #: and whole-fleet class evaluations (cache misses / overflows).
        self.rows_reloaded_total = 0
        self.rows_patched_total = 0
        self.class_rows_patched = 0
        self.class_evals_full = 0
        #: Full class evaluations served by the solve worker pool
        #: (subset of class_evals_full — the offload replaces the
        #: in-process pass bit-for-bit, it does not add evaluations).
        self.class_evals_offloaded = 0
        self._alloc(0, 1)

    # -- storage ---------------------------------------------------------------
    def _alloc(self, n: int, c: int) -> None:
        self.N, self.C = n, c
        shape = (n, c)
        self._g_base = self._g_alive = self._g_bonus = None
        self.has_topology = None
        if self.store is not None:
            # Shared-memory backing: same dtypes/shapes, same zeroed
            # start — only the allocation site differs, so the two
            # modes stay bit-identical.  Allocating bumps the store's
            # generation; workers holding the old layout are fenced.
            cols = self.store.alloc(n, c)
            self.has_topology = cols["has_topology"]
            self._g_base = cols["base"]
            self._g_alive = cols["alive"]
            self._g_bonus = cols["bonus"]
            self._g_alive[:] = True
        elif self.vec is not None:
            cols = self.vec.alloc(n, c)
        else:
            cols = dict.fromkeys(_CARD_COLUMNS)
        self.valid = cols["valid"]
        self.health = cols["health"]
        self.type_id = cols["type_id"]
        self.total_slots = cols["total_slots"]
        self.used_slots = cols["used_slots"]
        self.total_mem = cols["total_mem"]
        self.used_mem = cols["used_mem"]
        self.total_cores = cols["total_cores"]
        self.used_cores = cols["used_cores"]
        #: Whether the numpy columns exist (numpy imported, or the
        #: shared store): the writes below keep them equal to the
        #: Python mirrors, and the whole-fleet pass reads them.
        self.columns = self.valid is not None
        # Python mirrors: mutable per-chip state as lists (solver writes),
        # static per-chip state as tuples, per-row scalars as lists.
        self.p_used_slots: List[List[int]] = [[] for _ in range(n)]
        self.p_used_mem: List[List[int]] = [[] for _ in range(n)]
        self.p_used_cores: List[List[int]] = [[] for _ in range(n)]
        self.p_total_slots: List[Tuple[int, ...]] = [()] * n
        self.p_total_mem: List[Tuple[int, ...]] = [()] * n
        self.p_total_cores: List[Tuple[int, ...]] = [()] * n
        self.p_health: List[Tuple[bool, ...]] = [()] * n
        self.p_type: List[Tuple[int, ...]] = [()] * n
        self.p_topology: List[bool] = [False] * n
        self.alive: List[bool] = [True] * n       # lease gate, set per cycle
        self.bonus: List[float] = [0.0] * n       # --score-by-actual
        self.base: List[float] = [0.0] * n        # spread-form node score
        # Pooled numpy scratch for the vectorized class evaluation:
        # buffers are reused across cycles (keyed by name, sized to the
        # fleet shape) so a full class eval allocates nothing on the
        # steady path (Python allocation pressure in the per-tick
        # drain drives the garbage collector).
        self._bufs: Dict[str, object] = {}

    def _type_of(self, t: str) -> int:
        got = self._type_id.get(t)
        if got is None:
            got = len(self._types)
            self._type_id[t] = got
            self._types.append(t)
        return got

    # -- maintenance -----------------------------------------------------------
    def _note_dirty(self, row: int) -> None:
        """Mark ``row`` changed for every cached class evaluation — the
        next sync re-evaluates exactly these rows (scalar, bit-identical
        to the vectorized pass by the parity pin)."""
        for ce in self._class_cache.values():
            ce.pending.add(row)

    def refresh(self, snap: Dict[str, object],
                deltas: Optional[Dict[str, list]] = None,
                changed: Optional[Set[str]] = None) -> int:
        """Bring the columnar view up to the snapshot; returns how many
        rows were RELOADED from their entries (0 on an unchanged fleet).

        ``deltas`` is the write-through queue the scheduler feeds from
        the informer (pod completions/deletions and peer-replica grants,
        each carrying the (pod rev, inventory rev) key it produced):
        a row whose entry moved to exactly the key its queued deltas
        chain to is PATCHED in place — O(chips touched) — instead of
        reloaded, the same adoption rule the group commit's
        ``expected_key`` already uses.  A chain that does not compose
        (an event the queue never saw) falls back to the reload.

        ``changed`` (Scheduler.snapshot_for_batch) is the exact set of
        names whose entry was replaced since the last refresh: with it
        the walk is O(changed + touched), not an O(fleet) identity scan
        per cycle.  Every delta's node is in ``changed`` by
        construction (its registry change marked the node dirty before
        the snapshot that covers it).  None = legacy full scan."""
        if changed is None:
            if snap.keys() != self._entries.keys():
                self._rebuild(snap)
                return self.N
            names = snap.keys()
        else:
            if len(snap) != len(self._entries):
                self._rebuild(snap)
                return self.N
            names = changed
            if self.touched:
                names = set(changed)
                names.update(self.names[r] for r in self.touched)
        touched, self.touched = self.touched, set()
        expected, self.expected_key = self.expected_key, {}
        reloaded = 0
        patched = 0
        for name in names:
            entry = snap.get(name)
            if entry is None or name not in self.row_of:
                # Node-set membership moved (register/unregister with
                # the fleet size coincidentally equal): rebuild.
                self._rebuild(snap)
                return self.N
            row = self.row_of[name]
            if self._entries.get(name) is entry:
                if row in touched:
                    # Solver charged grants that never committed (lost
                    # race / failed pod): roll the phantom state back.
                    self._load_row(row, name, entry)
                    reloaded += 1
                continue
            key = expected.get(row)
            if key == entry.key:
                # The entry moved to exactly the generation our group
                # commit published — its usage equals the written-
                # through columnar state; adopt without reloading.
                self._entries[name] = entry
                continue
            if deltas is not None and (key is not None
                                       or row not in touched):
                # A touched row WITHOUT a published expected key lost
                # its commit race: the mirrors hold phantom grants and
                # only a reload squares them — deltas must not patch on
                # top.  With the key published, every planned grant
                # committed and the mirrors are exact.
                pend = deltas.get(name)
                if pend is not None and self._apply_deltas(
                        row, name, entry,
                        key if key is not None
                        else self._entries[name].key, pend):
                    patched += 1
                    continue
            if len(entry.usage) > self.C:
                self._rebuild(snap)
                return self.N
            self._load_row(row, name, entry)
            reloaded += 1
        if reloaded:
            self.any_topology = any(self.p_topology)
        self.rows_reloaded_total += reloaded
        self.rows_patched_total += patched
        return reloaded

    def _apply_deltas(self, row: int, name: str, entry, start_key: tuple,
                      pend: list) -> bool:
        """Patch one row from its queued write-through deltas.  Each
        delta is ``(sign, devices, key)``; the chain must step the pod
        rev by exactly one per event from ``start_key`` to the entry's
        key — any gap means an event the queue never captured, and the
        caller reloads.  Validation runs BEFORE any mutation so a broken
        chain leaves the row untouched."""
        if pend[-1] is None:
            return False    # poisoned queue (note_delta's cap): reload
        if len(pend) > 1:
            pend = sorted(pend, key=lambda d: d[2][0])
        cur = start_key
        for _sign, _devices, key in pend:
            if key != (cur[0] + 1, cur[1]):
                return False
            cur = key
        if cur != entry.key:
            return False
        cols = self.col_of[row]
        us = self.p_used_slots[row]
        um = self.p_used_mem[row]
        uc = self.p_used_cores[row]
        # Dry-run the chip lookups + underflow check first (mutating
        # then failing would corrupt the row without a reload).
        staged: List[Tuple[int, int, int, int]] = []
        tallies: Dict[int, List[int]] = {}
        for sign, devices, _key in pend:
            for container in devices:
                for d in container:
                    c = cols.get(d.uuid)
                    if c is None:
                        return False
                    t = tallies.get(c)
                    if t is None:
                        t = tallies[c] = [0, 0, 0]
                    t[0] += sign
                    t[1] += sign * d.usedmem
                    t[2] += sign * d.usedcores
                    staged.append((c, sign, d.usedmem, d.usedcores))
        for c, t in tallies.items():
            if us[c] + t[0] < 0 or um[c] + t[1] < 0 or uc[c] + t[2] < 0:
                return False
        for c, sign, mem, cores in staged:
            us[c] += sign
            um[c] += sign * mem
            uc[c] += sign * cores
            if self.columns:
                self.used_slots[row, c] += sign
                self.used_mem[row, c] += sign * mem
                self.used_cores[row, c] += sign * cores
        self._recompute_base(row)
        self._entries[name] = entry
        self._note_dirty(row)
        return True

    def _rebuild(self, snap: Dict[str, object]) -> None:
        self.rebuilds += 1
        # Row indices move wholesale: every cached class evaluation is
        # keyed by row and must go with them.
        self._class_cache.clear()
        names = sorted(snap)
        c = max((len(e.usage) for e in snap.values()), default=1)
        self._alloc(len(names), max(1, c))
        self.names = names
        self.row_of = {n: i for i, n in enumerate(names)}
        self.chip_ids = [[] for _ in names]
        self.chip_types = [[] for _ in names]
        self.col_of = [{} for _ in names]
        self._entries = {}
        self.touched = set()
        for row, name in enumerate(names):
            self._load_row(row, name, snap[name])
        self.any_topology = any(self.p_topology)

    def _load_row(self, row: int, name: str, entry) -> None:
        us = entry.usage
        ids: List[str] = []
        types: List[str] = []
        n = len(us)
        p_us: List[int] = []
        p_um: List[int] = []
        p_uc: List[int] = []
        p_ts: List[int] = []
        p_tm: List[int] = []
        p_tc: List[int] = []
        p_h: List[bool] = []
        p_t: List[int] = []
        columns = self.columns
        for c, (cid, u) in enumerate(us.items()):
            ids.append(cid)
            types.append(u.type)
            tid = self._type_of(u.type)
            if columns:
                self.valid[row, c] = True
                self.health[row, c] = u.health
                self.type_id[row, c] = tid
                self.total_slots[row, c] = u.total_slots
                self.used_slots[row, c] = u.used_slots
                self.total_mem[row, c] = u.total_mem
                self.used_mem[row, c] = u.used_mem
                self.total_cores[row, c] = u.total_cores
                self.used_cores[row, c] = u.used_cores
            p_us.append(u.used_slots)
            p_um.append(u.used_mem)
            p_uc.append(u.used_cores)
            p_ts.append(u.total_slots)
            p_tm.append(u.total_mem)
            p_tc.append(u.total_cores)
            p_h.append(u.health)
            p_t.append(tid)
        if n < self.C and columns:
            self.valid[row, n:] = False
            self.health[row, n:] = False
            for arr in (self.type_id, self.total_slots, self.used_slots,
                        self.total_mem, self.used_mem, self.total_cores,
                        self.used_cores):
                arr[row, n:] = 0
        self.chip_ids[row] = ids
        self.chip_types[row] = types
        self.col_of[row] = {cid: c for c, cid in enumerate(ids)}
        self.p_used_slots[row] = p_us
        self.p_used_mem[row] = p_um
        self.p_used_cores[row] = p_uc
        self.p_total_slots[row] = tuple(p_ts)
        self.p_total_mem[row] = tuple(p_tm)
        self.p_total_cores[row] = tuple(p_tc)
        self.p_health[row] = tuple(p_h)
        self.p_type[row] = tuple(p_t)
        self.p_topology[row] = entry.info.topology is not None
        if self.has_topology is not None:
            self.has_topology[row] = self.p_topology[row]
        self._entries[name] = entry
        self._recompute_base(row)
        self._note_dirty(row)

    def _recompute_base(self, row: int) -> None:
        """Node spread score = Σ over chips of free fractions, in the
        CANONICAL order (per chip: mem fraction then cores fraction,
        sequential) — the vectorized evaluator accumulates column-by-
        column in the same order, so the two paths agree bitwise and
        tie-breaks never depend on which computed the score."""
        b = 0.0
        tm = self.p_total_mem[row]
        tc = self.p_total_cores[row]
        um = self.p_used_mem[row]
        uc = self.p_used_cores[row]
        for c in range(len(tm)):
            if tm[c] > 0:
                b += (tm[c] - um[c]) / tm[c]
            if tc[c] > 0:
                b += (tc[c] - uc[c]) / tc[c]
        self.base[row] = b
        if self._g_base is not None:
            self._g_base[row] = b

    def entry_of(self, name: str):
        return self._entries.get(name)

    def apply_grant(self, row: int, chips: List[int], mems: List[int],
                    coresreq: int) -> None:
        """Charge one in-batch grant to the solver's Python mirrors AND
        the numpy columns (write-through keeps the two views identical,
        so a cleanly-committed row needs no reload next refresh — see
        ``expected_key``).  The authoritative commit still goes through
        the scheduler's rev-validated registry insert."""
        us = self.p_used_slots[row]
        um = self.p_used_mem[row]
        uc = self.p_used_cores[row]
        columns = self.columns
        for c, m in zip(chips, mems):
            us[c] += 1
            um[c] += m
            uc[c] += coresreq
            if columns:
                self.used_slots[row, c] += 1
                self.used_mem[row, c] += m
                self.used_cores[row, c] += coresreq
        self._recompute_base(row)
        self.touched.add(row)
        self._note_dirty(row)

    def set_gates(self, alive: List[bool], bonus: List[float]) -> None:
        """Install the per-cycle row gates (lease aliveness and
        the measured-utilization bonus), dirtying exactly the rows whose
        gate moved — a steady fleet pays an O(N) scalar compare, not a
        fleet-wide class re-evaluation."""
        old_a, old_b = self.alive, self.bonus
        if len(old_a) == len(alive) and self._class_cache:
            for r in range(len(alive)):
                if alive[r] != old_a[r] or bonus[r] != old_b[r]:
                    self._note_dirty(r)
        self.alive = alive
        self.bonus = bonus
        if self._g_alive is not None and len(alive) == self.N:
            # Mirror into the shared columns so solve workers read the
            # gates without per-request shipping (a Python float IS an
            # IEEE float64 — the mirrored values are the same bits).
            self._g_alive[:] = alive
            self._g_bonus[:] = bonus

    #: Cached class evaluations kept live at once.  Small on purpose:
    #: a storm has a handful of request shapes; an adversarial stream
    #: of unique shapes degrades to the uncached full eval, never to
    #: unbounded memory.
    CLASS_CACHE_MAX = 32
    #: Above this fraction of dirty rows the vectorized whole-fleet
    #: pass is cheaper than scalar row patching (both produce the same
    #: bits — the parity suite pins it).
    PATCH_FRACTION = 4

    def class_eval(self, fp: tuple, req, affinity,
                   binpack: bool) -> "_ClassEval":
        """Cached-or-built evaluation columns for one request class.
        A hit re-evaluates only the rows dirtied since the class last
        synced; a miss (or a dirty set too large to patch profitably)
        runs the vectorized whole-fleet pass."""
        ce = self._class_cache.get(fp)
        if ce is not None and ce.binpack == binpack:
            self._class_cache.move_to_end(fp)
            if len(ce.allowed) < len(self._types):
                # New chip types registered since the class was built:
                # extend the affinity mask (type ids only ever append).
                ce.allowed.extend(
                    score_mod.type_allows(ce.affinity, t)
                    for t in self._types[len(ce.allowed):])
            pending = ce.pending
            if len(pending) * self.PATCH_FRACTION > max(1, self.N):
                self._full_eval(ce)
                self.class_evals_full += 1
            else:
                for row in pending:
                    eval_class_row(self, ce, row)
                self.class_rows_patched += len(pending)
            pending.clear()
            return ce
        ce = _ClassEval(req, affinity, binpack)
        self._full_eval(ce)
        self.class_evals_full += 1
        while len(self._class_cache) >= self.CLASS_CACHE_MAX:
            self._class_cache.popitem(last=False)
        self._class_cache[fp] = ce
        return ce

    def _full_eval(self, ce: "_ClassEval") -> None:
        """Whole-fleet evaluation of one class: offloaded to the solve
        worker pool when one is installed (row-sharded across worker
        processes, bit-identical by construction), in-process
        otherwise — and in-process as the fallback whenever the pool
        cannot complete, so pool health never gates correctness."""
        pool = self.pool
        if pool is not None and pool.eval_class(self, ce):
            self.class_evals_offloaded += 1
            return
        eval_class_full(self, ce)


class _ClassEval:
    """One request class's outcome over every node: fit mask, chosen
    chip + resolved mem (single-chip classes), and the post-placement
    node score (−inf where the class does not fit).  Evaluated fully
    (vectorized) at cycle start; patched per row (scalar) after each
    in-batch assignment.  ``score``/``chip``/``mem`` are plain Python
    lists — the solver reads and writes them scalar-at-a-time."""

    __slots__ = ("req", "affinity", "nums", "binpack", "allowed", "pct",
                 "score", "chip", "mem", "pending")

    def __init__(self, req, affinity, binpack: bool) -> None:
        self.req = req
        self.affinity = affinity
        self.nums = max(1, req.nums)
        self.binpack = binpack
        self.allowed: List[bool] = []
        pct = req.mem_percentage_req if req.mem_percentage_req > 0 else 100
        self.pct = pct
        self.score: List[float] = []
        self.chip: List[int] = []
        self.mem: List[int] = []
        #: Rows dirtied since this class's columns last synced — the
        #: fleet's class cache re-evaluates exactly these (see
        #: ColumnarFleet.class_eval).
        self.pending: Set[int] = set()


def class_fingerprint(requests, anns, policy_default: str) -> tuple:
    """Dedup key for a batchable pod: the same request fingerprint the
    per-pod fit cache uses, plus the topology policy.  The declared
    ``vtpu.dev/mesh`` is left out, as in the JAX package: a pod with a
    mesh and more than one card never reaches the class evaluator (the
    slice stage places it), and a one-card pod's fit ignores its mesh on
    every path."""
    affinity = score_mod.parse_affinity(anns)
    policy = anns.get(score_mod.TOPOLOGY_POLICY_ANNOTATION, policy_default)
    return (tuple((r.nums, r.type, r.memreq, r.mem_percentage_req,
                   r.coresreq) for r in requests),
            None if affinity[0] is None else tuple(affinity[0]),
            tuple(affinity[1]), policy)


def eval_class_full(fleet: ColumnarFleet, ce: _ClassEval) -> None:
    """Whole-fleet evaluation of one request class: with the numpy
    columns, one vectorized pass (``parallelcp/vector.py``: the pods x
    cards predicates collapse to the class's ``[N, C]`` mask, the card
    choice to a packed-key argmax or argsort, the node score to ``base -
    delta``); without them, :func:`eval_class_row` on every row, the same
    rules in the same arithmetic order, so the same bits.  A solve worker
    runs this over its rows of the shared columns."""
    ce.allowed = [score_mod.type_allows(ce.affinity, t)
                  for t in fleet._types]
    if fleet.N == 0:
        ce.score, ce.chip, ce.mem = [], [], []
        return
    if fleet.valid is not None:
        from ..parallelcp import vector
        vector.eval_class_full(fleet, ce)
        return
    ce.score = [_NEG_INF] * fleet.N
    ce.chip = [-1] * fleet.N
    ce.mem = [0] * fleet.N
    for row in range(fleet.N):
        eval_class_row(fleet, ce, row)


def eval_class_row(fleet: ColumnarFleet, ce: _ClassEval, row: int) -> None:
    """Scalar one-row re-evaluation after an in-batch grant changed the
    row — the same rules and the same arithmetic order as
    :func:`eval_class_full`, over ≤ a dozen chips (faster in Python than
    a numpy call chain at this size; bitwise-equality pinned by the
    parity suite)."""
    req = ce.req
    cores = req.coresreq
    memreq = req.memreq
    pct = ce.pct
    us = fleet.p_used_slots[row]
    um = fleet.p_used_mem[row]
    uc = fleet.p_used_cores[row]
    ts = fleet.p_total_slots[row]
    tm = fleet.p_total_mem[row]
    tc = fleet.p_total_cores[row]
    health = fleet.p_health[row]
    types = fleet.p_type[row]
    allowed = ce.allowed
    exclusive = cores >= 100
    k = ce.nums
    if k <= 1:
        best_key = -1
        chip = -1
        mem_at = 0
        for c in range(len(ts)):
            if not health[c] or not allowed[types[c]]:
                continue
            if us[c] >= ts[c] or uc[c] >= tc[c]:
                continue
            if cores > tc[c] - uc[c]:
                continue
            m = memreq if memreq > 0 else tm[c] * pct // 100
            if m > tm[c] - um[c]:
                continue
            if exclusive and (us[c] > 0 or uc[c] > 0):
                continue
            key = us[c] * _KEY_BASE + um[c]
            if key > best_key:
                best_key = key
                chip = c
                mem_at = m
        if chip < 0 or not fleet.alive[row]:
            ce.score[row] = _NEG_INF
            ce.chip[row] = chip
            return
        delta = ((mem_at / tm[chip] if tm[chip] > 0 else 0.0)
                 + (cores / tc[chip] if tc[chip] > 0 else 0.0))
        after = fleet.base[row] - delta
        ce.score[row] = ((-after if ce.binpack else after)
                         + fleet.bonus[row])
        ce.chip[row] = chip
        ce.mem[row] = mem_at
        return
    chips, mems = _choose_multi(fleet, ce, row)
    if len(chips) < k or not fleet.alive[row]:
        ce.score[row] = _NEG_INF
        return
    delta = 0.0
    for c, m in zip(chips, mems):
        delta += ((m / tm[c] if tm[c] > 0 else 0.0)
                  + (cores / tc[c] if tc[c] > 0 else 0.0))
    after = fleet.base[row] - delta
    ce.score[row] = (-after if ce.binpack else after) + fleet.bonus[row]


def _choose_multi(fleet: ColumnarFleet, ce: _ClassEval,
                  row: int) -> Tuple[List[int], List[int]]:
    """First ``nums`` eligible chips in binpack-preference order
    (fit_container's sorted()[:k], stable ties by chip index)."""
    req = ce.req
    cores = req.coresreq
    memreq = req.memreq
    pct = ce.pct
    us = fleet.p_used_slots[row]
    um = fleet.p_used_mem[row]
    uc = fleet.p_used_cores[row]
    ts = fleet.p_total_slots[row]
    tm = fleet.p_total_mem[row]
    tc = fleet.p_total_cores[row]
    health = fleet.p_health[row]
    types = fleet.p_type[row]
    allowed = ce.allowed
    exclusive = cores >= 100
    eligible: List[Tuple[int, int]] = []   # (-key, chip)
    mems: Dict[int, int] = {}
    for c in range(len(ts)):
        if not health[c] or not allowed[types[c]]:
            continue
        if us[c] >= ts[c] or uc[c] >= tc[c]:
            continue
        if cores > tc[c] - uc[c]:
            continue
        m = memreq if memreq > 0 else tm[c] * pct // 100
        if m > tm[c] - um[c]:
            continue
        if exclusive and (us[c] > 0 or uc[c] > 0):
            continue
        eligible.append((-(us[c] * _KEY_BASE + um[c]), c))
        mems[c] = m
    eligible.sort()
    chosen = [c for _k, c in eligible[:ce.nums]]
    return chosen, [mems[c] for c in chosen]


def choose_chips(fleet: ColumnarFleet, ce: _ClassEval,
                 row: int) -> Tuple[List[int], List[int]]:
    """Chip indices + resolved mems for one assignment on ``row``."""
    if ce.nums <= 1:
        return [ce.chip[row]], [ce.mem[row]]
    return _choose_multi(fleet, ce, row)


def node_reject_reason(fleet: ColumnarFleet, req, affinity,
                       row: int) -> str:
    """Why this request class does not fit ``row`` — the SAME summary
    string the scalar path produces (``score._reject_summary`` /
    ``fit_container``'s reasons out-param), derived from the columnar
    mirrors: per-chip first-failing rule in ``_chip_reject_reason``'s
    exact rule order, tallied in chip order, dominant token first.
    Parity is pinned by tests/test_torch_batch.py: a rule added to
    score.py without its columnar twin fails the pin, so batched-path
    rejections never drift into coarser tokens than the per-pod
    path's."""
    cores = req.coresreq
    memreq = req.memreq
    pct = req.mem_percentage_req if req.mem_percentage_req > 0 else 100
    us = fleet.p_used_slots[row]
    um = fleet.p_used_mem[row]
    uc = fleet.p_used_cores[row]
    ts = fleet.p_total_slots[row]
    tm = fleet.p_total_mem[row]
    tc = fleet.p_total_cores[row]
    health = fleet.p_health[row]
    types = fleet.p_type[row]
    allowed = [score_mod.type_allows(affinity, t) for t in fleet._types]
    exclusive = cores >= 100
    tally: Dict[str, int] = {}
    n = len(ts)
    for c in range(n):
        if not health[c]:
            why = "unhealthy"
        elif not allowed[types[c]]:
            why = "type-mismatch"
        elif ts[c] - us[c] <= 0:
            why = "slots-exhausted"
        elif uc[c] >= tc[c]:
            why = "cores-exhausted"
        elif exclusive and (us[c] > 0 or uc[c] > 0):
            why = "exclusive-chip-busy"
        elif cores > tc[c] - uc[c]:
            why = "insufficient-cores"
        elif (memreq if memreq > 0
              else tm[c] * pct // 100) > tm[c] - um[c]:
            why = "insufficient-hbm"
        else:
            continue
        tally[why] = tally.get(why, 0) + 1
    if not tally:
        return (f"too-few-chips: node has {n} chips, "
                f"request needs {req.nums}")
    detail = ", ".join(f"{k}/{n} {why}" for why, k in
                       sorted(tally.items(), key=lambda kv: -kv[1]))
    return f"{max(tally, key=tally.get)}: {detail}"


class _Cohort:
    """Jobs sharing (request class, offered-node set): they see identical
    score rows, so the solver evaluates once per cohort, not per pod.
    The candidate ranking lives in a lazy max-heap keyed (−score, offer
    position): every score change pushes a fresh entry, stale entries
    are discarded when popped (they no longer match ``ce.score``), so a
    best/second read is O(log rows) instead of an O(rows) rescan per
    assignment — the term that dominated large-fleet cycles."""

    __slots__ = ("ce", "rows", "rowset", "pos_of", "jobs", "head",
                 "heap")

    def __init__(self, ce: _ClassEval, rows: Optional[List[int]],
                 rowset: Optional[Set[int]] = None,
                 pos_of: Optional[Dict[int, int]] = None) -> None:
        self.ce = ce
        self.rows = rows        # fleet rows in OFFER order; None = all
        if rows is None:
            self.rowset = None
            self.pos_of = None
        elif rowset is not None and pos_of is not None:
            # Prebuilt offer structures (the engine's cross-cycle offer
            # memo): a steady drain re-offers the same fleet-wide list
            # every cycle, and rebuilding set+positions per cohort per
            # cycle was O(fleet) Python the cached columns had just
            # saved elsewhere.
            self.rowset = rowset
            self.pos_of = pos_of
        else:
            self.rowset = set(rows)
            self.pos_of: Dict[int, int] = {}
            for pos, r in enumerate(rows):
                self.pos_of.setdefault(r, pos)   # first offer slot wins
        #: (rank, original job index) in fair-share priority order; the
        #: regret solver consumes members head-first, so within a cohort
        #: earlier-released pods place first.
        self.jobs: List[Tuple[int, int]] = []
        self.head = 0
        score = ce.score
        it = rows if rows is not None else range(len(score))
        heap = []
        for pos, r in enumerate(it):
            s = score[r]
            if s != _NEG_INF:
                heap.append((-s, pos, r))
        heapq.heapify(heap)
        self.heap = heap

    def note_update(self, row: int) -> None:
        """A grant changed ``row``'s score: push the fresh value (the
        superseded entries die lazily on pop)."""
        if self.rowset is None:
            pos = row
        else:
            pos = self.pos_of.get(row)
            if pos is None:
                return
        s = self.ce.score[row]
        if s != _NEG_INF:
            heapq.heappush(self.heap, (-s, pos, row))

    def best2(self) -> Tuple[float, int, float]:
        """(best score, fleet row of best, second-best score); the
        (−score, offer position) heap order keeps the FIRST maximum in
        offer order — the serial path's iteration tie-break."""
        score = self.ce.score
        heap = self.heap
        saved: List[Tuple[float, int, int]] = []
        best = _NEG_INF
        best_row = -1
        second = _NEG_INF
        while heap:
            entry = heap[0]
            negs, _pos, r = entry
            if -negs != score[r]:
                heapq.heappop(heap)     # stale: a fresher entry exists
                continue
            if best_row < 0:
                best = -negs
                best_row = r
                saved.append(heapq.heappop(heap))
                continue
            if r == best_row:           # duplicate of the best entry
                saved.append(heapq.heappop(heap))
                continue
            second = -negs
            break
        for e in saved:
            heapq.heappush(heap, e)
        return best, best_row, second


def solve(fleet: ColumnarFleet, cohorts: List[_Cohort], n_jobs: int,
          solver: str) -> List[Optional[Tuple[int, List[int], List[int]]]]:
    """Joint placement over the score matrix.  Returns, per ORIGINAL job
    index, ``(fleet row, chip indices, mems)`` or None (no fit).

    ``fifo`` assigns in priority (fair-share release) order by
    sequential argmax — decision parity with the serial per-pod path.
    ``regret`` assigns the largest best-minus-second-best gap first:
    when pods contend for the same node, the pod that has somewhere
    else to go yields to the pod that does not — strictly better
    packing than sequential argmax, proven by the contention tests.
    Capacity only shrinks within a cycle, so a cohort that stops
    fitting never fits again and its remaining members resolve to None
    (the caller's per-pod fallback re-checks them against the live
    fleet and produces reasons).  (The JAX solver also records each
    assignment's best and runner-up scores for the decision provenance
    store, which waits for ROADMAP A.5 provenance.)"""
    results: List[Optional[Tuple[int, List[int], List[int]]]] = \
        [None] * n_jobs

    def assign(cohort: _Cohort, job_idx: int, row: int) -> None:
        chips, mems = choose_chips(fleet, cohort.ce, row)
        results[job_idx] = (row, chips, mems)
        fleet.apply_grant(row, chips, mems, cohort.ce.req.coresreq)
        # Cohorts sharing one request class share the cached _ClassEval:
        # re-evaluate each distinct class once, then refresh every
        # cohort's heap view.
        seen: Set[int] = set()
        for c in cohorts:
            if id(c.ce) not in seen:
                seen.add(id(c.ce))
                eval_class_row(fleet, c.ce, row)
                # This class is now CURRENT for the row (apply_grant's
                # dirty mark just landed in pending): without the
                # discard, every committed row would re-evaluate again
                # next cycle for nothing — the expected-key adoption
                # leaves the mirrors exactly as scored here.  A lost
                # commit re-dirties via the reload.
                c.ce.pending.discard(row)
            c.note_update(row)

    if solver == "fifo":
        ordered = sorted(((rank, idx, c) for c in cohorts
                          for rank, idx in c.jobs))
        for _rank, idx, cohort in ordered:
            best, row, _second = cohort.best2()
            if best == _NEG_INF:
                continue
            assign(cohort, idx, row)
        return results

    # Lazy greedy-with-regret: heap entries carry the version (number of
    # assignments so far) they were scored at; a popped entry scored
    # against a superseded state is re-scored and pushed back, so every
    # assignment uses fresh scores.
    version = 0
    heap: List[Tuple[float, int, int, int, int]] = []

    def push(ci: int) -> None:
        cohort = cohorts[ci]
        best, row, second = cohort.best2()
        regret = math.inf if second == _NEG_INF else best - second
        rank = cohort.jobs[cohort.head][0]
        heapq.heappush(heap, (-regret, rank, ci, row, version))

    for ci in range(len(cohorts)):
        push(ci)   # -inf best still enters: resolved to None on pop
    while heap:
        _negr, _rank, ci, row, ver = heapq.heappop(heap)
        cohort = cohorts[ci]
        if cohort.head >= len(cohort.jobs):
            continue
        if ver != version:
            push(ci)   # stale score: re-rank against the current state
            continue
        best = cohort.ce.score[row] if row >= 0 else _NEG_INF
        if best == _NEG_INF:
            # Monotone capacity: nothing left for this whole cohort.
            cohort.head = len(cohort.jobs)
            continue
        job_idx = cohort.jobs[cohort.head][1]
        cohort.head += 1
        assign(cohort, job_idx, row)
        version += 1
        if cohort.head < len(cohort.jobs):
            push(ci)
    return results


class BatchStats:
    """Prometheus-shaped histograms of batch size and cycle latency
    (writes take the small lock; the metrics collector reads a
    consistent snapshot under it)."""

    SIZE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)
    LAT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5)

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._size_counts = [0] * (len(self.SIZE_BUCKETS) + 1)
        self._lat_counts = [0] * (len(self.LAT_BUCKETS) + 1)
        self.size_sum = 0.0
        self.lat_sum = 0.0
        self.cycles = 0
        self.pods = 0
        self.fallbacks = 0      # jobs resolved via the per-pod path
        self.conflicts = 0      # group-commit members that lost a rev race
        #: Per-cause fallback counts (vtpu_filter_batch_fallbacks_total
        #: {reason=...}): "slice-no-fit" (a topology/mesh job the
        #: in-cycle slice stage could not place), "no-fit" (a vector job
        #: the solver found no node for), "commit-conflict" (lost a rev
        #: race in the group commit), "error" (a cycle-internal failure
        #: resolved per-pod).  Bounded, fixed label set.
        self.fallback_reasons: Dict[str, int] = {}

    def record(self, size: int, seconds: float, fallbacks: int,
               conflicts: int,
               reasons: Optional[Dict[str, int]] = None) -> None:
        with self._lock:
            self.cycles += 1
            self.pods += size
            self.size_sum += size
            self.lat_sum += seconds
            self.fallbacks += fallbacks
            self.conflicts += conflicts
            for reason, n in (reasons or {}).items():
                self.fallback_reasons[reason] = \
                    self.fallback_reasons.get(reason, 0) + n
            for i, b in enumerate(self.SIZE_BUCKETS):
                if size <= b:
                    self._size_counts[i] += 1
                    break
            else:
                self._size_counts[-1] += 1
            for i, b in enumerate(self.LAT_BUCKETS):
                if seconds <= b:
                    self._lat_counts[i] += 1
                    break
            else:
                self._lat_counts[-1] += 1

    @staticmethod
    def _prom(buckets, counts) -> List[Tuple[str, float]]:
        out: List[Tuple[str, float]] = []
        cum = 0
        for b, n in zip(buckets, counts):
            cum += n
            out.append((str(float(b)), cum))
        out.append(("+Inf", cum + counts[-1]))
        return out

    def fallback_reason_counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.fallback_reasons)

    def size_histogram(self) -> Tuple[List[Tuple[str, float]], float]:
        with self._lock:
            return self._prom(self.SIZE_BUCKETS, self._size_counts), \
                self.size_sum

    def size_distribution(self) -> Dict[str, int]:
        """Per-bucket (non-cumulative) cycle counts: the batch-size
        distribution a storm reports."""
        with self._lock:
            out = {f"<={b}": n for b, n in zip(self.SIZE_BUCKETS,
                                               self._size_counts) if n}
            if self._size_counts[-1]:
                out[f">{self.SIZE_BUCKETS[-1]}"] = self._size_counts[-1]
            return out

    def latency_histogram(self) -> Tuple[List[Tuple[str, float]], float]:
        with self._lock:
            return self._prom(self.LAT_BUCKETS, self._lat_counts), \
                self.lat_sum


class BatchEngine:
    """The scheduler's batch front: a leader/follower gate that collapses
    concurrent ``filter()`` calls into cycles (same shape as
    util/decisionwriter.DecisionBatcher), and the cycle itself —
    snapshot → columnar refresh → class eval → joint solve → per-node
    rev-validated group commit → per-pod fallback for the remainder."""

    def __init__(self, scheduler) -> None:
        self.s = scheduler
        self.pool = None
        workers = int(getattr(scheduler.cfg, "solve_workers", 0) or 0)
        if workers > 0:
            # Opt-in multicore path: columns move into shared-memory
            # segments and full class evaluations fan out to worker
            # processes.  Deferred import — parallelcp imports this
            # module for the evaluator it re-executes.
            from ..parallelcp import SharedColumnStore, SolveWorkerPool
            store = SharedColumnStore()
            self.fleet = ColumnarFleet(store=store)
            self.pool = SolveWorkerPool(store, workers)
            self.fleet.pool = self.pool
        else:
            self.fleet = ColumnarFleet()
        self.stats = BatchStats()
        # One cycle at a time: the columnar state is single-writer.
        self._cycle_lock = threading.Lock()
        self._qlock = threading.Lock()
        self._queue: List[BatchJob] = []
        self._leader_active = False
        self._full = threading.Event()
        # Write-through delta queue: the informer thread records pod
        # completions/deletions (and peer-replica grants) here as
        # (sign, devices, resulting key); the next cycle's refresh
        # patches the affected rows in place instead of reloading them
        # (ColumnarFleet.refresh).  Own small lock — the fleet itself
        # is single-writer under the cycle lock.
        self._delta_lock = threading.Lock()
        self._pending_deltas: Dict[str, list] = {}
        # Cross-cycle offer memo: offer tuple -> (rows, rowset, pos_of)
        # against the CURRENT row layout.  Keyed on content (not list
        # identity — ids recycle across cycles); invalidated wholesale
        # when a rebuild moves row indices.  Bounded like the class
        # cache.
        self._offer_memo: Dict[tuple, tuple] = {}
        self._offer_memo_rebuilds = -1

    #: Queued deltas kept per node between cycles.  Past the cap the
    #: node's queue is POISONED (a single None sentinel): the next
    #: refresh falls back to the row reload, and the queue stays O(1)
    #: — a scheduler whose batch path is idle (filter_batch off, or a
    #: long arrival lull under a completion stream) must not retain an
    #: unbounded tail of device lists.
    DELTA_CAP = 128

    def note_delta(self, node: str, devices, sign: int,
                   key: tuple) -> None:
        """Queue one write-through usage delta for ``node`` (called by
        the scheduler's informer paths after the usage cache accepted
        the same delta)."""
        with self._delta_lock:
            pend = self._pending_deltas.get(node)
            if pend is None:
                pend = self._pending_deltas[node] = []
            elif pend and pend[-1] is None:
                return          # already poisoned: reload will square it
            elif len(pend) >= self.DELTA_CAP:
                pend.clear()
                pend.append(None)
                return
            pend.append((sign, devices, key))

    def _drain_deltas(self) -> Dict[str, list]:
        with self._delta_lock:
            deltas, self._pending_deltas = self._pending_deltas, {}
        return deltas

    def close(self) -> None:
        """Drain the solve worker pool and unlink the shared-memory
        segments (idempotent; a no-op on the default in-process
        configuration)."""
        pool, self.pool = self.pool, None
        self.fleet.pool = None
        if pool is not None:
            pool.close()
        store, self.fleet.store = self.fleet.store, None
        if store is not None:
            store.close()

    # -- the gate (filter() path) ----------------------------------------------
    def submit(self, job: BatchJob):
        """Enqueue one pod and return its FilterResult.  The first caller
        into an idle gate leads: it waits up to ``batch_tick_ms`` for
        concurrent Filters to pile on, then drains the queue through
        cycles until empty and resigns."""
        cfg = self.s.cfg
        job.done = threading.Event()
        with self._qlock:
            self._queue.append(job)
            depth = len(self._queue)
            lead = not self._leader_active
            if lead:
                self._leader_active = True
                self._full.clear()
            elif depth >= cfg.batch_max:
                self._full.set()
        perf.registry().set_gauge("pending_queue_depth", depth)
        if not lead:
            job.done.wait()
            return job.result
        if cfg.batch_tick_ms > 0:
            self._full.wait(cfg.batch_tick_ms / 1000.0)
        batch: List[BatchJob] = []
        try:
            while True:
                with self._qlock:
                    batch = self._queue[:cfg.batch_max]
                    del self._queue[:len(batch)]
                    if not batch:
                        self._leader_active = False
                        # Queue drained: nothing is waiting, so the
                        # drain-age figure (a CURRENT wait) is zero.
                        reg = perf.registry()
                        reg.set_gauge("pending_queue_depth", 0)
                        reg.set_gauge("drain_age_s", 0.0)
                        break
                results = self.decide_many(batch)
                for j, r in zip(batch, results):
                    j.result = r
                    if j.done is not None:
                        j.done.set()
        except BaseException:
            # Leader died mid-cycle: resolve everything in flight or the
            # followers block forever (DecisionBatcher's discipline).
            with self._qlock:
                orphans, self._queue = self._queue, []
                self._leader_active = False
            from .core import FilterResult
            for j in batch + orphans:
                if j.done is not None and not j.done.is_set():
                    j.result = FilterResult(error="batch cycle leader died")
                    j.done.set()
            raise
        return job.result

    # -- one cycle -------------------------------------------------------------
    def decide_many(self, jobs: List[BatchJob]) -> List[object]:
        """Run one batched scheduling cycle over ``jobs``.  Returns one
        FilterResult per job, in input order."""
        from .core import FilterResult  # cycle-free deferred import

        t0 = time.monotonic()
        tr = trace.tracer()
        reg = perf.registry()
        # Drain age: how long the oldest pod of this cycle waited
        # between routing and its tick (the gate wait + backlog depth
        # made visible — a growing age means ticks can't keep up).
        # The figure is a CURRENT wait, so /perfz must not report the
        # last storm's age next to an empty queue indefinitely: the
        # gate leader zeroes it when its queue drains, and filter_many
        # zeroes it after its batched chunks complete.
        oldest = min((j.enqueued_at for j in jobs if j.enqueued_at),
                     default=0.0)
        reg.set_gauge("drain_age_s", t0 - oldest if oldest else 0.0)
        phases: Dict[str, float] = {}
        ranks = self.fair_share_ranks(jobs)
        results: List[Optional[object]] = [None] * len(jobs)
        fallback: set = set()
        reasons: Dict[str, int] = {}
        conflicts = 0
        with self._cycle_lock, \
                tr.span("batch-cycle", pods=len(jobs)) as sp:
            pt = time.monotonic()
            # Deltas drained BEFORE the snapshot: every drained event's
            # registry change (and its dirty mark) precedes the
            # snapshot, so the snapshot's entries cover the drained
            # chain; an event landing after the drain waits one cycle.
            deltas = self._drain_deltas()
            snap, changed = self.s.snapshot_for_batch()
            phases["snapshot"] = time.monotonic() - pt
            # Columnar refresh, split full-rebuild vs incremental (the
            # roadmap's "rebuilds must stay O(changed rows)" watchpoint:
            # a steady state spending its ticks in columnar-rebuild is
            # the regression this phase exists to catch).
            pt = time.monotonic()
            rebuilds_before = self.fleet.rebuilds
            patched_before = self.fleet.rows_patched_total
            reloaded = self.fleet.refresh(snap, deltas, changed)
            self._gate_rows()
            refresh_s = time.monotonic() - pt
            full = self.fleet.rebuilds != rebuilds_before
            phases["columnar-rebuild" if full
                   else "columnar-refresh"] = refresh_s
            reg.set_gauge("columnar_rows_reloaded", reloaded)
            reg.set_gauge("columnar_rows_patched",
                          self.fleet.rows_patched_total - patched_before)
            vector: List[int] = []
            slices: List[int] = []
            for i, job in enumerate(jobs):
                req = job.requests[0]
                if req.nums > 1 and (self.fleet.any_topology
                                     or MESH_ANNOTATION in job.anns):
                    # Slice/mesh placements need the slice engine:
                    # placed sequentially in-cycle against copy-on-write
                    # snapshot views, then group-committed with everyone
                    # else.  Mesh pods route
                    # here even on a topology-less fleet: fit_pod then
                    # rejects them (topology-unverifiable) exactly like
                    # the per-pod path, instead of the vector stage
                    # silently scattering a declared mesh.
                    slices.append(i)
                else:
                    vector.append(i)
            plan: List[Optional[Tuple[int, List[int], List[int]]]] = \
                [None] * len(jobs)
            if slices:
                pt = time.monotonic()
                self._place_slices(jobs, slices, ranks, plan)
                phases["slice-stage"] = time.monotonic() - pt
                for i in slices:
                    if plan[i] is None:
                        fallback.add(i)
                        reasons["slice-no-fit"] = \
                            reasons.get("slice-no-fit", 0) + 1
            # Vector evaluation runs AFTER the slice stage: the slice
            # grants are charged into the columnar fleet, so the class
            # matrices already price them in.
            pt = time.monotonic()
            cohorts = self._build_cohorts(jobs, vector, ranks)
            phases["vector-eval"] = time.monotonic() - pt
            pt = time.monotonic()
            vplan = solve(self.fleet, cohorts, len(jobs),
                          self.s.cfg.batch_solver)
            phases["solve"] = time.monotonic() - pt
            for i in vector:
                plan[i] = vplan[i]
            pt = time.monotonic()
            committed, lost = self._commit(
                snap, jobs, vector + slices, plan)
            phases["group-commit"] = time.monotonic() - pt
            conflicts = len(lost)
            if lost:
                reasons["commit-conflict"] = \
                    reasons.get("commit-conflict", 0) + len(lost)
            for i, res in committed.items():
                results[i] = res
            fallback.update(lost)
            unfit_vector = [i for i in vector if results[i] is None
                            and i not in fallback]
            if unfit_vector:
                # (The JAX cycle also records each one's
                # batch_no_fit_reasons as provenance when that store is
                # on; the port's waits for ROADMAP A.5 provenance.)
                reasons["no-fit"] = len(unfit_vector)
            fallback.update(unfit_vector)
            sp.set("committed", len(committed))
            sp.set("fallback", len(fallback))
        # Per-pod fallback OUTSIDE the cycle lock: these run the normal
        # optimistic protocol (fresh snapshot — which already includes
        # this cycle's grants — conflict retries, preemption planning,
        # per-node failure reasons).
        ft = time.monotonic()
        for i in sorted(fallback, key=lambda i: ranks[i]):
            job = jobs[i]
            with tr.span("batch-fallback", trace_id=job.trace_id,
                         pod=job.name) as fsp:
                try:
                    results[i] = self.s._decide_optimistic(
                        job.pod, job.requests, job.node_names, fsp)
                except Exception as e:  # noqa: BLE001 — one pod's failure
                    # must not poison the cycle's other decisions.
                    log.exception("batch fallback for %s failed", job.name)
                    fsp.set("error", str(e))
                    reasons["error"] = reasons.get("error", 0) + 1
                    results[i] = FilterResult(
                        error=f"batch fallback failed: {e}")
        if fallback:
            phases["fallback"] = time.monotonic() - ft
        total = time.monotonic() - t0
        self.stats.record(len(jobs), total, len(fallback), conflicts,
                          reasons)
        # Per-cycle breakdown into the performance observatory: each
        # phase's ring (cross-cycle quantiles) + the tick journal (the
        # /perfz slow-tick table with this cycle's split), plus the
        # cycle total the VtpuSchedulerTickStall alert watches.
        if reg.enabled:
            for name, seconds in phases.items():
                reg.phase(name).record(seconds)
            reg.phase("cycle-total").record(total)
            reg.note_tick("batch-cycle", total, phases, pods=len(jobs),
                          fallbacks=len(fallback), conflicts=conflicts)
        return [r if r is not None
                else FilterResult(error="batch cycle produced no decision")
                for r in results]

    def batch_no_fit_reasons(self, job: BatchJob,
                             limit: int = 8) -> Dict[str, str]:
        """Why a vector job the solver found no node for fits none: the
        per-node rejection tokens over the first ``limit`` offered nodes,
        from the same rule set as the scalar path (``node_reject_reason``)
        plus the lease or shard gate's reason for a gated row, the batched
        twin of the per-pod path's failed map.  (The JAX cycle emits it as a
        provenance record; the port's store waits for ROADMAP A.5
        provenance.)"""
        fleet = self.fleet
        req = job.requests[0]
        affinity = score_mod.parse_affinity(job.anns)
        reasons: Dict[str, str] = {}
        for name in job.node_names:
            if len(reasons) >= limit:
                break
            row = fleet.row_of.get(name)
            if row is None:
                reasons[name] = "no GPU inventory registered"
                continue
            if not fleet.alive[row]:
                why = self.s.leases.reject_reason(name)
                if why is None and self.s.shards.enabled:
                    why = self.s.shards.reject_reason(name)
                reasons[name] = why or "gated"
                continue
            reasons[name] = node_reject_reason(fleet, req, affinity, row)
        return reasons

    def fair_share_ranks(self, jobs: List[BatchJob]) -> List[int]:
        """Per-job priority rank for the solver: arrival order, except
        that quota-governed pods are reordered among themselves by the
        admission loop's release sequence (the fair-share order): a
        drain must not invert the order fairness released in, and must
        not privilege governed pods over ungoverned ones either."""
        ranks = list(range(len(jobs)))
        quota = self.s.quota
        if not quota.enabled or len(jobs) < 2:
            return ranks
        seqs = [quota.release_seq_of(j.uid) for j in jobs]
        governed = [i for i, s in enumerate(seqs) if s is not None]
        if len(governed) < 2:
            return ranks
        # Governed pods swap ranks among their own arrival slots, sorted
        # by release sequence; everyone else keeps their slot.
        by_release = sorted(governed, key=lambda i: seqs[i])
        for slot, i in zip(governed, by_release):
            ranks[i] = slot
        return ranks

    def _gate_rows(self) -> None:
        """Per-cycle node gates: the lease reject (suspect and dead nodes
        take no new placements), the shard-ownership gate (another replica
        owns the node's placements) and the measured-utilization bonus."""
        fleet = self.fleet
        shards = self.s.shards
        # One lease-lock acquisition for the whole row set.
        alive = self.s.leases.alive_map(fleet.names)
        if shards.enabled:
            # placeable() fails closed before a shard map is seen: a blind
            # replica gates out the whole fleet, as the per-pod paths'
            # shard-no-map does.
            alive = [ok and shards.placeable(name)
                     for ok, name in zip(alive, fleet.names)]
        if self.s.cfg.score_by_actual:
            from ..accounting import efficiency as eff_mod
            bonus = [
                eff_mod.actual_idle_bonus(self.s.ledger, name,
                                          len(fleet.chip_ids[row]))
                for row, name in enumerate(fleet.names)]
        else:
            bonus = [0.0] * fleet.N
        # set_gates dirties exactly the rows whose gate moved, so the
        # cached class columns re-evaluate O(changed rows), not O(fleet).
        fleet.set_gates(alive, bonus)

    def _place_slices(self, jobs: List[BatchJob], slices: List[int],
                      ranks: List[int], plan: List) -> None:
        """In-cycle placement for multi-chip slice/mesh jobs: the
        slice engine (score.fit_pod → topology/torus.py,
        placement/mesh.py) runs per candidate over copy-on-write views
        of the SAME snapshot entries the columnar fleet mirrors, the
        winner is charged into the columnar state (apply_grant — the
        vector stage prices it in; a lost commit rolls the row back via
        the touched-set on the next refresh), and the grant joins the
        per-node group commit as a regular plan entry.  Jobs that fit
        nowhere leave plan[i] None — the per-pod fallback re-checks
        against the live fleet and produces reasons + the defrag demand
        signal."""
        fleet = self.fleet
        policy = self.s.cfg.node_scheduler_policy
        cows: Dict[int, score_mod.CowUsage] = {}
        for i in sorted(slices, key=lambda i: ranks[i]):
            job = jobs[i]
            best = None   # (score, offer_pos, row, placement, probe)
            for pos, name in enumerate(job.node_names):
                row = fleet.row_of.get(name)
                if row is None or not fleet.alive[row]:
                    continue
                entry = fleet.entry_of(name)
                if entry is None:
                    continue
                base = cows.get(row)
                if base is None:
                    base = cows[row] = score_mod.CowUsage(entry.usage)
                probe = score_mod.CowUsage(base)
                got = score_mod.fit_pod(
                    job.requests, probe, entry.info.topology, job.anns,
                    self.s.cfg.topology_policy)
                if got is None:
                    continue
                s = score_mod.node_score(probe, policy) \
                    + fleet.bonus[row]
                if best is None or s > best[0]:
                    best = (s, pos, row, got, probe)
            if best is None:
                continue
            _s, _pos, row, placement, probe = best
            cows[row] = probe  # later slice jobs see this grant
            cols = fleet.col_of[row]
            chips = [cols[d.uuid] for d in placement[0]]
            mems = [d.usedmem for d in placement[0]]
            plan[i] = (row, chips, mems)
            fleet.apply_grant(row, chips, mems, job.requests[0].coresreq)

    def _build_cohorts(self, jobs: List[BatchJob], vector: List[int],
                       ranks: List[int]) -> List[_Cohort]:
        fleet = self.fleet
        binpack = self.s.cfg.node_scheduler_policy == "binpack"
        cohorts: Dict[tuple, _Cohort] = {}
        # Per-cycle offer-tuple memo keyed on list identity: a backlog
        # drain passes the SAME candidate list object for every pod, and
        # re-tupling a 10k-node offer per job would dominate the cycle
        # at control-plane scale.  Safe within this call: the jobs hold
        # references, so an id() cannot be recycled mid-cycle.
        offers: Dict[int, tuple] = {}
        for i in sorted(vector, key=lambda i: ranks[i]):
            job = jobs[i]
            fp = class_fingerprint(job.requests, job.anns,
                                   self.s.cfg.topology_policy)
            offer = offers.get(id(job.node_names))
            if offer is None:
                offer = offers[id(job.node_names)] = tuple(job.node_names)
            key = (fp, offer)
            cohort = cohorts.get(key)
            if cohort is None:
                # Cached-or-built class columns: a cached class syncs
                # only its dirty rows (ColumnarFleet.class_eval) — the
                # steady-state vector-eval cost tracks churn, not fleet
                # size.  Cohorts of one class share the _ClassEval.
                ce = fleet.class_eval(fp, job.requests[0],
                                      score_mod.parse_affinity(job.anns),
                                      binpack)
                # An empty offer means NO candidates (the per-pod paths
                # iterate node_names), never the whole fleet.  The
                # rows/rowset/positions of an offer are stable across
                # cycles until a rebuild moves row indices — memoized
                # so a steady fleet-wide offer costs one tuple hash,
                # not three O(fleet) rebuilds per cohort per cycle.
                if self._offer_memo_rebuilds != fleet.rebuilds:
                    self._offer_memo.clear()
                    self._offer_memo_rebuilds = fleet.rebuilds
                ent = self._offer_memo.get(offer)
                if ent is None:
                    rows = [fleet.row_of[n] for n in offer
                            if n in fleet.row_of]
                    rowset = set(rows)
                    pos_of: Dict[int, int] = {}
                    for pos, r in enumerate(rows):
                        pos_of.setdefault(r, pos)
                    if len(self._offer_memo) >= 64:
                        self._offer_memo.clear()
                    ent = self._offer_memo[offer] = (rows, rowset,
                                                     pos_of)
                cohort = cohorts[key] = _Cohort(ce, ent[0],
                                                rowset=ent[1],
                                                pos_of=ent[2])
            cohort.jobs.append((ranks[i], i))
        return list(cohorts.values())

    #: Node groups committed per commit-lock acquire: chunking amortizes
    #: the instrumented commit and usage-cache locks to 1/16 a group at
    #: one-pod-a-node shapes, while keeping each hold short enough not to
    #: convoy the optimistic path.
    COMMIT_CHUNK = 16

    def _commit(self, snap, jobs: List[BatchJob], vector: List[int],
                plan) -> Tuple[Dict[int, object], List[int]]:
        """Per-node-group optimistic commit: one rev validation per node,
        then the group's grants inserted as an unbroken pod-rev chain
        (``PodManager.add_pods_group`` — the whole group under one
        registry acquire, so an informer event can never break the chain
        mid-group) and published as a single usage delta.  A node whose
        generation moved sends its whole group to the per-pod fallback —
        the protocol's conflict semantics, amortized.  Groups commit in
        chunks of :data:`COMMIT_CHUNK` per commit-lock acquire with one
        usage-cache publish per chunk."""
        from .core import FilterResult
        from .pods import PodInfo

        s = self.s
        groups: Dict[int, List[int]] = {}
        for i in vector:
            if plan[i] is not None:
                groups.setdefault(plan[i][0], []).append(i)
        committed: Dict[int, object] = {}
        lost: List[int] = []
        group_items = list(groups.items())
        for at in range(0, len(group_items), self.COMMIT_CHUNK):
            chunk = group_items[at:at + self.COMMIT_CHUNK]
            publishes: List[tuple] = []
            with s._commit_lock:
                for row, members in chunk:
                    node = self.fleet.names[row]
                    entry = snap[node]
                    live = (s.pods.rev_of(node), s.nodes.rev_of(node))
                    if live != entry.key:
                        lost.extend(members)
                        continue
                    infos: List[PodInfo] = []
                    placements: List[list] = []
                    for i in members:
                        job = jobs[i]
                        _row, chips, mems = plan[i]
                        placement = [[
                            ContainerDevice(
                                uuid=self.fleet.chip_ids[row][c],
                                type=self.fleet.chip_types[row][c],
                                usedmem=m,
                                usedcores=job.requests[0].coresreq)
                            for c, m in zip(chips, mems)]]
                        infos.append(PodInfo(
                            uid=job.uid, name=job.name,
                            namespace=job.namespace, node=node,
                            devices=placement, priority=job.priority,
                            trace_id=job.trace_id,
                            qos=job.anns.get(QOS_ANNOTATION, "") or ""))
                        placements.append(placement)
                    final = s.pods.add_pods_group(infos, node,
                                                  entry.key[0])
                    if final is None:
                        # An informer event bumped the node between the
                        # rev check and the bulk insert: nothing was
                        # added — conflict the whole group.
                        lost.extend(members)
                        continue
                    publishes.append((node, entry, placements, final))
                    # Every planned grant on this row committed: the
                    # columnar mirrors equal the usage the publish
                    # caches under this generation, so the next refresh
                    # can adopt the new entry reload-free.
                    self.fleet.expected_key[row] = (final, entry.key[1])
                    for i in members:
                        committed[i] = FilterResult(node=node)
                if publishes:
                    s._publish_grants_many(publishes)
        if lost:
            with s._busy_lock:
                s.commit_conflicts += len(lost)
        return committed, lost
