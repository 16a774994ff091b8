"""Per-shard solve worker processes over the shared columnar fleet (the
port's copy of the JAX package's ``parallelcp/workers.py``).

Each worker maps the store's segments read-only
(:class:`~.shmem.SharedColumnView`) and runs the UNMODIFIED
``eval_class_full`` from ``scheduler/batch.py`` over its contiguous row
range — every operation in that pass is per-row (elementwise or
axis-1), so concatenating the per-shard slices is bit-identical to the
parent's whole-fleet pass.  That identity is the correctness story: the
pool does not approximate the in-process evaluator, it IS the
in-process evaluator, row-sharded.

Lifecycle: workers are spawned lazily on first use (``spawn`` context —
the parent has live threads and locks ``fork`` would clone mid-state),
respawned on crash / stale-generation refusal / timeout, and drained
with a sentinel on shutdown.  Every request carries the generation it
was built against; a worker whose header disagrees replies ``stale``
and is respawned fresh (it remaps on the retry).  Any pool failure
makes ``eval_class`` return False and the caller evaluates in-process —
a broken pool can slow a cycle, never wrong a decision.
"""

from __future__ import annotations

import multiprocessing
import threading
import time
from typing import List, Optional

from ..util import perf
from .shmem import SharedColumnStore, SharedColumnView, StaleGeneration


class _WorkerFleet:
    """Duck-typed row-slice [lo:hi) of the shared columns, presenting
    exactly the ``ColumnarFleet`` surface ``eval_class_full`` reads (the
    numpy columns, the type table and the scratch pool), so the worker
    executes the very same code the parent would."""

    def __init__(self, arrays, lo: int, hi: int, types: List[str],
                 c: int, bufs) -> None:
        self.N = hi - lo
        self.C = c
        self._types = types
        sl = slice(lo, hi)
        self.valid = arrays["valid"][sl]
        self.health = arrays["health"][sl]
        self.type_id = arrays["type_id"][sl]
        self.total_slots = arrays["total_slots"][sl]
        self.used_slots = arrays["used_slots"][sl]
        self.total_mem = arrays["total_mem"][sl]
        self.used_mem = arrays["used_mem"][sl]
        self.total_cores = arrays["total_cores"][sl]
        self.used_cores = arrays["used_cores"][sl]
        self.has_topology = arrays["has_topology"][sl]
        self.base = arrays["base"][sl]
        self.alive = arrays["alive"][sl]
        self.bonus = arrays["bonus"][sl]
        #: Scratch pool persisted across requests by the worker loop —
        #: steady-state evaluations allocate nothing, same as the
        #: parent's fleet.
        self._bufs = bufs


def _worker_main(conn, header_name: str, idx: int) -> None:
    """Solve worker loop: map the store, serve ``eval`` requests for
    exactly the generation each request names, refuse stale ones."""
    from ..scheduler import batch as batch_mod
    try:
        view = SharedColumnView(header_name)
    except FileNotFoundError:
        conn.close()
        return
    bufs = {}
    try:
        while True:
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                break
            if msg is None:                    # graceful drain sentinel
                break
            op = msg[0]
            try:
                if op == "eval":
                    (_op, gen, lo, hi, types, req, affinity,
                     binpack) = msg
                    try:
                        arrays = view.ensure(gen)
                    except StaleGeneration as e:
                        # Generation fence: never evaluate a layout
                        # other than the one the parent asked about.
                        conn.send(("stale", idx, e.published))
                        continue
                    wf = _WorkerFleet(arrays, lo, hi, types, view.c,
                                      bufs)
                    ce = batch_mod._ClassEval(req, affinity, binpack)
                    t0 = time.perf_counter()
                    batch_mod.eval_class_full(wf, ce)
                    dt = time.perf_counter() - t0
                    conn.send(("ok", gen, lo, hi, ce.score, ce.chip,
                               ce.mem, dt))
                elif op == "ping":
                    conn.send(("pong", idx, view.generation,
                               view.header_generation()))
                else:
                    conn.send(("err", idx, f"unknown op {op!r}"))
            except Exception as e:             # pragma: no cover
                try:
                    conn.send(("err", idx, repr(e)))
                except Exception:
                    break
    finally:
        view.close()
        conn.close()


class SolveWorkerPool:
    """Parent-side handle on N solve worker processes.  Used only
    under the batch engine's cycle lock (the columnar state is
    single-writer), so dispatch needs no locking of its own; the
    internal lock only serializes spawn/close against each other."""

    #: Below this many rows the IPC round-trip costs more than the
    #: whole vectorized pass — evaluate in-process.
    MIN_ROWS = 8
    #: Per-attempt collection deadline.  A worker that cannot evaluate
    #: a class over its shard within this is wedged, not slow.
    EVAL_TIMEOUT_S = 30.0

    def __init__(self, store: SharedColumnStore, n_workers: int) -> None:
        self.store = store
        self.n = max(1, int(n_workers))
        self._ctx = multiprocessing.get_context("spawn")
        self._procs: List[Optional[multiprocessing.Process]] = \
            [None] * self.n
        self._conns = [None] * self.n
        self._lock = threading.Lock()
        self._closed = False
        self.restarts_total = 0
        self.evals_offloaded = 0
        self.eval_fallbacks = 0
        #: Parent-side ring of worker-measured eval latencies, one per
        #: worker slot — /perfz and the metrics scrape read these.
        self.latency = [perf.PhaseRing(f"solve-worker-{i}")
                        for i in range(self.n)]

    # -- lifecycle -------------------------------------------------------------
    def _spawn(self, i: int, respawn: bool = False) -> None:
        old_conn = self._conns[i]
        if old_conn is not None:
            try:
                old_conn.close()
            except OSError:                    # pragma: no cover
                pass
        old = self._procs[i]
        if old is not None and old.is_alive():
            old.terminate()
        parent_conn, child_conn = self._ctx.Pipe()
        p = self._ctx.Process(
            target=_worker_main,
            args=(child_conn, self.store.header_name, i),
            name=f"vgpu-solve-worker-{i}", daemon=True)
        p.start()
        child_conn.close()
        self._procs[i] = p
        self._conns[i] = parent_conn
        if respawn:
            self.restarts_total += 1

    def start(self) -> None:
        with self._lock:
            if self._closed:
                return
            for i in range(self.n):
                p = self._procs[i]
                if p is None or not p.is_alive():
                    self._spawn(i, respawn=p is not None)
        perf.registry().set_gauge("solve_workers", self.alive_count())

    def alive_count(self) -> int:
        return sum(1 for p in self._procs
                   if p is not None and p.is_alive())

    def ping(self, timeout: float = 5.0):
        """Round-trip every live worker; returns the list of
        ``("pong", idx, mapped_gen, header_gen)`` replies (tests use
        this to prove remap-within-one-cycle)."""
        self.start()
        out = []
        for i in range(self.n):
            conn = self._conns[i]
            try:
                conn.send(("ping",))
                if conn.poll(timeout):
                    out.append(conn.recv())
            except (EOFError, OSError, BrokenPipeError):
                continue
        return out

    def close(self) -> None:
        """Graceful drain: sentinel every worker, join briefly, then
        terminate stragglers."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            for conn in self._conns:
                if conn is None:
                    continue
                try:
                    conn.send(None)
                except (OSError, BrokenPipeError):
                    pass
            for p in self._procs:
                if p is not None:
                    p.join(timeout=2.0)
                    if p.is_alive():           # pragma: no cover
                        p.terminate()
                        p.join(timeout=1.0)
            for conn in self._conns:
                if conn is not None:
                    try:
                        conn.close()
                    except OSError:            # pragma: no cover
                        pass
            self._procs = [None] * self.n
            self._conns = [None] * self.n
        perf.registry().set_gauge("solve_workers", 0)

    # -- the offloaded evaluation ---------------------------------------------
    def eval_class(self, fleet, ce, gen: int = None) -> bool:
        """Row-shard one class's full evaluation across the workers.
        Fills ``ce`` exactly as ``eval_class_full(fleet, ce)`` would
        (bit-identical by construction) and returns True; returns False
        when the fleet is too small to profit or the pool could not
        complete (after one respawn+retry) — caller falls back to the
        in-process pass."""
        if self._closed:
            return False
        n = fleet.N
        if n < self.MIN_ROWS:
            return False
        if gen is None:
            gen = self.store.generation
        self.start()
        # Contiguous near-equal shards; empty shards are skipped.
        bounds = [n * j // self.n for j in range(self.n + 1)]
        shards = [(i, bounds[i], bounds[i + 1]) for i in range(self.n)
                  if bounds[i + 1] > bounds[i]]
        types = list(fleet._types)
        parts = self._attempt(shards, gen, types, ce)
        if parts is None:
            # Respawn whatever died/refused and retry once: a worker
            # that raced a rebuild remaps on the fresh request.
            parts = self._attempt(shards, gen, types, ce)
        if parts is None:
            self.eval_fallbacks += 1
            return False
        ce.allowed = [_type_allows(ce.affinity, t) for t in types]
        score: List[float] = []
        chip: List[int] = []
        mem: List[int] = []
        for i, lo, hi in shards:
            p_score, p_chip, p_mem = parts[i]
            score.extend(p_score)
            chip.extend(p_chip)
            mem.extend(p_mem)
        ce.score, ce.chip, ce.mem = score, chip, mem
        self.evals_offloaded += 1
        return True

    def _attempt(self, shards, gen: int, types, ce):
        """One dispatch+collect round.  Returns {worker: (score, chip,
        mem)} or None after respawning every failed worker."""
        payloads = {}
        failed = []
        pending = []
        for i, lo, hi in shards:
            conn = self._conns[i]
            proc = self._procs[i]
            if conn is None or proc is None or not proc.is_alive():
                failed.append(i)
                continue
            try:
                conn.send(("eval", gen, lo, hi, types, ce.req,
                           ce.affinity, ce.binpack))
                pending.append(i)
            except (OSError, BrokenPipeError):
                failed.append(i)
        deadline = time.monotonic() + self.EVAL_TIMEOUT_S
        for i in pending:
            conn = self._conns[i]
            got = None
            try:
                if conn.poll(max(0.0, deadline - time.monotonic())):
                    got = conn.recv()
            except (EOFError, OSError):
                got = None
            if got is not None and got[0] == "ok" and got[1] == gen:
                _tag, _g, _lo, _hi, p_score, p_chip, p_mem, dt = got
                payloads[i] = (p_score, p_chip, p_mem)
                self.latency[i].record(dt)
            else:
                # Crash (EOF), wedge (timeout), stale refusal, or an
                # error reply — all respawn the worker slot.
                failed.append(i)
        if failed:
            with self._lock:
                if not self._closed:
                    for i in failed:
                        self._spawn(i, respawn=True)
            perf.registry().set_gauge("solve_workers",
                                      self.alive_count())
            return None
        return payloads

    # -- telemetry -------------------------------------------------------------
    def export(self) -> dict:
        """/perfz section: pool shape, lifetime counters, per-worker
        recent-window latency quantiles."""
        per = []
        for i, ring in enumerate(self.latency):
            w = ring.window()
            per.append({
                "worker": i,
                "evals": ring.count,
                "p50_ms": w["p50_s"] * 1e3,
                "p99_ms": w["p99_s"] * 1e3,
                "max_ms": w["max_s"] * 1e3,
            })
        return {
            "configured": self.n,
            "workers": self.alive_count(),
            "restarts_total": self.restarts_total,
            "evals_offloaded": self.evals_offloaded,
            "eval_fallbacks": self.eval_fallbacks,
            "per_worker": per,
        }


def _type_allows(affinity, t: str) -> bool:
    from ..scheduler import score as score_mod
    return score_mod.type_allows(affinity, t)
