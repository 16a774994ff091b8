"""The control plane's performance observatory (the port's copy of the
JAX package's ``util/perf.py``).

Per-phase timing rings, lock wait/hold telemetry, informer lag, queue
depth and GC pressure, served on ``GET /perfz`` and as the
``vtpu_cycle_phase_seconds{phase}`` / ``vtpu_lock_wait_seconds{lock}``
families of ``scheduler/metrics.py``.

Hot-path discipline:

- monotonic clocks only: a wall-clock step must never mint a negative
  or inflated sample;
- a record is a slot store into a preallocated ring plus a bisect into
  fixed cumulative bucket counters, with no lock: a racing record may
  lose a counter increment or a ring slot (a telemetry sample), never
  correctness, and never blocks a scheduling thread;
- lock wait samples are taken only on the contended path (the fast
  try-acquire costs one extra C call); hold samples on very hot locks
  are 1-in-N sampled (``sample_shift``);
- everything can be switched off wholesale (``registry().enabled``,
  ``Config.perf_enabled`` / ``--no-perf``).

One registry per process (like ``util/trace.Tracer``): every scheduler,
tool and test in a process feeds the same rings; ``/perfz`` is the
process's answer, not one object's.
"""

from __future__ import annotations

import bisect
import gc
import threading
import time
from typing import Dict, List, Optional, Tuple

from . import trace

_mono = time.monotonic

# Phase-duration buckets (seconds): the trace-span histograms' table
# (util/trace.py), so vtpu_cycle_phase_seconds and the phase histograms
# cannot disagree on resolution.  Phases cap at 5 s (trace keeps the
# 10.0 bound for whole-pod spans).
PHASE_BUCKETS = trace.DEFAULT_BUCKETS[:-1]

# Informer-apply sampling factor: on_pod_event clocks 1 event in this
# many (the event path runs per apiserver event; the ring wants a recent
# latency distribution, which a thinned sample preserves).  Must be a
# power of two — the sampler masks with (N - 1).
INFORMER_SAMPLE_EVERY = 8

# After this long without an informer-apply sample the exported lag
# gauge decays to 0.0 — a ring window never ages out on its own, and
# "the last storm's p99" must not read as live lag hours later.
INFORMER_LAG_HORIZON_S = 60.0

# Lock wait/hold buckets: healthy holds are sub-microsecond to tens of
# microseconds; a millisecond hold on the commit lock is an event.
LOCK_BUCKETS = (0.000001, 0.0000025, 0.000005, 0.00001, 0.000025,
                0.00005, 0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                0.01, 0.05, 0.25, 1.0)


def _pctl(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted sample."""
    if not sorted_vals:
        return 0.0
    i = max(0, min(len(sorted_vals) - 1,
                   int(q * len(sorted_vals) + 0.999999) - 1))
    return sorted_vals[i]


class PhaseRing:
    """Bounded ring of recent durations + lifetime cumulative bucket
    counts for ONE phase (or one lock's wait/hold series).

    ``record`` is lock-free by design: a slot store, a bisect, and three
    int adds.  Under racing writers an increment or a slot can be lost —
    acceptable for telemetry, and the price of never blocking the
    scheduling thread that is being measured.  Readers (``/perfz``, the
    metrics scrape) copy what they need and compute quantiles on their
    own time.
    """

    __slots__ = ("name", "bounds", "counts", "count", "sum_s",
                 "lifetime_max_s", "last_at", "_ring", "_cap")

    def __init__(self, name: str, capacity: int = 512,
                 bounds: Tuple[float, ...] = PHASE_BUCKETS) -> None:
        self.name = name
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)   # +Inf bucket last
        self.count = 0
        self.sum_s = 0.0
        self.lifetime_max_s = 0.0
        self.last_at = 0.0       # monotonic time of the newest sample
        self._cap = max(8, capacity)
        # Preallocated slots; -1.0 marks "never written" so window stats
        # on a cold ring don't read zeros as samples.
        self._ring = [-1.0] * self._cap

    def record(self, seconds: float) -> None:
        if seconds < 0.0:
            seconds = 0.0
        i = bisect.bisect_left(self.bounds, seconds)
        self.counts[i] += 1
        n = self.count
        self.count = n + 1
        self.sum_s += seconds
        if seconds > self.lifetime_max_s:
            self.lifetime_max_s = seconds
        self._ring[n % self._cap] = seconds
        # Recency stamp so gauges derived from a ring window (informer
        # lag) can decay instead of reporting the last storm's
        # distribution forever.  One clock read per record — callers
        # already paid two to compute the duration.
        self.last_at = _mono()

    # -- readers ---------------------------------------------------------------
    def window(self) -> Dict[str, float]:
        """Quantiles over the ring window (the recent past, not the
        process lifetime): p50/p99/max/mean + sample count."""
        vals = sorted(v for v in list(self._ring) if v >= 0.0)
        if not vals:
            return {"n": 0, "p50_s": 0.0, "p99_s": 0.0, "max_s": 0.0,
                    "mean_s": 0.0}
        return {
            "n": len(vals),
            "p50_s": _pctl(vals, 0.50),
            "p99_s": _pctl(vals, 0.99),
            "max_s": vals[-1],
            "mean_s": sum(vals) / len(vals),
        }

    def prom(self) -> Tuple[List[Tuple[str, float]], float]:
        """Prometheus-shaped cumulative buckets (+Inf last) + sum.  The
        +Inf count is derived from the per-bucket counts themselves (not
        ``self.count``) so a racing record can never yield a +Inf bucket
        smaller than an inner one — prometheus clients reject that."""
        counts = list(self.counts)
        out: List[Tuple[str, float]] = []
        acc = 0
        for b, n in zip(self.bounds, counts):
            acc += n
            out.append((repr(b), acc))
        out.append(("+Inf", acc + counts[-1]))
        return out, self.sum_s


class LockStats:
    """Shared wait/hold telemetry for every :class:`TimedLock` of one
    name (several scheduler instances in one process aggregate, like the
    process-global tracer)."""

    __slots__ = ("name", "wait", "hold", "acquires", "contended",
                 "sample_shift", "mask")

    def __init__(self, name: str, sample_shift: int = 0) -> None:
        self.name = name
        self.wait = PhaseRing(f"lock-wait:{name}", bounds=LOCK_BUCKETS)
        self.hold = PhaseRing(f"lock-hold:{name}", bounds=LOCK_BUCKETS)
        self.acquires = 0
        self.contended = 0
        #: hold samples are recorded for 1 in 2**sample_shift acquires —
        #: >0 only for locks hot enough that even a ring record per
        #: release would show up against the overhead budget.
        self.sample_shift = sample_shift
        self.mask = (1 << sample_shift) - 1

    def sampled_acquires(self) -> int:
        """Acquires whose wait/hold telemetry was observed.  The sampled
        acquire is the FIRST of each 2**sample_shift block (TimedLock
        samples on ``n & mask == 0``), so this rounds UP: a lock with 3
        acquires at shift 2 has observed 1 — a floor would export
        contention_ratio 0.0 next to a non-empty wait ring."""
        return (self.acquires + self.mask) >> self.sample_shift


class TimedLock:
    """A ``threading.Lock`` with wait/hold telemetry.

    Fast path (uncontended, unsampled): one non-blocking C acquire and
    an integer mask check — no clock read at all.  Contended acquires
    record the wait; 1-in-N releases record the hold.  Disabled
    (``registry().enabled`` False) it degrades to bare acquire/release.
    ``__enter__``/``__exit__`` inline the whole fast path (no nested
    Python call, bound C methods hoisted at construction).

    Non-reentrant, single-holder, like the Lock it wraps: the
    ``_t0``/``_rec`` handoff attributes are only ever touched by the
    current holder between its acquire and its release, and the release
    reads them BEFORE releasing the underlying lock.
    """

    __slots__ = ("_lock", "_acq", "_rel", "stats", "_reg", "_t0", "_rec")

    def __init__(self, name: str, sample_shift: int = 0,
                 reg: Optional["PerfRegistry"] = None) -> None:
        self._lock = threading.Lock()
        self._acq = self._lock.acquire
        self._rel = self._lock.release
        self._reg = reg or registry()
        self.stats = self._reg.lock_stats(name, sample_shift)
        self._t0 = 0.0
        self._rec = False

    def __enter__(self) -> "TimedLock":
        if not self._reg.enabled:
            self._acq()
            self._rec = False
            return self
        st = self.stats
        n = st.acquires
        st.acquires = n + 1
        if n & st.mask:
            # Unsampled acquire (hot locks): a plain C acquire — no
            # probe, no clock.  Contention and wait are observed on the
            # 1-in-2**shift sampled acquires; the sample is unbiased
            # (every acquire has the same chance of being the sampled
            # slot), so ratios computed against the sampled count hold.
            self._acq()
            self._rec = False
            return self
        if not self._acq(False):
            t0 = _mono()
            self._acq()
            st.contended += 1
            st.wait.record(_mono() - t0)
        self._rec = True
        self._t0 = _mono()
        return self

    def __exit__(self, *exc) -> bool:
        if self._rec:
            self._rec = False
            self.stats.hold.record(_mono() - self._t0)
        self._rel()
        return False

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        """Explicit-call form (same telemetry as the with-statement).
        ``_rec`` is only ever written AFTER the underlying acquire
        succeeds — writing it before (while another thread still holds)
        would clobber that holder's pending hold sample, and do so
        preferentially under contention, exactly the condition the hold
        histogram exists to measure."""
        if not self._reg.enabled:
            ok = self._acq(blocking, timeout)
            if ok:
                self._rec = False
            return ok
        st = self.stats
        n = st.acquires
        st.acquires = n + 1
        if n & st.mask:
            ok = self._acq(blocking, timeout)
            if ok:
                self._rec = False
            return ok
        if self._acq(False):
            ok = True
        else:
            if not blocking:
                return False
            t0 = _mono()
            ok = self._acq(True, timeout)
            st.contended += 1
            st.wait.record(_mono() - t0)
            if not ok:
                return False
        self._rec = True
        self._t0 = _mono()
        return ok

    def release(self) -> None:
        if self._rec:
            self._rec = False
            self.stats.hold.record(_mono() - self._t0)
        self._rel()

    def locked(self) -> bool:
        return self._lock.locked()


class _Tick:
    """One recorded tick (a batched cycle, a background-loop pass): its
    total, its per-phase split, and a small free-form attrs dict."""

    __slots__ = ("name", "at_s", "total_s", "phases", "attrs")

    def __init__(self, name: str, total_s: float,
                 phases: Dict[str, float], attrs: Dict[str, object]) -> None:
        self.name = name
        self.at_s = _mono()
        self.total_s = total_s
        self.phases = phases
        self.attrs = attrs

    def to_dict(self) -> dict:
        return {"name": self.name, "age_s": round(_mono() - self.at_s, 3),
                "total_ms": round(self.total_s * 1e3, 3),
                "phases_ms": {k: round(v * 1e3, 3)
                              for k, v in self.phases.items()},
                **self.attrs}


class GcWatch:
    """gc.callbacks hook: collection counts per generation and pause
    durations.  CPython serializes collections, so the start/stop pair
    always runs on one thread back-to-back — a plain attribute carries
    the start stamp.

    The pause ring is OWNED here (not fetched via ``registry().phase``):
    a collection can trigger inside ``PerfRegistry._make_lock``'s
    critical section, and a callback that then tried to take the same
    non-reentrant lock to create its ring would deadlock the process."""

    def __init__(self, reg: "PerfRegistry") -> None:
        self._reg = reg
        self.collections = [0, 0, 0]
        self.pause = PhaseRing("gc-pause")
        self._t0 = 0.0
        self._installed = False

    def install(self) -> None:
        if not self._installed:
            gc.callbacks.append(self._cb)
            self._installed = True

    def uninstall(self) -> None:
        if self._installed:
            try:
                gc.callbacks.remove(self._cb)
            except ValueError:
                pass
            self._installed = False

    def _cb(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = _mono()
        elif phase == "stop":
            gen = info.get("generation", 0)
            if 0 <= gen <= 2:
                self.collections[gen] += 1
            if self._reg.enabled and self._t0:
                self.pause.record(_mono() - self._t0)


class PerfRegistry:
    """Per-process home of every ring, lock-stats table, gauge and tick
    journal.  Creation of rings takes a small lock; recording never
    does (see PhaseRing)."""

    TICK_RING = 64

    def __init__(self) -> None:
        self.enabled = True
        self._phases: Dict[str, PhaseRing] = {}
        self._locks: Dict[str, LockStats] = {}
        self._gauges: Dict[str, float] = {}
        self._make_lock = threading.Lock()
        self._ticks: List[Optional[_Tick]] = [None] * self.TICK_RING
        self._tick_n = 0
        self.gc = GcWatch(self)
        self._tracemalloc = False

    # -- writers ---------------------------------------------------------------
    def phase(self, name: str) -> PhaseRing:
        ring = self._phases.get(name)
        if ring is None:
            with self._make_lock:
                ring = self._phases.setdefault(name, PhaseRing(name))
        return ring

    def record(self, name: str, seconds: float) -> None:
        if self.enabled:
            self.phase(name).record(seconds)

    def lock_stats(self, name: str, sample_shift: int = 0) -> LockStats:
        st = self._locks.get(name)
        if st is None:
            with self._make_lock:
                st = self._locks.setdefault(
                    name, LockStats(name, sample_shift))
        return st

    def set_gauge(self, name: str, value: float) -> None:
        if self.enabled:
            self._gauges[name] = value

    def gauge(self, name: str, default: float = 0.0) -> float:
        return self._gauges.get(name, default)

    def note_tick(self, name: str, total_s: float,
                  phases: Dict[str, float], **attrs) -> None:
        """Journal one tick's breakdown (a small dict per TICK — not per
        pod — so the allocation is off the per-decision path)."""
        if not self.enabled:
            return
        n = self._tick_n
        self._tick_n = n + 1
        self._ticks[n % self.TICK_RING] = _Tick(name, total_s, phases,
                                                attrs)

    # -- tracemalloc opt-in ----------------------------------------------------
    def enable_tracemalloc(self, frames: int = 8) -> None:
        import tracemalloc

        if not tracemalloc.is_tracing():
            tracemalloc.start(frames)
        self._tracemalloc = True

    def _tracemalloc_top(self, limit: int = 10) -> Optional[List[dict]]:
        if not self._tracemalloc:
            return None
        import tracemalloc

        if not tracemalloc.is_tracing():
            return None
        snap = tracemalloc.take_snapshot()
        return [
            {"site": str(stat.traceback[0]) if stat.traceback else "?",
             "size_kib": round(stat.size / 1024, 1),
             "count": stat.count}
            for stat in snap.statistics("lineno")[:limit]
        ]

    # -- readers ---------------------------------------------------------------
    def phase_rings(self) -> Dict[str, PhaseRing]:
        """Every phase ring including the gc watcher's (which lives off
        the creation lock — see GcWatch)."""
        out = dict(self._phases)
        out["gc-pause"] = self.gc.pause
        return out

    def lock_tables(self) -> Dict[str, LockStats]:
        """Every lock's stats table (snapshot copy) — the public read
        surface for /perfz and the metrics scrape, mirroring
        phase_rings()."""
        return dict(self._locks)

    def informer_lag_s(self) -> float:
        """The exported informer-lag figure: p99 of the recent
        informer-apply window — per-event service time from callback
        entry to registries updated.  The watch dispatch loop is
        synchronous, so growth HERE is what backs the watch up
        (the loop cannot consume faster than it applies); queueing
        upstream of the callback — transport, apiserver — is not
        included (``resync_last_s`` and the pending-queue gauges cover
        gross staleness).

        The figure is a CURRENT lag, same discipline as drain_age_s:
        once no informer-apply sample has been recorded for
        ``INFORMER_LAG_HORIZON_S`` the gauge decays to 0.0 instead of
        serving the last storm's p99 next to a zero event rate
        indefinitely (0.0 means "no recent informer activity", not
        "fast")."""
        ring = self._phases.get("informer-apply")
        if ring is None or ring.count == 0:
            return 0.0
        if _mono() - ring.last_at > INFORMER_LAG_HORIZON_S:
            return 0.0
        return ring.window()["p99_s"]

    def slow_ticks(self, top: int = 8) -> List[dict]:
        ticks = [t for t in self._ticks if t is not None]
        ticks.sort(key=lambda t: -t.total_s)
        return [t.to_dict() for t in ticks[:top]]

    def export(self, top_ticks: int = 8) -> dict:
        """The /perfz document (scheduler/routes.py adds nothing —
        Scheduler.export_perf merges instance-local stats in)."""
        rings = self.phase_rings()
        phases = {}
        for name in sorted(rings):
            ring = rings[name]
            phases[name] = {
                "count": ring.count,
                "total_s": round(ring.sum_s, 6),
                "lifetime_max_s": round(ring.lifetime_max_s, 6),
                "window": {k: (v if k == "n" else round(v, 9))
                           for k, v in ring.window().items()},
            }
        locks = {}
        for name in sorted(self._locks):
            st = self._locks[name]
            sampled = st.sampled_acquires()
            locks[name] = {
                "acquires": st.acquires,
                "contended": st.contended,
                # Contention is observed on the sampled acquires only
                # (unbiased — see TimedLock), so the ratio's
                # denominator is the sampled count.
                "contention_ratio": round(
                    st.contended / sampled, 6) if sampled else 0.0,
                "sampled_1_in": 1 << st.sample_shift,
                "wait": {k: (v if k == "n" else round(v, 9))
                         for k, v in st.wait.window().items()},
                "hold": {k: (v if k == "n" else round(v, 9))
                         for k, v in st.hold.window().items()},
            }
        return {
            "enabled": self.enabled,
            "phases": phases,
            "locks": locks,
            "informer": {
                "lag_s": round(self.informer_lag_s(), 9),
                # The apply path is 1-in-N sampled (on_pod_event): this
                # is the SAMPLED count, published next to its factor so
                # nobody divides the phase total by an 8x-understated
                # event count.
                "apply_sampled_count":
                    self._phases["informer-apply"].count
                    if "informer-apply" in self._phases else 0,
                "apply_sample_1_in": INFORMER_SAMPLE_EVERY,
                "resync_last_s": round(self.gauge("informer_resync_last_s"),
                                       6),
            },
            "queue": {
                "pending_depth": int(self.gauge("pending_queue_depth")),
                "drain_age_s": round(self.gauge("drain_age_s"), 6),
            },
            "gc": {
                "collections": list(self.gc.collections),
                "tracemalloc_top": self._tracemalloc_top(),
            },
            "slow_ticks": self.slow_ticks(top_ticks),
        }

    def reset(self) -> None:
        """Test hook: drop recorded samples (lock-stats objects survive —
        live TimedLocks hold references — but their rings restart)."""
        with self._make_lock:
            self._phases.clear()
            for st in self._locks.values():
                st.wait = PhaseRing(f"lock-wait:{st.name}",
                                    bounds=LOCK_BUCKETS)
                st.hold = PhaseRing(f"lock-hold:{st.name}",
                                    bounds=LOCK_BUCKETS)
                st.acquires = 0
                st.contended = 0
            self._gauges.clear()
            self._ticks = [None] * self.TICK_RING
            self._tick_n = 0
            self.gc.collections = [0, 0, 0]
            self.gc.pause = PhaseRing("gc-pause")


_GLOBAL = PerfRegistry()
_GLOBAL.gc.install()


def registry() -> PerfRegistry:
    """The process-global performance registry (one per OS process)."""
    return _GLOBAL


class phase_timer:
    """``with perf.phase_timer("quota-tick"):`` — records into the named
    ring; also usable around background-loop ticks.  A plain class (no
    generator machinery) like trace.Span."""

    __slots__ = ("_name", "_t0", "_reg")

    def __init__(self, name: str, reg: Optional[PerfRegistry] = None) -> None:
        self._name = name
        self._reg = reg or _GLOBAL

    def __enter__(self) -> "phase_timer":
        self._t0 = _mono()
        return self

    def __exit__(self, *exc) -> bool:
        if self._reg.enabled:
            self._reg.phase(self._name).record(_mono() - self._t0)
        return False
