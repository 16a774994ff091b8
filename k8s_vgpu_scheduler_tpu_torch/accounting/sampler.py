"""Node-side usage metering of the PyTorch/CUDA port: shared-region
samples → monotonic counters.

The port's own copy of the JAX package's ``accounting/sampler.py``.  It
rides the monitor's FeedbackLoop tick (``cmd/monitor.py`` calls
:meth:`UsageSampler.sample` right after ``loop.tick()``): each sample
integrates one tick interval into per-container counters —

- **chip-seconds**: elapsed time × GPUs held, credited only when the
  container launched during the interval (the feedback loop's
  ``age_kernel`` census, the same duty signal the priority throttle keys
  on);
- **HBM-byte-seconds**: elapsed time × bytes currently accounted in the
  region (right-rectangle integration of occupancy);
- **throttled-seconds**: time spent with the priority utilization switch
  engaged (borrowed compute reclaimed by a higher-priority sharer);
- **oversub-spill-seconds**: active time under an oversubscribed grant —
  the window in which host-RAM spills can occur.

Counters live HERE, keyed by container key, never inside the region: a
workload SIGKILL, a slot GC (feedback.py) or an in-place container
restart resets the region's instantaneous fields but can only stop the
integrals from growing, never rewind them.  A container first seen this
tick gets no credit for the interval (nobody observed it), and a key that
vanishes is retained for ``retention_s`` so its final totals still reach
one more report before GC.

Imports the standard library and the port's stdlib-only modules; never
torch.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional

from ..shim.core import QOS_CLASSES as QOS_CLASS_NAMES

#: Field names of a counter row, as the JAX package's transports and
#: ledger carry them — one tuple so encoders/decoders cannot drift.
#: The qos_* tail carries the SLO-tiered co-residency plane: class +
#: current duty weight are instantaneous,
#: wait seconds and the log2-us wait histogram are sampler-side monotonic
#: (restart-tolerant, like the other counters).
USAGE_FIELDS = (
    "ctrkey", "chips", "active", "oversubscribe", "chip_seconds",
    "hbm_byte_seconds", "throttled_seconds", "oversub_spill_seconds",
    "window_s", "qos_class", "qos_weight_pct", "qos_wait_seconds_total",
    "qos_wait_hist",
)



@dataclasses.dataclass
class CounterSet:
    """One container's monotonic usage integrals plus its last observed
    instantaneous state (the latter rides along so consumers get
    busy/oversub flags without a second data path)."""

    first_seen: float
    last_seen: float
    chips: int = 0
    active: bool = False
    oversubscribe: bool = False
    chip_seconds: float = 0.0
    hbm_byte_seconds: float = 0.0
    throttled_seconds: float = 0.0
    oversub_spill_seconds: float = 0.0
    #: QoS plane: class/weight are last-observed, wait totals/histogram
    #: are monotonic accumulations of region deltas (a container restart
    #: resets the region's counters but can only pause these).
    qos_class: str = ""
    qos_weight_pct: int = 100
    qos_wait_seconds_total: float = 0.0
    qos_wait_hist: List[int] = dataclasses.field(default_factory=list)
    #: Raw region values of the previous sample (reset detection).
    _qos_raw_wait_us: int = 0
    _qos_raw_hist: List[int] = dataclasses.field(default_factory=list)

    def row(self, key: str) -> dict:
        return {
            "ctrkey": key,
            "chips": self.chips,
            "active": self.active,
            "oversubscribe": self.oversubscribe,
            "chip_seconds": self.chip_seconds,
            "hbm_byte_seconds": self.hbm_byte_seconds,
            "throttled_seconds": self.throttled_seconds,
            "oversub_spill_seconds": self.oversub_spill_seconds,
            "window_s": self.last_seen - self.first_seen,
            "qos_class": self.qos_class,
            "qos_weight_pct": self.qos_weight_pct,
            "qos_wait_seconds_total": self.qos_wait_seconds_total,
            "qos_wait_hist": list(self.qos_wait_hist),
        }

    def absorb_qos(self, cls: str, weight: int, wait_us: int,
                   hist: List[int]) -> None:
        """Fold one region sample into the monotonic qos counters
        (counter-reset handling: a raw value below the previous one is a
        restarted container — its full value is new)."""
        self.qos_class = cls
        self.qos_weight_pct = weight
        reset = (wait_us < self._qos_raw_wait_us
                 or len(hist) != len(self._qos_raw_hist)
                 or any(h < p for h, p in zip(hist, self._qos_raw_hist)))
        d_wait = wait_us if reset else wait_us - self._qos_raw_wait_us
        prev = ([0] * len(hist) if reset else self._qos_raw_hist)
        if len(self.qos_wait_hist) < len(hist):
            self.qos_wait_hist += \
                [0] * (len(hist) - len(self.qos_wait_hist))
        for i, h in enumerate(hist):
            self.qos_wait_hist[i] += h - (prev[i] if i < len(prev) else 0)
        self.qos_wait_seconds_total += d_wait / 1e6
        self._qos_raw_wait_us = wait_us
        self._qos_raw_hist = list(hist)


class UsageSampler:
    def __init__(self, loop, clock=time.monotonic,
                 retention_s: float = 300.0) -> None:
        self.loop = loop  # FeedbackLoop (or any .lock + .containers duck)
        self._clock = clock
        self.retention_s = retention_s
        # Own lock (not the loop's): snapshot() may be called from other
        # threads while sample() runs on the tick thread, and holding the
        # loop lock across both would couple a reader to the region
        # rescan.
        self._lock = threading.Lock()
        self._counters: Dict[str, CounterSet] = {}
        self._last_sample: Optional[float] = None
        #: class → (hist, wait_seconds) folded in from GC'd containers
        #: (per-class sums over live and retired containers must never
        #: go backwards).
        self._qos_retired: Dict[str, tuple] = {}

    def sample(self, now: Optional[float] = None) -> int:
        """Integrate one tick interval; returns the number of containers
        credited.  Region reads happen under the loop lock (rescan()
        munmaps regions); the arithmetic happens under the sampler's own
        lock only."""
        now = self._clock() if now is None else now
        rows = []
        with self.loop.lock:
            for key, state in self.loop.containers.items():
                region = state.region
                try:
                    n = region.num_devices
                    used = sum(region.used(i) for i in range(n))
                    # getattr: duck-typed regions (simulator fakes,
                    # pre-QoS test stubs) need not carry the QoS plane.
                    cls = getattr(region, "qos_class", -1)
                    qos = None
                    if cls >= 0:
                        qos = (QOS_CLASS_NAMES.get(cls, ""),
                               int(region.qos_weight),
                               int(region.qos_wait_us_total()),
                               region.qos_wait_hist())
                    rows.append((key, n, bool(state.active),
                                 bool(region.utilization_switch),
                                 bool(region.oversubscribe), used, qos))
                except Exception:  # noqa: BLE001 — region unmapped mid-read
                    continue
        with self._lock:
            dt = (0.0 if self._last_sample is None
                  else max(0.0, now - self._last_sample))
            self._last_sample = now
            seen = set()
            credited = 0
            for key, chips, active, throttled, oversub, used, qos in rows:
                seen.add(key)
                cs = self._counters.get(key)
                if cs is None:
                    # First observation: record instantaneous state only —
                    # crediting dt would meter an interval nobody watched.
                    cs = CounterSet(
                        first_seen=now, last_seen=now, chips=chips,
                        active=active, oversubscribe=oversub)
                    if qos is not None:
                        cs.absorb_qos(*qos)
                    self._counters[key] = cs
                    continue
                if active:
                    # ``active`` means "dispatched since the previous
                    # tick" (age_kernel census), so it describes exactly
                    # the interval being credited.
                    cs.chip_seconds += dt * chips
                    if oversub:
                        cs.oversub_spill_seconds += dt
                cs.hbm_byte_seconds += dt * used
                if throttled:
                    cs.throttled_seconds += dt
                if qos is not None:
                    cs.absorb_qos(*qos)
                cs.chips = chips
                cs.active = active
                cs.oversubscribe = oversub
                cs.last_seen = now
                credited += 1
            # GC: a key gone past retention has had retention_s worth of
            # reports carrying its final totals; dropping it bounds the
            # map under pod churn.  QoS wait counters fold into the
            # retired base first so per-class sums stay monotonic.
            for key in [k for k, cs in self._counters.items()
                        if k not in seen
                        and now - cs.last_seen > self.retention_s]:
                cs = self._counters.pop(key)
                if cs.qos_class:
                    hist, s = self._qos_retired.get(cs.qos_class,
                                                    ([], 0.0))
                    hist = list(hist)
                    if len(hist) < len(cs.qos_wait_hist):
                        hist += [0] * (len(cs.qos_wait_hist)
                                       - len(hist))
                    for i, n in enumerate(cs.qos_wait_hist):
                        hist[i] += n
                    self._qos_retired[cs.qos_class] = (
                        hist, s + cs.qos_wait_seconds_total)
            return credited

    def snapshot(self) -> List[dict]:
        """Current counter rows (USAGE_FIELDS shape), including
        recently-ended containers still inside the retention window —
        sorted by key so reports are deterministic."""
        with self._lock:
            return [cs.row(key)
                    for key, cs in sorted(self._counters.items())]

    def qos_retired(self) -> Dict[str, tuple]:
        """class → (hist bucket counts, wait_seconds) of GC'd
        containers (the monotonicity base of per-class sums)."""
        with self._lock:
            return {cls: (list(h), s)
                    for cls, (h, s) in self._qos_retired.items()}

    def get(self, key: str) -> Optional[CounterSet]:
        with self._lock:
            cs = self._counters.get(key)
            if cs is None:
                return None
            copy = dataclasses.replace(cs)
            # replace() shares list references; sample() mutates them.
            copy.qos_wait_hist = list(cs.qos_wait_hist)
            copy._qos_raw_hist = list(cs._qos_raw_hist)
            return copy
