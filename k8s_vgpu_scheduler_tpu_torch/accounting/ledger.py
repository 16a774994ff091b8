"""Scheduler-side usage ledger: node counter reports → durable accounts
(the port's copy of the JAX package's ``accounting/ledger.py``).

Each node agent piggybacks its monitor's monotonic counters on the
register-stream messages it already sends (``deviceplugin/register.py``);
``Scheduler.observe_registration`` feeds them here.  The ledger turns
those per-monitor-lifetime counters into per-pod accounts that survive
monitor restarts (Prometheus-style counter-reset handling: a report that
went backwards is a fresh monitor, its full value is new usage) and keeps
a bounded ring of cumulative samples per pod, so showback can answer "how
much did namespace X use in the last N hours" without a TSDB.

Keys: the node-side container key is ``<podUID>_<podName>``
(``monitor/reader.py`` ``scan_container_dirs``); the ledger indexes by pod
UID, so the efficiency join (``efficiency.py``) matches accounts against
the grant registry directly.  The field names are the JAX package's
(``chip_seconds`` counts GPU-seconds here): they are the wire's.
Standard library only.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

#: Monotonic counter fields carried per report (subset of
#: sampler.USAGE_FIELDS that accumulates).
COUNTER_FIELDS = ("chip_seconds", "hbm_byte_seconds", "throttled_seconds",
                  "oversub_spill_seconds")


def split_ctrkey(ctrkey: str) -> Tuple[str, str]:
    """``<podUID>_<podName>`` → (uid, name); a key without the separator
    is treated as a bare uid (synthetic feeds)."""
    uid, _, name = ctrkey.partition("_")
    return uid, name


@dataclasses.dataclass
class PodAccount:
    uid: str
    name: str
    node: str
    #: Ledger-side totals — monotonic across monitor restarts.
    chip_seconds: float = 0.0
    hbm_byte_seconds: float = 0.0
    throttled_seconds: float = 0.0
    oversub_spill_seconds: float = 0.0
    #: Last observed instantaneous state.
    chips: int = 0
    active: bool = False
    oversubscribe: bool = False
    first_recorded: float = 0.0
    last_recorded: float = 0.0
    #: Last time the pod was seen dispatching (active flag, or any
    #: chip-second accrual) — the idle-grant detector's input.
    last_active_at: float = 0.0
    #: QoS plane: class/weight are last-observed; the
    #: wait totals/histogram are stored as the node's latest monotonic
    #: values (the sampler already absorbed container restarts, so these
    #: only move forward within one monitor lifetime — Prometheus-style
    #: counter semantics fleet-side).
    qos_class: str = ""
    qos_weight_pct: int = 100
    qos_wait_seconds_total: float = 0.0
    qos_wait_hist: List[int] = dataclasses.field(default_factory=list)
    #: Raw cumulative values of the previous report (reset detection).
    _raw: Dict[str, float] = dataclasses.field(default_factory=dict)
    #: Ring of (t, chip_seconds_total, hbm_byte_seconds_total) samples.
    _series: deque = dataclasses.field(
        default_factory=lambda: deque(maxlen=360))


class UsageLedger:
    def __init__(self, clock=None, retention_s: float = 900.0,
                 series_len: int = 360) -> None:
        self._clock = clock or time.monotonic
        self.retention_s = retention_s
        self.series_len = series_len
        self._lock = threading.Lock()
        self._accounts: Dict[str, PodAccount] = {}
        #: Lifetime count of counter resets observed (a monitor restart
        #: per pod per field batch — visible for debugging feeds).
        self.resets_observed = 0
        #: class → (hist, wait_seconds) folded in from PRUNED accounts:
        #: the fleet-wide per-class dispatch-wait series are sums over
        #: accounts, and dropping a retired pod's contribution would
        #: make a Prometheus counter go backwards (rate() then reads
        #: the dip as a reset and reports a spurious spike).
        self._qos_retired: Dict[str, tuple] = {}
        #: Lifetime count of absorbed usage rows — a cheap dirty check
        #: for readers that derive purely from ledger state (the SLO
        #: engine skips its ledger-sourced SLIs on sweeps where no new
        #: row arrived).
        self.records_total = 0

    def now(self) -> float:
        return self._clock()

    # -- ingest ----------------------------------------------------------------
    def record(self, node: str, reports: Iterable[Mapping],
               now: Optional[float] = None) -> int:
        """Absorb one node's counter rows (USAGE_FIELDS shape — proto
        messages pass through ``decode_usage``).  Returns rows absorbed."""
        now = self._clock() if now is None else now
        n = 0
        with self._lock:
            for row in reports:
                ctrkey = row.get("ctrkey", "")
                if not ctrkey:
                    continue
                uid, name = split_ctrkey(ctrkey)
                acct = self._accounts.get(uid)
                if acct is None:
                    acct = PodAccount(uid=uid, name=name, node=node,
                                      first_recorded=now,
                                      last_active_at=now)
                    acct._series = deque(maxlen=self.series_len)
                    self._accounts[uid] = acct
                acct.node = node
                acct.name = name or acct.name
                accrued = False
                for field in COUNTER_FIELDS:
                    raw = float(row.get(field, 0.0))
                    prev = acct._raw.get(field)
                    if prev is None or raw < prev:
                        # First report for this pod, or the monitor
                        # restarted and its counters began again at zero:
                        # the whole raw value is usage the ledger has not
                        # yet absorbed.
                        delta = raw
                        if prev is not None:
                            self.resets_observed += 1
                    else:
                        delta = raw - prev
                    acct._raw[field] = raw
                    if delta > 0.0:
                        setattr(acct, field, getattr(acct, field) + delta)
                        if field == "chip_seconds":
                            accrued = True
                acct.chips = int(row.get("chips", acct.chips))
                if row.get("qos_class"):
                    acct.qos_class = row["qos_class"]
                    acct.qos_weight_pct = int(
                        row.get("qos_weight_pct", 100) or 100)
                    acct.qos_wait_seconds_total = float(
                        row.get("qos_wait_seconds_total", 0.0))
                    acct.qos_wait_hist = list(
                        row.get("qos_wait_hist", ()))
                acct.active = bool(row.get("active", False))
                acct.oversubscribe = bool(row.get("oversubscribe",
                                                  acct.oversubscribe))
                if acct.active or accrued:
                    acct.last_active_at = now
                acct.last_recorded = now
                acct._series.append(
                    (now, acct.chip_seconds, acct.hbm_byte_seconds))
                n += 1
            self.records_total += n
            self._prune_locked(now)
        return n

    def _prune_locked(self, now: float) -> None:
        for uid in [u for u, a in self._accounts.items()
                    if now - a.last_recorded > self.retention_s]:
            acct = self._accounts.pop(uid)
            if acct.qos_class:
                hist, s = self._qos_retired.get(acct.qos_class,
                                                ([], 0.0))
                hist = list(hist)
                if len(hist) < len(acct.qos_wait_hist):
                    hist += [0] * (len(acct.qos_wait_hist) - len(hist))
                for i, n in enumerate(acct.qos_wait_hist):
                    hist[i] += n
                self._qos_retired[acct.qos_class] = (
                    hist, s + acct.qos_wait_seconds_total)

    def qos_retired(self) -> Dict[str, tuple]:
        """class → (hist bucket counts, wait_seconds) of pruned
        accounts — the base the fleet-wide per-class histograms add so
        they stay monotonic across account GC."""
        with self._lock:
            return {cls: (list(h), s)
                    for cls, (h, s) in self._qos_retired.items()}

    # -- queries ---------------------------------------------------------------
    def get(self, uid: str) -> Optional[PodAccount]:
        with self._lock:
            acct = self._accounts.get(uid)
            if acct is None:
                return None
            copy = dataclasses.replace(acct)
            copy._series = deque(acct._series, maxlen=self.series_len)
            return copy

    def accounts(self) -> List[PodAccount]:
        with self._lock:
            out = []
            for acct in self._accounts.values():
                copy = dataclasses.replace(acct)
                copy._series = deque(acct._series,
                                     maxlen=self.series_len)
                out.append(copy)
            return out

    def window_usage(self, uid: str, window_s: float,
                     now: Optional[float] = None
                     ) -> Tuple[float, float, float]:
        """(chip_seconds, hbm_byte_seconds, covered_s) accrued by ``uid``
        inside the trailing window.  Baseline = the newest ring sample at
        or before the window start (so the delta covers the whole window
        when history suffices); with less history than the window, the
        delta is since the account began and ``covered_s`` says how much
        of the window the answer actually spans."""
        now = self._clock() if now is None else now
        start = now - window_s
        with self._lock:
            acct = self._accounts.get(uid)
            if acct is None or not acct._series:
                return 0.0, 0.0, 0.0
            base = None
            for sample in acct._series:
                if sample[0] <= start:
                    base = sample
                else:
                    break
            if base is None:
                base = acct._series[0]
            t0, chip0, hbm0 = base
            return (acct.chip_seconds - chip0,
                    acct.hbm_byte_seconds - hbm0,
                    max(0.0, acct.last_recorded - max(t0, start)))

    def node_busy_chips(self, node: str, stale_after_s: float = 60.0,
                        now: Optional[float] = None) -> Optional[int]:
        """Chips with a currently-dispatching container on ``node`` —
        the instantaneous 'actual utilization' the --score-by-actual
        placement signal reads (efficiency.py).  Returns None when the
        node has no FRESH reports (never reported, or every account went
        stale — a deleted pod's retained account must not count as busy,
        and an unmonitored node must read as 'unknown', never 'idle')."""
        now = self._clock() if now is None else now
        with self._lock:
            fresh = [a for a in self._accounts.values()
                     if a.node == node
                     and now - a.last_recorded <= stale_after_s]
            if not fresh:
                return None
            return sum(a.chips for a in fresh if a.active)

    def pods_on_node(self, node: str) -> List[str]:
        with self._lock:
            return [u for u, a in self._accounts.items() if a.node == node]


def decode_usage(usage_msgs) -> List[dict]:
    """Proto UsageCounters (either package's) → USAGE_FIELDS dict rows."""
    return [
        {
            "ctrkey": m.ctrkey,
            "chips": m.chips,
            "active": m.active,
            "oversubscribe": m.oversubscribe,
            "chip_seconds": m.chip_seconds,
            "hbm_byte_seconds": m.hbm_byte_seconds,
            "throttled_seconds": m.throttled_seconds,
            "oversub_spill_seconds": m.oversub_spill_seconds,
            "window_s": m.window_s,
            "qos_class": getattr(m, "qos_class", ""),
            "qos_weight_pct": int(getattr(m, "qos_weight_pct", 0) or 100),
            "qos_wait_seconds_total": getattr(
                m, "qos_wait_seconds_total", 0.0),
            "qos_wait_hist": list(getattr(m, "qos_wait_hist", ())),
        }
        for m in usage_msgs
    ]
