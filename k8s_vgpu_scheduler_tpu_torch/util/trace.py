"""End-to-end scheduling traces and the pod-lifecycle journal of the port.

The port's copy of the JAX package's ``util/trace.py``.  The mutating
webhook issues a trace id into the pod's annotations
(``vtpu.dev/trace-id``); Filter, Bind and the scheduler-side ``allocate``
span record under it; ``Allocate`` hands it to the container as
``VTPU_TRACE_ID`` and drops it next to the pod's region, so one id
stitches every phase of a pod's placement across the extender, the node
agent and the pod.

Three surfaces, all fed from the same per-process :class:`Tracer`:

- per-phase latency histograms and rejection-reason counters, exported by
  the port's collectors (``scheduler/metrics.py``, ``monitor/metrics.py``)
  through :meth:`Tracer.histogram_snapshot` and
  :meth:`Tracer.rejection_snapshot`;
- ``/debug/tracez`` (text) and ``/debug/events?pod=<uid>`` through the
  transport-agnostic ``util/debugz.py`` handler;
- ``/debug/tracez?format=json``: OTLP-shaped JSON (resourceSpans →
  scopeSpans → spans), so traces ship to any OpenTelemetry collector.

A finished span is one slotted object appended to a ``deque(maxlen=N)``
(append is atomic under the GIL: no lock on the record path), and a
histogram observe is a bisect and two adds under a lock held for
nanoseconds.  Nothing here talks to the network or the disk.
"""

from __future__ import annotations

import bisect
import itertools
import json
import os
import threading
import time
import uuid
from collections import Counter, deque
from typing import Dict, List, Optional, Tuple

# The trace ID's home in the scheduling protocol: issued by the mutating
# webhook, read by Filter/Bind and the device plugin's Allocate.
TRACE_ID_ANNOTATION = "vtpu.dev/trace-id"
# Container env carrying the ID past the kubelet boundary (emitted by the
# device plugin next to the enforcement env).
ENV_TRACE_ID = "VTPU_TRACE_ID"

# Latency buckets (seconds), the JAX package's: a per-pod decision of a
# few microseconds, a filter→bind cycle of about a millisecond and
# apiserver writes of about ten all resolve.
DEFAULT_BUCKETS = (0.000005, 0.00001, 0.000025, 0.00005,
                   0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                   0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

# Admissible values of the histogram qos label: the webhook-validated
# classes (util/types.py), the only values that may become Prometheus
# label values through the phase histograms.
from .types import QOS_CLASSES as _QOS_LABELS  # noqa: E402


def new_trace_id() -> str:
    """OTLP-compatible 16-byte trace id as 32 hex chars, issued once per
    pod admission."""
    return uuid.uuid4().hex


# Span ids are randomly seeded once, then counted up: within-process
# uniqueness is all OTLP needs.
_SPAN_SEQ = itertools.count(int.from_bytes(os.urandom(8), "big") | 1)


def new_span_id() -> str:
    """OTLP-compatible 8-byte span id as 16 hex chars."""
    return format(next(_SPAN_SEQ) & 0xFFFFFFFFFFFFFFFF, "016x")


def trace_id_of(pod: dict) -> str:
    """The webhook-issued trace id of a pod dict ('' when untraced)."""
    return pod.get("metadata", {}).get("annotations", {}).get(
        TRACE_ID_ANNOTATION, "")


class Span:
    """One finished (or in-flight) phase of one scheduling decision.
    Doubles as its own context manager (``with tracer.span(...) as sp``)
    so the hot path pays no generator machinery."""

    __slots__ = ("trace_id", "span_id", "name", "start", "end", "attrs",
                 "_tracer", "_mono")

    def __init__(self, name: str, trace_id: str = "",
                 start: Optional[float] = None,
                 tracer: Optional["Tracer"] = None) -> None:
        self.name = name
        self.trace_id = trace_id
        self.span_id = new_span_id()
        # Wall clock anchors the span on the OTLP timeline; the monotonic
        # stamp measures its duration (an NTP step mid-span must not feed
        # a negative or wildly inflated observation into the histograms).
        self.start = time.time() if start is None else start
        self._mono = time.monotonic()
        self.end: Optional[float] = None
        self.attrs: Dict[str, object] = {}
        self._tracer = tracer

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc is not None:
            # setdefault: a handler that already recorded a specific
            # error (e.g. before context.abort re-raises generically)
            # must not have it clobbered by the carrier exception.
            self.attrs.setdefault("error", f"{exc_type.__name__}: {exc}")
        if self._tracer is not None:
            self._tracer.finish(self)
        return False  # exceptions propagate (and are recorded)

    @property
    def duration_s(self) -> float:
        if self.end is None:  # in-flight
            return max(0.0, time.monotonic() - self._mono)
        return self.end - self.start

    def set(self, key: str, value) -> None:
        self.attrs[key] = value

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "name": self.name,
            "start_s": self.start,
            "duration_ms": round(self.duration_s * 1e3, 3),
            "attributes": dict(self.attrs),
        }


class PhaseHistogram:
    """Fixed-bucket latency histogram for one phase.  ``observe`` is a
    bisect plus two integer adds under a lock held for nanoseconds —
    cheap enough for the filter hot path."""

    __slots__ = ("bounds", "counts", "total", "sum_s", "_lock")

    def __init__(self, bounds: Tuple[float, ...] = DEFAULT_BUCKETS) -> None:
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)  # +inf bucket last
        self.total = 0
        self.sum_s = 0.0
        self._lock = threading.Lock()

    def observe(self, seconds: float) -> None:
        i = bisect.bisect_left(self.bounds, seconds)
        with self._lock:
            self.counts[i] += 1
            self.total += 1
            self.sum_s += seconds

    def snapshot(self) -> Tuple[List[Tuple[str, int]], int, float]:
        """Prometheus-shaped (cumulative buckets incl +Inf, count, sum)."""
        with self._lock:
            counts = list(self.counts)
            total, sum_s = self.total, self.sum_s
        out: List[Tuple[str, int]] = []
        acc = 0
        for bound, n in zip(self.bounds, counts):
            acc += n
            out.append((repr(bound), acc))
        out.append(("+Inf", total))
        return out, total, sum_s


class Tracer:
    """Per-process span ring + pod-lifecycle journal + phase histograms.

    One module-global instance per process (``tracer()``); the scheduler,
    the monitor and the device plugin each own their own, labeled via
    ``service``.
    """

    def __init__(self, capacity: int = 2048, event_capacity: int = 4096,
                 service: str = "vtpu") -> None:
        self.service = service
        # deque(maxlen) gives bounded memory and GIL-atomic appends: the
        # journal is effectively lock-free on the record path.
        self._spans: deque = deque(maxlen=capacity)
        self._events: deque = deque(maxlen=event_capacity)
        self._hist: Dict[str, PhaseHistogram] = {}
        self._hist_lock = threading.Lock()
        self._rejections: Counter = Counter()
        self._rej_lock = threading.Lock()
        self._seq = itertools.count()

    # -- recording -------------------------------------------------------------
    def span(self, name: str, trace_id: str = "", **attrs) -> Span:
        """Context manager recording one phase; attributes may be added
        on the entered span.  Exceptions propagate (and are recorded)."""
        sp = Span(name, trace_id, tracer=self)
        if attrs:
            sp.attrs.update(attrs)
        return sp

    def finish(self, sp: Span) -> None:
        # Monotonic duration projected onto the wall-clock start, so
        # end-start stays the true elapsed time even across a clock step.
        sp.end = sp.start + max(0.0, time.monotonic() - sp._mono)
        self._spans.append(sp)
        self.histogram(sp.name,
                       str(sp.attrs.get("qos") or "")).observe(
            sp.duration_s)

    def record(self, name: str, trace_id: str, start_s: float,
               end_s: float, **attrs) -> Span:
        """Record a phase whose endpoints were measured elsewhere (e.g.
        the allocate phase reconstructed from bind-time annotation +
        watch-event arrival)."""
        sp = Span(name, trace_id, start=start_s)
        sp.attrs.update(attrs)
        sp.end = end_s
        self._spans.append(sp)
        self.histogram(name, str(attrs.get("qos") or "")).observe(
            max(0.0, end_s - start_s))
        return sp

    def event(self, pod_uid: str, what: str, trace_id: str = "",
              **attrs) -> None:
        """Append one pod-lifecycle journal entry."""
        self._events.append((time.time(), next(self._seq), pod_uid, what,
                             trace_id, attrs))

    def reject(self, reason: str, n: int = 1) -> None:
        """Count one node-rejection reason (low-cardinality strings from
        scheduler/score.py)."""
        with self._rej_lock:
            self._rejections[reason] += n

    def histogram(self, phase: str, qos: str = "") -> PhaseHistogram:
        """Per-(phase, QoS class) latency histogram — the class label
        lets tiered latency be sliced in the exported histograms the
        same way ``vtpu.dev/qos`` slices it in traces (unclassed pods
        aggregate under the empty class).  The label set is CLAMPED to
        the known classes: the annotation reaches here unvalidated when
        the webhook is bypassed, and keying histograms (and Prometheus
        series) on a tenant-controlled string would grow both without
        bound — unknown values aggregate under "invalid"."""
        if qos and qos not in _QOS_LABELS:
            qos = "invalid"
        key = (phase, qos)
        h = self._hist.get(key)
        if h is None:
            with self._hist_lock:
                h = self._hist.setdefault(key, PhaseHistogram())
        return h

    # -- reading ---------------------------------------------------------------
    def spans(self, trace_id: Optional[str] = None,
              limit: int = 0) -> List[Span]:
        out = [s for s in list(self._spans)
               if trace_id is None or s.trace_id == trace_id]
        return out[-limit:] if limit else out

    def events(self, pod_uid: Optional[str] = None,
               limit: int = 0, after_seq: int = -1) -> List[dict]:
        """Journal read with reader-side pagination: ``after_seq``
        returns only entries newer than a previously-seen sequence
        number (the cursor a poller carries between reads — under storm
        load the ring moves while you read, and seq is the only stable
        ordering).  With a cursor (``after_seq >= 0``) ``limit`` pages
        from the OLDEST end, so a tailing poller walks forward without
        silently skipping the entries between its cursor and the newest
        page; without one it caps from the newest end (the "show me
        recent" view)."""
        out = [
            {"time_s": t, "seq": seq, "pod_uid": uid, "event": what,
             "trace_id": tid, "attributes": attrs}
            for (t, seq, uid, what, tid, attrs) in list(self._events)
            if (pod_uid is None or uid == pod_uid) and seq > after_seq
        ]
        if not limit:
            return out
        return out[:limit] if after_seq >= 0 else out[-limit:]

    def histogram_snapshot(self) -> Dict[Tuple[str, str],
                                         Tuple[List[Tuple[str, int]],
                                               int, float]]:
        """``(phase, qos class)`` → Prometheus-shaped snapshot.  Both
        exporters render the pair as ``{phase=..., qos=...}`` labels."""
        with self._hist_lock:
            phases = dict(self._hist)
        return {key: h.snapshot() for key, h in phases.items()}

    def rejection_snapshot(self) -> Dict[str, int]:
        with self._rej_lock:
            return dict(self._rejections)

    def reset(self) -> None:
        """Test hook: drop all recorded state."""
        self._spans.clear()
        self._events.clear()
        with self._hist_lock:
            self._hist.clear()
        with self._rej_lock:
            self._rejections.clear()

    # -- OTLP export -----------------------------------------------------------
    def to_otlp(self, trace_id: Optional[str] = None) -> dict:
        """OTLP/JSON trace shape (resourceSpans → scopeSpans → spans) so
        ``/debug/tracez?format=json`` pipes into any OTel collector."""

        def attr(k, v):
            if isinstance(v, bool):
                return {"key": k, "value": {"boolValue": v}}
            if isinstance(v, int):
                return {"key": k, "value": {"intValue": str(v)}}
            if isinstance(v, float):
                return {"key": k, "value": {"doubleValue": v}}
            return {"key": k, "value": {"stringValue": str(v)}}

        spans = []
        for s in self.spans(trace_id):
            spans.append({
                "traceId": s.trace_id or "0" * 32,
                "spanId": s.span_id,
                "name": s.name,
                "kind": "SPAN_KIND_INTERNAL",
                "startTimeUnixNano": str(int(s.start * 1e9)),
                "endTimeUnixNano": str(int((s.end or s.start) * 1e9)),
                "attributes": [attr(k, v) for k, v in s.attrs.items()],
            })
        return {
            "resourceSpans": [{
                "resource": {"attributes": [attr("service.name",
                                                 self.service)]},
                "scopeSpans": [{
                    "scope": {"name": "vtpu.trace"},
                    "spans": spans,
                }],
            }]
        }


_GLOBAL = Tracer()


def tracer() -> Tracer:
    """The process-global tracer (one per OS process by construction)."""
    return _GLOBAL


def configure(service: Optional[str] = None,
              capacity: Optional[int] = None,
              event_capacity: Optional[int] = None) -> Tracer:
    """Entrypoint wiring: name the process and optionally resize the
    rings (resizing rebuilds the deques, keeping the most recent entries
    that fit — call once at startup, before traffic)."""
    t = _GLOBAL
    if service is not None:
        t.service = service
    if capacity is not None:
        t._spans = deque(t._spans, maxlen=max(1, capacity))
    if event_capacity is not None:
        t._events = deque(t._events, maxlen=max(1, event_capacity))
    return t


# -- /debug renderers (plugged into util/debugz.handle) ------------------------
def render_tracez(query: Dict[str, str]) -> Tuple[int, str, str]:
    t = tracer()
    trace_id = query.get("trace") or None
    if query.get("format") == "json":
        return 200, "application/json", json.dumps(
            t.to_otlp(trace_id), indent=1)
    by_trace: Dict[str, List[Span]] = {}
    for s in t.spans(trace_id):
        by_trace.setdefault(s.trace_id or "<untraced>", []).append(s)
    lines = [f"tracez: {sum(len(v) for v in by_trace.values())} spans in "
             f"{len(by_trace)} traces ({t.service})"]
    for tid, spans in by_trace.items():
        lines.append(f"--- trace {tid} ---")
        for s in sorted(spans, key=lambda x: x.start):
            attrs = " ".join(f"{k}={v}" for k, v in s.attrs.items())
            lines.append(f"  {s.name:<16} {s.duration_s * 1e3:9.3f} ms"
                         f"  {attrs}")
    return 200, "text/plain", "\n".join(lines) + "\n"


def render_events(query: Dict[str, str]) -> Tuple[int, str, str]:
    """``/debug/events[?pod=<uid>&limit=<n>&after_seq=<seq>]`` — the
    pagination params let a poller tail the journal under storm load
    without re-downloading the whole ring per poll (next_seq in the
    reply is the cursor to pass back)."""
    t = tracer()
    try:
        limit = int(query.get("limit", "0"))
        after_seq = int(query.get("after_seq", "-1"))
    except ValueError as e:
        return 400, "application/json", json.dumps(
            {"error": f"bad pagination param: {e}"})
    events = t.events(query.get("pod") or None, limit=limit,
                      after_seq=after_seq)
    return 200, "application/json", json.dumps(
        {"service": t.service, "events": events,
         "next_seq": events[-1]["seq"] if events else after_seq},
        indent=1)
