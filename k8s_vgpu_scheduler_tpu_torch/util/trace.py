"""Scheduling traces and the pod-lifecycle journal of the port's node agent.

The port's copy of the part of the JAX package's ``util/trace.py`` that
the webhook, Filter, Bind and ``Allocate`` use: the per-process tracer,
its spans and its event journal, ``new_trace_id``, ``trace_id_of`` and
``ENV_TRACE_ID``.  The mutating
webhook issues a trace id into the pod's annotations; Filter and Bind
record their spans under it; Allocate records its span under it, hands it
to the container as ``VTPU_TRACE_ID`` and drops it next to the pod's
region.  The phase histograms, the rejection counters, the OTLP export
and the /debug renderers wait for the metrics slice.

A finished span is one slotted object appended to a ``deque(maxlen=N)``
(append is atomic under the GIL: no lock on the record path).
"""

from __future__ import annotations

import itertools
import os
import time
import uuid
from collections import deque
from typing import Dict, List, Optional

# The trace ID's home in the scheduling protocol: issued by the mutating
# webhook, read by Filter/Bind and the device plugin's Allocate.
TRACE_ID_ANNOTATION = "vtpu.dev/trace-id"
# Container env carrying the ID past the kubelet boundary (emitted by the
# device plugin next to the enforcement env).
ENV_TRACE_ID = "VTPU_TRACE_ID"

# Span ids are randomly seeded once, then counted up: within-process
# uniqueness is all OTLP needs.
_SPAN_SEQ = itertools.count(int.from_bytes(os.urandom(8), "big") | 1)


def new_trace_id() -> str:
    """OTLP-compatible 16-byte trace id as 32 hex chars, issued once per
    pod admission."""
    return uuid.uuid4().hex


def new_span_id() -> str:
    """OTLP-compatible 8-byte span id as 16 hex chars."""
    return format(next(_SPAN_SEQ) & 0xFFFFFFFFFFFFFFFF, "016x")


def trace_id_of(pod: dict) -> str:
    """The webhook-issued trace id of a pod dict ('' when untraced)."""
    return pod.get("metadata", {}).get("annotations", {}).get(
        TRACE_ID_ANNOTATION, "")


class Span:
    """One finished (or in-flight) phase of one scheduling decision, and
    its own context manager (``with tracer.span(...) as sp``)."""

    __slots__ = ("trace_id", "span_id", "name", "start", "end", "attrs",
                 "_tracer", "_mono")

    def __init__(self, name: str, trace_id: str = "",
                 tracer: Optional["Tracer"] = None) -> None:
        self.name = name
        self.trace_id = trace_id
        self.span_id = new_span_id()
        # Wall clock anchors the span; the monotonic stamp measures it.
        self.start = time.time()
        self._mono = time.monotonic()
        self.end: Optional[float] = None
        self.attrs: Dict[str, object] = {}
        self._tracer = tracer

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc is not None:
            # A handler that recorded a specific error keeps it.
            self.attrs.setdefault("error", f"{exc_type.__name__}: {exc}")
        if self._tracer is not None:
            self._tracer.finish(self)
        return False  # exceptions propagate (and are recorded)

    def set(self, key: str, value) -> None:
        self.attrs[key] = value


class Tracer:
    """Per-process span ring and pod-lifecycle journal."""

    def __init__(self, capacity: int = 2048,
                 event_capacity: int = 4096) -> None:
        self._spans: deque = deque(maxlen=capacity)
        self._events: deque = deque(maxlen=event_capacity)
        self._seq = itertools.count()

    def span(self, name: str, trace_id: str = "", **attrs) -> Span:
        """Context manager recording one phase; attributes may be added
        on the entered span.  Exceptions propagate (and are recorded)."""
        sp = Span(name, trace_id, tracer=self)
        if attrs:
            sp.attrs.update(attrs)
        return sp

    def finish(self, sp: Span) -> None:
        sp.end = sp.start + max(0.0, time.monotonic() - sp._mono)
        self._spans.append(sp)

    def event(self, pod_uid: str, what: str, trace_id: str = "",
              **attrs) -> None:
        """Append one pod-lifecycle journal entry."""
        self._events.append((time.time(), next(self._seq), pod_uid, what,
                             trace_id, attrs))

    def spans(self, trace_id: Optional[str] = None) -> List[Span]:
        return [s for s in list(self._spans)
                if trace_id is None or s.trace_id == trace_id]

    def events(self, pod_uid: Optional[str] = None) -> List[dict]:
        return [
            {"time_s": t, "seq": seq, "pod_uid": uid, "event": what,
             "trace_id": tid, "attributes": attrs}
            for (t, seq, uid, what, tid, attrs) in list(self._events)
            if pod_uid is None or uid == pod_uid
        ]

    def reset(self) -> None:
        """Test hook: drop all recorded state."""
        self._spans.clear()
        self._events.clear()


_GLOBAL = Tracer()


def tracer() -> Tracer:
    """The process-global tracer (one per OS process by construction)."""
    return _GLOBAL

