"""Prometheus exposition text of the port, written without a client library.

The JAX package builds its metric families with ``prometheus_client``; the
port writes the same text itself, so its daemons need nothing beyond the
standard library.  The three family classes take the constructor and
``add_metric`` arguments of ``prometheus_client``'s ``GaugeMetricFamily``,
``CounterMetricFamily`` and ``HistogramMetricFamily``, and :func:`render`
writes what ``prometheus_client.generate_latest`` writes for them:

- ``# HELP`` (backslashes and newlines escaped) and ``# TYPE`` per family;
- a counter's family and sample names end in ``_total``;
- a histogram's samples are ``_bucket{le=...}`` (cumulative, ``+Inf``
  last), then ``_count`` (the ``+Inf`` bucket) and ``_sum``;
- label pairs sorted by name, values escaped (backslash, newline, double
  quote), sample values in Go's float formatting.

:class:`MetricsServer` serves ``GET /metrics`` from a collect function on a
``ThreadingHTTPServer``; it reports its bound port, so port 0 works.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def go_float(value) -> str:
    """A sample value as Prometheus' text format writes it (Go's
    formatting, which switches to exponents sooner than Python's)."""
    d = float(value)
    if d == float("inf"):
        return "+Inf"
    if d == float("-inf"):
        return "-Inf"
    if d != d:
        return "NaN"
    s = repr(d)
    dot = s.find(".")
    if d > 0 and dot > 6:
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


def escape_help(text: str) -> str:
    return text.replace("\\", r"\\").replace("\n", r"\n")


def escape_label(value: str) -> str:
    return value.replace("\\", r"\\").replace("\n", r"\n").replace(
        '"', r'\"')


class _Family:
    kind = ""

    def __init__(self, name: str, documentation: str,
                 labels: Optional[Sequence[str]] = None) -> None:
        self.name = name
        self.documentation = documentation
        self.labelnames = tuple(labels or ())
        #: (sample name, {label: value}, value), in emission order.
        self.samples: List[Tuple[str, dict, float]] = []

    def _labels(self, values: Sequence[str]) -> dict:
        return dict(zip(self.labelnames, (str(v) for v in values)))


class GaugeMetricFamily(_Family):
    kind = "gauge"

    def __init__(self, name: str, documentation: str, value=None,
                 labels: Optional[Sequence[str]] = None) -> None:
        super().__init__(name, documentation, labels)
        if value is not None:
            self.add_metric([], value)

    def add_metric(self, labels: Sequence[str], value) -> None:
        self.samples.append((self.name, self._labels(labels), float(value)))


class CounterMetricFamily(_Family):
    kind = "counter"

    def __init__(self, name: str, documentation: str, value=None,
                 labels: Optional[Sequence[str]] = None) -> None:
        if name.endswith("_total"):
            name = name[:-6]
        super().__init__(name, documentation, labels)
        if value is not None:
            self.add_metric([], value)

    def add_metric(self, labels: Sequence[str], value) -> None:
        self.samples.append((self.name + "_total", self._labels(labels),
                             float(value)))


class HistogramMetricFamily(_Family):
    kind = "histogram"

    def add_metric(self, labels: Sequence[str],
                   buckets: Sequence[Tuple[str, float]],
                   sum_value: Optional[float]) -> None:
        """``buckets``: cumulative ``(le, count)`` pairs, sorted, with
        ``+Inf`` last; the ``+Inf`` count is the ``_count`` sample."""
        base = self._labels(labels)
        for le, count in buckets:
            self.samples.append((self.name + "_bucket",
                                 {**base, "le": str(le)}, float(count)))
        if float(buckets[0][0]) >= 0 and sum_value is not None:
            self.samples.append((self.name + "_count", dict(base),
                                 float(buckets[-1][1])))
            self.samples.append((self.name + "_sum", dict(base),
                                 float(sum_value)))


def _sample_line(name: str, labels: dict, value: float) -> str:
    if labels:
        pairs = ",".join(f'{k}="{escape_label(v)}"'
                         for k, v in sorted(labels.items()))
        return f"{name}{{{pairs}}} {go_float(value)}\n"
    return f"{name} {go_float(value)}\n"


def render(families: Iterable[_Family]) -> str:
    """The exposition text of ``families``, in their order."""
    out: List[str] = []
    for fam in families:
        mname = fam.name + "_total" if fam.kind == "counter" else fam.name
        out.append(f"# HELP {mname} {escape_help(fam.documentation)}\n")
        out.append(f"# TYPE {mname} {fam.kind}\n")
        out.extend(_sample_line(*s) for s in fam.samples)
    return "".join(out)


class MetricsServer:
    """``GET /metrics`` (and ``/``) answering ``render(collect())`` on a
    threaded HTTP server; a collect that raises answers 500."""

    def __init__(self, collect: Callable[[], Iterable[_Family]],
                 host: str = "0.0.0.0", port: int = 0) -> None:
        class _H(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def do_GET(self):  # noqa: N802 (http.server's API)
                path = self.path.split("?", 1)[0]
                if path not in ("/metrics", "/"):
                    code, body = 404, b"not found\n"
                else:
                    try:
                        code, body = 200, render(collect()).encode()
                    except Exception as e:  # noqa: BLE001 — a 500, not a hangup
                        code, body = 500, f"collect failed: {e}\n".encode()
                self.send_response(code)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.httpd = ThreadingHTTPServer((host, port), _H)
        self.httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self) -> "MetricsServer":
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="metrics-http", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
