"""pprof-style debug endpoints of the port (its copy of the JAX package's
``util/debugz.py``; the reference has klog alone).

Five views, modeled on Go's net/http/pprof:

- ``/debug/stacks``   every thread's current stack (goroutine?debug=2)
- ``/debug/profile``  a wall-clock sampling profiler over ``?seconds=N``
  (default 5): polls ``sys._current_frames`` and counts frames
- ``/debug/vars``     process vitals (rss, fds, threads, gc, uptime, pid)
- ``/debug/tracez``   recent scheduling spans from ``util/trace.py``,
  grouped by trace id; ``?trace=<id>`` filters, ``?format=json`` emits
  OTLP-shaped JSON
- ``/debug/events``   the pod-lifecycle journal; ``?pod=<uid>`` filters

``handle(path, query) -> (status, content_type, body)`` is transport-
agnostic, so the extender's HTTP handler and the monitor's standalone
:class:`DebugServer` share it.  Standard library only.
"""

from __future__ import annotations

import collections
import gc
import json
import os
import sys
import threading
import time
import traceback
from typing import Dict, Tuple

_START = time.time()


def stacks() -> str:
    frames = sys._current_frames()
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for ident, frame in sorted(frames.items()):
        out.append(f"--- thread {ident} ({names.get(ident, '?')}) ---")
        out.extend(ln.rstrip() for ln in traceback.format_stack(frame))
    return "\n".join(out) + "\n"


def profile(seconds: float = 5.0, hz: int = 100) -> str:
    """Wall-clock sampler: frame counts across ALL threads.  Blocking — the
    caller's thread sleeps; other threads keep serving."""
    seconds = max(0.1, min(seconds, 60.0))
    interval = 1.0 / hz
    counts: Dict[str, int] = collections.Counter()
    total = 0
    deadline = time.monotonic() + seconds
    me = threading.get_ident()
    while time.monotonic() < deadline:
        for ident, frame in sys._current_frames().items():
            if ident == me:
                continue
            co = frame.f_code
            key = f"{co.co_filename}:{frame.f_lineno} {co.co_name}"
            counts[key] += 1
            total += 1
        time.sleep(interval)
    lines = [f"wall-clock samples over {seconds:.1f}s "
             f"({total} thread-samples @ {hz}Hz)"]
    for key, n in sorted(counts.items(), key=lambda kv: -kv[1])[:50]:
        lines.append(f"{n:8d} {100.0 * n / max(1, total):5.1f}%  {key}")
    return "\n".join(lines) + "\n"


def vars_() -> dict:
    rss_kib = fds = 0
    try:
        with open("/proc/self/status") as f:
            for ln in f:
                if ln.startswith("VmRSS:"):
                    rss_kib = int(ln.split()[1])
    except OSError:
        pass
    try:
        fds = len(os.listdir("/proc/self/fd"))
    except OSError:
        pass
    return {
        "uptime_s": round(time.time() - _START, 1),
        "rss_mib": round(rss_kib / 1024, 1),
        "open_fds": fds,
        "threads": threading.active_count(),
        "gc_counts": gc.get_count(),
        "pid": os.getpid(),
    }


def handle(path: str, query: Dict[str, str]) -> Tuple[int, str, str]:
    """Route a /debug/* request; 404 for unknown paths."""
    if path == "/debug/stacks":
        return 200, "text/plain", stacks()
    if path == "/debug/profile":
        try:
            seconds = float(query.get("seconds", "5"))
        except ValueError:
            seconds = 5.0
        return 200, "text/plain", profile(seconds)
    if path == "/debug/vars":
        return 200, "application/json", json.dumps(vars_(), indent=1)
    if path == "/debug/tracez":
        from . import trace

        return trace.render_tracez(query)
    if path == "/debug/events":
        from . import trace

        return trace.render_events(query)
    return 404, "application/json", json.dumps({"error": "not found"})


class DebugServer:
    """Standalone debug HTTP server (monitor sidecar; port 0 = disabled)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        class _H(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def do_GET(self):  # noqa: N802
                from urllib.parse import parse_qsl, urlsplit

                parts = urlsplit(self.path)
                code, ctype, body = handle(parts.path, dict(parse_qsl(parts.query)))
                raw = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(raw)))
                self.end_headers()
                self.wfile.write(raw)

        self.httpd = ThreadingHTTPServer((host, port), _H)
        self._thread = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
