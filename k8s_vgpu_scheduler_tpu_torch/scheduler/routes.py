"""HTTP routes: the kube-scheduler extender protocol and the admission
webhook (the port's copy of the reference's surface of the JAX package's
``scheduler/routes.py``).

Reference: pkg/scheduler/routes/route.go (PredicateRoute 41–77, Bind
79–108, WebHookRoute 122–131), scheduler-extender v1 JSON:

- ``POST /filter``  ExtenderArgs{Pod, NodeNames | Nodes} →
                    ExtenderFilterResult
- ``POST /bind``    ExtenderBindingArgs{PodName, PodNamespace, PodUID,
                    Node} → ExtenderBindingResult{Error}
- ``POST /webhook`` AdmissionReview v1
- ``GET  /healthz``
- ``GET  /fleetz``  the fleet snapshot (inventory, fabric, live grants and
                    the placement policies) for ``vgpu-simulate
                    --from-cluster``; an export error answers 500
- ``GET  /usagez``  per-namespace showback over a trailing window
                    (``?window=<seconds>``, a positive finite number, else
                    400; an export error answers 500) for ``vgpu-report``
- ``GET  /debug/*`` stacks, profile, vars, tracez, events
                    (``util/debugz.py``), with ``Config.enable_debug``

``/metrics`` is served on its own port (``scheduler/metrics.py``, as the
JAX daemon does).  The JAX package's other export endpoints (``/queuez``,
``/capacityz``, ``/auditz``, ``/sloz``, ``/explainz``, ``/perfz``) wait
for ROADMAP A.5; ``vgpu-report`` degrades without them.
"""

from __future__ import annotations

import json
import logging
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..util.config import Config
from .core import Scheduler
from .webhook import handle_admission_review

log = logging.getLogger(__name__)


def filter_endpoint(scheduler: Scheduler, args: dict) -> dict:
    pod = args.get("Pod") or {}
    node_names = args.get("NodeNames") or []
    # A kube-scheduler that is not nodeCacheCapable sends whole Node
    # objects and reads only `Nodes` back: the reply keeps its form.
    nodes_form = not node_names and bool(args.get("Nodes"))
    node_items = (args.get("Nodes") or {}).get("items", [])
    if nodes_form:
        node_names = [n.get("metadata", {}).get("name", "")
                      for n in node_items]

    result = scheduler.filter(pod, list(node_names))

    def reply(names, failed, error):
        out = {"NodeNames": names, "FailedNodes": failed, "Error": error}
        if nodes_form:
            keep = set(names)
            out["Nodes"] = {
                "apiVersion": "v1", "kind": "NodeList",
                "items": [n for n in node_items
                          if n.get("metadata", {}).get("name", "") in keep]}
        return out

    if result.error:
        return reply([], result.failed, result.error)
    if result.node is None:
        # The pod asks for no card: every candidate passes as it came.
        return reply(node_names, {}, "")
    return reply([result.node], result.failed, "")


def bind_endpoint(scheduler: Scheduler, args: dict) -> dict:
    err = scheduler.bind(args.get("PodNamespace", "default"),
                         args.get("PodName", ""), args.get("PodUID", ""),
                         args.get("Node", ""))
    return {"Error": err or ""}


class _Handler(BaseHTTPRequestHandler):
    scheduler: Scheduler
    cfg: Config

    def log_message(self, fmt, *args):  # through logging, not stderr
        log.debug("http: " + fmt, *args)

    def _reply(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 (http.server's API)
        from urllib.parse import parse_qsl, urlsplit

        parts = urlsplit(self.path)
        if self.path == "/healthz":
            self._reply(200, {"ok": True})
        elif self.path == "/fleetz":
            try:
                self._reply(200, self.scheduler.export_fleet())
            except Exception as e:  # noqa: BLE001 — a 500, not a hangup
                log.exception("fleetz export failed")
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})
        elif parts.path == "/usagez":
            query = dict(parse_qsl(parts.query))
            try:
                window = (float(query["window"])
                          if "window" in query else None)
                # float() takes nan and inf, which would flow into the
                # showback and break the body's strict JSON.
                if window is not None and (
                        not math.isfinite(window) or window <= 0):
                    raise ValueError(f"not a positive finite number: "
                                     f"{query['window']!r}")
            except (ValueError, TypeError) as e:
                self._reply(400, {"error": f"bad window: {e}"})
                return
            try:
                self._reply(200, self.scheduler.export_usage(window))
            except Exception as e:  # noqa: BLE001 — a 500, not a hangup
                log.exception("usagez export failed")
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})
        elif self.path.startswith("/debug/") and self.cfg.enable_debug:
            from ..util import debugz

            code, ctype, body = debugz.handle(
                parts.path, dict(parse_qsl(parts.query)))
            raw = body.encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(raw)))
            self.end_headers()
            self.wfile.write(raw)
        else:
            self._reply(404, {"error": "not found"})

    def do_POST(self):  # noqa: N802
        length = int(self.headers.get("Content-Length", 0))
        raw = self.rfile.read(length) if length else b"{}"
        try:
            body = json.loads(raw)
        except json.JSONDecodeError as e:
            self._reply(400, {"Error": f"bad json: {e}"})
            return
        try:
            if self.path == "/filter":
                self._reply(200, filter_endpoint(self.scheduler, body))
            elif self.path == "/bind":
                self._reply(200, bind_endpoint(self.scheduler, body))
            elif self.path == "/webhook":
                self._reply(200, handle_admission_review(
                    body, self.cfg, self.scheduler.known_topologies))
            else:
                self._reply(404, {"error": "not found"})
        except Exception as e:  # noqa: BLE001 — the extender answers, never dies
            log.exception("handler error on %s", self.path)
            self._reply(500, {"Error": str(e)})


class ExtenderServer:
    """The threaded HTTP server, with TLS when given a cert and a key (the
    reference's cert flags)."""

    def __init__(self, scheduler: Scheduler, cfg: Config,
                 host: str = "0.0.0.0", port: int = 9443,
                 certfile: Optional[str] = None,
                 keyfile: Optional[str] = None) -> None:
        handler = type("BoundHandler", (_Handler,),
                       {"scheduler": scheduler, "cfg": cfg})
        self.httpd = ThreadingHTTPServer((host, port), handler)
        if certfile and keyfile:
            import ssl

            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(certfile, keyfile)
            self.httpd.socket = ctx.wrap_socket(self.httpd.socket,
                                                server_side=True)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self) -> None:
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
