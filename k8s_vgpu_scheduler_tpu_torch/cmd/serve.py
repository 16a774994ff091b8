"""Model-serving entry point of the port: the continuous-batching engine
behind HTTP.

    vgpu-serve --config llama.json --checkpoint /ckpt --quant int8 --bind :8000
    python -m k8s_vgpu_scheduler_tpu_torch.cmd.serve --demo tiny --device cpu

Port of the JAX package's ``cmd/serve.py`` (``vtpu-serve``), the
deployable form of ``models/serve.py``.  One engine thread owns ALL device
work (the ServingEngine is deliberately not thread-safe); HTTP handlers
hand requests over and block on a per-request event, so any number of
concurrent clients share the slot pool, which is the point.

API (token ids in/out — tokenization is the application's concern):

- ``POST /v1/generate``  ``{"prompt": [ints], "max_new_tokens": N}`` →
  ``{"request_id", "tokens", "finished_by"}`` (blocks until complete);
  with ``"stream": true`` the response is server-sent events — one
  ``data: {"token": id}`` per token as decode dispatches land, then
  ``data: {"done": true, "finished_by": ...}``
- ``GET /healthz``   liveness
- ``GET /statsz``    engine stats, utilization, queue depth, pool bytes
- ``GET /metrics``   the same as Prometheus exposition text (written here:
  the JAX package's ``prometheus_client`` is not a dependency of the port)
- ``GET /profilez?seconds=N``  capture a ``torch.profiler`` trace (Chrome
  trace format, CUDA kernels included on the card) of the live decode
  loop; returns the trace directory.  On the card the pod starts the
  tracer before it loads its model, charging the tracer's footprint to
  its grant: 503 where the grant cannot hold it

``--config`` holds ``LlamaConfig`` fields as JSON, ``--checkpoint`` a
directory written by ``models/checkpoint.py``'s ``save_checkpoint`` of a
``Llama``; ``--quant int8|int4`` quantizes the restored weights one
projection at a time on their way to the card, so a pod whose grant
cannot hold the full-precision weights serves the quantized ones.  Runs
on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import queue as _queue
import shutil
import signal
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..util import exposition as expo

log = logging.getLogger(__name__)

DEMO_CONFIGS = {
    # "tiny" is CI/demo scale, "base" ~110M params.
    "tiny": dict(vocab=256, dim=128, n_layers=2, n_heads=8, n_kv_heads=4,
                 ffn_hidden=256),
    "base": dict(vocab=8192, dim=768, n_layers=12, n_heads=12, n_kv_heads=4,
                 ffn_hidden=2048),
}


class EngineFrontend:
    """Thread-safe facade: submit() from any thread, one worker thread
    drives the engine and delivers completions."""

    def __init__(self, engine):
        self.engine = engine
        self._cv = threading.Condition()
        self._incoming = []          # (prompt, max_new, waiter)
        self._waiters = {}           # request_id -> waiter
        self._to_cancel = []         # waiters whose client gave up
        self._submitting = []        # popped from _incoming, not yet in
        #                              _waiters — drain() must see them
        self._stop = False
        self._draining = False
        self._fatal: Optional[BaseException] = None
        # Cancellations that never reached the engine (client gave up
        # while still in _incoming): engine stats can't see them, so the
        # cancelled metric folds this in at stats() time.
        self._pre_cancelled = 0
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="serve-engine")
        self._thread.start()

    def submit_and_wait(self, prompt, max_new_tokens: int,
                        timeout: Optional[float] = None):
        waiter = self._enqueue(prompt, max_new_tokens, stream=False)
        if not waiter["event"].wait(timeout):
            # Nobody will read the result: free the slot for the next
            # request instead of decoding to max_new_tokens for a ghost.
            self.cancel(waiter)
            raise TimeoutError("generation timed out")
        if waiter["error"] is not None:
            raise waiter["error"]
        return waiter["completion"]

    def cancel(self, waiter: dict) -> None:
        """Abort a request whose client went away (timeout, disconnect).
        Applied by the worker thread before its next dispatch; a waiter
        not yet submitted is skipped at submit time instead."""
        with self._cv:
            waiter["cancelled"] = True
            self._to_cancel.append(waiter)
            self._cv.notify()

    def submit_stream(self, prompt, max_new_tokens: int) -> dict:
        """Streaming submit: returns the waiter whose ``stream_q`` yields
        ("tok", id) per generated token as decode dispatches land, then
        ("done", finished_by) — or ("err", message)."""
        return self._enqueue(prompt, max_new_tokens, stream=True)

    def _enqueue(self, prompt, max_new_tokens: int, stream: bool) -> dict:
        waiter = {"event": threading.Event(), "completion": None,
                  "error": None}
        if stream:
            waiter["stream_q"] = _queue.Queue()
            waiter["sent"] = 0
        with self._cv:
            if self._fatal is not None:
                raise RuntimeError(f"engine failed: {self._fatal!r}")
            if self._draining:
                raise RuntimeError("server draining (terminating)")
            self._incoming.append((prompt, max_new_tokens, waiter))
            self._cv.notify()
        return waiter

    def drain(self, timeout: float = 30.0) -> bool:
        """k8s preStop/SIGTERM path: refuse new requests, let in-flight
        generation finish.  True when the pool is fully idle; False when
        the grace period expired with work still running (the kubelet's
        SIGKILL will take it either way)."""
        with self._cv:
            self._draining = True
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._cv:
                idle = (not self._incoming and not self._submitting
                        and not self._waiters)
            if idle and not self.engine.active.any() \
                    and not self.engine.queue:
                return True
            time.sleep(0.1)
        return False

    def stats(self) -> dict:
        eng = self.engine
        with self._cv:
            depth = len(self._incoming)
        merged = dict(eng.stats)
        # Pre-submission abandonments (see _loop): one cancelled metric
        # covering the whole request lifecycle, not just engine-side.
        merged["cancelled"] = merged.get("cancelled", 0) + self._pre_cancelled
        return {
            "stats": merged,
            "utilization": eng.utilization,
            "queue_depth": depth + len(eng.queue),
            "slots": eng.S, "max_len": eng.L, "horizon": eng.horizon,
            "pool_hbm_bytes": eng.pool_hbm_bytes(),
            # {} until the first completion (latency_percentiles contract)
            "latency": eng.latency_percentiles(),
        }

    def healthy(self) -> bool:
        return self._fatal is None and self._thread.is_alive()

    def shutdown(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify()
        self._thread.join(timeout=30)

    def _fail_all(self, err: BaseException) -> None:
        """Fail every in-flight and queued waiter (stop/fatal paths)."""
        for _, _, w in self._incoming:
            self._fail_one(w, err)
        self._incoming = []
        for w in self._waiters.values():
            self._fail_one(w, err)
        self._waiters.clear()

    @staticmethod
    def _fail_one(w: dict, err: BaseException) -> None:
        w["error"] = err
        if "stream_q" in w:
            w["stream_q"].put(("err", str(err)))
        w["event"].set()

    def _loop(self) -> None:
        while True:
            with self._cv:
                while (not self._incoming and not self._to_cancel
                       and not self._stop
                       and not self.engine.active.any()
                       and not self.engine.queue):
                    self._cv.wait()
                if self._stop:
                    self._fail_all(RuntimeError("server shutting down"))
                    return
                batch = self._incoming
                self._incoming = []
                self._submitting = batch
                cancels = self._to_cancel
                self._to_cancel = []
            for prompt, max_new, waiter in batch:
                if waiter.get("cancelled"):
                    # Client gave up before submission: the engine never
                    # saw it, so count it here or the cancelled metric
                    # undercounts abandonments.
                    self._pre_cancelled += 1
                    continue
                try:
                    rid = self.engine.submit(prompt, max_new)
                    waiter["rid"] = rid
                    self._waiters[rid] = waiter
                except Exception as e:  # noqa: BLE001 — refuse, don't die
                    self._fail_one(waiter, e)
            with self._cv:
                self._submitting = []
            for w in cancels:
                rid = w.get("rid")
                if rid is not None and self._waiters.pop(rid, None) \
                        is not None:
                    self.engine.cancel(rid)
            try:
                completed = self.engine.step()
            except Exception as e:  # noqa: BLE001 — engine is now suspect
                # A mid-dispatch failure leaves the pool's cache rows in an
                # undefined state: mark the frontend FATALLY unhealthy
                # (healthz flips 503 so the pod restarts) instead of
                # retrying a corrupted engine in a hot loop.
                log.exception("engine step failed; marking frontend down")
                with self._cv:
                    self._fatal = e
                    self._fail_all(e)
                return
            # Token streaming: after each dispatch, push the still-active
            # slots' new tokens (this thread owns the engine, so reading
            # slot state here is the one safe place).
            for st in list(self.engine.slots.values()):
                w = self._waiters.get(st.request_id)
                if w is not None and "stream_q" in w:
                    while w["sent"] < len(st.tokens):
                        w["stream_q"].put(("tok", st.tokens[w["sent"]]))
                        w["sent"] += 1
            for c in completed:
                w = self._waiters.pop(c.request_id, None)
                if w is not None:
                    w["completion"] = c
                    if "stream_q" in w:
                        while w["sent"] < len(c.tokens):
                            w["stream_q"].put(("tok", c.tokens[w["sent"]]))
                            w["sent"] += 1
                        w["stream_q"].put(("done", c.finished_by))
                    w["event"].set()


def prometheus_text(stats: dict) -> str:
    """The serving pod's Prometheus surface: the exposition text of the
    JAX package's ``prometheus_text`` (a counter family per engine
    counter, gauges for utilization, queue depth and pool bytes, and the
    latency quantiles once the first completion lands), written by the
    port's ``util/exposition.py``."""
    fams = []
    for key, help_ in (
            ("prefills", "Requests admitted into slots"),
            ("decode_steps", "Decode steps executed"),
            ("decode_dispatches", "Device dispatches (horizon steps each)"),
            ("tokens_out", "Tokens generated"),
            ("completions", "Requests completed"),
            ("cancelled", "Requests cancelled (timeout/disconnect)")):
        fams.append(expo.CounterMetricFamily(
            f"vtpu_serve_{key}", help_, value=stats["stats"].get(key, 0)))
    for name, help_, value in (
            ("vtpu_serve_slot_utilization", "Fraction of slots decoding",
             stats["utilization"]),
            ("vtpu_serve_queue_depth", "Requests waiting for a slot",
             stats["queue_depth"]),
            ("vtpu_serve_pool_hbm_bytes", "KV-cache pool footprint",
             stats["pool_hbm_bytes"])):
        fams.append(expo.GaugeMetricFamily(name, help_, value=value))
    # Latency quantiles appear once the first completion lands
    # (absent-not-zero, same contract as /statsz "latency").
    lat = stats.get("latency") or {}
    for key, help_ in (("ttft", "Client-observed submit->first-token"),
                       ("per_token", "Steady-state per-token latency")):
        q = lat.get(f"{key}_s")
        if not q:
            continue
        for p in ("p50", "p95"):
            fams.append(expo.GaugeMetricFamily(
                f"vtpu_serve_{key}_seconds_{p}", help_ + f" ({p})",
                value=q[p]))
    return expo.render(fams)


_PROFILE_LOCK = threading.Lock()
# What CUPTI keeps on the card once the process has traced CUDA activity,
# outside every allocation the interposer sees: a reserve charged to the
# pod's grant when the tracer first starts and held until the process
# exits (chip_smoke.py reads the card around the pods' traces).
TRACER_MIB = 64
_tracer_started = False


def start_tracer(device) -> bool:
    """Charge the tracer's footprint on ``device`` (the card) to the pod's
    grant and start the tracer once a process, on the calling thread;
    False where the grant cannot hold the charge.  The pod calls it before
    it loads its model, with no other thread on the card: a first start
    from a ``/profilez`` handler while the engine thread decoded once
    ended a pod and once took one past its grant.  :func:`profile_capture`
    calls it (under _PROFILE_LOCK) where nothing has."""
    global _tracer_started
    if not _tracer_started:
        import torch
        from torch.profiler import ProfilerActivity, profile

        from ..shim.core import interposer_charge

        index = torch.cuda.current_device() if device.index is None \
            else device.index
        if interposer_charge(index, TRACER_MIB << 20) is False:
            return False
        _tracer_started = True
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.ones(1, device=device).add_(1)
            torch.cuda.synchronize(device)
    return True


def profile_capture(path: str, device) -> tuple:
    """``GET /profilez?seconds=N`` — trace whatever the engine runs for N
    seconds with ``torch.profiler`` (CUDA activity too when the engine is
    on the card) and return the trace directory, which holds one Chrome
    trace (``trace.json``).

    On the card the tracer must have started (:func:`start_tracer`, which
    charges its footprint to the pod's grant): 503 where the grant cannot
    hold it.  What CUPTI keeps on the card is not an allocation the
    interposer sees, and a pod must not outgrow its grant to be traced.

    Serialized: one capture at a time per process.  Traces land in fresh
    directories under $VTPU_PROFILE_BASE (default: the pod tmpdir) — the
    path is never caller-controlled (unauthenticated port) — and only the
    newest $VTPU_PROFILE_KEEP (default 5) are kept."""
    from urllib.parse import parse_qs, urlparse

    q = parse_qs(urlparse(path).query)
    try:
        seconds = float(q.get("seconds", ["2"])[0])
    except ValueError:
        return 400, {"error": "bad seconds"}
    if not 0.0 < seconds <= 60.0:   # also rejects NaN
        return 400, {"error": "seconds must be in (0, 60]"}
    if not _PROFILE_LOCK.acquire(blocking=False):
        # Before any filesystem work: the 409 path is the one a polling
        # client can hit in a loop, and it must not leak tmpdirs.
        return 409, {"error": "a capture is already running"}
    try:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            if not start_tracer(device):
                return 503, {"error": "the pod's memory grant cannot hold "
                             "the tracer's footprint on the card"}
            activities.append(ProfilerActivity.CUDA)
        base = os.environ.get("VTPU_PROFILE_BASE") or None
        out_dir = tempfile.mkdtemp(prefix="vtpu-prof-", dir=base)
        try:
            prof = profile(activities=activities)
            prof.start()
            try:
                time.sleep(seconds)
            finally:
                # A failed sleep must not leave the process-wide trace
                # running (every later capture would fail).
                prof.stop()
            prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
        except Exception as e:  # noqa: BLE001 — never take the server down
            shutil.rmtree(out_dir, ignore_errors=True)
            return 500, {"error": f"{type(e).__name__}: {e}"}
        # Retention bound: an unauthenticated poller must not fill the
        # pod filesystem.  Under the lock, so no concurrent capture's
        # fresh dir can be mistaken for an old one.
        try:
            keep = max(1, int(os.environ.get("VTPU_PROFILE_KEEP", "5")))
            root = os.path.dirname(out_dir)
            sibs = sorted(
                (os.path.join(root, d) for d in os.listdir(root)
                 if d.startswith("vtpu-prof-")
                 and os.path.isdir(os.path.join(root, d))),
                key=lambda p: os.stat(p).st_mtime)
            for old in sibs[:-keep]:
                if old != out_dir:
                    shutil.rmtree(old, ignore_errors=True)
        except Exception:  # noqa: BLE001 — rotation is best-effort
            pass
    except Exception as e:  # noqa: BLE001 — import / mkdtemp failed
        return 500, {"error": f"{type(e).__name__}: {e}"}
    finally:
        _PROFILE_LOCK.release()
    # Fresh mkdtemp: everything under it was written by THIS capture.
    n_files = sum(len(fs) for _, _, fs in os.walk(out_dir))
    return 200, {"trace_dir": out_dir, "seconds": seconds,
                 "files": n_files}


def make_handler(frontend: EngineFrontend, request_timeout: float):
    class Handler(BaseHTTPRequestHandler):
        # Socket timeout for every read/write: with daemon_threads=False a
        # client that connects and never sends a request (or an SSE reader
        # that stalls its receive window) would otherwise hold its handler
        # thread forever and server_close() could never join it outside
        # k8s (no SIGKILL backstop).  30s stalls only count
        # socket inactivity; server-side generation waits are unaffected.
        timeout = 30.0

        def log_message(self, fmt, *args):  # route through logging
            log.debug("http: " + fmt, *args)

        def _reply(self, code: int, obj: dict = None, *,
                   raw: bytes = b"",
                   content_type: str = "application/json") -> None:
            body = raw if obj is None else json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                if frontend.healthy():
                    self._reply(200, {"ok": True})
                else:
                    self._reply(503, {"ok": False,
                                      "error": "engine thread down"})
            elif self.path == "/statsz":
                self._reply(200, frontend.stats())
            elif self.path == "/metrics":
                self._reply(200,
                            raw=prometheus_text(frontend.stats()).encode(),
                            content_type="text/plain; version=0.0.4")
            elif self.path == "/profilez" or \
                    self.path.startswith("/profilez?"):
                self._reply(*profile_capture(self.path,
                                             frontend.engine.device))
            else:
                self._reply(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/v1/generate":
                self._reply(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n) or b"{}")
                prompt = req["prompt"]
                max_new = int(req.get("max_new_tokens", 64))
            except (KeyError, TypeError, ValueError,
                    json.JSONDecodeError) as e:
                self._reply(400, {"error": f"bad request: {e}"})
                return
            if req.get("stream"):
                self._stream(prompt, max_new)
                return
            try:
                c = frontend.submit_and_wait(prompt, max_new,
                                             timeout=request_timeout)
            except TimeoutError:
                self._reply(504, {"error": "generation timed out"})
                return
            except ValueError as e:      # over-capacity / bad shapes
                self._reply(422, {"error": str(e)})
                return
            except RuntimeError as e:
                self._reply(503, {"error": str(e)})
                return
            except Exception as e:  # noqa: BLE001 — the worker loop stores
                # ANY exception type in the waiter (e.g. TypeError from a
                # malformed prompt element); an unmapped type must become
                # an HTTP error, not a dropped connection.
                self._reply(400 if isinstance(e, (TypeError, KeyError))
                            else 500, {"error": f"{type(e).__name__}: {e}"})
                return
            self._reply(200, {"request_id": c.request_id,
                              "tokens": c.tokens,
                              "finished_by": c.finished_by})

        def _stream(self, prompt, max_new: int) -> None:
            """Server-sent events: one ``data: {"token": id}`` per
            generated token as decode dispatches land, terminated by
            ``data: {"done": true, "finished_by": ...}``.  The body is
            close-delimited (HTTP/1.0 semantics), so no Content-Length."""
            # Validate BEFORE committing 200 + SSE headers, so ordinary
            # rejections keep their status codes on the streaming path too
            # (validate_request is thread-safe: reads only max_len).
            try:
                frontend.engine.validate_request(prompt, max_new)
            except ValueError as e:
                self._reply(422, {"error": str(e)})
                return
            except Exception as e:  # noqa: BLE001 — e.g. TypeError coercion
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})
                return
            try:
                waiter = frontend.submit_stream(prompt, max_new)
            except RuntimeError as e:
                self._reply(503, {"error": str(e)})
                return
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()

            def event(obj: dict) -> bool:
                try:
                    self.wfile.write(b"data: " + json.dumps(obj).encode()
                                     + b"\n\n")
                    self.wfile.flush()
                    return True
                except OSError:
                    return False    # client went away
            while True:
                try:
                    kind, val = waiter["stream_q"].get(
                        timeout=request_timeout)
                except _queue.Empty:
                    frontend.cancel(waiter)
                    event({"error": "token timeout"})
                    return
                if kind == "tok":
                    if not event({"token": val}):
                        # Disconnected mid-stream: free the slot instead
                        # of decoding the rest for a ghost.
                        frontend.cancel(waiter)
                        return
                elif kind == "done":
                    event({"done": True, "finished_by": val})
                    return
                else:
                    event({"error": val})
                    return

    return Handler


def build_engine(args):
    """The ServingEngine ``args`` describe, on ``args.device``.  With
    ``--checkpoint`` and ``--quant`` the full-precision weights are
    restored to the host and quantized one projection at a time on their
    way to the device (``quantize_model``); without ``--quant`` they are
    restored straight into a model on the device."""
    # Imported under the entry point, not at module level: the device
    # must come up inside the pod's enforcement env.
    import torch

    from ..device import resolve_device
    from ..models.checkpoint import restore_checkpoint
    from ..models.convert import init_weights, quantize_model
    from ..models.llama import Llama, LlamaConfig
    from ..models.quant import BITS
    from ..models.serve import ServingEngine

    dev = resolve_device(args.device)
    if args.config:
        with open(args.config) as f:
            cfg = LlamaConfig(**json.load(f))
    else:
        cfg = LlamaConfig(**DEMO_CONFIGS[args.demo])
    if cfg.quant is not None:
        # Checkpoints hold full-precision weights; quantization is a
        # transform of the restored weights, chosen with --quant.
        raise SystemExit("--config must be full precision; pass --quant")
    # Full-precision weights first, on the host when they are quantized
    # on their way up.
    home = torch.device("cpu") if args.quant else dev
    if args.checkpoint:
        model = Llama(cfg, device=home)
        restore_checkpoint(args.checkpoint, model, device=home)
    else:
        model = init_weights(cfg, torch.Generator(device=home).manual_seed(0),
                             device=home)
    if args.quant:
        quantize_model(model, BITS[args.quant], device=dev)
    generator = (torch.Generator(device=dev).manual_seed(args.seed)
                 if args.temperature > 0 else None)
    return ServingEngine(
        model, max_slots=args.max_slots, max_len=args.max_len,
        horizon=args.horizon, eos_id=args.eos_id,
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        generator=generator)


def parse_args(argv=None):
    p = argparse.ArgumentParser("vgpu-serve")
    p.add_argument("--bind", default="0.0.0.0:8000")
    p.add_argument("--demo", choices=sorted(DEMO_CONFIGS), default="base")
    p.add_argument("--config", default="",
                   help="LlamaConfig fields as JSON (overrides --demo)")
    p.add_argument("--checkpoint", default="",
                   help="a Llama's checkpoint dir (models/checkpoint.py)")
    p.add_argument("--quant", choices=["int8", "int4"], default="")
    p.add_argument("--device", default="cuda",
                   help="the card unless 'cpu'")
    p.add_argument("--max-slots", type=int, default=8)
    p.add_argument("--max-len", type=int, default=2048)
    p.add_argument("--horizon", type=int, default=8)
    p.add_argument("--eos-id", type=int, default=None)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--request-timeout", type=float, default=300.0)
    p.add_argument("--drain-grace", type=float, default=30.0,
                   help="SIGTERM: seconds to let in-flight generation "
                        "finish before exiting (stay under the pod's "
                        "terminationGracePeriodSeconds)")
    return p.parse_args(argv)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    host, _, port = args.bind.rpartition(":")
    if not port.isdigit() or ":" in host:
        # ":" in host = bare/bracketed IPv6 — the server is IPv4/hostname
        # only; reject rather than bind somewhere surprising.
        raise SystemExit(
            f"--bind must be IPv4-host:port or :port, got {args.bind!r}")
    from ..device import resolve_device

    device = resolve_device(args.device)
    if device.type == "cuda" and not start_tracer(device):
        log.warning("the memory grant cannot hold the tracer (%d MiB): "
                    "/profilez will answer 503", TRACER_MIB)
    frontend = EngineFrontend(build_engine(args))

    class _Server(ThreadingHTTPServer):
        # Non-daemon handler threads + block_on_close: server_close()
        # joins them, so the last response finishes writing before the
        # process exits (a daemon handler mid-write would be killed at
        # interpreter teardown and the client would see a reset).
        daemon_threads = False

    server = _Server((host or "0.0.0.0", int(port)),
                     make_handler(frontend, args.request_timeout))
    log.info("serving on %s (slots=%d max_len=%d horizon=%d, pool=%d MiB)",
             args.bind, frontend.engine.S, frontend.engine.L,
             frontend.engine.horizon,
             frontend.engine.pool_hbm_bytes() // 2**20)

    def _terminate(_sig, _frame):
        # Signal handlers must not block: drain in a helper thread, then
        # stop serve_forever.  New submits 503 immediately; k8s has
        # already pulled the terminating pod from Service endpoints.
        def _drain_and_stop():
            clean = frontend.drain(args.drain_grace)
            log.info("drain %s; shutting down",
                     "complete" if clean else "grace expired")
            server.shutdown()

        threading.Thread(target=_drain_and_stop, daemon=True,
                         name="drain").start()

    signal.signal(signal.SIGTERM, _terminate)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        # Fail leftover waiters first so blocked handlers unblock, then
        # join the handler threads (daemon_threads=False) so every
        # response finishes writing.
        frontend.shutdown()
        server.server_close()


if __name__ == "__main__":
    main()
