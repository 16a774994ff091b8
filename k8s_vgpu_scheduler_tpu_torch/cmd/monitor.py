"""Node monitor of the PyTorch/CUDA port (a sidecar of the device plugin's
DaemonSet).

    vgpu-monitor --container-root /tmp/vgpu/containers [--interval 2.0]
        [--metrics-port 9394] [--grpc-port 9395 --grpc-bind 127.0.0.1]
        [--debug-port 0] [--node-name N] [--no-backend]
    python -m k8s_vgpu_scheduler_tpu_torch.cmd.monitor ...

The port's counterpart of the JAX package's ``cmd/monitor.py``
(reference: cmd/vGPUmonitor/main.go, the metrics goroutine and the
watchAndFeedback loop every 2 s over the hostPath-mounted container cache
dirs).  Each tick is a ``region-scan`` span around ``loop.tick()``
(rescan, priority switch, QoS re-weighting, slot GC) and
``sampler.sample()`` (the usage counters).  :func:`serve` starts what the
node exposes over that loop and sampler: the Prometheus exporter
(``monitor/metrics.py``), the NodeTPUInfo RPC (``monitor/noderpc.py``,
loaded only when ``--grpc-port`` is not 0) and the loopback ``/debug``
server.  The card inventory comes from ``tpulib.detect()`` (NVML, or the
mock fixture), so ``host_tpu_memory_total_mib`` is each card's advertised
MiB.  Never imports torch.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import signal
import threading
import time
from typing import Optional

from ..accounting.sampler import UsageSampler
from ..monitor.feedback import FeedbackLoop, QosConfig
from ..monitor.metrics import start_metrics_server
from ..monitor.reader import RegionReader
from ..util import trace
from ..util.debugz import DebugServer
from ..util.exposition import MetricsServer

log = logging.getLogger("vgpu.monitor")


def parse_args(argv=None):
    p = argparse.ArgumentParser("vgpu-monitor")
    p.add_argument("--container-root", default="/tmp/vgpu/containers")
    p.add_argument("--metrics-port", type=int, default=9394)
    p.add_argument("--grpc-port", type=int, default=9395,
                   help="NodeTPUInfo gRPC port (0 = disabled)")
    p.add_argument("--grpc-bind", default="127.0.0.1",
                   help="NodeTPUInfo bind address; the endpoint is "
                        "unauthenticated, so the default is loopback-only "
                        "(node-local tooling) — widen to [::] explicitly "
                        "and add a NetworkPolicy if peers need it")
    p.add_argument("--interval", type=float, default=2.0)
    # SLO-tiered co-residency feedback (QosController).
    p.add_argument("--qos-target-p99-ms", type=float, default=20.0,
                   help="critical-class dispatch-wait p99 target; above "
                        "it duty shifts from best-effort to critical")
    p.add_argument("--qos-step-pct", type=int, default=15,
                   help="duty-weight percentage points shifted per tick")
    p.add_argument("--qos-min-weight", type=int, default=25,
                   help="best-effort duty-weight floor (never starved)")
    p.add_argument("--qos-max-weight", type=int, default=175,
                   help="latency-critical duty-weight ceiling")
    p.add_argument("--qos-recover-ticks", type=int, default=3,
                   help="consecutive good ticks before duty returns and "
                        "the best-effort yield flag clears (hysteresis)")
    p.add_argument("--debug-port", type=int, default=0,
                   help="loopback /debug profiling endpoints (0 = off)")
    p.add_argument("--node-name", default=os.environ.get("NODE_NAME", ""))
    p.add_argument("--no-backend", action="store_true",
                   help="skip card enumeration (metrics from regions only)")
    p.add_argument("--library", default=None,
                   help="a built libvgpu_torch.so (default: build "
                        "csrc/vgpu/ with g++ on first use)")
    p.add_argument("-v", "--verbose", action="count", default=0)
    return p.parse_args(argv)


def qos_config(args) -> QosConfig:
    return QosConfig(
        target_p99_us=int(args.qos_target_p99_ms * 1000),
        step_pct=args.qos_step_pct,
        min_weight_pct=args.qos_min_weight,
        max_weight_pct=args.qos_max_weight,
        recover_ticks=args.qos_recover_ticks,
    )


@dataclasses.dataclass
class Serving:
    """What :func:`serve` started: the exporter, the RPC (None with
    ``grpc_port`` 0) and the debug server (None with ``debug_port`` 0)."""

    metrics: MetricsServer
    rpc: Optional[object] = None
    rpc_port: int = 0
    debug: Optional[DebugServer] = None

    def stop(self) -> None:
        if self.rpc is not None:
            self.rpc.stop()
        if self.debug is not None:
            self.debug.stop()
        self.metrics.stop()


def serve(loop: FeedbackLoop, sampler: UsageSampler, backend, node: str,
          metrics_port: int = 9394, grpc_port: int = 9395,
          grpc_bind: str = "127.0.0.1", debug_port: int = 0,
          metrics_host: str = "0.0.0.0") -> Serving:
    """Start the node's surfaces over ``loop`` and ``sampler``: the
    exporter on ``metrics_port`` (0 picks a free one), NodeTPUInfo on
    ``grpc_bind:grpc_port`` and the debug server on loopback
    ``debug_port`` (each 0 = off).  A failed bind raises."""
    metrics = start_metrics_server(loop, backend, node, metrics_port,
                                   sampler=sampler, host=metrics_host)
    out = Serving(metrics=metrics)
    try:
        if debug_port:
            out.debug = DebugServer(port=debug_port)
            out.debug.start()
        if grpc_port:
            from ..monitor.noderpc import NodeTPUInfoServer

            out.rpc = NodeTPUInfoServer(loop, node, sampler=sampler)
            out.rpc_port = out.rpc.serve(grpc_port, grpc_bind)
    except BaseException:
        out.stop()
        raise
    return out


def tick(loop: FeedbackLoop, sampler: UsageSampler) -> None:
    """One monitor tick as a ``region-scan`` span: its latency histogram
    is exported by the node collector, and the spans show on /debug/tracez."""
    with trace.tracer().span("region-scan") as sp:
        loop.tick()
        sampler.sample()
        sp.set("containers", len(loop.containers))


def run(loop: FeedbackLoop, sampler: UsageSampler, interval: float,
        stop: threading.Event, on_tick=None) -> None:
    """Tick every ``interval`` seconds until ``stop`` is set: :func:`tick`
    (the feedback loop, then the sampler), then ``on_tick()`` if given.  A
    failed tick is logged and the next one runs."""
    while not stop.is_set():
        t0 = time.monotonic()
        try:
            tick(loop, sampler)
            if on_tick is not None:
                on_tick()
        except Exception:  # noqa: BLE001 — the daemon outlives a bad tick
            log.exception("feedback tick failed")
        stop.wait(max(0.1, interval - (time.monotonic() - t0)))


def main(argv=None, stop: Optional[threading.Event] = None) -> None:
    args = parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    trace.configure(service="vgpu-monitor")
    backend = None
    if not args.no_backend:
        try:
            from ..tpulib import detect

            backend = detect()
        except Exception:  # noqa: BLE001 — the regions alone still report
            log.exception("card backend unavailable; continuing without")
    loop = FeedbackLoop(args.container_root,
                        reader=RegionReader(args.library),
                        qos=qos_config(args))
    # Usage metering rides the same tick as the feedback loop; its
    # counters feed the exporter, the NodeTPUInfo usage reply and (through
    # the device plugin's register stream) the scheduler's ledger.
    sampler = UsageSampler(loop)
    node = args.node_name or os.uname().nodename
    try:
        serving = serve(loop, sampler, backend, node,
                        metrics_port=args.metrics_port,
                        grpc_port=args.grpc_port, grpc_bind=args.grpc_bind,
                        debug_port=args.debug_port)
    except BaseException:
        loop.close()
        raise
    log.info("vgpu-monitor up: root=%s interval=%.2fs metrics=:%d "
             "grpc=%s:%d debug=%d", args.container_root, args.interval,
             serving.metrics.port, args.grpc_bind, serving.rpc_port,
             serving.debug.port if serving.debug else 0)
    if threading.current_thread() is threading.main_thread():
        def terminate(signum, frame):
            raise KeyboardInterrupt

        signal.signal(signal.SIGTERM, terminate)
    try:
        run(loop, sampler, args.interval, stop or threading.Event())
    except KeyboardInterrupt:
        pass
    finally:
        serving.stop()
        loop.close()


if __name__ == "__main__":
    main()
