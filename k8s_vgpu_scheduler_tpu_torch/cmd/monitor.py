"""Node monitor of the PyTorch/CUDA port (a sidecar of the device plugin's
DaemonSet).

    vgpu-monitor --container-root /tmp/vgpu/containers [--interval 2.0]
    python -m k8s_vgpu_scheduler_tpu_torch.cmd.monitor ...

The port's counterpart of the JAX package's ``cmd/monitor.py``
(reference: cmd/vGPUmonitor/main.go, the watchAndFeedback loop every 2 s
over the hostPath-mounted container cache dirs).  Each tick is
``loop.tick()`` (rescan, priority switch, QoS re-weighting, slot GC) then
``sampler.sample()`` (the usage counters).  The Prometheus exporter, the
node RPC and the debug endpoints are not ported.  Never imports torch.
"""

from __future__ import annotations

import argparse
import logging
import threading
import time
from typing import Optional

from ..accounting.sampler import UsageSampler
from ..monitor.feedback import FeedbackLoop, QosConfig
from ..monitor.reader import RegionReader

log = logging.getLogger("vgpu.monitor")


def parse_args(argv=None):
    p = argparse.ArgumentParser("vgpu-monitor")
    p.add_argument("--container-root", default="/tmp/vgpu/containers")
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


def run(loop: FeedbackLoop, sampler: UsageSampler, interval: float,
        stop: threading.Event, on_tick=None) -> None:
    """Tick every ``interval`` seconds until ``stop`` is set: the feedback
    loop, then the sampler, then ``on_tick()`` if given.  A failed tick is
    logged and the next one runs."""
    while not stop.is_set():
        t0 = time.monotonic()
        try:
            loop.tick()
            sampler.sample()
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
    loop = FeedbackLoop(args.container_root,
                        reader=RegionReader(args.library),
                        qos=qos_config(args))
    sampler = UsageSampler(loop)
    log.info("vgpu-monitor up: root=%s interval=%.2fs",
             args.container_root, args.interval)
    try:
        run(loop, sampler, args.interval, stop or threading.Event())
    except KeyboardInterrupt:
        pass
    finally:
        loop.close()


if __name__ == "__main__":
    main()
