"""Node-level Prometheus metrics of the port's monitor (its copy of the
JAX package's ``monitor/metrics.py``).

Reference: cmd/vGPUmonitor/metrics.go:62–271, served on :9394: the host's
card capacity plus each container's ACTUAL use, read out of the shared
regions (the scheduler's :9395 reports *granted* amounts).  Family names,
help strings, types and labels are the JAX collector's, so dashboards
written for it read the port's text; the text is written by
``util/exposition.py``, not by ``prometheus_client``.  Standard library
only: the monitor never imports torch, grpc or protobuf.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Iterable, Optional

from ..shim.core import QOS_CLASSES as QOS_CLASS_NAMES
from ..tpulib.backend import Backend
from ..util import trace
from ..util.exposition import (
    CounterMetricFamily,
    GaugeMetricFamily,
    HistogramMetricFamily,
    MetricsServer,
)
from ..util.types import QOS_CLASSES
from .feedback import FeedbackLoop

log = logging.getLogger(__name__)


def _fold_hist(per_class: dict, cls: str, hist, wait_s: float) -> None:
    """Accumulate one (hist, wait_seconds) contribution into the
    class-keyed aggregation both exporters build."""
    counts, s = per_class.get(cls, ([], 0.0))
    if len(counts) < len(hist):
        counts = counts + [0] * (len(hist) - len(counts))
    for i, n in enumerate(hist):
        counts[i] += n
    per_class[cls] = (counts, s + wait_s)


def qos_wait_family(per_class) -> HistogramMetricFamily:
    """Build the per-class dispatch-wait histogram family from
    ``class name → (log2-us bucket counts, wait_seconds_sum)``.  Bucket k
    of the native histogram covers [2^(k-1), 2^k) us (bucket 0 = zero
    wait), so the Prometheus ``le`` bound of bucket k is 2^k / 1e6 s."""
    fam = HistogramMetricFamily(
        "vtpu_dispatch_wait_seconds",
        "Time one dispatch waited at the QoS admission gate, by class "
        "(from the shared regions' wait histograms; the critical-class "
        "p99 here is the signal the duty re-weighting loop closes on)",
        labels=["class"],
    )
    for cls in QOS_CLASSES:
        counts, wait_sum = per_class.get(cls, ([], 0.0))
        buckets = []
        cum = 0
        for k in range(max(len(counts), 1)):
            cum += counts[k] if k < len(counts) else 0
            if k == max(len(counts), 1) - 1:
                buckets.append(("+Inf", cum))  # saturating last bucket
            else:
                buckets.append((repr((1 << k) / 1e6), cum))
        fam.add_metric([cls], buckets, wait_sum)
    return fam


class NodeCollector:
    # Card capacities are static between hotplug events: the inventory is
    # cached for a TTL on the order of the health loop's own refresh, not
    # enumerated through NVML on every scrape.
    INVENTORY_TTL_S = 30.0

    def __init__(self, loop: FeedbackLoop, backend: Optional[Backend] = None,
                 node_name: str = "", now=time.monotonic,
                 sampler=None) -> None:
        from ..accounting.forecast import ForecastConfig, SeriesForecaster

        self.loop = loop
        self.backend = backend
        self.node_name = node_name
        self.sampler = sampler  # Optional[accounting.UsageSampler]
        self._now = now
        self._inv_cache: Optional[list] = None
        self._inv_at = float("-inf")
        # Node-local busy-card forecast: EWMA over THIS node's count of
        # launching cards, observed at scrape cadence.  Seasonality off — a single node's schedule is
        # dominated by its current tenants, not a daily cycle.  Own
        # lock: concurrent scrapes both reach observe(), whose
        # bucket-close path is a multi-step read-modify-write (same
        # discipline as the JAX planner's tracker).
        self._busy_forecast = SeriesForecaster(
            ForecastConfig(bucket_s=60.0, season_buckets=1,
                           alpha=0.3, beta=0.05))
        self._busy_forecast_lock = threading.Lock()
        self._busy_observed_at: Optional[float] = None

    def _chips(self) -> list:
        now = self._now()
        if (self._inv_cache is None
                or now - self._inv_at > self.INVENTORY_TTL_S):
            self._inv_cache = list(self.backend.inventory().chips)
            self._inv_at = now
        return self._inv_cache

    def collect(self) -> Iterable[GaugeMetricFamily]:
        host_mem = GaugeMetricFamily(
            "host_tpu_memory_total_mib", "Physical HBM per chip",
            labels=["node", "deviceuuid"],
        )
        if self.backend is not None:
            try:
                for chip in self._chips():
                    host_mem.add_metric([self.node_name, chip.uuid], chip.hbm_mib)
            except Exception:
                log.exception("host inventory scrape failed")

        c_usage = GaugeMetricFamily(
            "vtpu_device_memory_usage_bytes",
            "Actual HBM use of one container on one chip (from shared region)",
            labels=["container", "deviceuuid"],
        )
        c_limit = GaugeMetricFamily(
            "vtpu_device_memory_limit_bytes",
            "HBM cap of one container on one chip",
            labels=["container", "deviceuuid"],
        )
        c_sm = GaugeMetricFamily(
            "vtpu_device_core_limit_percent",
            "Compute cap of one container on one chip",
            labels=["container", "deviceuuid"],
        )
        c_switch = GaugeMetricFamily(
            "vtpu_utilization_switch",
            "1 when the priority throttle is engaged for this container",
            labels=["container"],
        )
        c_procs = GaugeMetricFamily(
            "vtpu_container_processes",
            "TPU processes registered in this container's region",
            labels=["container"],
        )
        c_oversub = GaugeMetricFamily(
            "vtpu_oversubscribe",
            "1 when this container's grant may exceed physical HBM "
            "(virtual device memory; spills to host RAM under pressure)",
            labels=["container"],
        )
        c_qos_weight = GaugeMetricFamily(
            "vtpu_qos_duty_weight",
            "Current duty-cycle weight of one QoS-classed container "
            "(percent of its core grant; 100 = neutral, shifted by the "
            "monitor's p99 feedback loop)",
            labels=["container", "class"],
        )
        c_qos_yield = GaugeMetricFamily(
            "vtpu_qos_yield",
            "1 when this best-effort container must not borrow idle "
            "duty (a co-resident latency-critical slot has queued work)",
            labels=["container"],
        )
        qos_by_class: dict = {}
        # Under the loop lock: rescan() munmaps regions, and reading a closed
        # handle from the scrape thread would crash the monitor.
        with self.loop.lock:
            for c in self.loop.containers.values():
                r = c.region
                for i in range(r.num_devices):
                    uuid = r.uuid(i) or str(i)
                    c_usage.add_metric([c.key, uuid], r.used(i))
                    c_limit.add_metric([c.key, uuid], r.limit(i))
                    c_sm.add_metric([c.key, uuid], r.sm_limit(i))
                c_switch.add_metric([c.key], r.utilization_switch)
                c_procs.add_metric([c.key], len(r.proc_pids()))
                c_oversub.add_metric([c.key], r.oversubscribe)
                # getattr: duck-typed regions (simulator fakes, pre-QoS
                # test stubs) need not carry the QoS plane.
                name = QOS_CLASS_NAMES.get(getattr(r, "qos_class", -1))
                if name is not None:
                    c_qos_weight.add_metric([c.key, name], r.qos_weight)
                    c_qos_yield.add_metric([c.key], r.qos_yield)

        # Per-class dispatch-wait histograms: prefer the sampler's
        # monotonic accumulation (restart-tolerant) over raw region
        # values, so the series keep Prometheus counter semantics across
        # in-place container restarts.
        if self.sampler is not None:
            # GC'd containers' folded-in totals first, so the per-class
            # sums never go backwards when the sampler prunes a key.
            retired = self.sampler.qos_retired()
            for cls, (hist, s) in retired.items():
                _fold_hist(qos_by_class, cls, hist, s)
            for row in self.sampler.snapshot():
                if not row.get("qos_class"):
                    continue
                _fold_hist(qos_by_class, row["qos_class"],
                           row["qos_wait_hist"],
                           row["qos_wait_seconds_total"])
        else:
            with self.loop.lock:
                for c in self.loop.containers.values():
                    r = c.region
                    name = QOS_CLASS_NAMES.get(
                        getattr(r, "qos_class", -1))
                    if name is None:
                        continue
                    _fold_hist(qos_by_class, name, r.qos_wait_hist(),
                               r.qos_wait_us_total() / 1e6)

        # Accounting counters (accounting/sampler.py): monotonic usage
        # integrals, the node-side face of the fleet-wide showback layer
        # (the scheduler exporter carries the per-pod/namespace join).
        families = [host_mem, c_usage, c_limit, c_sm, c_switch, c_procs,
                    c_oversub, c_qos_weight, c_qos_yield,
                    qos_wait_family(qos_by_class)]
        if self.sampler is not None:
            u_chip = CounterMetricFamily(
                "vtpu_usage_chip_seconds",
                "Chip-seconds actually consumed by one container "
                "(elapsed time x chips held, credited only while "
                "dispatching)",
                labels=["container"],
            )
            u_hbm = CounterMetricFamily(
                "vtpu_usage_hbm_byte_seconds",
                "HBM byte-seconds actually held by one container "
                "(occupancy integrated over time)",
                labels=["container"],
            )
            u_throttled = CounterMetricFamily(
                "vtpu_usage_throttled_seconds",
                "Seconds one container spent priority-throttled "
                "(utilization switch engaged)",
                labels=["container"],
            )
            u_spill = CounterMetricFamily(
                "vtpu_usage_oversub_spill_seconds",
                "Active seconds under an oversubscribed grant (the "
                "window in which host-RAM spills can occur)",
                labels=["container"],
            )
            for row in self.sampler.snapshot():
                key = [row["ctrkey"]]
                u_chip.add_metric(key, row["chip_seconds"])
                u_hbm.add_metric(key, row["hbm_byte_seconds"])
                u_throttled.add_metric(key, row["throttled_seconds"])
                u_spill.add_metric(key, row["oversub_spill_seconds"])
            families += [u_chip, u_hbm, u_throttled, u_spill]

        # Node-local capacity forecast: busy cards this node will want
        # next bucket.
        busy_fc = GaugeMetricFamily(
            "vtpu_capacity_node_busy_chips_forecast",
            "One-bucket-ahead forecast of this node's dispatching chip "
            "count (EWMA over the sampler's active-chip census; 0 until "
            "a bucket of observations has closed)",
            labels=["node"],
        )
        if self.sampler is not None:
            from ..accounting.forecast import SeriesForecaster as _SF

            busy = sum(int(row.get("chips", 0))
                       for row in self.sampler.snapshot()
                       if row.get("active"))
            now = self._now()
            with self._busy_forecast_lock:
                # Samples arrive at SCRAPE cadence: a scrape outage is
                # unobserved time, not zero demand — backfilling the
                # gap as empty buckets would teach the model a busy
                # node was idle.  Cold-restart the forecaster instead
                # (honest re-learning from the first fresh sample).
                cfg = self._busy_forecast.cfg
                if self._busy_observed_at is not None and \
                        now - self._busy_observed_at > 3 * cfg.bucket_s:
                    self._busy_forecast = _SF(cfg)
                self._busy_observed_at = now
                self._busy_forecast.observe(now, float(busy))
                pts = self._busy_forecast.forecast(1)
            busy_fc.add_metric([self.node_name], round(pts[0].mean, 4))
        else:
            busy_fc.add_metric([self.node_name], 0.0)
        families.append(busy_fc)

        phase_latency = HistogramMetricFamily(
            "vtpu_monitor_phase_latency_seconds",
            "Wall-clock latency of one monitor phase (region-scan "
            "tick), by QoS class where a phase is class-scoped",
            labels=["phase", "qos"],
        )
        for (phase, qos), (buckets, _count, sum_s) in \
                trace.tracer().histogram_snapshot().items():
            phase_latency.add_metric([phase, qos], buckets, sum_s)

        return families + [phase_latency]


def start_metrics_server(loop: FeedbackLoop, backend: Optional[Backend],
                         node_name: str, port: int = 9394, sampler=None,
                         host: str = "0.0.0.0") -> MetricsServer:
    """Serve ``/metrics`` with the node collector alone, started; the
    server's ``port`` is the bound one (port 0 picks a free one)."""
    collector = NodeCollector(loop, backend, node_name, sampler=sampler)
    return MetricsServer(collector.collect, host=host, port=port).start()
