"""Scheduler extender entrypoint of the port.

    vgpu-scheduler --http-bind 0.0.0.0:9443 --grpc-bind 0.0.0.0:9090 ...
    python -m k8s_vgpu_scheduler_tpu_torch.cmd.scheduler ...

The port's counterpart of the JAX package's ``cmd/scheduler.py`` with the
reference's flags (cmd/scheduler/main.go:50–100): the gRPC and HTTP binds,
the TLS cert and key, the scheduler name, the request defaults and the
resource names, plus the topology and node policies, priority preemption, the leases,
the card quarantine, the rescue sweep, the informer's knobs, and the
observability flags: ``--metrics-port`` (the cluster exporter,
``scheduler/metrics.py``), ``--score-by-actual``, ``--efficiency-window``
and ``--idle-grant-grace`` (the usage ledger's join), ``--debug`` (the
extender's ``/debug`` endpoints) and the capacity queues:
``--quota-config`` (JSON; YAML where PyYAML is installed),
``--fair-share-usage-informed``, ``--admission-interval``,
``--queue-reclaim-grace``, ``--queue-fleet-headroom``,
``--no-queue-backfill`` and ``--no-reclaim``; and the defragmenter:
``--enable-defrag``, ``--defrag-interval``, ``--defrag-checkpoint-grace``,
``--defrag-reservation-ttl`` and ``--defrag-max-victims``; and elastic
mesh resizing: ``--enable-elastic``, ``--elastic-interval``,
``--resize-hysteresis``, ``--resize-checkpoint-grace`` and
``--elastic-downgrade-after``; and active replicas (``shard/``):
``--shard-replica``, ``--shard-ttl``, ``--shard-grace-beats``,
``--shard-tick``, ``--shard-stale-ttl``, ``--shard-adoption-grace`` and
``--shard-coord-object``; and the capacity forecast:
``--capacity-interval``, ``--capacity-bucket``,
``--capacity-season-buckets``, ``--capacity-horizon`` and
``--capacity-starve-after``; and the optimistic Filter and the
performance observatory: ``--filter-workers``, ``--serial-filter``,
``--commit-retries``, ``--no-perf`` and ``--perf-tracemalloc``; and the
batched cycles and their solve workers: ``--filter-batch``,
``--batch-tick-ms``, ``--batch-max``, ``--batch-solver`` and
``--solve-workers``; and the process's settings: ``--gil-switch-interval``
and ``--gc-threshold0`` (``apply_process_settings``) and
``--trace-capacity``.
Boot order: list the pods and reconcile the grants before anything serves
(a restarted scheduler that filtered against an empty registry would book
cards twice), then the watch thread, the rescue thread, the admission
thread (with a quota config), the defrag thread (with
``--enable-defrag``), the resize thread (with ``--enable-elastic``), the
capacity-observe thread (unless ``--capacity-interval 0``), with
``--shard-replica`` a first coordination tick (the replica joins the shard
map before it serves a Filter) and the coordination thread, the
register service, the exporter and the HTTP extender.  This module is the gRPC edge: the core imports neither grpc nor
protobuf.
"""

from __future__ import annotations

import argparse
import logging
import signal
import threading
from concurrent import futures

from ..k8s import FakeKube, make_client
from ..k8s.client import KubeClient, NotFound
from ..scheduler.core import Scheduler, run_watch_loop
from ..scheduler.metrics import start_metrics_server
from ..scheduler.routes import ExtenderServer
from ..util import trace
from ..util.config import Config, ResourceNames
from ..util.types import TOPOLOGY_POLICIES

log = logging.getLogger(__name__)


def parse_args(argv=None):
    p = argparse.ArgumentParser("vgpu-scheduler")
    p.add_argument("--grpc-bind", default="0.0.0.0:9090",
                   help="the register stream's address (host:port, or "
                        "unix:<path>)")
    p.add_argument("--http-bind", default="0.0.0.0:9443")
    p.add_argument("--metrics-port", type=int, default=9395,
                   help="the cluster exporter's /metrics port")
    p.add_argument("--cert-file", default="")
    p.add_argument("--key-file", default="")
    p.add_argument("--scheduler-name", default="vgpu-scheduler")
    p.add_argument("--default-mem", type=int, default=0,
                   help="MiB a container that asks for cards but no memory "
                        "gets; 0 = the whole card")
    p.add_argument("--default-cores", type=int, default=0)
    p.add_argument("--resource-name", default="nvidia.com/gpu")
    p.add_argument("--resource-mem", default="nvidia.com/gpumem")
    p.add_argument("--resource-mem-percentage",
                   default="nvidia.com/gpumem-percentage")
    p.add_argument("--resource-cores", default="nvidia.com/gpucores")
    p.add_argument("--resource-priority", default="nvidia.com/priority")
    p.add_argument("--topology-policy", default="best-effort",
                   choices=TOPOLOGY_POLICIES,
                   help="the topology policy of a multi-card request whose "
                        "pod names none (vtpu.dev/topology-policy)")
    p.add_argument("--node-scheduler-policy", default="spread",
                   choices=("spread", "binpack"),
                   help="among fitting nodes: spread = the most free "
                        "capacity wins; binpack = the fullest wins")
    p.add_argument("--filter-workers", type=int, default=0,
                   help="candidate-evaluation worker pool size; 0 = auto "
                        "(min(8, cpu count)), 1 = evaluate in the calling "
                        "thread")
    p.add_argument("--serial-filter", action="store_true",
                   help="disable the optimistic snapshot/commit Filter and "
                        "decide serially under one lock (A/B baseline and "
                        "operational escape hatch)")
    p.add_argument("--commit-retries", type=int, default=4,
                   help="optimistic commits that lose their revision race "
                        "re-evaluate at most this many times before one "
                        "fully-locked decision")
    p.add_argument("--filter-batch", action="store_true",
                   help="batched scheduling cycles: concurrent Filters "
                        "collapse into one snapshot + vectorized "
                        "pods×cards evaluation + per-node group commit")
    p.add_argument("--batch-tick-ms", type=float, default=2.0,
                   help="how long the first Filter into an idle batch "
                        "gate waits for concurrent Filters to join its "
                        "cycle; 0 = no wait")
    p.add_argument("--batch-max", type=int, default=256,
                   help="pods per batch cycle cap (bounds per-cycle "
                        "latency; a deeper backlog drains over "
                        "successive cycles)")
    p.add_argument("--batch-solver", default="regret",
                   choices=("regret", "fifo"),
                   help="joint-placement solver: regret = greedy-with-"
                        "regret over the score matrix (a pod with one "
                        "feasible node is served before a flexible pod "
                        "takes it); fifo = sequential argmax in fair-"
                        "share order (serial-path decision parity)")
    p.add_argument("--solve-workers", type=int, default=0,
                   help="solve worker processes that map the columnar "
                        "fleet's shared-memory segments read-only and "
                        "run the vectorized class evaluations in true "
                        "parallel; 0 = evaluate in-process (default — "
                        "decisions are bit-identical either way)")
    p.add_argument("--gil-switch-interval", type=float, default=0.05,
                   help="sys.setswitchinterval for this process (seconds); "
                        "concurrent Filters are short CPU-bound bursts and "
                        "the CPython default of 5 ms makes 8 submitter "
                        "threads convoy on GIL handoffs — 50 ms lets each "
                        "decision run to its next I/O point uninterrupted. "
                        "0 = leave the interpreter default")
    p.add_argument("--enable-preemption", action="store_true",
                   help="let a pod that fits nowhere ask strictly lower-"
                        "priority pods to checkpoint and leave (the "
                        "vtpu.dev/preempt-requested annotation)")
    p.add_argument("--lease-ttl", type=float, default=15.0,
                   help="seconds without a register-stream message before "
                        "a node takes no new placement")
    p.add_argument("--lease-grace-beats", type=int, default=2,
                   help="further lease-ttl periods before the node is dead "
                        "and its pods are rescued")
    p.add_argument("--quarantine-flap-threshold", type=int, default=3,
                   help="card health flips inside the flap window that "
                        "quarantine the card out of the schedulable set")
    p.add_argument("--quarantine-flap-window", type=float, default=60.0,
                   help="seconds of the flap-damping window")
    p.add_argument("--quarantine-probation", type=float, default=30.0,
                   help="seconds a quarantined card must stay healthy "
                        "before it is placed on again")
    p.add_argument("--rescue-interval", type=float, default=5.0,
                   help="period of the background rescue sweep")
    p.add_argument("--rescue-checkpoint-grace", type=float, default=120.0,
                   help="seconds a victim on a quarantined card, asked to "
                        "checkpoint, gets to exit before its grant is "
                        "rescinded anyway")
    p.add_argument("--lease-retention", type=float, default=900.0,
                   help="seconds a Dead lease is kept once nothing remains "
                        "to rescue on its node")
    p.add_argument("--no-rescue", action="store_true",
                   help="no background rescue sweep (the leases and the "
                        "quarantine still gate Filter; grants on dead "
                        "nodes stay until an operator acts)")
    p.add_argument("--score-by-actual", action="store_true",
                   help="bias candidate selection toward nodes whose "
                        "MEASURED utilization (ledger usage reports) is "
                        "low — packs against actual, not just granted, "
                        "capacity; requires node monitors reporting usage")
    p.add_argument("--efficiency-window", type=float, default=300.0,
                   help="trailing window (seconds) for the granted-vs-"
                        "actual efficiency join (vtpu_grant_efficiency_"
                        "ratio, /usagez default window)")
    p.add_argument("--idle-grant-grace", type=float, default=600.0,
                   help="seconds a grant must accrue ~no GPU-seconds "
                        "before it is surfaced as an idle grant "
                        "(vtpu_idle_grants; flagged, never evicted)")
    # Predictive capacity (accounting/forecast.py + planner.py).
    p.add_argument("--capacity-interval", type=float, default=30.0,
                   help="demand-sampling period (seconds) for the "
                        "capacity forecaster behind GET /capacityz and "
                        "the vtpu_capacity_* gauges; 0 disables the "
                        "sampling thread (the endpoint still samples "
                        "on each export)")
    p.add_argument("--capacity-bucket", type=float, default=60.0,
                   help="forecast bucket size in seconds (demand is "
                        "aggregated and predicted per bucket)")
    p.add_argument("--capacity-season-buckets", type=int, default=24,
                   help="buckets per seasonal cycle of the demand "
                        "forecaster (1 = no seasonality; 24 x 3600s "
                        "buckets = diurnal)")
    p.add_argument("--capacity-horizon", type=float, default=1800.0,
                   help="default forecast horizon (seconds) for "
                        "/capacityz (?horizon= overrides per request)")
    p.add_argument("--capacity-starve-after", type=float, default=300.0,
                   help="a queue counts as starving once a pod has "
                        "waited this long unplaced — the ETA the "
                        "starvation forecast predicts toward")
    p.add_argument("--no-perf", action="store_true",
                   help="disable the control-plane performance "
                        "observatory (phase rings, lock wait/hold "
                        "telemetry, /perfz quantiles; the instrumented "
                        "overhead budget is <=2%% on bench_batch_cycle "
                        "— this is the escape hatch and the overhead "
                        "A/B's baseline)")
    p.add_argument("--perf-tracemalloc", action="store_true",
                   help="opt-in tracemalloc allocation tracking: "
                        "/perfz then carries the top allocation sites "
                        "(costs memory + CPU on every allocation — a "
                        "diagnosis tool, not an always-on default)")
    p.add_argument("--debug", action="store_true",
                   help="enable the /debug endpoints (stacks, wall-clock "
                        "profile, vars, tracez, events); unauthenticated — "
                        "keep off unless the port is restricted")
    p.add_argument("--trace-capacity", type=int, default=2048,
                   help="spans kept in the in-memory /debug/tracez ring "
                        "(the pod-lifecycle event journal keeps 2x this)")
    p.add_argument("--quota-config", default="",
                   help="path to the capacity-queue config ({'queues': "
                        "[{'name', 'namespaces', 'cohort', 'weight', "
                        "'quota': {'chips', 'hbm_mib'}, "
                        "'borrow_limit_chips', ...}]}), JSON or YAML; "
                        "empty = the admission layer is off and every "
                        "namespace bypasses it")
    p.add_argument("--fair-share-usage-informed", action="store_true",
                   help="fold measured grant efficiency (the usage ledger) "
                        "into fair-share weights: chronically idle "
                        "tenants are demoted toward a floor")
    p.add_argument("--admission-interval", type=float, default=2.0,
                   help="capacity-queue admission loop period (seconds)")
    p.add_argument("--queue-reclaim-grace", type=float, default=15.0,
                   help="seconds a released pod may sit unplaced before "
                        "its under-nominal queue reclaims borrowed grants "
                        "(also the per-queue floor between reclaims)")
    p.add_argument("--queue-fleet-headroom", type=float, default=1.0,
                   help="release-throttle multiplier over registered "
                        "cards; raise above 1.0 on fleets whose split-"
                        "count sharing packs many grants on a card")
    p.add_argument("--no-queue-backfill", action="store_true",
                   help="disable gang-aware backfill (small pods "
                        "admitted ahead of an accumulating gang)")
    p.add_argument("--no-reclaim", action="store_true",
                   help="never reclaim borrowed grants for starved "
                        "in-quota tenants (fair-share ordering and "
                        "borrowing stay on)")
    p.add_argument("--enable-defrag", action="store_true",
                   help="background fleet defragmentation: compact "
                        "fragmented nodes by checkpoint-migrating "
                        "movable pods so blocked large slice/mesh "
                        "demands can admit")
    p.add_argument("--defrag-interval", type=float, default=10.0,
                   help="defrag loop period, seconds")
    p.add_argument("--defrag-checkpoint-grace", type=float, default=120.0,
                   help="seconds an asked migration victim gets to "
                        "checkpoint and exit before the plan aborts")
    p.add_argument("--defrag-reservation-ttl", type=float, default=300.0,
                   help="seconds an assembled (reserved) slice waits "
                        "for its beneficiary before returning to the pool")
    p.add_argument("--defrag-max-victims", type=int, default=8,
                   help="largest victim set a compaction plan may ask")
    p.add_argument("--enable-elastic", action="store_true",
                   help="elastic mesh resizing: gangs declaring a "
                        "vtpu.dev/mesh-min..mesh-max range shrink one "
                        "rung (checkpoint-restart) instead of dying "
                        "under reclaim/defrag pressure and grow back "
                        "when capacity frees")
    p.add_argument("--elastic-interval", type=float, default=10.0,
                   help="resize controller loop period, seconds")
    p.add_argument("--resize-hysteresis", type=float, default=300.0,
                   help="seconds after any resize before the same gang "
                        "may grow again (thrash guard)")
    p.add_argument("--resize-checkpoint-grace", type=float, default=120.0,
                   help="seconds resize victims get to checkpoint and "
                        "exit before the resize aborts and rolls back")
    p.add_argument("--elastic-downgrade-after", type=float, default=30.0,
                   help="seconds a pending elastic gang must sit "
                        "Filter-rejected before admission retries it "
                        "one rung down")
    p.add_argument("--shard-replica", default="",
                   help="this replica's name among active extender "
                        "replicas (the chart passes the pod name); "
                        "empty: the shard layer is inert and this is a "
                        "single-replica extender")
    p.add_argument("--shard-ttl", type=float, default=15.0,
                   help="seconds without a coordination beat before a "
                        "peer replica is suspect (keeps its nodes)")
    p.add_argument("--shard-grace-beats", type=int, default=2,
                   help="more shard-ttl periods a suspect replica gets "
                        "before it is dead and the survivors adopt its "
                        "nodes (an epoch bump)")
    p.add_argument("--shard-tick", type=float, default=3.0,
                   help="coordination tick period: the beat, the shard "
                        "map's read and the adoptions' progress")
    p.add_argument("--shard-stale-ttl", type=float, default=10.0,
                   help="a decision commit whose shard map was read more "
                        "than this long ago fails closed")
    p.add_argument("--shard-adoption-grace", type=float, default=12.0,
                   help="seconds an adopted node stays unplaceable after "
                        "an epoch bump while the previous owner's "
                        "commits in flight drain into the staleness "
                        "fence; at least --shard-stale-ttl")
    p.add_argument("--shard-coord-object",
                   default="vtpu-shard-coordination",
                   help="the coordination Node the shard map is "
                        "compare-and-swapped on (one a replica set)")
    p.add_argument("--resync-seconds", type=float, default=None,
                   help="full re-list period; default 300 with the watch, "
                        "30 without")
    p.add_argument("--no-watch", action="store_true",
                   help="no pod watch: the resync alone frees grants")
    p.add_argument("--gc-threshold0", type=int, default=0,
                   help="raise Python's gen-0 GC threshold for this "
                        "long-running process (0 = interpreter default "
                        "700).  At fleet scale the default walks a "
                        "large, mostly-immortal heap thousands of "
                        "times per minute; the gc-pause phase on "
                        "GET /perfz shows what your fleet pays")
    p.add_argument("--fake-kube", action="store_true",
                   help="an in-memory apiserver (a dry run)")
    p.add_argument("--kube-url", default="",
                   help="apiserver base URL; empty = in-cluster")
    p.add_argument("-v", "--verbose", action="count", default=0)
    return p.parse_args(argv)


def build_config(args) -> Config:
    return Config(
        resources=ResourceNames(
            count=args.resource_name, memory=args.resource_mem,
            memory_percentage=args.resource_mem_percentage,
            cores=args.resource_cores, priority=args.resource_priority),
        scheduler_name=args.scheduler_name, default_mem=args.default_mem,
        default_cores=args.default_cores,
        topology_policy=args.topology_policy,
        node_scheduler_policy=args.node_scheduler_policy,
        optimistic_commit=not args.serial_filter,
        filter_workers=args.filter_workers,
        commit_retries=args.commit_retries,
        filter_batch=args.filter_batch,
        batch_tick_ms=args.batch_tick_ms,
        batch_max=args.batch_max,
        batch_solver=args.batch_solver,
        solve_workers=args.solve_workers,
        enable_preemption=args.enable_preemption,
        lease_ttl_s=args.lease_ttl, lease_grace_beats=args.lease_grace_beats,
        quarantine_flap_threshold=args.quarantine_flap_threshold,
        quarantine_flap_window_s=args.quarantine_flap_window,
        quarantine_probation_s=args.quarantine_probation,
        rescue_interval_s=args.rescue_interval,
        rescue_checkpoint_grace_s=args.rescue_checkpoint_grace,
        lease_retention_s=args.lease_retention,
        enable_rescue=not args.no_rescue,
        score_by_actual=args.score_by_actual,
        efficiency_window_s=args.efficiency_window,
        idle_grant_grace_s=args.idle_grant_grace,
        capacity_interval_s=args.capacity_interval,
        capacity_bucket_s=args.capacity_bucket,
        capacity_season_buckets=args.capacity_season_buckets,
        capacity_horizon_s=args.capacity_horizon,
        capacity_starve_after_s=args.capacity_starve_after,
        enable_debug=args.debug,
        perf_enabled=not args.no_perf,
        perf_tracemalloc=args.perf_tracemalloc,
        quota_queues=load_quota_config(args.quota_config),
        fair_share_usage_informed=args.fair_share_usage_informed,
        admission_interval_s=args.admission_interval,
        queue_reclaim_grace_s=args.queue_reclaim_grace,
        queue_fleet_headroom=args.queue_fleet_headroom,
        enable_queue_backfill=not args.no_queue_backfill,
        enable_reclaim=not args.no_reclaim,
        enable_defrag=args.enable_defrag,
        defrag_interval_s=args.defrag_interval,
        defrag_checkpoint_grace_s=args.defrag_checkpoint_grace,
        defrag_reservation_ttl_s=args.defrag_reservation_ttl,
        defrag_max_victims=args.defrag_max_victims,
        enable_elastic=args.enable_elastic,
        elastic_interval_s=args.elastic_interval,
        resize_hysteresis_s=args.resize_hysteresis,
        resize_checkpoint_grace_s=args.resize_checkpoint_grace,
        elastic_downgrade_after_s=args.elastic_downgrade_after,
        shard_replica=args.shard_replica,
        shard_ttl_s=args.shard_ttl,
        shard_grace_beats=args.shard_grace_beats,
        shard_tick_s=args.shard_tick,
        shard_stale_ttl_s=args.shard_stale_ttl,
        shard_adoption_grace_s=args.shard_adoption_grace,
        shard_coord_object=args.shard_coord_object)


def load_quota_config(path: str) -> tuple:
    """The --quota-config file -> ``Config.quota_queues``.  JSON first;
    YAML (the chart renders ``quota.yaml``) only where PyYAML is
    installed, else an error that names the file.  Checked at boot
    (``parse_quota_config`` raises on a duplicate queue or a namespace two
    queues govern): a bad quota must not come up half-governing."""
    if not path:
        return ()
    import json

    from ..quota.queues import parse_quota_config

    with open(path) as f:
        text = f.read()
    try:
        doc = json.loads(text) if text.strip() else None
    except json.JSONDecodeError:
        try:
            import yaml
        except ImportError:
            raise ValueError(
                f"--quota-config {path}: not JSON, and PyYAML is not "
                "installed to read it as YAML") from None
        doc = yaml.safe_load(text)
    if doc is None:
        return ()  # an empty or comments-only file: quota off
    if not isinstance(doc, dict):
        raise ValueError(
            f"--quota-config {path}: expected a mapping with a "
            f"'queues' list, got {type(doc).__name__}")
    parse_quota_config(doc)  # raise early on a bad config
    return tuple(doc.get("queues", ()))


def resolve_watch_and_resync(no_watch: bool, client, resync_seconds):
    """(watch on, resync period): the watch runs unless disabled or the
    client cannot watch; the resync is then the safety net (300 s), else
    the only delete path (30 s)."""
    watch = (not no_watch and type(client).watch_pods_events
             is not KubeClient.watch_pods_events)
    if resync_seconds is None:
        resync_seconds = 300.0 if watch else 30.0
    return watch, resync_seconds


class DryRunKube(FakeKube):
    """A FakeKube for ``--fake-kube`` dry runs: a pod POSTed to /filter
    that was never created is created by its decision write, and a node
    a device plugin registers exists for Bind's lock."""

    def patch_pod_annotations(self, namespace, name, annotations,
                              resource_version=None):
        try:
            return super().patch_pod_annotations(
                namespace, name, annotations,
                resource_version=resource_version)
        except NotFound:
            self.create_pod({
                "metadata": {"name": name, "namespace": namespace,
                             "uid": f"dryrun-{namespace}-{name}",
                             "annotations": {}},
                "spec": {"containers": []}})
            return super().patch_pod_annotations(namespace, name,
                                                 annotations)

    def get_node(self, name):
        try:
            return super().get_node(name)
        except NotFound:
            self.add_node({"metadata": {"name": name, "annotations": {}}})
            return super().get_node(name)


def start_register_service(scheduler: Scheduler, bind: str,
                           workers: int = 16):
    """The gRPC register service (DeviceService.Register) on ``bind``,
    started; returns the server."""
    import grpc

    from ..api import device_register_pb2 as pb
    from ..api.service import add_device_service

    server = grpc.server(futures.ThreadPoolExecutor(max_workers=workers))

    def register(request_iterator, context):
        node = scheduler.handle_register_stream(request_iterator, context)
        return pb.RegisterReply(message=f"bye {node}")

    add_device_service(server, register)
    if server.add_insecure_port(bind) == 0:
        raise OSError(f"cannot bind the register service to {bind}")
    server.start()
    return server


def capacity_loop(scheduler: Scheduler, stop: threading.Event) -> None:
    """Sample each queue's demand every ``capacity_interval_s`` until
    ``stop``; a failed sample is logged, and the loop goes on."""
    while not stop.wait(scheduler.cfg.capacity_interval_s):
        try:
            scheduler.observe_capacity()
        except Exception:  # noqa: BLE001 — sampling never dies
            log.exception("capacity demand sample failed")


def apply_process_settings(gil_switch_interval: float,
                           gc_threshold0: int) -> None:
    """The interpreter settings a scheduler process runs under, as the
    JAX entry point sets them: the GIL switch interval (concurrent Filters
    are short CPU-bound bursts, and at CPython's 5 ms default eight
    submitters convoy on GIL hand-offs, below one thread's rate) and
    Python's gen-0 collection threshold.  0 leaves either as the
    interpreter has it."""
    if gil_switch_interval > 0:
        import sys
        sys.setswitchinterval(gil_switch_interval)
    if gc_threshold0 > 0:
        import gc
        gc.set_threshold(gc_threshold0)


def main(argv=None):
    args = parse_args(argv)
    apply_process_settings(args.gil_switch_interval, args.gc_threshold0)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    trace.configure(service="vgpu-scheduler",
                    capacity=args.trace_capacity,
                    event_capacity=2 * args.trace_capacity)
    client = DryRunKube() if args.fake_kube else \
        make_client(kube_url=args.kube_url)
    scheduler = Scheduler(client, build_config(args))
    # Before anything serves: the grants of the running pods.
    initial_rv = scheduler.resync_from_apiserver()
    watch, resync_s = resolve_watch_and_resync(args.no_watch, client,
                                               args.resync_seconds)
    stop = threading.Event()
    if watch:
        threading.Thread(target=run_watch_loop, args=(scheduler, stop),
                         kwargs={"initial_rv": initial_rv},
                         name="pod-watch", daemon=True).start()
    if scheduler.cfg.enable_rescue:
        scheduler.rescuer.start()
    # After the boot reconcile, so held and admitted pods are known; a
    # no-op without a quota config.
    scheduler.admission.start()
    # The compaction loop, when asked for (embedders and tests call
    # defrag.tick() themselves).
    if scheduler.cfg.enable_defrag:
        scheduler.defrag.start()
    # The grow and downgrade loop, when asked for (shrinks are started by
    # reclaim and defrag themselves).
    if scheduler.cfg.enable_elastic:
        scheduler.elastic.start()
    # Periodic demand samples into the capacity forecaster (/capacityz
    # also samples on each export, so the thread only densifies the
    # series).
    if scheduler.cfg.capacity_interval_s > 0:
        threading.Thread(target=capacity_loop, args=(scheduler, stop),
                         name="capacity-observe", daemon=True).start()
    # Active replicas: join the shard map before anything serves (an
    # unfenced replica answering /filter could place on nodes it does not
    # own), then coordinate on the thread.  Inert without --shard-replica.
    if scheduler.cfg.shard_replica:
        scheduler.shards.tick()
        scheduler.shards.start(scheduler.cfg.shard_tick_s)
    grpc_server = start_register_service(scheduler, args.grpc_bind)
    metrics_server = start_metrics_server(scheduler, args.metrics_port)
    host, _, port = args.http_bind.rpartition(":")
    http_server = ExtenderServer(
        scheduler, scheduler.cfg, host=host or "0.0.0.0", port=int(port),
        certfile=args.cert_file or None, keyfile=args.key_file or None)
    http_server.start()
    log.info("vgpu-scheduler up: grpc=%s http=%s:%d metrics=:%d",
             args.grpc_bind, host or "0.0.0.0", http_server.port,
             metrics_server.port)

    def terminate(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, terminate)
    try:
        while not stop.wait(resync_s):
            try:
                scheduler.resync_from_apiserver()
            except Exception:  # noqa: BLE001 — a passing apiserver loss
                log.exception("resync failed")
    except KeyboardInterrupt:
        pass
    finally:
        stop.set()
        scheduler.shards.stop()
        # Drains the solve workers and unlinks their shared-memory
        # segments (a no-op with --solve-workers 0).
        scheduler.close()
        http_server.stop()
        metrics_server.stop()
        grpc_server.stop(grace=2)


if __name__ == "__main__":
    main()
