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
``--no-queue-backfill`` and ``--no-reclaim``.
Boot order: list the pods and reconcile the grants before anything serves
(a restarted scheduler that filtered against an empty registry would book
cards twice), then the watch thread, the rescue thread, the admission
thread (with a quota config), the register service, the exporter and the
HTTP extender.  This module is the gRPC edge: the core imports neither grpc nor
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
    p.add_argument("--debug", action="store_true",
                   help="enable the /debug endpoints (stacks, wall-clock "
                        "profile, vars, tracez, events); unauthenticated — "
                        "keep off unless the port is restricted")
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
    p.add_argument("--resync-seconds", type=float, default=None,
                   help="full re-list period; default 300 with the watch, "
                        "30 without")
    p.add_argument("--no-watch", action="store_true",
                   help="no pod watch: the resync alone frees grants")
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
        enable_debug=args.debug,
        quota_queues=load_quota_config(args.quota_config),
        fair_share_usage_informed=args.fair_share_usage_informed,
        admission_interval_s=args.admission_interval,
        queue_reclaim_grace_s=args.queue_reclaim_grace,
        queue_fleet_headroom=args.queue_fleet_headroom,
        enable_queue_backfill=not args.no_queue_backfill,
        enable_reclaim=not args.no_reclaim)


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


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    trace.configure(service="vgpu-scheduler")
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
        scheduler.rescuer.stop()
        scheduler.admission.stop()
        http_server.stop()
        metrics_server.stop()
        grpc_server.stop(grace=2)


if __name__ == "__main__":
    main()
