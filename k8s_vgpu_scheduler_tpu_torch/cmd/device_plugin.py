"""GPU device-plugin entrypoint of the port (a DaemonSet, one per node).

    vgpu-device-plugin --node-name <node> [--mode mem-share] \
        [--topology-policy best-effort] \
        [--shim-dir /usr/local/vgpu --install-shim]
    python -m k8s_vgpu_scheduler_tpu_torch.cmd.device_plugin ...

The port's counterpart of the JAX package's ``cmd/device_plugin.py``
(reference: cmd/device-plugin/nvidia/main.go:56–241 — per-node config
override from /config/config.json, kubelet socket watch for restart,
plugin + registration wiring).  The cards come from NVML (``detect()``:
the mock under ``$VTPU_MOCK_JSON``, else NVML, else it raises); the node
agent never imports torch.  ``--install-shim`` first builds the interposer
and installs it with its ``ld.so.preload`` and the shim's startup hook
(``sitecustomize.py``) into ``--shim-dir``, the directory Allocate mounts
into every container and puts on the ``PYTHONPATH`` of an oversubscribed
one.  ``--topology-policy`` is the policy of kubelet's preferred
allocation; under ``restricted`` or ``guaranteed`` the node carries
``vtpu.dev/ici-unsatisfiable-sizes`` (the card counts no free slice
holds), published at start and after each health change.  The partition
strategies (MIG), the usage counters and the debug endpoints wait for
their own slices.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import time

from ..deviceplugin import (DeviceCache, DeviceRegister, GpuDevicePlugin,
                            publish_unsatisfiable)
from ..deviceplugin.plugin import CrashLoopBreaker
from ..k8s import make_client
from ..tpulib import detect
from ..util.config import Config
from ..util.types import TOPOLOGY_POLICIES

log = logging.getLogger(__name__)


def parse_args(argv=None):
    p = argparse.ArgumentParser("vgpu-device-plugin")
    p.add_argument("--node-name", default=os.environ.get("NODE_NAME", ""))
    p.add_argument("--scheduler-endpoint",
                   default=os.environ.get("SCHEDULER_ENDPOINT", "127.0.0.1:9090"))
    p.add_argument("--device-split-count", type=int, default=10)
    p.add_argument("--device-memory-scaling", type=float, default=1.0)
    p.add_argument("--device-cores-scaling", type=float, default=1.0)
    p.add_argument("--disable-core-limit", action="store_true")
    p.add_argument("--topology-policy", default="best-effort",
                   choices=TOPOLOGY_POLICIES,
                   help="policy of kubelet's preferred allocation: "
                        "guaranteed = one contiguous slice or nothing, "
                        "restricted = contiguous where a slice of the count "
                        "exists, best-effort = contiguous where it can")
    p.add_argument("--mode", default="mem-share",
                   choices=["default", "mem-share", "env-share"],
                   help="sharing mode (reference MLU modes): mem-share = "
                        "fractional memory caps, env-share = time-slice with "
                        "no caps, default = exclusive whole cards")
    p.add_argument("--health-poll-seconds", type=float, default=5.0,
                   help="NVML health poll period")
    p.add_argument("--heartbeat-seconds", type=float, default=5.0,
                   help="max quiet time before the full inventory is "
                        "re-advertised down the register stream anyway — "
                        "the scheduler's lease beat; 0 disables heartbeats")
    p.add_argument("--socket-dir", default="/var/lib/kubelet/device-plugins")
    p.add_argument("--config-file", default="/config/config.json")
    p.add_argument("--shim-dir", default="/usr/local/vgpu")
    p.add_argument("--install-shim", action="store_true",
                   help="build the interposer and install it, its "
                        "ld.so.preload and the startup hook into --shim-dir "
                        "before serving")
    p.add_argument("--cache-dir", default="/tmp/vgpu/containers")
    p.add_argument("--fake-kube", action="store_true")
    p.add_argument("--kube-url", default="",
                   help="apiserver base URL (e.g. the apisim); empty = in-cluster")
    p.add_argument("-v", "--verbose", action="count", default=0)
    return p.parse_args(argv)


def apply_node_config_overrides(cfg: Config, config_file: str) -> Config:
    """Per-node ConfigMap overrides keyed by node name
    (cmd/device-plugin/nvidia/main.go:87–110)."""
    try:
        with open(config_file) as f:
            data = json.load(f)
    except (OSError, json.JSONDecodeError):
        return cfg
    for entry in data.get("nodeconfig", []):
        if entry.get("name") != cfg.node_name:
            continue
        updates = {}
        if "devicememoryscaling" in entry:
            updates["device_memory_scaling"] = float(entry["devicememoryscaling"])
        if "devicesplitcount" in entry:
            updates["device_split_count"] = int(entry["devicesplitcount"])
        if "devicecorescaling" in entry:
            updates["device_cores_scaling"] = float(entry["devicecorescaling"])
        if updates:
            log.info("node config override for %s: %s", cfg.node_name, updates)
            cfg = dataclasses.replace(cfg, **updates)
    return cfg


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    cfg = Config(
        node_name=args.node_name or os.uname().nodename,
        scheduler_endpoint=args.scheduler_endpoint,
        device_split_count=args.device_split_count,
        device_memory_scaling=args.device_memory_scaling,
        device_cores_scaling=args.device_cores_scaling,
        disable_core_limit=args.disable_core_limit,
        topology_policy=args.topology_policy,
        sharing_mode=args.mode,
        shim_host_dir=args.shim_dir,
        cache_host_dir=args.cache_dir,
    )
    cfg = apply_node_config_overrides(cfg, args.config_file)

    backend = detect()
    if args.install_shim:
        from ..ops import _kernels

        log.info("installed %s", _kernels.install_shim(cfg.shim_host_dir))
    client = make_client(fake=args.fake_kube, kube_url=args.kube_url)
    cache = DeviceCache(backend, poll_seconds=args.health_poll_seconds,
                        heartbeat_seconds=args.heartbeat_seconds)
    plugin = GpuDevicePlugin(client, cache.inventory, cfg,
                             socket_dir=args.socket_dir)
    register = DeviceRegister(backend, cfg)

    def on_health_change(inv):
        plugin.notify_health_changed()
        # A health change alters which slice sizes stay placeable
        # (reference server.go:493–522).
        publish_unsatisfiable(client, cfg.node_name, inv, cfg.topology_policy)

    cache.subscribe("plugin", on_health_change)
    # The register stream is the lease-heartbeat channel: it alone
    # receives the periodic unchanged-inventory keepalives.
    cache.subscribe("register", register.push_update, heartbeat=True)
    publish_unsatisfiable(client, cfg.node_name, cache.inventory,
                          cfg.topology_policy)
    cache.start()
    register.start()
    plugin.serve()

    kubelet_sock = os.path.join(args.socket_dir, "kubelet.sock")

    def try_register():
        try:
            plugin.register_with_kubelet(kubelet_sock)
            return True
        except Exception as e:  # noqa: BLE001
            log.warning("kubelet registration failed: %s", e)
            return False

    registered = try_register()
    # Kubelet restart detection: watch the socket inode; on recreation,
    # re-register (reference uses fsnotify, main.go:213–217).  Seed with the
    # current inode so the first tick doesn't spuriously re-register.
    try:
        last_ino = os.stat(kubelet_sock).st_ino
    except OSError:
        last_ino = None
    # Serve supervision: a died/wedged gRPC server is restarted, but a
    # flapping one trips the breaker (reference plugin.go:200–217).
    breaker = CrashLoopBreaker()

    def ensure_serving(count_crash: bool) -> bool:
        """Restart a dead plugin server; True if it was restarted.
        ``count_crash`` is False when the kubelet just restarted (it wipes
        the whole plugin dir — an external event, not a server crash)."""
        if plugin.serving():
            return False
        if count_crash:
            breaker.record(f"device-plugin server ({plugin.resource_name})")
        log.warning("server for %s down; restarting", plugin.resource_name)
        try:
            plugin.serve()
            return True
        except Exception:  # noqa: BLE001 — retried next tick
            log.exception("restart failed for %s", plugin.resource_name)
            return False

    try:
        while True:
            time.sleep(5)
            try:
                ino = os.stat(kubelet_sock).st_ino
            except OSError:
                ino = None
            kubelet_restarted = ino != last_ino
            last_ino = ino
            if ensure_serving(count_crash=not kubelet_restarted):
                registered = try_register()
            if kubelet_restarted:
                if ino is not None:
                    log.info("kubelet socket changed; re-registering")
                    registered = try_register()
            elif not registered:
                registered = try_register()
    except KeyboardInterrupt:
        pass
    finally:
        plugin.stop()
        register.stop()
        cache.stop()
        close = getattr(backend, "close", None)
        if close is not None:
            close()  # nvmlShutdown


if __name__ == "__main__":
    main()
