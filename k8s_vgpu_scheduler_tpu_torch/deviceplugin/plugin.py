"""GPU device plugin — the kubelet-facing node agent of the port.

The port's counterpart of the JAX package's ``deviceplugin/plugin.py``
(reference: pkg/device-plugin/plugin.go, NvidiaDevicePlugin, 136–391):

- advertise every card as ``device_split_count`` virtual devices
  ``<uuid>-<k>`` (apiDevices, plugin.go:479–488), so kubelet admits up to N
  sharers per card;
- ``Allocate`` IGNORES kubelet's device IDs: the decision was made by the
  scheduler extender and travels in pod annotations; Allocate pops it and
  answers with the env and mounts the port's interposer enforces
  (plugin.go:318–386);
- a failure finalizes the handshake as failed and releases the node lock,
  so the pod can reschedule;
- ``GetPreferredAllocation`` packs a whole-card request that kubelet
  places on its own onto a slice of the node's fabric
  (``allocator.SliceAllocator`` under ``Config.topology_policy``; the
  reference's server.go:441–491).

The env a container gets (read by ``csrc/vgpu/region.cc``):

- ``CUDA_DEVICE_MEMORY_LIMIT_<i>``  memory cap in MiB of the i-th card
- ``CUDA_DEVICE_SM_LIMIT``           compute percentage (0 = uncapped)
- ``CUDA_DEVICE_MEMORY_SHARED_CACHE`` the in-container path of the pod's
  region file, in the per-container directory the monitor scans
- ``NVIDIA_VISIBLE_DEVICES``         the granted cards' UUIDs: the NVIDIA
  container runtime mounts them (and renumbers them from 0), and the
  region maps its slots by them
- ``CUDA_OVERSUBSCRIBE``             present when host swap is enabled
- ``VTPU_QOS_CLASS``/``_DUTY_SPLIT``, ``VTPU_GANG_*``, ``VTPU_TRACE_ID``
- ``PYTHONPATH``                     the mounted shim dir, where the
  shim's startup hook (``sitecustomize.py``) installs the Python shim in
  every Python process of the pod that imports the port (the JAX
  package's chart sets it; the port has no chart yet, so Allocate does),
  for a grant that oversubscribes or a node with no ``ld.so.preload``:
  elsewhere the interposer does all the shim would
- mounts: the per-container region dir at /tmp/vgpu, the node's shim dir
  at /usr/local/vgpu (``libvgpu_cuda.so`` and ``sitecustomize.py``) and
  its ``ld.so.preload`` at /etc/ld.so.preload.

No device specs: the container runtime mounts the cards
``NVIDIA_VISIBLE_DEVICES`` names, as the reference relies on.  No physical
memory env: the port has no ballast.

The core (:meth:`GpuDevicePlugin.allocate`, :meth:`build_container_response`,
:meth:`api_devices`, ``allocator``) returns plain dataclasses and imports neither grpc nor
protobuf; the kubelet servicer methods, :meth:`serve` and
:meth:`register_with_kubelet` import them and convert at the edge.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import queue
import threading
import time
from typing import Dict, List, Optional

from ..k8s.client import KubeClient, pod_name, pod_uid
from ..tpulib.types import NodeInventory
from ..util import protocol, trace
from ..util.config import Config
from ..util.enforcement import check_shim_install
from ..util.types import (
    CACHE_CONTAINER_DIR,
    CACHE_FILE,
    ENV_MEMORY_LIMIT_PREFIX,
    ENV_OVERSUBSCRIBE,
    ENV_QOS_CLASS,
    ENV_QOS_DUTY_SPLIT,
    ENV_SHARED_CACHE,
    ENV_SM_LIMIT,
    ENV_VISIBLE_DEVICES,
    GANG_COORDINATOR_ANNOTATION,
    GANG_GROUP_ANNOTATION,
    GANG_RANK_ANNOTATION,
    GANG_TOTAL_ANNOTATION,
    NVIDIA_DEVICE,
    OVERSUBSCRIBE_ANNOTATION,
    PRELOAD_FILE,
    QOS_ANNOTATION,
    QOS_DUTY_SPLIT_ANNOTATION,
    SHIM_CONTAINER_DIR,
)
from .allocator import SliceAllocator

#: Set where the shim dir is mounted and the Python shim enforces.
ENV_PYTHONPATH = "PYTHONPATH"

log = logging.getLogger(__name__)

HEALTHY = "Healthy"
UNHEALTHY = "Unhealthy"


@dataclasses.dataclass
class Mount:
    container_path: str
    host_path: str
    read_only: bool = False


@dataclasses.dataclass
class ContainerResponse:
    """One container's answer to Allocate: its env and mounts."""

    envs: Dict[str, str] = dataclasses.field(default_factory=dict)
    mounts: List[Mount] = dataclasses.field(default_factory=list)

    def to_proto(self):
        from ..api import deviceplugin_pb2 as pb

        return pb.ContainerAllocateResponse(
            envs=self.envs,
            mounts=[pb.Mount(**dataclasses.asdict(m)) for m in self.mounts])


@dataclasses.dataclass
class Device:
    """One virtual device as kubelet sees it."""

    ID: str
    health: str


class CrashLoopBreaker:
    """Backstop against a flapping gRPC server: more than ``max_crashes``
    restarts inside ``window_s`` is a persistent fault — die loudly and let
    the DaemonSet controller surface CrashLoopBackOff instead of looping
    forever (reference plugin.go:200–217: >5 crashes/hour → Fatal)."""

    def __init__(self, max_crashes: int = 5, window_s: float = 3600.0,
                 now=None) -> None:
        self.max_crashes = max_crashes
        self.window_s = window_s
        self._now = now or time.monotonic
        self._crashes: list = []

    def record(self, what: str = "server") -> None:
        t = self._now()
        self._crashes = [c for c in self._crashes
                         if t - c <= self.window_s] + [t]
        if len(self._crashes) > self.max_crashes:
            raise SystemExit(
                f"{what} crashed {len(self._crashes)} times within "
                f"{int(self.window_s)}s; giving up (crash-loop breaker)")


def attach_enforcement(resp: ContainerResponse, cfg: Config, cache_key: str,
                       trace_id: str = "") -> None:
    """Attach the enforcement contract to a container's response: the
    per-container region directory (``<cache_host_dir>/<cache_key>`` on
    the host, scanned by the monitor; reference
    CUDA_DEVICE_MEMORY_SHARED_CACHE + /tmp/vgpu/containers/<uid_ctr>,
    plugin.go:353–380, pathmonitor.go:17) and the interposer's mounts.  A
    webhook-issued trace id is dropped as a ``trace`` file beside the
    region, so host-side tooling can map a region dir to its trace."""
    cache_dir = os.path.join(cfg.cache_host_dir, cache_key)
    try:
        os.makedirs(cache_dir, exist_ok=True)
    except OSError as e:
        log.warning("cannot create cache dir %s: %s", cache_dir, e)
    if trace_id:
        try:
            with open(os.path.join(cache_dir, "trace"), "w") as f:
                f.write(trace_id + "\n")
        except OSError as e:
            log.warning("cannot record trace id in %s: %s", cache_dir, e)
    resp.envs[ENV_SHARED_CACHE] = f"{CACHE_CONTAINER_DIR}/{CACHE_FILE}"
    resp.mounts.append(Mount(container_path=CACHE_CONTAINER_DIR,
                             host_path=cache_dir))
    # Only mount what exists on the host (a mount with a missing source
    # fails every container create) — but never silently: the policy
    # (util/enforcement.py) warns loudly on fail-open, and
    # VTPU_STRICT_ENFORCEMENT=1 raises instead (the caller finalizes
    # bind-phase=failed and the pod reschedules elsewhere).
    mount_dir, mount_preload = check_shim_install(
        cfg.shim_host_dir, what="allocation")
    if mount_dir:
        resp.mounts.append(Mount(container_path=SHIM_CONTAINER_DIR,
                                 host_path=cfg.shim_host_dir,
                                 read_only=True))
        # The shim's startup hook (sitecustomize.py in the directory,
        # shim/startup.py) then installs the Python shim in every process
        # of the pod that imports the port.  Only where that shim has work
        # the interposer does not do (host swap, or all of it where no
        # interposer is preloaded): the setting replaces a PYTHONPATH
        # baked into the pod's image, as the JAX chart's setting does.
        if ENV_OVERSUBSCRIBE in resp.envs or not mount_preload:
            resp.envs[ENV_PYTHONPATH] = SHIM_CONTAINER_DIR
    if mount_preload:
        resp.mounts.append(Mount(
            container_path=f"/etc/{PRELOAD_FILE}",
            host_path=os.path.join(cfg.shim_host_dir, PRELOAD_FILE),
            read_only=True))


class GpuDevicePlugin:
    """Serves the kubelet DevicePlugin API for the ``nvidia.com/gpu``
    resource."""

    def __init__(
        self,
        client: KubeClient,
        inventory: NodeInventory,
        cfg: Config,
        socket_dir: str = "/var/lib/kubelet/device-plugins",
        socket_name: str = "vgpu.sock",
    ) -> None:
        self.client = client
        self.inventory = inventory
        self.cfg = cfg
        self.socket_dir = socket_dir
        self.socket_path = os.path.join(socket_dir, socket_name)
        self.resource_name = cfg.resources.count
        self._server = None
        # One queue per live ListAndWatch stream: kubelet restarts open a new
        # stream while the old generator may still be draining, and a shared
        # queue would let the dead stream steal health events.
        self._watch_qs: Dict[int, "queue.Queue"] = {}
        self._watch_seq = 0
        self._watch_lock = threading.Lock()
        self._stop = threading.Event()
        self._probe_failures = 0
        # Kubelet's topology path (reference server.go:441–491): packs a
        # whole-card pod placed without the extender.
        self.allocator = SliceAllocator(inventory, cfg.topology_policy)

    # -- the core: plain dataclasses, no grpc ----------------------------------
    def api_devices(self) -> List[Device]:
        """Each card as ``effective_split_count`` virtual devices
        (apiDevices, plugin.go:479–488)."""
        return [Device(ID=f"{chip.uuid}-{k}",
                       health=HEALTHY if chip.healthy else UNHEALTHY)
                for chip in self.inventory.chips
                for k in range(self.cfg.effective_split_count())]

    def notify_health_changed(self) -> None:
        with self._watch_lock:
            for q in self._watch_qs.values():
                q.put(True)

    def allocate(self, containers: int) -> List[ContainerResponse]:
        """The node-agent half of the two-phase commit (plugin.go:318–386)
        for a request of ``containers`` containers: each takes the pending
        pod's next grant.  On any failure the pod is marked failed and the
        node lock released, then the error propagates.  Traced in this
        process's tracer as the ``allocate`` span under the pod's
        webhook-issued trace id (kubelet carries no trace context)."""
        out: List[ContainerResponse] = []
        pod = None
        tr = trace.tracer()
        tid = ""
        with tr.span("allocate", node=self.cfg.node_name) as sp:
            try:
                pod = protocol.get_pending_pod(self.client,
                                               self.cfg.node_name)
                if pod is None:
                    raise LookupError(
                        "no pod in allocating phase on node "
                        f"{self.cfg.node_name}")
                sp.trace_id = tid = trace.trace_id_of(pod)
                sp.set("pod", pod_name(pod))
                for _ in range(containers):
                    grant = protocol.get_next_device_request(NVIDIA_DEVICE,
                                                             pod)
                    protocol.erase_next_device_type(self.client,
                                                    NVIDIA_DEVICE, pod)
                    out.append(self.build_container_response(pod, grant))
                    sp.set("cards", len(grant))
                protocol.pod_allocation_try_success(self.client, pod)
                tr.event(pod_uid(pod), "allocated", trace_id=tid,
                         pod=pod_name(pod), node=self.cfg.node_name)
                return out
            except Exception as e:  # any failure must free the pod
                log.exception("Allocate failed")
                sp.set("error", str(e))
                if pod is not None:
                    tr.event(pod_uid(pod), "allocate-failed", trace_id=tid,
                             pod=pod_name(pod), error=str(e))
                    try:
                        protocol.pod_allocation_failed(self.client, pod)
                    except Exception:
                        log.exception("failed to mark pod allocation failed")
                raise

    def build_container_response(self, pod: dict, grant) -> ContainerResponse:
        resp = ContainerResponse()
        anns = pod.get("metadata", {}).get("annotations", {})
        uuids = []
        # env-share time-slices the whole card: sharers get no memory caps
        # (reference env-share mode emits only visibility env).
        enforce_mem = self.cfg.sharing_mode != "env-share"
        for i, dev in enumerate(grant):
            if self.inventory.chip_by_uuid(dev.uuid) is None:
                # The granted card is gone from the inventory (died between
                # Filter and Allocate): fail, so the pod is marked failed
                # and reschedules — a silent skip would misalign
                # MEMORY_LIMIT_<i> with NVIDIA_VISIBLE_DEVICES.
                raise LookupError(f"granted card {dev.uuid} not in inventory")
            if enforce_mem:
                resp.envs[f"{ENV_MEMORY_LIMIT_PREFIX}{i}"] = str(dev.usedmem)
            uuids.append(dev.uuid)
        if grant and not self.cfg.disable_core_limit:
            resp.envs[ENV_SM_LIMIT] = str(grant[0].usedcores)
        resp.envs[ENV_VISIBLE_DEVICES] = ",".join(uuids)
        if anns.get(OVERSUBSCRIBE_ANNOTATION, "") in ("true", "1"):
            resp.envs[ENV_OVERSUBSCRIBE] = "true"
        # SLO-tiered co-residency: the webhook-validated class reaches the
        # region through this env; the scheduler's placement-time duty
        # split rides along for introspection.  No annotation, no env: the
        # region stays on the flat limiter path.
        qos = anns.get(QOS_ANNOTATION, "")
        if qos:
            resp.envs[ENV_QOS_CLASS] = qos
            split = anns.get(QOS_DUTY_SPLIT_ANNOTATION, "")
            if split:
                resp.envs[ENV_QOS_DUTY_SPLIT] = split
        # Multi-host gangs: the scheduler-assigned rank and group size, and
        # the user's coordinator address, passed through verbatim.
        rank = anns.get(GANG_RANK_ANNOTATION, "")
        if rank:
            resp.envs["VTPU_GANG_RANK"] = rank
            resp.envs["VTPU_GANG_SIZE"] = anns.get(GANG_TOTAL_ANNOTATION, "")
            resp.envs["VTPU_GANG_GROUP"] = anns.get(GANG_GROUP_ANNOTATION, "")
            coord = anns.get(GANG_COORDINATOR_ANNOTATION, "")
            if coord:
                resp.envs["VTPU_GANG_COORDINATOR"] = coord
        trace_id = trace.trace_id_of(pod)
        if trace_id:
            resp.envs[trace.ENV_TRACE_ID] = trace_id
        attach_enforcement(resp, self.cfg, f"{pod_uid(pod)}_{pod_name(pod)}",
                           trace_id=trace_id)
        return resp

    # -- the DevicePlugin service (the gRPC edge) -------------------------------
    def GetDevicePluginOptions(self, request, context):  # noqa: N802
        from ..api import deviceplugin_pb2 as pb

        return pb.DevicePluginOptions(
            pre_start_required=False,
            get_preferred_allocation_available=True)

    def ListAndWatch(self, request, context):  # noqa: N802
        from ..api import deviceplugin_pb2 as pb

        def devices():
            return pb.ListAndWatchResponse(devices=[
                pb.Device(ID=d.ID, health=d.health)
                for d in self.api_devices()])

        with self._watch_lock:
            self._watch_seq += 1
            sid = self._watch_seq
            q: "queue.Queue" = queue.Queue()
            self._watch_qs[sid] = q
        try:
            yield devices()
            while not self._stop.is_set():
                try:
                    q.get(timeout=1.0)
                except queue.Empty:
                    if context is not None and not context.is_active():
                        return  # kubelet hung up; stop draining
                    continue
                yield devices()
        finally:
            with self._watch_lock:
                self._watch_qs.pop(sid, None)

    def GetPreferredAllocation(self, request, context):  # noqa: N802
        """Topology-pack kubelet's choice of virtual devices.  A pod the
        extender placed ignores it (Allocate obeys the annotations); a
        whole-card pod the default scheduler placed gets cards of one
        slice here."""
        from ..api import deviceplugin_pb2 as pb

        return pb.PreferredAllocationResponse(container_responses=[
            pb.ContainerPreferredAllocationResponse(
                deviceIDs=self.allocator.preferred(
                    list(creq.available_deviceIDs),
                    list(creq.must_include_deviceIDs),
                    creq.allocation_size))
            for creq in request.container_requests])

    def PreStartContainer(self, request, context):  # noqa: N802
        from ..api import deviceplugin_pb2 as pb

        return pb.PreStartContainerResponse()

    def Allocate(self, request, context):  # noqa: N802
        import grpc

        from ..api import deviceplugin_pb2 as pb

        try:
            out = self.allocate(len(request.container_requests))
        except Exception as e:  # reported to kubelet; the pod is freed
            context.abort(grpc.StatusCode.INTERNAL, f"allocate failed: {e}")
        return pb.AllocateResponse(
            container_responses=[r.to_proto() for r in out])

    # -- serving lifecycle (Serve/Register, plugin.go:181–253) ----------------
    # A restart aborts in-flight Allocates mid two-phase commit, so a single
    # slow probe (CPU-starved node, long GC pause) must NOT look like death:
    # the RPC probe only reports dead after this many CONSECUTIVE failures.
    PROBE_FAILURE_THRESHOLD = 2

    def serving(self, probe_timeout: float = 5.0) -> bool:
        """Liveness for the supervisor: server object present, unix socket
        still on disk (kubelet wipes the plugin dir on restart; a crashed
        server leaves a stale path), AND a local RPC answers — a
        wedged-but-alive server must fail this check, not just a dead one.
        Hard evidence (no server object / no socket) is immediate; the
        probe needs consecutive failures."""
        import grpc

        from ..api import deviceplugin_pb2 as pb
        from ..api.kubelet import DevicePluginStub

        if self._server is None or not os.path.exists(self.socket_path):
            self._probe_failures = 0
            return False
        try:
            with grpc.insecure_channel(f"unix://{self.socket_path}") as ch:
                DevicePluginStub(ch).GetDevicePluginOptions(
                    pb.Empty(), timeout=probe_timeout)
            self._probe_failures = 0
            return True
        except grpc.RpcError:
            self._probe_failures += 1
            if self._probe_failures >= self.PROBE_FAILURE_THRESHOLD:
                self._probe_failures = 0
                return False
            log.warning(
                "plugin liveness probe failed (%d/%d); tolerating",
                self._probe_failures, self.PROBE_FAILURE_THRESHOLD)
            return True

    def serve(self) -> None:
        from concurrent import futures

        import grpc

        from ..api.kubelet import add_deviceplugin_service

        if self._server is not None:
            # Supervised restart: release the old executor's threads and the
            # fd on the unlinked socket inode before replacing it.
            self._server.stop(grace=0)
            self._server = None
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=16))
        add_deviceplugin_service(self._server, self)
        self._server.add_insecure_port(f"unix://{self.socket_path}")
        self._server.start()
        log.info("device plugin serving on %s", self.socket_path)

    def register_with_kubelet(self, kubelet_socket: Optional[str] = None) -> None:
        import grpc

        from ..api import deviceplugin_pb2 as pb
        from ..api.kubelet import API_VERSION, registration_stub

        kubelet_socket = kubelet_socket or os.path.join(self.socket_dir,
                                                        "kubelet.sock")
        with grpc.insecure_channel(f"unix://{kubelet_socket}") as channel:
            registration_stub(channel)(
                pb.RegisterRequest(
                    version=API_VERSION,
                    endpoint=os.path.basename(self.socket_path),
                    resource_name=self.resource_name,
                    # Kubelet reads the options carried here, not a later
                    # GetDevicePluginOptions call.
                    options=pb.DevicePluginOptions(
                        get_preferred_allocation_available=True),
                ),
                timeout=10,
            )
        log.info("registered %s with kubelet", self.resource_name)

    def stop(self) -> None:
        self._stop.set()
        if self._server is not None:
            self._server.stop(grace=1)
            self._server = None
        if os.path.exists(self.socket_path):
            try:
                os.unlink(self.socket_path)
            except OSError:
                pass
