"""The port's device plugin (``deviceplugin/``) against the JAX package's.

The same pods, made by the scheduler's Bind as tests/test_deviceplugin.py
makes them, go through the JAX ``TpuDevicePlugin.Allocate`` and the port's
``GpuDevicePlugin`` (its core, ``allocate``, and its kubelet servicer over
a real unix socket); the port's responses must equal the JAX plugin's
under the env table below, and the bind phase, the node lock and the
trace must end the same.  Both inventories hold the same cards by UUID;
the device type is the JAX package's "TPU-<gen>" and the port's
"NVIDIA-<gen>".

The env table (JAX -> port):

- ``TPU_DEVICE_MEMORY_LIMIT_<i>`` -> ``CUDA_DEVICE_MEMORY_LIMIT_<i>``
- ``TPU_DEVICE_CORE_LIMIT`` -> ``CUDA_DEVICE_SM_LIMIT``
- ``TPU_DEVICE_MEMORY_SHARED_CACHE`` /tmp/vtpu/vtpu.cache ->
  ``CUDA_DEVICE_MEMORY_SHARED_CACHE`` /tmp/vgpu/cudevshr.cache
- ``TPU_VISIBLE_CHIPS`` -> ``NVIDIA_VISIBLE_DEVICES``
- ``TPU_OVERSUBSCRIBE`` -> ``CUDA_OVERSUBSCRIBE``
- ``TPU_VISIBLE_DEVICES``, ``TPU_DEVICE_PHYSICAL_MEMORY_<i>``: none
- ``VTPU_*`` unchanged; mounts /tmp/vtpu -> /tmp/vgpu and /usr/local/vtpu
  -> /usr/local/vgpu, on the same host paths.

One stated difference: where the shim dir is mounted and the grant
oversubscribes, the port's answer also sets ``PYTHONPATH`` to it
(``SHIM_ENV``), so the shim's startup hook installs the Python shim's
host swap in the pod; the JAX package leaves that to its chart, and the
port has no chart yet.
"""

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
from concurrent import futures
from pathlib import Path

import grpc
import pytest

from k8s_vgpu_scheduler_tpu.api import deviceplugin_pb2 as jpb
from k8s_vgpu_scheduler_tpu.cmd import device_plugin as jcmd
from k8s_vgpu_scheduler_tpu.deviceplugin import TpuDevicePlugin
from k8s_vgpu_scheduler_tpu.deviceplugin import register as jregister
from k8s_vgpu_scheduler_tpu.deviceplugin.plugin import \
    CrashLoopBreaker as JBreaker
from k8s_vgpu_scheduler_tpu.k8s import FakeKube as JKube
from k8s_vgpu_scheduler_tpu.scheduler.core import decode_register_request
from k8s_vgpu_scheduler_tpu.tpulib import MockBackend as JMock
from k8s_vgpu_scheduler_tpu.util import codec as jcodec
from k8s_vgpu_scheduler_tpu.util import nodelock as jnodelock
from k8s_vgpu_scheduler_tpu.util import trace as jtrace
from k8s_vgpu_scheduler_tpu.util import types as jtypes
from k8s_vgpu_scheduler_tpu.util.config import Config as JConfig
from k8s_vgpu_scheduler_tpu_torch.api import deviceplugin_pb2 as tpb
from k8s_vgpu_scheduler_tpu_torch.api.kubelet import (
    API_VERSION, DevicePluginStub, add_registration_service)
from k8s_vgpu_scheduler_tpu_torch.cmd import device_plugin as tcmd
from k8s_vgpu_scheduler_tpu_torch.deviceplugin import allocator as tallocator
from k8s_vgpu_scheduler_tpu_torch.deviceplugin import (
    DeviceCache, DeviceRegister, GpuDevicePlugin, advertised_devices,
    inventory_to_request)
from k8s_vgpu_scheduler_tpu_torch.deviceplugin.plugin import \
    CrashLoopBreaker as TBreaker
from k8s_vgpu_scheduler_tpu_torch.k8s import FakeKube as TKube
from k8s_vgpu_scheduler_tpu_torch.tpulib import MockBackend as TMock
from k8s_vgpu_scheduler_tpu_torch.util import codec as tcodec
from k8s_vgpu_scheduler_tpu_torch.util import nodelock as tnodelock
from k8s_vgpu_scheduler_tpu_torch.util import trace as ttrace
from k8s_vgpu_scheduler_tpu_torch.util import types as ttypes
from k8s_vgpu_scheduler_tpu_torch.util.config import Config as TConfig

NODE = "node-a"
# Four H100s by UUID; the JAX backend types them "TPU-h100", the port's
# "NVIDIA-h100".
FIXTURE = {"generation": "h100", "mesh": [4], "hbm_mib": 81079,
           "chips": [{"coords": [i],
                      "uuid": f"GPU-{i:08x}-5b3f-0a1c-2222-333344445555"}
                     for i in range(4)]}

ENV_TABLE = {"TPU_DEVICE_CORE_LIMIT": "CUDA_DEVICE_SM_LIMIT",
             "TPU_DEVICE_MEMORY_SHARED_CACHE":
                 "CUDA_DEVICE_MEMORY_SHARED_CACHE",
             "TPU_VISIBLE_CHIPS": "NVIDIA_VISIBLE_DEVICES",
             "TPU_OVERSUBSCRIBE": "CUDA_OVERSUBSCRIBE"}
PATHS = {"/tmp/vtpu/vtpu.cache": "/tmp/vgpu/cudevshr.cache",
         "/tmp/vtpu": "/tmp/vgpu", "/usr/local/vtpu": "/usr/local/vgpu"}
# The port's one key beyond the JAX answer, where the shim dir is mounted
# and the grant oversubscribes.
SHIM_ENV = {"PYTHONPATH": "/usr/local/vgpu"}


def as_port_envs(envs: dict) -> dict:
    out = {}
    for k, v in envs.items():
        if k.startswith("TPU_DEVICE_MEMORY_LIMIT_"):
            out["CUDA_DEVICE_MEMORY_LIMIT_" + k.rsplit("_", 1)[1]] = v
        elif k.startswith(("TPU_VISIBLE_DEVICES",
                           "TPU_DEVICE_PHYSICAL_MEMORY_")):
            continue
        else:
            out[ENV_TABLE.get(k, k)] = PATHS.get(v, v)
    return out


def mounts_of(resp) -> list:
    return [(m.container_path, m.host_path, m.read_only) for m in resp.mounts]


def as_port_mounts(resp) -> list:
    return [(PATHS.get(c, c), h, ro) for c, h, ro in mounts_of(resp)]


class Side:
    """One package's node agent on a FakeKube with the node registered."""

    def __init__(self, port: bool, tmp_path, **cfg):
        self.port = port
        mod = (TKube, TMock, TConfig, tcodec, tnodelock, ttypes) if port \
            else (JKube, JMock, JConfig, jcodec, jnodelock, jtypes)
        kube_cls, mock_cls, cfg_cls, self.codec, self.nodelock, \
            self.types = mod
        self.kube = kube_cls()
        self.kube.add_node({"metadata": {"name": NODE, "annotations": {}}})
        self.inv = mock_cls(json.loads(json.dumps(FIXTURE))).inventory()
        self.cfg = cfg_cls(node_name=NODE,
                           shim_host_dir=str(tmp_path / "shim"),
                           cache_host_dir=str(tmp_path / "cache"), **cfg)
        cls = GpuDevicePlugin if port else TpuDevicePlugin
        self.plugin = cls(self.kube, self.inv, self.cfg,
                          socket_dir=str(tmp_path),
                          socket_name=f"{'t' if port else 'j'}.sock")

    def bind(self, grants, name="p1", annotations=None, locked=True):
        """What the scheduler's Bind leaves: the node locked, the pod
        ``allocating`` with ``grants`` ([[(card index, MiB, cores)]] a
        container) to allocate."""
        if locked:
            self.nodelock.lock_node(self.kube, NODE)
        pod_devices = [[self.types.ContainerDevice(
            uuid=self.inv.chips[i].uuid, type=self.inv.chips[i].type,
            usedmem=mem, usedcores=cores) for i, mem, cores in ctr]
            for ctr in grants]
        anns = {self.types.BIND_TIME_ANNOTATION: "1",
                self.types.BIND_PHASE_ANNOTATION:
                    self.types.BIND_ALLOCATING,
                self.types.ASSIGNED_NODE_ANNOTATION: NODE,
                self.types.TO_ALLOCATE_ANNOTATION:
                    self.codec.encode_pod_devices(pod_devices),
                **(annotations or {})}
        return self.kube.create_pod({
            "metadata": {"name": name, "namespace": "default",
                         "uid": f"uid-{name}", "annotations": anns},
            "spec": {"containers": [{"name": f"c{i}"}
                                     for i in range(len(grants))],
                     "nodeName": NODE}})

    def allocate(self, containers: int):
        """(responses as (envs, mounts), error) through the servicer."""
        pb = tpb if self.port else jpb
        req = pb.AllocateRequest(container_requests=[
            pb.ContainerAllocateRequest() for _ in range(containers)])
        try:
            resp = self.plugin.Allocate(req, AbortContext())
        except Aborted as e:
            return None, e.args
        return [(dict(r.envs), mounts_of(r))
                for r in resp.container_responses], None

    def outcome(self, name="p1"):
        anns = self.kube.get_pod("default", name)["metadata"]["annotations"]
        return (anns.get(self.types.BIND_PHASE_ANNOTATION),
                anns.get(self.types.TO_ALLOCATE_ANNOTATION),
                self.nodelock.is_locked(self.kube, NODE))


class Aborted(Exception):
    pass


class AbortContext:
    def abort(self, code, details):
        raise Aborted(code, details)

    def is_active(self):
        return True


@pytest.fixture
def sides(tmp_path):
    """A node's shim install (an ld.so.preload in the shim dir, so both
    plugins mount it), then the two sides on it."""
    (tmp_path / "shim").mkdir()
    (tmp_path / "shim" / "ld.so.preload").write_text(
        "/usr/local/vgpu/libvgpu_cuda.so\n")

    def make(**cfg):
        return Side(False, tmp_path, **cfg), Side(True, tmp_path, **cfg)
    return make


CASES = {
    "one_card": ([[(0, 3000, 30)]], {}, {}),
    "multi_card": ([[(0, 3000, 30), (1, 3000, 30)]], {}, {}),
    "two_containers": ([[(0, 24000, 50)], [(2, 40000, 50)]], {}, {}),
    "env_share": ([[(0, 3000, 30)]], {}, {"sharing_mode": "env-share"}),
    "mem_share": ([[(1, 3000, 30)]], {}, {"sharing_mode": "mem-share"}),
    "default_mode": ([[(3, 81079, 100)]], {}, {"sharing_mode": "default"}),
    "disable_core_limit": ([[(0, 3000, 30)]], {},
                           {"disable_core_limit": True}),
    "oversubscribe": ([[(0, 90000, 50)]],
                      {"vtpu.dev/oversubscribe": "true"}, {}),
    "qos_class_and_split": ([[(0, 24000, 50)]],
                            {"vtpu.dev/qos": "latency-critical",
                             "vtpu.dev/qos-duty-split": "70/30"}, {}),
    "gang_rank": ([[(0, 8000, 100)]],
                  {"vtpu.dev/pod-group": "job-a",
                   "vtpu.dev/pod-group-total": "4",
                   "vtpu.dev/pod-group-rank": "2",
                   "vtpu.dev/pod-group-coordinator": "job-a-0.svc:1234"},
                  {}),
    "trace_id": ([[(0, 3000, 30)]],
                 {"vtpu.dev/trace-id": "0af7651916cd43dd8448eb211c80319c"},
                 {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_allocate_responses_equal_the_jax_plugin(sides, tmp_path, case):
    grants, anns, cfg = CASES[case]
    j, t = sides(**cfg)
    j.bind(grants, annotations=anns)
    t.bind(grants, annotations=anns)
    jr, jerr = j.allocate(len(grants))
    tr, terr = t.allocate(len(grants))
    assert jerr is None and terr is None, (jerr, terr)
    assert [envs for envs, _ in tr] == [
        {**as_port_envs(e),
         **(SHIM_ENV if "TPU_OVERSUBSCRIBE" in e else {})} for e, _ in jr]
    assert [m for _, m in tr] == [[(PATHS.get(c, c), h, ro)
                                   for c, h, ro in m] for _, m in jr]
    assert t.outcome() == j.outcome()
    assert t.outcome()[0] == "success" and not t.outcome()[2]
    for _, mounts in tr:  # each container's region dir exists
        host = dict((c, h) for c, h, _ in mounts)["/tmp/vgpu"]
        assert os.path.isdir(host)
        if "trace-id" in case:
            assert open(os.path.join(host, "trace")).read() == \
                anns["vtpu.dev/trace-id"] + "\n"


def test_core_allocate_equals_the_servicer(sides):
    j, t = sides()
    t.bind([[(0, 3000, 30)]])
    core = t.plugin.allocate(1)
    t.bind([[(0, 3000, 30)]], name="p2")
    served, _ = t.allocate(1)
    assert [(r.envs, [(m.container_path, m.host_path, m.read_only)
                      for m in r.mounts]) for r in core] == \
        [(envs, [(c, h.replace("uid-p2_p2", "uid-p1_p1"), ro)
                 for c, h, ro in m]) for envs, m in served]


@pytest.mark.parametrize("case", ["no_pending_pod", "empty_grant",
                                  "card_not_in_inventory"])
def test_allocate_failure_is_the_jax_plugins(sides, case):
    """No pending pod: aborted, nothing changes.  A grant that cannot be
    popped or names a card this node lacks: aborted, the pod marked
    failed and the node lock released."""
    j, t = sides()
    outs = []
    for side in (j, t):
        if case != "no_pending_pod":
            side.bind([[(0, 3000, 30)]])
        if case == "empty_grant":
            side.kube.patch_pod_annotations("default", "p1", {
                side.types.TO_ALLOCATE_ANNOTATION: ""})
        if case == "card_not_in_inventory":
            side.inv.chips.pop(0)
        resp, err = side.allocate(1)
        assert resp is None and err[0] == grpc.StatusCode.INTERNAL
        outs.append(None if case == "no_pending_pod" else side.outcome())
    assert outs[1] == outs[0]
    if case != "no_pending_pod":
        assert outs[1][0] == "failed" and not outs[1][2]
    with pytest.raises(LookupError):
        t.plugin.allocate(1)  # the core raises what the servicer aborts


def test_allocate_traces_like_the_jax_plugin(sides):
    tid = "4bf92f3577b34da6a3ce929d0e0e4736"
    outs = []
    for side, tracer in zip(sides(), (jtrace.tracer(), ttrace.tracer())):
        tracer.reset()
        side.bind([[(0, 3000, 30)]],
                  annotations={"vtpu.dev/trace-id": tid})
        side.allocate(1)
        span = [s for s in tracer.spans(tid) if s.name == "allocate"]
        outs.append((len(span), span[0].attrs.get("pod"),
                     [(e["event"], e["trace_id"])
                      for e in tracer.events("uid-p1")]))
    assert outs[1] == outs[0] == (1, "p1", [("allocated", tid)])


@pytest.mark.parametrize("mode", ["mem-share", "env-share", "default"])
def test_api_devices_equal_the_jax_plugin(sides, mode):
    j, t = sides(sharing_mode=mode)
    for side in (j, t):
        side.inv.chips[2].healthy = False
    assert [(d.ID, d.health) for d in t.plugin.api_devices()] == \
        [(d.ID, d.health) for d in j.plugin.api_devices()]
    assert len(t.plugin.api_devices()) == 4 * (1 if mode == "default"
                                               else 10)


def test_options_offer_no_preferred_allocation(sides):
    """The options as the JAX plugin gives them: no PreStartContainer, and
    (since the port's slice allocator) a preferred allocation."""
    j, t = sides()
    opts = t.plugin.GetDevicePluginOptions(tpb.Empty(), None)
    want = j.plugin.GetDevicePluginOptions(jpb.Empty(), None)
    assert not opts.pre_start_required
    assert opts.get_preferred_allocation_available
    assert (opts.pre_start_required, opts.get_preferred_allocation_available
            ) == (want.pre_start_required,
                  want.get_preferred_allocation_available)


@pytest.fixture
def served(sides, tmp_path):
    _, t = sides()
    t.plugin.serve()
    channel = grpc.insecure_channel(f"unix://{t.plugin.socket_path}")
    yield t, DevicePluginStub(channel)
    channel.close()
    t.plugin.stop()


def test_list_and_watch_over_the_socket(served):
    t, stub = served
    stream = stub.ListAndWatch(tpb.Empty(), timeout=10)
    it = iter(stream)
    first = next(it)
    assert [(d.ID, d.health) for d in first.devices] == \
        [(d.ID, d.health) for d in t.plugin.api_devices()]
    t.inv.chips[0].healthy = False
    t.plugin.notify_health_changed()
    second = next(it)
    assert sum(d.health == "Unhealthy" for d in second.devices) == 10
    stream.cancel()


def test_full_kubelet_handshake_over_the_socket(served):
    """tests/test_deviceplugin.py's handshake: kubelet's Allocate over the
    unix socket pops the grant, the bind phase ends in success and the
    node lock is released."""
    t, stub = served
    t.bind([[(0, 3000, 30)]])
    resp = stub.Allocate(tpb.AllocateRequest(container_requests=[
        tpb.ContainerAllocateRequest(
            devicesIDs=[f"{t.inv.chips[0].uuid}-3"])]), timeout=10)
    envs = dict(resp.container_responses[0].envs)
    assert envs["CUDA_DEVICE_MEMORY_LIMIT_0"] == "3000"
    assert envs["CUDA_DEVICE_SM_LIMIT"] == "30"
    assert envs["NVIDIA_VISIBLE_DEVICES"] == t.inv.chips[0].uuid
    assert envs["CUDA_DEVICE_MEMORY_SHARED_CACHE"] == \
        "/tmp/vgpu/cudevshr.cache"
    mounts = {m.container_path: m.host_path
              for m in resp.container_responses[0].mounts}
    assert os.path.isdir(mounts["/tmp/vgpu"])
    assert t.outcome()[0] == "success" and not t.outcome()[2]
    with pytest.raises(grpc.RpcError) as ei:  # no pending pod now
        stub.Allocate(tpb.AllocateRequest(container_requests=[
            tpb.ContainerAllocateRequest()]), timeout=10)
    assert ei.value.code() == grpc.StatusCode.INTERNAL


def test_register_with_a_fake_kubelet(served, tmp_path):
    t, _ = served
    received = []
    kubelet = grpc.server(futures.ThreadPoolExecutor(max_workers=2))

    def handle_register(request, context):
        received.append(request)
        return tpb.Empty()

    add_registration_service(kubelet, handle_register)
    sock = str(tmp_path / "kubelet.sock")
    kubelet.add_insecure_port(f"unix://{sock}")
    kubelet.start()
    try:
        t.plugin.register_with_kubelet(sock)
    finally:
        kubelet.stop(grace=1)
    assert len(received) == 1
    r = received[0]
    assert (r.version, r.resource_name, r.endpoint) == (
        API_VERSION, "nvidia.com/gpu", "t.sock")
    assert r.options.get_preferred_allocation_available


def test_serving_liveness(served):
    t, _ = served
    assert t.plugin.serving()
    os.unlink(t.plugin.socket_path)  # kubelet wiped the plugin dir
    assert not t.plugin.serving()
    t.plugin.serve()
    assert t.plugin.serving()


@pytest.mark.parametrize("cfg", [
    {}, {"device_memory_scaling": 2.0, "device_split_count": 5,
         "device_cores_scaling": 1.5}, {"sharing_mode": "default"}],
    ids=["plain", "scaled", "default_mode"])
def test_the_jax_scheduler_decodes_the_port_register_request(cfg):
    """What the scheduler sees of the cards: the JAX scheduler's
    decode_register_request reads the port's request as it reads the JAX
    plugin's, but for the device type."""
    jinv = JMock(json.loads(json.dumps(FIXTURE))).inventory()
    tinv = TMock(json.loads(json.dumps(FIXTURE))).inventory()
    jinv.chips[1].healthy = tinv.chips[1].healthy = False
    jreq = jregister.inventory_to_request(NODE, jinv, JConfig(**cfg))
    treq = inventory_to_request(NODE, tinv, TConfig(**cfg))
    from k8s_vgpu_scheduler_tpu.api import device_register_pb2 as jrpb

    got = decode_register_request(
        jrpb.RegisterRequest.FromString(treq.SerializeToString()))
    want = decode_register_request(jreq)
    for d in want.devices:
        d.type = d.type.replace("TPU-", "NVIDIA-")
    assert got == want
    assert [dataclasses.asdict(d) for d in got.devices] == [
        {**d, "coords": tuple(d["coords"])}
        for d in advertised_devices(tinv, TConfig(**cfg))]


def test_register_stream_reaches_the_jax_scheduler():
    """DeviceRegister keeps retrying a scheduler that is not there yet,
    then streams to the JAX scheduler's register handler; a health flip
    goes down the same stream (register.go:494–509)."""
    from k8s_vgpu_scheduler_tpu.api import device_register_pb2 as jrpb
    from k8s_vgpu_scheduler_tpu.api.service import add_device_service
    from k8s_vgpu_scheduler_tpu.scheduler import Scheduler

    backend = TMock(json.loads(json.dumps(FIXTURE)))
    s = Scheduler(JKube(), JConfig(node_name=NODE))
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
    add_device_service(server, lambda it, ctx: jrpb.RegisterReply(
        message=s.handle_register_stream(it, ctx)))
    port = server.add_insecure_port("127.0.0.1:0")
    server.start()
    reg = DeviceRegister(backend, TConfig(node_name=NODE),
                         endpoint=f"127.0.0.1:{port}")
    reg.start()
    try:
        deadline = time.time() + 10
        while time.time() < deadline and s.nodes.get_node(NODE) is None:
            time.sleep(0.05)
        node = s.nodes.get_node(NODE)
        assert node is not None and len(node.devices) == 4
        assert {d.type for d in node.devices} == {"NVIDIA-h100"}
        inv = backend.inventory()
        inv.chips[0].healthy = False
        reg.push_update(inv)
        deadline = time.time() + 10
        while time.time() < deadline and all(
                d.health for d in s.nodes.get_node(NODE).devices):
            time.sleep(0.05)
        assert not s.nodes.get_node(NODE).devices[0].health
    finally:
        reg.stop()
        server.stop(grace=1)


def test_device_cache_poll_fans_out_like_the_jax_cache(tmp_path):
    from k8s_vgpu_scheduler_tpu.deviceplugin import DeviceCache as JCache

    outs = []
    for cache_cls, mock_cls in ((JCache, JMock), (DeviceCache, TMock)):
        backend = mock_cls(json.loads(json.dumps(FIXTURE)))
        cache = cache_cls(backend, poll_seconds=1.0, heartbeat_seconds=5.0)
        seen = []
        cache.subscribe("plugin", lambda inv: seen.append("plugin"))
        cache.subscribe("register", lambda inv: seen.append("register"),
                        heartbeat=True)
        t0 = time.monotonic()
        polls = [cache.poll_once(now=t0 + 1.0)]
        backend.fixture["chips"][1]["healthy"] = False
        polls.append(cache.poll_once(now=t0 + 2.0))
        polls.append(cache.poll_once(now=t0 + 8.0))
        outs.append((polls, seen, [c.healthy for c in cache.inventory.chips]))
    assert outs[1] == outs[0]


@pytest.mark.parametrize("entries,want", [
    ([{"name": NODE, "devicememoryscaling": 3.0, "devicesplitcount": 20},
      {"name": "node-b", "devicememoryscaling": 1.0}],
     {"device_memory_scaling": 3.0, "device_split_count": 20}),
    ([{"name": NODE, "devicecorescaling": 2.0}],
     {"device_cores_scaling": 2.0}),
    (None, {}),
], ids=["memory_and_split", "cores", "missing_file"])
def test_node_config_overrides_equal_the_jax_entry_point(tmp_path, entries,
                                                          want):
    path = tmp_path / "config.json"
    if entries is not None:
        path.write_text(json.dumps({"nodeconfig": entries}))
    t = tcmd.apply_node_config_overrides(TConfig(node_name=NODE), str(path))
    j = jcmd.apply_node_config_overrides(JConfig(node_name=NODE), str(path))
    fields = ("device_memory_scaling", "device_split_count",
              "device_cores_scaling")
    assert [getattr(t, f) for f in fields] == [getattr(j, f) for f in fields]
    assert {f: getattr(t, f) for f in want} == want
    if entries is None:
        cfg = TConfig(node_name=NODE)
        assert tcmd.apply_node_config_overrides(cfg, str(path)) is cfg


@pytest.mark.parametrize("gap_s,crashes,trips", [
    (60, 6, True), (1800, 20, False)], ids=["six_in_an_hour", "sparse"])
def test_crash_loop_breaker_equals_the_jax_one(gap_s, crashes, trips):
    outs = []
    for cls in (JBreaker, TBreaker):
        t = [0.0]
        b = cls(max_crashes=5, window_s=3600, now=lambda: t[0])
        tripped = False
        for _ in range(crashes):
            t[0] += gap_s
            try:
                b.record()
            except SystemExit as e:
                tripped = "crash-loop" in str(e)
                break
        outs.append(tripped)
    assert outs == [trips, trips]


def test_entry_point_serves_the_mock_and_registers(tmp_path, monkeypatch):
    """vgpu-device-plugin on the mock: it serves kubelet's API on its
    socket (the loop stops at the first tick)."""
    fix = tmp_path / "h100.json"
    fix.write_text(json.dumps(FIXTURE))
    monkeypatch.setenv("VTPU_MOCK_JSON", str(fix))
    seen = {}

    def stop(_):
        sock = str(tmp_path / "vgpu.sock")
        with grpc.insecure_channel(f"unix://{sock}") as ch:
            stream = DevicePluginStub(ch).ListAndWatch(tpb.Empty(),
                                                       timeout=10)
            seen["devices"] = len(next(iter(stream)).devices)
            stream.cancel()
        raise KeyboardInterrupt

    monkeypatch.setattr(tcmd.time, "sleep", stop)
    tcmd.main(["--fake-kube", "--node-name", NODE, "--socket-dir",
               str(tmp_path), "--shim-dir", str(tmp_path / "shim"),
               "--cache-dir", str(tmp_path / "cache"),
               "--scheduler-endpoint", "127.0.0.1:1",
               "--config-file", str(tmp_path / "none.json")])
    assert seen["devices"] == 40
    assert not os.path.exists(tmp_path / "vgpu.sock")  # stopped


@pytest.mark.parametrize("policy,want", [
    ("guaranteed", "3"), ("restricted", "3"), ("best-effort", None)])
def test_entry_point_publishes_unsatisfiable_sizes(tmp_path, monkeypatch,
                                                   policy, want):
    """vgpu-device-plugin --topology-policy: the node carries the card
    counts no free slice holds, from the start (none on a healthy line of
    four) and after a health change (card 1 lost: no arc of 3); kubelet's
    preferred allocation follows the policy."""
    fx = {"generation": "h100", "mesh": [4], "hbm_mib": 81079,
          "chips": [{"coords": [i]} for i in range(4)]}
    fix = tmp_path / "line.json"
    fix.write_text(json.dumps(fx))
    monkeypatch.setenv("VTPU_MOCK_JSON", str(fix))
    kube = TKube()
    kube.add_node({"metadata": {"name": NODE, "annotations": {}}})
    monkeypatch.setattr(tcmd, "make_client", lambda **_: kube)
    seen = {}

    def annotation():
        return (kube.get_node(NODE)["metadata"].get("annotations") or {}
                ).get(tallocator.UNSATISFIABLE_ANNOTATION)

    def stop(_):
        seen["start"] = annotation()
        fx["chips"][1]["healthy"] = False
        fix.write_text(json.dumps(fx))
        waited = threading.Event()
        for _ in range(200):
            if annotation() is not None or waited.wait(0.02):
                break
        seen["lost"] = annotation()
        sock = str(tmp_path / "vgpu.sock")
        with grpc.insecure_channel(f"unix://{sock}") as ch:
            resp = DevicePluginStub(ch).GetPreferredAllocation(
                tpb.PreferredAllocationRequest(container_requests=[
                    tpb.ContainerPreferredAllocationRequest(
                        available_deviceIDs=[f"GPU-h100-mock-{i}-0"
                                             for i in (0, 2, 3)],
                        allocation_size=3)]), timeout=10)
        seen["preferred"] = list(resp.container_responses[0].deviceIDs)
        raise KeyboardInterrupt

    monkeypatch.setattr(tcmd.time, "sleep", stop)
    tcmd.main(["--fake-kube", "--node-name", NODE, "--socket-dir",
               str(tmp_path), "--shim-dir", str(tmp_path / "shim"),
               "--cache-dir", str(tmp_path / "cache"),
               "--scheduler-endpoint", "127.0.0.1:1",
               "--health-poll-seconds", "0.02",
               "--topology-policy", policy,
               "--config-file", str(tmp_path / "none.json")])
    assert seen["start"] is None and seen["lost"] == want
    assert seen["preferred"] == ([] if want else [
        f"GPU-h100-mock-{i}-0" for i in (0, 2, 3)])


# -- the shim's startup hook ---------------------------------------------------
def test_a_missing_shim_dir_sets_no_pythonpath(tmp_path):
    """PYTHONPATH comes with the shim dir's mount, and only with it."""
    t = Side(True, tmp_path)  # no shim dir installed under tmp_path
    t.bind([[(0, 90000, 50)]],
           annotations={"vtpu.dev/oversubscribe": "true"})
    [(envs, mounts)], err = t.allocate(1)
    assert err is None
    assert envs["CUDA_OVERSUBSCRIBE"] == "true"
    assert "PYTHONPATH" not in envs
    assert "/usr/local/vgpu" not in [c for c, _, _ in mounts]


@pytest.mark.parametrize("preload,oversubscribe,want", [
    (True, False, False), (True, True, True), (False, False, True),
    (False, True, True)],
    ids=["interposer", "interposer_oversubscribed", "no_interposer",
         "no_interposer_oversubscribed"])
def test_pythonpath_only_where_the_python_shim_enforces(
        tmp_path, preload, oversubscribe, want):
    """Where the interposer is preloaded it does all the Python shim
    would but host swap, so only an oversubscribed grant gets the hook
    (and loses the image's PYTHONPATH); with no ld.so.preload every pod
    does."""
    (tmp_path / "shim").mkdir()
    if preload:
        (tmp_path / "shim" / "ld.so.preload").write_text(
            "/usr/local/vgpu/libvgpu_cuda.so\n")
    t = Side(True, tmp_path)
    t.bind([[(0, 90000, 50)]], annotations={
        "vtpu.dev/oversubscribe": "true"} if oversubscribe else None)
    [(envs, mounts)], err = t.allocate(1)
    assert err is None
    assert ("CUDA_OVERSUBSCRIBE" in envs) == oversubscribe
    assert envs.get("PYTHONPATH") == ("/usr/local/vgpu" if want else None)
    assert "/usr/local/vgpu" in [c for c, _, _ in mounts]


#: What a node's shim dir holds: no copy of the port.
SHIM_FILES = ["ld.so.preload", "libvgpu_cuda.so", "sitecustomize.py"]


def shim_files(shim) -> list:
    """The shim dir's files, less the bytecode a writable directory gets
    (a pod's mount is read-only)."""
    return sorted(p.name for p in shim.iterdir() if p.name != "__pycache__")


@pytest.fixture(scope="module")
def shim_install(tmp_path_factory):
    """A node's shim install as vgpu-device-plugin --install-shim makes
    it: the interposer, its ld.so.preload and the startup hook."""
    from k8s_vgpu_scheduler_tpu_torch.ops import _kernels

    shim = tmp_path_factory.mktemp("node") / "shim"
    _kernels.install_shim(shim)
    return shim


def side_on(shim, tmp_path) -> Side:
    """The port's side on this node's shim install (its shim dir a link
    to it)."""
    (tmp_path / "shim").symlink_to(shim, target_is_directory=True)
    return Side(True, tmp_path)


def test_allocate_mounts_the_startup_hook(shim_install, tmp_path):
    t = side_on(shim_install, tmp_path)
    t.bind([[(0, 90000, 50)]],
           annotations={"vtpu.dev/oversubscribe": "true"})
    [(envs, mounts)], err = t.allocate(1)
    assert err is None
    mounted = {c: (h, ro) for c, h, ro in mounts}
    assert envs["PYTHONPATH"] == "/usr/local/vgpu"
    assert mounted["/usr/local/vgpu"] == (str(tmp_path / "shim"), True)
    assert shim_files(shim_install) == SHIM_FILES
    hook = shim_install / "sitecustomize.py"
    assert hook.read_text() == (
        ttypes_root() / "shim" / "startup.py").read_text()


def ttypes_root():
    return Path(ttypes.__file__).resolve().parent.parent


PORT_NAME = "k8s_vgpu_scheduler_tpu_torch"
HOOK_PROBE = (
    "import json, sys\n"
    "at_start = sorted(m for m in sys.modules if m.startswith('k8s_vgpu'))\n"
    "torch_at_start = 'torch' in sys.modules\n"
    "from k8s_vgpu_scheduler_tpu_torch.shim import core\n"
    "shim = core._GLOBAL\n"
    "print(json.dumps(dict(\n"
    "    at_start=at_start, torch_at_start=torch_at_start,\n"
    "    installed=bool(shim),\n"
    "    spiller=bool(shim) and shim._spiller is not None,\n"
    "    gate=bool(shim) and core._GATE is shim,\n"
    "    fractions=bool(shim) and shim.fractions,\n"
    "    torch='torch' in sys.modules, source=core.__file__,\n"
    "    lib=shim.native.lib._name if shim else None)))\n")


def pod_process(shim, tmp_path, allocated: dict, code=HOOK_PROBE):
    """A Python process started with the answer's env alone, its container
    paths put where a kubelet mounts them (no LD_PRELOAD: the interposer
    is held to its own tests), running ``code`` as a script that has its
    own port beside it (a link to this checkout's package), as a program
    that runs the port from its own directory does; ``code`` never calls
    install()."""
    host = {"/usr/local/vgpu": str(shim),
            "/tmp/vgpu": str(tmp_path / "region")}
    (tmp_path / "region").mkdir(exist_ok=True)
    app = tmp_path / "app"
    app.mkdir(exist_ok=True)
    if not (app / PORT_NAME).exists():
        (app / PORT_NAME).symlink_to(ttypes_root(), target_is_directory=True)
    (app / "main.py").write_text(code)

    def on_host(value):
        for c, h in host.items():
            if value == c or value.startswith(c + "/"):
                return h + value[len(c):]
        return value

    env = {"PATH": os.environ["PATH"], "HOME": str(tmp_path),
           **{k: on_host(v) for k, v in allocated.items()}}
    return subprocess.run([sys.executable, str(app / "main.py")], env=env,
                          cwd=tmp_path, capture_output=True, text=True,
                          timeout=300)


def answer(shim, tmp_path, annotations=None) -> dict:
    t = side_on(shim, tmp_path)
    t.bind([[(0, 90000, 50)]], annotations=annotations)
    [(envs, _)], err = t.allocate(1)
    assert err is None
    return envs


def test_the_hook_installs_the_spiller_without_install(shim_install,
                                                       tmp_path):
    """An oversubscribed pod's process gets the shim, with the spiller
    and the gate, as it imports its own port's shim, without calling
    install(): the hook imports nothing of the port at start, the shim
    is the program's port (beside its script, which joins sys.path after
    the hook ran), its library builds in that port's build dir, and the
    shim dir gains nothing."""
    from k8s_vgpu_scheduler_tpu_torch.ops import _kernels

    envs = answer(shim_install, tmp_path, {"vtpu.dev/oversubscribe": "true"})
    assert envs["CUDA_OVERSUBSCRIBE"] == "true"
    res = pod_process(shim_install, tmp_path, envs)
    assert res.returncode == 0, res.stderr
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["at_start"] == [] and not got["torch_at_start"], got
    assert got["installed"] and got["spiller"] and got["gate"] \
        and not got["fractions"], got
    assert got["source"] == str(tmp_path / "app" / PORT_NAME / "shim"
                                / "core.py"), got
    assert Path(got["lib"]).parent == _kernels.BUILD_DIR, got
    region = tmp_path / "region" / "cudevshr.cache"
    assert region.exists()
    assert shim_files(shim_install) == SHIM_FILES


def test_a_failed_install_ends_the_process_nonzero(shim_install, tmp_path):
    from k8s_vgpu_scheduler_tpu_torch.shim import startup

    envs = answer(shim_install, tmp_path, {"vtpu.dev/oversubscribe": "true"})
    # The region's directory is a file: the region cannot be attached.
    (tmp_path / "blocked").write_text("")
    envs["CUDA_DEVICE_MEMORY_SHARED_CACHE"] = str(
        tmp_path / "blocked" / "cudevshr.cache")
    res = pod_process(shim_install, tmp_path, envs, code=(
        "from k8s_vgpu_scheduler_tpu_torch.models import train\n"
        "print('ran unenforced')\n"))
    assert res.returncode == startup.EXIT_UNENFORCED, (res.returncode,
                                                       res.stderr)
    assert "ran unenforced" not in res.stdout
    assert "the shim did not install" in res.stderr


@pytest.mark.parametrize("drop", ["CUDA_DEVICE_MEMORY_SHARED_CACHE",
                                  "VTPU_DISABLE"],
                         ids=["unmanaged", "disabled"])
def test_outside_a_managed_container_the_hook_does_nothing(shim_install,
                                                           tmp_path, drop):
    envs = answer(shim_install, tmp_path, {"vtpu.dev/oversubscribe": "true"})
    if drop == "VTPU_DISABLE":
        envs["VTPU_DISABLE"] = "1"
    else:
        del envs[drop]
    res = pod_process(shim_install, tmp_path, envs)
    assert res.returncode == 0, res.stderr
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert not got["installed"] and not got["torch"], got


def test_a_process_that_never_imports_the_port_gets_nothing(shim_install,
                                                            tmp_path):
    """In a managed container the hook waits for the port's shim: a
    process that never imports the port loads none of it, nor torch."""
    envs = answer(shim_install, tmp_path, {"vtpu.dev/oversubscribe": "true"})
    res = pod_process(shim_install, tmp_path, envs, code=(
        "import json, sys\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "                        if m.startswith(('k8s_vgpu', 'torch')))))\n"))
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []
