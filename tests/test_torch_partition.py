"""The port's card partitions (``deviceplugin/partition.py``) against the
JAX package's, case for case with tests/test_partition.py.

The JAX package runs on v5p inventories (dual-core chips, split into two
TensorCore partitions of half the HBM each).  The port runs on H100
inventories whose designated cards have MIG on with two equal MIG devices
of the JAX share's MiB each; the other cards have MIG off.  The results
are combinatorial, so they are compared exactly, under this name map:

- chip ``chip<i>`` -> card ``chip<i>`` (the same UUIDs);
- partition ``chip<i>/core<k>`` -> the k-th MIG device ``MIG-chip<i>-<k>``;
- resource ``google.com/tpu-1c.<m>gb`` -> ``nvidia.com/mig-<flavor>``
  (NVIDIA's profile of the MIG device, ``3g.<gb>gb``), and the main
  resource ``google.com/tpu`` -> ``nvidia.com/gpu``;
- the env and mounts under tests/test_torch_deviceplugin.py's table.

Three answers differ by design, and one guard has no JAX case; each has
its own test below, with its reason.
"""

import dataclasses
import hashlib
import json
import os
import threading
from concurrent import futures

import grpc
import pytest

from k8s_vgpu_scheduler_tpu.api import deviceplugin_pb2 as jpb
from k8s_vgpu_scheduler_tpu.cmd import device_plugin as jcmd
from k8s_vgpu_scheduler_tpu.deviceplugin import partition as jpart
from k8s_vgpu_scheduler_tpu.deviceplugin import register as jregister
from k8s_vgpu_scheduler_tpu.tpulib import types as jtypes
from k8s_vgpu_scheduler_tpu.util.config import Config as JConfig
from k8s_vgpu_scheduler_tpu_torch.api import deviceplugin_pb2 as tpb
from k8s_vgpu_scheduler_tpu_torch.api.kubelet import (
    DevicePluginStub, add_registration_service)
from k8s_vgpu_scheduler_tpu_torch.cmd import device_plugin as tcmd
from k8s_vgpu_scheduler_tpu_torch.deviceplugin import partition as tpart
from k8s_vgpu_scheduler_tpu_torch.deviceplugin import register as tregister
from k8s_vgpu_scheduler_tpu_torch.tpulib import types as ttypes
from k8s_vgpu_scheduler_tpu_torch.util.config import Config as TConfig
from tests.test_torch_deviceplugin import PATHS, as_port_envs

N = 4
SLICES = 3


def j_inventory(generation="v5p", hbm=95 * 1024, unhealthy=()):
    """tests/test_partition.py's inventory: four chips on a (2, 2, 1)
    mesh, ``unhealthy`` by index."""
    mesh = (2, 2, 1) if generation == "v5p" else (2, 2)
    coords = [(0, 0, 0), (0, 1, 0), (1, 0, 0), (1, 1, 0)] \
        if generation == "v5p" else [(0, 0), (0, 1), (1, 0), (1, 1)]
    return jtypes.NodeInventory(
        chips=[jtypes.ChipInfo(index=i, uuid=f"chip{i}",
                               type=f"TPU-{generation}", hbm_mib=hbm,
                               coords=coords[i], healthy=i not in unhealthy)
               for i in range(N)],
        topology=jtypes.TopologyDesc(generation=generation, mesh=mesh))


def t_inventory(hbm=95 * 1024, mig=range(N), unhealthy=(), share=None):
    """Four H100s; the cards of ``mig`` have MIG on with two MIG devices
    of ``share`` MiB each (the JAX share, half of ``hbm``)."""
    share = hbm // 2 if share is None else share
    return ttypes.NodeInventory(
        chips=[ttypes.ChipInfo(
            index=i, uuid=f"chip{i}", type="NVIDIA-h100", hbm_mib=hbm,
            coords=(i,), healthy=i not in unhealthy, mig_enabled=i in mig,
            mig=tuple(ttypes.MigDevice(
                uuid=f"MIG-chip{i}-{k}", slices=SLICES,
                compute_slices=SLICES, memory_mib=share, hbm_mib=share)
                for k in range(2)) if i in mig else ())
            for i in range(N)],
        topology=ttypes.TopologyDesc(generation="h100", mesh=(N,)))


def to_port_id(jid: str) -> str:
    chip, core = jid.split("/core")
    return f"MIG-{chip}-{core}"


def to_port_resource(name: str, hbm=95 * 1024) -> str:
    if name == "google.com/tpu":
        return "nvidia.com/gpu"
    share = hbm // 2
    assert name == f"google.com/tpu-1c.{share // 1024}gb"
    return f"nvidia.com/mig-{SLICES}g.{-(-share // 1024)}gb"


def j_parts(parts):
    return [(to_port_id(p.uuid), p.chip_uuid, p.chip_index, p.core,
             p.hbm_mib, p.healthy) for p in parts]


def t_parts(parts):
    return [(p.uuid, p.chip_uuid, p.chip_index, p.core, p.hbm_mib,
             p.healthy) for p in parts]


def cfgs(**kw):
    return JConfig(**kw), TConfig(**kw)


# -- enumeration ----------------------------------------------------------------
def test_enumeration_splits_each_card_like_the_dual_core_chip():
    j = jpart.enumerate_partitions(j_inventory())
    t = tpart.enumerate_partitions(t_inventory())
    assert len(t) == 8 and t_parts(t) == j_parts(j)
    assert t[0].uuid == "MIG-chip0-0" and t[0].hbm_mib == 95 * 1024 // 2
    assert "nvidia.com/mig-" + t[0].resource_suffix == to_port_resource(
        "google.com/tpu-" + j[0].resource_suffix)


def test_mig_off_is_the_single_core_generation():
    assert jpart.enumerate_partitions(j_inventory("v5e")) == []
    assert tpart.enumerate_partitions(t_inventory(mig=())) == []


def test_an_unhealthy_card_makes_its_partitions_unhealthy():
    j = jpart.enumerate_partitions(j_inventory(unhealthy=[1]))
    t = tpart.enumerate_partitions(t_inventory(unhealthy=[1]))
    assert t_parts(t) == j_parts(j)
    assert {p.uuid for p in t if not p.healthy} == {"MIG-chip1-0",
                                                    "MIG-chip1-1"}


# -- strategies -----------------------------------------------------------------
def test_none_yields_nothing():
    jc, tc = cfgs()
    assert jpart.get_partition_plugins("none", None, j_inventory(), jc,
                                       "/tmp") == []
    assert tpart.get_partition_plugins("none", t_inventory(), tc,
                                       "/tmp") == []


def test_single_replaces_the_main_resource(tmp_path):
    jc, tc = cfgs()
    [jp] = jpart.get_partition_plugins("single", None, j_inventory(), jc,
                                       str(tmp_path))
    [tp] = tpart.get_partition_plugins("single", t_inventory(), tc,
                                       str(tmp_path))
    assert tp.resource_name == to_port_resource(jp.resource_name)
    assert sorted(tp.partitions) == sorted(map(to_port_id, jp.partitions))
    assert os.path.basename(tp.socket_path) == "vgpu-single.sock"


def test_mixed_one_plugin_per_flavor(tmp_path):
    jc, tc = cfgs()
    j = jpart.get_partition_plugins("mixed", None, j_inventory(), jc,
                                    str(tmp_path))
    t = tpart.get_partition_plugins("mixed", t_inventory(), tc,
                                    str(tmp_path))
    assert [p.resource_name for p in t] == [
        to_port_resource(p.resource_name) for p in j]
    assert [os.path.basename(p.socket_path) for p in t] == [
        "vgpu-3g.48gb.sock"]


def test_mixed_without_mig_changes_nothing(tmp_path):
    """No partition plugin, and the whole-card view and the register
    request equal those under ``none``."""
    jc, tc = cfgs(partition_strategy="mixed")
    inv = t_inventory(mig=())
    assert jpart.get_partition_plugins("mixed", None, j_inventory("v5e"),
                                       jc, str(tmp_path)) == []
    assert tpart.get_partition_plugins("mixed", inv, tc,
                                       str(tmp_path)) == []
    assert tpart.whole_chip_view(inv) is inv
    none = TConfig()
    assert tregister.inventory_to_request("n", inv, tc) == \
        tregister.inventory_to_request("n", inv, none)


def test_health_flip_reflected_live(tmp_path):
    """DeviceCache mutates ChipInfo in place; partition advertising must
    follow, not freeze the startup snapshot."""
    jc, tc = cfgs()
    jinv, tinv = j_inventory(), t_inventory()
    [jp] = jpart.get_partition_plugins("mixed", None, jinv, jc,
                                       str(tmp_path))
    [tp] = tpart.get_partition_plugins("mixed", tinv, tc,
                                       str(tmp_path))
    assert all(d.health == "Healthy" for d in tp.api_devices())
    jinv.chips[0].healthy = False
    tinv.chips[0].healthy = False
    assert [(d.ID, d.health) for d in tp.api_devices()] == [
        (to_port_id(d.ID), d.health) for d in jp.api_devices()]
    assert {d.ID for d in tp.api_devices() if d.health == "Unhealthy"} == {
        "MIG-chip0-0", "MIG-chip0-1"}


def test_unknown_strategy_raises():
    jc, tc = cfgs()
    with pytest.raises(ValueError):
        jpart.get_partition_plugins("bogus", None, j_inventory(), jc, "/tmp")
    with pytest.raises(ValueError):
        tpart.get_partition_plugins("bogus", t_inventory(), tc, "/tmp")


# -- passthrough Allocate over real sockets --------------------------------------
HBM = 32 * 1024


def shim_dir(tmp_path):
    shim = tmp_path / "shim"
    shim.mkdir(exist_ok=True)
    (shim / "ld.so.preload").write_text("/usr/local/vgpu/libvgpu_cuda.so\n")
    return str(shim)


@pytest.fixture
def served(tmp_path):
    """Both packages' mixed plugins on the same node's shim install, each
    on its own unix socket."""
    kw = dict(shim_host_dir=shim_dir(tmp_path),
              cache_host_dir=str(tmp_path / "cache"))
    jc, tc = cfgs(**kw)
    [jp] = jpart.get_partition_plugins("mixed", None, j_inventory(hbm=HBM),
                                       jc, str(tmp_path / "j"))
    [tp] = tpart.get_partition_plugins("mixed", t_inventory(hbm=HBM),
                                       tc, str(tmp_path / "t"))
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jp.serve()
    tp.serve()
    jch = grpc.insecure_channel(f"unix://{jp.socket_path}")
    tch = grpc.insecure_channel(f"unix://{tp.socket_path}")
    yield (jp, jch), (tp, tch)
    jch.close()
    tch.close()
    jp.stop()
    tp.stop()


def call(ch, pb, method, req_cls, resp_cls, req):
    fn = ch.unary_unary(f"/v1beta1.DevicePlugin/{method}",
                        request_serializer=req_cls.SerializeToString,
                        response_deserializer=resp_cls.FromString)
    return fn(req, timeout=10)


def allocate(ch, pb, ids):
    resp = call(ch, pb, "Allocate", pb.AllocateRequest, pb.AllocateResponse,
                pb.AllocateRequest(container_requests=[
                    pb.ContainerAllocateRequest(devicesIDs=ids)]))
    r = resp.container_responses[0]
    return dict(r.envs), [(m.container_path, m.host_path, m.read_only)
                          for m in r.mounts]


def region_key(ids) -> str:
    return "part-" + hashlib.sha1(",".join(sorted(ids)).encode()
                                  ).hexdigest()[:12]


def test_single_partition_allocate_equals_the_jax_answer(served, tmp_path):
    """One partition: the JAX answer under the env table, where the
    visible device is the MIG device's UUID, not its card's (difference
    1), and no SM limit is set (difference 2); the region dir is keyed by
    the granted set, and the mounts are the JAX plugin's."""
    (_, jch), (_, tch) = served
    jenv, jmounts = allocate(jch, jpb, ["chip1/core0"])
    tenv, tmounts = allocate(tch, tpb, ["MIG-chip1-0"])
    want = as_port_envs(jenv)
    assert want.pop("CUDA_DEVICE_SM_LIMIT") == "50"
    assert want["NVIDIA_VISIBLE_DEVICES"] == "chip1"
    want["NVIDIA_VISIBLE_DEVICES"] = "MIG-chip1-0"
    assert tenv == want
    assert tenv["CUDA_DEVICE_MEMORY_LIMIT_0"] == str(HBM // 2)
    cache = str(tmp_path / "cache")
    assert [(PATHS.get(c, c),
             h.replace(region_key(["chip1/core0"]),
                       region_key(["MIG-chip1-0"])), ro)
            for c, h, ro in jmounts] == tmounts
    assert (tmp_path / "cache" / region_key(["MIG-chip1-0"])).is_dir()
    assert ("/tmp/vgpu", os.path.join(cache, region_key(["MIG-chip1-0"])),
            False) in tmounts


def test_memory_limits_are_per_mig_device(served):
    """Difference 1.  The JAX plugin sums the cores granted on one chip
    into the limit of that chip, because its shim maps MEMORY_LIMIT_<i> to
    the i-th visible chip.  Each MIG device is a CUDA device of its own, so
    the port gives each granted instance its own limit, in the order of
    NVIDIA_VISIBLE_DEVICES: the same MiB in all, split per device."""
    (_, jch), (_, tch) = served
    jenv, _ = allocate(jch, jpb, ["chip2/core0", "chip2/core1"])
    tenv, _ = allocate(tch, tpb, ["MIG-chip2-0", "MIG-chip2-1"])
    assert jenv["TPU_DEVICE_MEMORY_LIMIT_0"] == str(HBM)
    assert "TPU_DEVICE_MEMORY_LIMIT_1" not in jenv
    assert jenv["TPU_DEVICE_CORE_LIMIT"] == "100"
    assert tenv["NVIDIA_VISIBLE_DEVICES"] == "MIG-chip2-0,MIG-chip2-1"
    assert [tenv[f"CUDA_DEVICE_MEMORY_LIMIT_{i}"] for i in range(2)] == [
        str(HBM // 2)] * 2
    assert "CUDA_DEVICE_MEMORY_LIMIT_2" not in tenv
    assert "CUDA_DEVICE_SM_LIMIT" not in tenv


@pytest.mark.parametrize("disable", [False, True])
def test_no_sm_limit_on_a_mig_device(tmp_path, disable):
    """Difference 2, with ``disable_core_limit``.  The JAX plugin caps a
    partition at its share of the chip's cores (50 for one of two), unless
    the core limit is disabled.  A MIG device already is its share of the
    card's SMs, in hardware; a duty cap on top would cut its own SMs by
    the same factor again.  So the port sets none, either way."""
    jc, tc = cfgs(disable_core_limit=disable,
                  cache_host_dir=str(tmp_path / "cache"))
    [jp] = jpart.get_partition_plugins("mixed", None, j_inventory(hbm=HBM),
                                       jc, str(tmp_path))
    [tp] = tpart.get_partition_plugins("mixed", t_inventory(hbm=HBM),
                                       tc, str(tmp_path))
    jp.serve()
    tp.serve()
    try:
        with grpc.insecure_channel(f"unix://{jp.socket_path}") as jch, \
                grpc.insecure_channel(f"unix://{tp.socket_path}") as tch:
            jenv, _ = allocate(jch, jpb, ["chip0/core0"])
            tenv, _ = allocate(tch, tpb, ["MIG-chip0-0"])
    finally:
        jp.stop()
        tp.stop()
    assert ("TPU_DEVICE_CORE_LIMIT" in jenv) == (not disable)
    assert "CUDA_DEVICE_SM_LIMIT" not in tenv


def test_allocate_of_an_unknown_id_is_invalid_argument(served):
    (_, jch), (_, tch) = served
    codes = []
    for ch, pb, vid in ((jch, jpb, "nope/core9"), (tch, tpb, "MIG-nope")):
        with pytest.raises(grpc.RpcError) as e:
            allocate(ch, pb, [vid])
        codes.append(e.value.code())
    assert codes == [grpc.StatusCode.INVALID_ARGUMENT] * 2


def test_list_and_watch_serves_the_partitions(served):
    (_, jch), (_, tch) = served
    got = []
    for ch, pb in ((jch, jpb), (tch, tpb)):
        fn = ch.unary_stream(
            "/v1beta1.DevicePlugin/ListAndWatch",
            request_serializer=pb.Empty.SerializeToString,
            response_deserializer=pb.ListAndWatchResponse.FromString)
        stream = fn(pb.Empty(), timeout=10)
        got.append([(d.ID, d.health) for d in next(iter(stream)).devices])
        stream.cancel()
    assert got[1] == [(to_port_id(i), h) for i, h in got[0]]
    assert len(got[1]) == 8


def test_preferred_allocation_packs_one_card(served):
    (_, jch), (_, tch) = served
    avail = ["chip0/core0", "chip1/core0", "chip1/core1", "chip3/core1"]
    got = []
    for ch, pb, ids in ((jch, jpb, avail),
                        (tch, tpb, [to_port_id(i) for i in avail])):
        resp = call(ch, pb, "GetPreferredAllocation",
                    pb.PreferredAllocationRequest,
                    pb.PreferredAllocationResponse,
                    pb.PreferredAllocationRequest(container_requests=[
                        pb.ContainerPreferredAllocationRequest(
                            available_deviceIDs=ids, allocation_size=2)]))
        got.append(list(resp.container_responses[0].deviceIDs))
    assert got[1] == [to_port_id(i) for i in got[0]] == [
        "MIG-chip1-0", "MIG-chip1-1"]


# -- no double booking -------------------------------------------------------------
def test_whole_chip_view_excludes_the_designated_cards():
    jc, tc = cfgs(partition_strategy="mixed",
                  partition_chips=("chip0", "chip2"))
    jinv, tinv = j_inventory(), t_inventory(mig=(0, 2))
    jview = jpart.whole_chip_view(jinv, jc)
    tview = tpart.whole_chip_view(tinv)
    assert [c.uuid for c in tview.chips] == [c.uuid for c in jview.chips] \
        == ["chip1", "chip3"]
    tinv.chips[1].healthy = False  # shared objects: the flip shows
    assert not tview.chips[0].healthy


def test_the_view_excludes_every_card_by_default():
    jc, tc = cfgs(partition_strategy="mixed")
    assert jpart.whole_chip_view(j_inventory(), jc).chips == []
    assert tpart.whole_chip_view(t_inventory()).chips == []


def test_the_view_keeps_every_card_without_mig():
    jc, tc = cfgs(partition_strategy="mixed")
    assert len(jpart.whole_chip_view(j_inventory("v5e"), jc).chips) == 4
    assert len(tpart.whole_chip_view(t_inventory(mig=())).chips) == 4


def test_the_register_stream_excludes_the_designated_cards():
    jc, tc = cfgs(partition_strategy="mixed", partition_chips=("chip0",))
    jreq = jregister.inventory_to_request("n", j_inventory(), jc)
    treq = tregister.inventory_to_request("n", t_inventory(mig=(0,)), tc)
    assert [d.id for d in treq.devices] == [d.id for d in jreq.devices] == [
        "chip1", "chip2", "chip3"]
    assert [d["id"] for d in tregister.advertised_devices(
        t_inventory(mig=(0,)), tc)] == ["chip1", "chip2", "chip3"]


def test_the_partition_plugin_respects_the_designation(tmp_path):
    jc, tc = cfgs(partition_strategy="mixed", partition_chips=("chip0",))
    [jp] = jpart.get_partition_plugins("mixed", None, j_inventory(), jc,
                                       str(tmp_path))
    [tp] = tpart.get_partition_plugins("mixed", t_inventory(), tc,
                                       str(tmp_path))
    assert sorted(tp.partitions) == sorted(map(to_port_id, jp.partitions)) \
        == ["MIG-chip0-0", "MIG-chip0-1"]


@pytest.mark.parametrize("strategy,chips", [
    ("none", ()), ("mixed", ("chip0",)), ("single", ("chip0",))])
def test_a_mig_card_is_never_in_the_whole_card_view(strategy, chips):
    """Difference 3.  The JAX view returns every chip under ``none``,
    because a TPU chip can still run whole.  An H100 in MIG mode cannot
    run a CUDA context on the parent card, so advertising it whole would
    give a pod a card it cannot use: the double booking the view exists
    to prevent.  So a MIG card is out of the whole-card view under every
    strategy, and one outside ``--partition-chips`` is in neither view."""
    jc, tc = cfgs(partition_strategy=strategy, partition_chips=chips)
    jinv, tinv = j_inventory(), t_inventory(mig=(0, 1))
    if strategy == "none":
        assert len(jpart.whole_chip_view(jinv, jc).chips) == 4
    assert [c.uuid for c in tpart.whole_chip_view(tinv).chips] == [
        "chip2", "chip3"]
    served = {p.chip_uuid for p in tpart.enumerate_partitions(tinv, tc)}
    outside = tpart.outside_both_views(tinv, tc)
    assert served | set(outside) == {"chip0", "chip1"}
    assert outside == (["chip0", "chip1"] if strategy == "none"
                       else ["chip1"])


def test_single_refuses_more_than_one_flavor():
    """The one-flavor guard (no JAX case: each TPU generation has one
    flavor).  Under ``single`` every MIG device is served as one resource,
    ``nvidia.com/gpu``; a node with 1g.10gb and 3g.40gb devices would let
    kubelet give a pod that asked for one unit either, so the agent
    refuses to start, as it refuses a subset that strands cards."""
    inv = t_inventory()
    inv.chips[1].mig = tuple(dataclasses.replace(
        m, slices=1, compute_slices=1, memory_mib=9856, hbm_mib=9856)
        for m in inv.chips[1].mig)
    why = tpart.single_refusal(inv, TConfig(partition_strategy="single"))
    assert why.startswith("--partition-strategy=single with MIG devices of "
                          "2 flavors ['1g.10gb', '3g.48gb']")
    assert tpart.single_refusal(inv, TConfig(partition_strategy="mixed")) \
        is None


def test_single_refuses_a_card_without_mig():
    """Under ``single`` the whole-card plugin does not serve, so a card
    with MIG off would be advertised by no plugin (on a TPU node every
    chip of the generation partitions, so the JAX agent never meets it)."""
    why = tpart.single_refusal(t_inventory(mig=(0, 1, 2)),
                               TConfig(partition_strategy="single"))
    assert "strand cards with MIG off ['chip3']" in why
    assert tpart.single_refusal(t_inventory(),
                                TConfig(partition_strategy="single")) is None


# -- the entry points ----------------------------------------------------------------
def fixture_file(tmp_path, mig=range(N), name="fx.json", share=48640):
    fx = {"generation": "h100", "mesh": [N], "hbm_mib": 81079,
          "chips": [{"coords": [i], "uuid": f"chip{i}",
                     **({"mig": [{"slices": SLICES, "mib": share,
                                  "uuid": f"MIG-chip{i}-{k}"}
                                 for k in range(2)]} if i in mig else {})}
                    for i in range(N)]}
    path = tmp_path / name
    path.write_text(json.dumps(fx))
    return path, fx


def agent_args(tmp_path, *extra):
    return ["--fake-kube", "--node-name", "n", "--socket-dir", str(tmp_path),
            "--shim-dir", str(tmp_path / "shim"), "--cache-dir",
            str(tmp_path / "cache"), "--scheduler-endpoint", "127.0.0.1:1",
            "--config-file", str(tmp_path / "none.json"), *extra]


def test_single_with_a_subset_is_refused_in_the_jax_words(tmp_path,
                                                          monkeypatch):
    """Both entry points exit with the stranded-chip message, the chips
    named alike."""
    jfx = {"generation": "v5p", "mesh": [2, 2, 1], "hbm_mib": 95 * 1024,
           "chips": [{"coords": list(c), "uuid": f"chip{i}"}
                     for i, c in enumerate([(0, 0, 0), (0, 1, 0), (1, 0, 0),
                                            (1, 1, 0)])]}
    (tmp_path / "j.json").write_text(json.dumps(jfx))
    tpath, _ = fixture_file(tmp_path)
    msgs = []
    for cmd, path in ((jcmd, tmp_path / "j.json"), (tcmd, tpath)):
        monkeypatch.setenv("VTPU_MOCK_JSON", str(path))
        with pytest.raises(SystemExit) as e:
            cmd.main(agent_args(tmp_path, "--partition-strategy", "single",
                                "--partition-chips", "chip0"))
        msgs.append(str(e.value.code))
    assert msgs[0] == msgs[1]
    assert "would strand chips ['chip1', 'chip2', 'chip3']" in msgs[1]


class FakeKubelet:
    """kubelet's Registration service on <dir>/kubelet.sock."""

    def __init__(self, socket_dir) -> None:
        self.received = []
        self.server = grpc.server(futures.ThreadPoolExecutor(max_workers=2))

        def handle(request, context):
            self.received.append(request)
            return tpb.Empty()

        add_registration_service(self.server, handle)
        self.server.add_insecure_port(
            f"unix://{os.path.join(str(socket_dir), 'kubelet.sock')}")
        self.server.start()

    def stop(self) -> None:
        self.server.stop(grace=1)


def devices_on(sock: str) -> list:
    with grpc.insecure_channel(f"unix://{sock}") as ch:
        stream = DevicePluginStub(ch).ListAndWatch(tpb.Empty(), timeout=10)
        it = iter(stream)
        out = [(d.ID, d.health) for d in next(it).devices]
        stream.cancel()
    return out


@pytest.mark.parametrize("strategy", ["mixed", "single"])
def test_the_entry_point_serves_and_registers_every_plugin(
        tmp_path, monkeypatch, strategy):
    """vgpu-device-plugin under a strategy, on the mock: every plugin
    registers with kubelet on its own socket and serves its devices.
    Under mixed the whole-card plugin serves the card without MIG beside
    the MIG plugin; under single (every card with MIG) the MIG devices
    alone, under nvidia.com/gpu.  A health flip reaches the MIG plugin's
    stream."""
    mig = range(N) if strategy == "single" else (0, 1, 2)
    path, fx = fixture_file(tmp_path, mig=mig)
    monkeypatch.setenv("VTPU_MOCK_JSON", str(path))
    kubelet = FakeKubelet(tmp_path)
    seen = {}
    mig_sock = str(tmp_path / ("vgpu-single.sock" if strategy == "single"
                               else "vgpu-3g.48gb.sock"))

    def stop(_):
        seen["registered"] = sorted((r.resource_name, r.endpoint)
                                    for r in kubelet.received)
        seen["mig"] = devices_on(mig_sock)
        seen["whole"] = (devices_on(str(tmp_path / "vgpu.sock"))
                         if os.path.exists(tmp_path / "vgpu.sock") else None)
        fx["chips"][0]["healthy"] = False
        path.write_text(json.dumps(fx))
        waited = threading.Event()
        for _ in range(200):
            seen["after"] = devices_on(mig_sock)
            if ("MIG-chip0-0", "Unhealthy") in seen["after"] \
                    or waited.wait(0.02):
                break
        raise KeyboardInterrupt

    monkeypatch.setattr(tcmd.time, "sleep", stop)
    try:
        tcmd.main(agent_args(tmp_path, "--partition-strategy", strategy,
                             "--health-poll-seconds", "0.02"))
    finally:
        kubelet.stop()
    migs = [(f"MIG-chip{i}-{k}", "Healthy") for i in mig for k in range(2)]
    assert seen["mig"] == migs
    if strategy == "single":
        assert seen["registered"] == [("nvidia.com/gpu", "vgpu-single.sock")]
        assert seen["whole"] is None
    else:
        assert seen["registered"] == [
            ("nvidia.com/gpu", "vgpu.sock"),
            ("nvidia.com/mig-3g.48gb", "vgpu-3g.48gb.sock")]
        assert seen["whole"] == [(f"chip3-{k}", "Healthy") for k in range(10)]
    assert ("MIG-chip0-0", "Unhealthy") in seen["after"]
    assert not os.path.exists(mig_sock)  # stopped


def test_single_with_two_flavors_exits_at_start(tmp_path, monkeypatch):
    path, fx = fixture_file(tmp_path)
    fx["chips"][3]["mig"] = [{"slices": 1, "mib": 9856}] * 7
    path.write_text(json.dumps(fx))
    monkeypatch.setenv("VTPU_MOCK_JSON", str(path))
    with pytest.raises(SystemExit) as e:
        tcmd.main(agent_args(tmp_path, "--partition-strategy", "single"))
    assert "MIG devices of 2 flavors ['1g.10gb', '3g.48gb']" in str(
        e.value.code)
    assert not os.path.exists(tmp_path / "vgpu-single.sock")
