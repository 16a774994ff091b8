"""The port's NVML binding (``tpulib/nvml.py``) and ``NvmlBackend`` over the
mock NVML (``csrc/vgpu/mock_nvml.cc``, built with g++ as
``libnvidia-ml.so.1``), against the JAX package's ``MockBackend`` and the
port's own.

The mock reads the MockBackend fixture its ``$MOCK_NVML_JSON`` names, so
``NvmlBackend`` over it must give the inventory ``MockBackend`` gives for
the same file (the board is NVML's name of the card), and what the JAX
backend gives but for the device kind.  The fabric (coordinates, mesh,
wraparound) comes from the mock's NVLink P2P answers (its ``"fabric"``
key), so it is compared where the fixture states one, or has one card;
elsewhere the node has none.  This runs the binding's real
``ctypes`` signatures and structs: a lost card answers
``NVML_ERROR_GPU_IS_LOST`` and ``ListAndWatch`` then pushes ``Unhealthy``;
a critical Xid marks its card; calls the driver refuses as not supported
leave their fields None; the advertised memory is what CUDA can get.
"""

import ctypes
import dataclasses
import json

import grpc
import pytest

from k8s_vgpu_scheduler_tpu import tpulib as jtpulib
from k8s_vgpu_scheduler_tpu_torch.api import deviceplugin_pb2 as tpb
from k8s_vgpu_scheduler_tpu_torch.api.kubelet import DevicePluginStub
from k8s_vgpu_scheduler_tpu_torch.deviceplugin import (DeviceCache,
                                                        GpuDevicePlugin)
from k8s_vgpu_scheduler_tpu_torch.k8s import FakeKube
from k8s_vgpu_scheduler_tpu_torch.ops import _kernels
from k8s_vgpu_scheduler_tpu_torch.tpulib import backend, nvml
from k8s_vgpu_scheduler_tpu_torch.util.config import Config

FIXTURES = {
    "h100_node": {"generation": "h100", "mesh": [8], "hbm_mib": 81079},
    "explicit_chips": {
        "generation": "h100", "mesh": [3], "hbm_mib": 81079,
        "chips": [{"coords": [0], "uuid": "GPU-a", "serial": "1654"},
                  {"coords": [1], "uuid": "GPU-b", "hbm_mib": 40000},
                  {"coords": [2], "type": "NVIDIA-h100"}]},
    "a100_pair": {"generation": "a100", "mesh": [2], "hbm_mib": 40326},
    "one_card": {"generation": "h100", "mesh": [1]},
    "hgx_nvswitch": {"generation": "h100", "mesh": [8], "wraparound": [True],
                     "hbm_mib": 81079, "fabric": "nvswitch"},
    "bridged_pair": {"generation": "h100", "mesh": [2],
                     "wraparound": [False], "hbm_mib": 81079,
                     "fabric": "pairs"},
}


def states_fabric(fx) -> bool:
    return "fabric" in fx or fx["mesh"] == [1]


@pytest.fixture(scope="module")
def library():
    return str(_kernels.build_mock_nvml())


@pytest.fixture
def fixture_file(tmp_path, monkeypatch):
    """Write a fixture and point the mock NVML at it."""
    path = tmp_path / "nvml.json"

    def write(fx):
        path.write_text(json.dumps(fx))
        monkeypatch.setenv("MOCK_NVML_JSON", str(path))
        return path
    monkeypatch.delenv("MOCK_NVML_NOT_SUPPORTED", raising=False)
    return write


def without_board(inv, fabric=True):
    """The inventory but the boards; without the fabric (coordinates, mesh
    and wraparound) where ``fabric`` is false."""
    drop = {"board"} if fabric else {"board", "coords"}
    topo = dataclasses.asdict(inv.topology)
    if not fabric:
        topo = {"generation": topo["generation"]}
    return ([{k: v for k, v in dataclasses.asdict(c).items() if k not in drop}
             for c in inv.chips], topo)


def no_fabric(inv) -> bool:
    return inv.topology.mesh == (len(inv.chips),) \
        and all(c.coords == () for c in inv.chips)


@pytest.mark.parametrize("name", list(FIXTURES))
def test_nvml_over_the_mock_equals_mock_backend(library, fixture_file, name):
    path = fixture_file(FIXTURES[name])
    b = backend.NvmlBackend(library)
    try:
        got = b.inventory()
    finally:
        b.close()
    want = backend.MockBackend(path=str(path)).inventory()
    fabric = states_fabric(FIXTURES[name])
    assert without_board(got, fabric) == without_board(want, fabric)
    assert fabric or no_fabric(got)
    assert {c.board for c in got.chips} == {
        "NVIDIA " + c.type.split("-", 1)[1] for c in want.chips}


@pytest.mark.parametrize("name", [n for n, fx in FIXTURES.items()
                                  if "hbm_mib" in fx])
def test_nvml_over_the_mock_equals_the_jax_backend(library, fixture_file,
                                                   name):
    """The JAX backend's inventory of the same file, its device kind
    ("TPU-<gen>", "TPU-<gen>-mock-<i>") written as the port's (a fixture
    without a memory size defaults to a TPU's there, an H100's here), and
    no MIG device on any card (a field the JAX ChipInfo has not)."""
    path = fixture_file(FIXTURES[name])
    b = backend.NvmlBackend(library)
    try:
        got = b.inventory()
    finally:
        b.close()
    j = jtpulib.MockBackend(path=str(path)).inventory()
    gen = j.topology.generation
    fabric = states_fabric(FIXTURES[name])
    want = []
    for c in j.chips:
        d = {k: v for k, v in dataclasses.asdict(c).items() if k != "board"}
        d["type"] = d["type"].replace("TPU-", "NVIDIA-")
        d["mig_enabled"], d["mig"] = False, ()
        if d["uuid"] == f"TPU-{gen}-mock-{c.index}":
            d["uuid"] = f"GPU-{gen}-mock-{c.index}"
        if not fabric:
            del d["coords"]
        want.append(d)
    topo = dataclasses.asdict(j.topology)
    if not fabric:
        topo = {"generation": topo["generation"]}
    assert without_board(got, fabric) == (want, topo)
    assert fabric or no_fabric(got)


def test_cards_read_every_field(library, fixture_file):
    fixture_file({"generation": "h100", "mesh": [2], "hbm_mib": 81079,
                  "reserved_mib": 480})
    b = backend.NvmlBackend(library)
    try:
        cards = b.cards()
    finally:
        b.close()
    assert cards[1] == dict(
        index=1, uuid="GPU-h100-mock-1", name="NVIDIA h100",
        memory_total=81559 << 20, memory_free=81079 << 20,
        memory_used=480 << 20, not_supported=[], serial="SN0001",
        pci_bus_id="00000000:02:00.0", minor=1,
        memory_v2=dict(total=81559 << 20, reserved=480 << 20,
                       free=81079 << 20, used=0),
        mig=dict(mode=[nvml.MIG_DISABLE, nvml.MIG_DISABLE], devices=[]))


@pytest.mark.parametrize("refused,want_mib", [
    ("", 81079), ("nvmlDeviceGetMemoryInfo_v2", 81559),
    ("nvmlDeviceGetPciInfo_v3,nvmlDeviceGetSerial", 81079)],
    ids=["v2", "no_v2", "refused_calls"])
def test_advertised_memory_is_what_cuda_can_get(library, fixture_file,
                                                monkeypatch, refused,
                                                want_mib):
    """A card whose driver reserves 480 MiB of 81,559 (an H100 80GB HBM3):
    v2's total less the reserve is advertised, NVML's total where v2 is
    refused; a refused call leaves its field None and names itself."""
    fixture_file({"generation": "h100", "mesh": [1], "hbm_mib": 81079,
                  "reserved_mib": 480})
    monkeypatch.setenv("MOCK_NVML_NOT_SUPPORTED", refused)
    b = backend.NvmlBackend(library)
    try:
        inv, card = b.inventory(), b.cards()[0]
    finally:
        b.close()
    assert inv.chips[0].hbm_mib == want_mib
    names = [n for n in refused.split(",") if n]
    assert card["not_supported"] == sorted(names, key=[
        "nvmlDeviceGetSerial", "nvmlDeviceGetPciInfo_v3",
        "nvmlDeviceGetMinorNumber", "nvmlDeviceGetMemoryInfo_v2"].index)
    field = {"nvmlDeviceGetMemoryInfo_v2": "memory_v2",
             "nvmlDeviceGetPciInfo_v3": "pci_bus_id",
             "nvmlDeviceGetSerial": "serial"}
    assert all(card[field[n]] is None for n in names)
    if "nvmlDeviceGetSerial" in names:
        assert inv.chips[0].serial == ""


def test_a_refused_identity_query_raises(library, fixture_file, monkeypatch):
    fixture_file(FIXTURES["one_card"])
    monkeypatch.setenv("MOCK_NVML_NOT_SUPPORTED", "nvmlDeviceGetUUID")
    b = backend.NvmlBackend(library)
    try:
        with pytest.raises(nvml.NvmlError) as ei:
            b.inventory()
    finally:
        b.close()
    assert ei.value.code == nvml.ERROR_NOT_SUPPORTED
    assert ei.value.call == "nvmlDeviceGetUUID"
    assert "Not Supported" in str(ei.value)


def test_a_lost_card_is_unhealthy_and_comes_back(library, fixture_file):
    fx = json.loads(json.dumps(FIXTURES["explicit_chips"]))
    path = fixture_file(fx)
    b = backend.NvmlBackend(library)
    try:
        inv = b.inventory()
        assert not b.refresh_health(inv)
        fx["chips"][1]["healthy"] = False
        path.write_text(json.dumps(fx))
        with pytest.raises(nvml.NvmlError) as ei:
            b.nvml.handle(1)
        assert ei.value.code == nvml.ERROR_GPU_IS_LOST
        assert b.refresh_health(inv)
        assert [c.healthy for c in inv.chips] == [True, False, True]
        assert not b.refresh_health(inv)
        fx["chips"][1]["healthy"] = True
        path.write_text(json.dumps(fx))
        assert b.refresh_health(inv)
        assert all(c.healthy for c in inv.chips)
    finally:
        b.close()


@pytest.mark.parametrize("xid,marks", [(79, True), (48, True), (13, False),
                                       (31, False)])
def test_a_critical_xid_marks_its_card(library, fixture_file, xid, marks):
    """Xid 79 (fallen off the bus) and 48 (double-bit ECC) mark their card
    for good; 13 and 31 are an application's faults."""
    fx = json.loads(json.dumps(FIXTURES["explicit_chips"]))
    path = fixture_file(fx)
    b = backend.NvmlBackend(library)
    try:
        inv = b.inventory()
        assert b.events is not None and b.events.registered == [0, 1, 2]
        fx["chips"][2]["xid"] = xid
        path.write_text(json.dumps(fx))
        assert b.refresh_health(inv) == marks
        assert [c.healthy for c in inv.chips] == [True, True, not marks]
        assert not b.refresh_health(inv)  # one event, delivered once
        assert inv.chips[2].healthy == (not marks)
    finally:
        fx["chips"][2].pop("xid")
        path.write_text(json.dumps(fx))
        b.close()


def test_no_event_sets_is_recorded_not_raised(library, fixture_file,
                                              monkeypatch):
    fixture_file(FIXTURES["one_card"])
    monkeypatch.setenv("MOCK_NVML_NOT_SUPPORTED", "nvmlEventSetCreate")
    b = backend.NvmlBackend(library)
    try:
        inv = b.inventory()
        assert b.events is None and "nvmlEventSetCreate" in b.events_error
        assert not b.refresh_health(inv) and inv.chips[0].healthy
    finally:
        b.close()


def test_list_and_watch_pushes_unhealthy_from_nvml(library, fixture_file,
                                                   tmp_path):
    """A card lost under NVML reaches kubelet: the cache's poll flips it,
    the plugin's ListAndWatch stream (a real unix socket) pushes its
    virtual devices Unhealthy."""
    fx = json.loads(json.dumps(FIXTURES["explicit_chips"]))
    path = fixture_file(fx)
    b = backend.NvmlBackend(library)
    cache = DeviceCache(b, poll_seconds=60, heartbeat_seconds=0)
    plugin = GpuDevicePlugin(FakeKube(), cache.inventory,
                             Config(node_name="n", device_split_count=4),
                             socket_dir=str(tmp_path))
    cache.subscribe("plugin", lambda inv: plugin.notify_health_changed())
    plugin.serve()
    try:
        with grpc.insecure_channel(f"unix://{plugin.socket_path}") as ch:
            stream = DevicePluginStub(ch).ListAndWatch(tpb.Empty(),
                                                       timeout=10)
            it = iter(stream)
            assert {d.health for d in next(it).devices} == {"Healthy"}
            fx["chips"][0]["healthy"] = False
            path.write_text(json.dumps(fx))
            assert cache.poll_once()
            pushed = next(it).devices
            stream.cancel()
        assert sorted(d.ID for d in pushed if d.health == "Unhealthy") == \
            [f"GPU-a-{k}" for k in range(4)]
    finally:
        plugin.stop()
        b.close()


def test_structs_match_nvml_h():
    assert ctypes.sizeof(nvml.Memory) == 24
    assert ctypes.sizeof(nvml.MemoryV2) == 40
    assert nvml.MEMORY_V2_VERSION == 0x02000028
    assert ctypes.sizeof(nvml.PciInfo) == 68
    assert nvml.PciInfo.busId.offset == 36
    assert ctypes.sizeof(nvml.EventData) == 32
    for name in ("nvmlInit_v2", "nvmlDeviceGetCount_v2",
                 "nvmlDeviceGetHandleByIndex_v2"):
        assert name in nvml.SIGNATURES


def test_init_fails_without_a_fixture(library, monkeypatch):
    monkeypatch.delenv("MOCK_NVML_JSON", raising=False)
    with pytest.raises(nvml.NvmlError) as ei:
        nvml.Nvml(library)
    assert ei.value.call == "nvmlInit_v2"


def test_binding_raises_without_the_library():
    with pytest.raises(OSError):
        nvml.Nvml("libnvidia-ml-absent.so.1")


def test_detect_returns_nvml_without_the_mock_backend(library, fixture_file,
                                                      monkeypatch):
    fixture_file(FIXTURES["h100_node"])
    monkeypatch.delenv("VTPU_MOCK_JSON", raising=False)
    monkeypatch.setattr(nvml, "LIBRARY", library)
    b = backend.detect()
    try:
        assert isinstance(b, backend.NvmlBackend)
        assert len(b.inventory().chips) == 8
    finally:
        b.close()


def test_p2p_values_are_nvml_h_s():
    """``NVML_P2P_CAPS_INDEX_NVLINK`` and ``nvmlGpuP2PStatus_t`` as the
    nvml.h of the card machine's CUDA 12.8 toolkit defines them."""
    assert nvml.P2P_CAPS_INDEX_NVLINK == 2
    assert nvml.P2P_STATUS_OK == 0
    assert nvml.P2P_STATUS == {
        0: "OK", 1: "CHIPSET_NOT_SUPPORTED", 2: "GPU_NOT_SUPPORTED",
        3: "IOH_TOPOLOGY_NOT_SUPPORTED", 4: "DISABLED_BY_REGKEY",
        5: "NOT_SUPPORTED", 6: "UNKNOWN"}
    assert nvml.SIGNATURES["nvmlDeviceGetP2PStatus"][2] is ctypes.c_int


# fabric key, cards -> the wraparound and whether the cards have coords
# (the mesh is always one axis of the cards).
FABRICS = {
    "nvswitch_8": ("nvswitch", 8, (True,), True),
    "nvswitch_4": ("nvswitch", 4, (True,), True),
    "nvswitch_2": ("nvswitch", 2, (False,), True),
    "bridged_pair": ("pairs", 2, (False,), True),
    "pairs_4": ("pairs", 4, (), False),
    "pairs_8": ("pairs", 8, (), False),
    "pcie_4": ("pcie", 4, (), False),
    "pcie_2": ("pcie", 2, (), False),
    "absent_4": (None, 4, (), False),
    "one_card_nvswitch": ("nvswitch", 1, (), True),
    "one_card_pcie": ("pcie", 1, (), True),
    "one_card_absent": (None, 1, (), True),
}


@pytest.mark.parametrize("name", list(FABRICS))
def test_the_fabric_is_what_the_p2p_matrix_shows(library, fixture_file,
                                                 name):
    """A ring only where every pair reports NVLink OK; one card is (1,);
    anything else is no fabric: one axis of the cards and no card
    coordinates, which the scheduler registers as they are."""
    from k8s_vgpu_scheduler_tpu_torch.deviceplugin import inventory_to_request
    from k8s_vgpu_scheduler_tpu_torch.scheduler.core import \
        decode_register_request

    key, n, wrap, coords = FABRICS[name]
    fx = {"generation": "h100", "mesh": [n], "hbm_mib": 81079}
    if key:
        fx["fabric"] = key
    fixture_file(fx)
    b = backend.NvmlBackend(library)
    try:
        inv = b.inventory()
        fabric = b.last_fabric
    finally:
        b.close()
    assert (inv.topology.mesh, inv.topology.wraparound) == ((n,), wrap)
    assert [c.coords for c in inv.chips] == \
        [(i,) if coords else () for i in range(n)]
    assert inv.topology.generation == "h100"
    assert fabric["kind"] == ("single" if n == 1 else
                              "nvlink" if coords else "none")
    assert fabric["not_supported"] == (
        ["nvmlDeviceGetP2PStatus"] if key is None and n > 1 else [])
    if key is not None and n > 1:
        assert [link[:2] for link in fabric["links"]] == \
            [[i, j] for i in range(n) for j in range(i + 1, n)]
    info = decode_register_request(inventory_to_request("n", inv, Config()))
    assert (info.topology.mesh, info.topology.wrap()) == \
        ((n,), inv.topology.wrap())
    assert [d.coords for d in info.devices] == [c.coords for c in inv.chips]


def test_p2p_status_answers_per_pair_and_index(library, fixture_file):
    fixture_file({"generation": "h100", "mesh": [4], "fabric": "pairs"})
    n = nvml.Nvml(library)
    try:
        h = [n.handle(i) for i in range(4)]
        got = [[n.p2p_status(h[i], h[j]) for j in range(4)]
               for i in range(4)]
        with pytest.raises(nvml.NvmlError) as ei:
            n.p2p_status(h[0], h[1], nvml.P2P_CAPS_INDEX_NVLINK + 1)
    finally:
        n.shutdown()
    assert got == [[0, 0, 5, 5], [0, 0, 5, 5], [5, 5, 0, 0], [5, 5, 0, 0]]
    assert ei.value.code == nvml.ERROR_NOT_SUPPORTED


def test_a_refused_p2p_query_is_recorded_not_raised(library, fixture_file,
                                                    monkeypatch):
    fixture_file(FIXTURES["hgx_nvswitch"])
    monkeypatch.setenv("MOCK_NVML_NOT_SUPPORTED", "nvmlDeviceGetP2PStatus")
    b = backend.NvmlBackend(library)
    try:
        inv = b.inventory()
    finally:
        b.close()
    assert b.last_fabric == dict(links=[], kind="none",
                                 not_supported=["nvmlDeviceGetP2PStatus"])
    assert no_fabric(inv)


def test_a_failed_p2p_query_raises(library, fixture_file):
    """A lost card's P2P query is no refusal: the inventory raises."""
    fx = json.loads(json.dumps(FIXTURES["hgx_nvswitch"]))
    path = fixture_file(fx)
    b = backend.NvmlBackend(library)
    try:
        b.inventory()
        h = [b.nvml.handle(i) for i in range(2)]
        fx["chips"] = [{"coords": [i], "healthy": i != 1} for i in range(8)]
        path.write_text(json.dumps(fx))
        b.nvml.handle(0)  # the mock reads its fixture again
        with pytest.raises(nvml.NvmlError) as ei:
            b.nvml.p2p_status(h[0], h[1])
    finally:
        b.close()
    assert ei.value.code == nvml.ERROR_GPU_IS_LOST


@pytest.mark.parametrize("policy,reason", [
    ("guaranteed", "topology-unverifiable: guaranteed policy but chip "
                   "coords missing"),
    ("mesh", "topology-unverifiable: mesh declared but chip coords "
             "missing"),
    ("restricted", None), ("best-effort", None),
])
@pytest.mark.parametrize("key", ["pcie", "pairs", None],
                         ids=["pcie", "pairs", "absent"])
def test_a_node_without_a_fabric_is_held_to_it_end_to_end(
        library, fixture_file, key, policy, reason):
    """NVML over the mock, four cards without an all-pairs NVLink matrix,
    through the register stream into the port's scheduler: a 2-card pod
    that is guaranteed or declares a mesh is refused, any other gets two
    of the cards.  The plugin's allocator leaves kubelet to choose."""
    from k8s_vgpu_scheduler_tpu_torch.deviceplugin import (
        SliceAllocator, inventory_to_request)
    from k8s_vgpu_scheduler_tpu_torch.scheduler import Scheduler
    from k8s_vgpu_scheduler_tpu_torch.scheduler.core import \
        decode_register_request
    from k8s_vgpu_scheduler_tpu_torch.util import types as t

    fx = {"generation": "h100", "mesh": [4], "hbm_mib": 81079}
    if key:
        fx["fabric"] = key
    fixture_file(fx)
    b = backend.NvmlBackend(library)
    try:
        inv = b.inventory()
    finally:
        b.close()
    kube = FakeKube()
    s = Scheduler(kube, Config())
    s.observe_registration("n", decode_register_request(
        inventory_to_request("n", inv, Config())))
    anns = ({t.MESH_ANNOTATION: "2"} if policy == "mesh"
            else {"vtpu.dev/topology-policy": policy})
    p = {"metadata": {"name": "p", "namespace": "default", "uid": "uid-p",
                      "annotations": anns},
         "spec": {"containers": [{"name": "c", "resources": {"limits": {
             "nvidia.com/gpu": "2", "nvidia.com/gpumem": "1000",
             "nvidia.com/gpucores": "100"}}}]}}
    kube.create_pod(p)
    r = s.filter(p, ["n"])
    if reason is None:
        assert r.node == "n" and r.failed == {}
        ids = kube.get_pod("default", "p")["metadata"]["annotations"][
            t.ASSIGNED_IDS_ANNOTATION]
        assert len({c.uuid for c in inv.chips if c.uuid in ids}) == 2
    else:
        assert r.node is None and r.failed == {"n": reason}
    assert s.known_topologies() == []
    vids = [f"{c.uuid}-{k}" for c in inv.chips for k in range(2)]
    for allocator_policy in ("best-effort", "restricted", "guaranteed"):
        assert SliceAllocator(inv, allocator_policy).preferred(
            vids, [], 2) == []


# -- MIG ---------------------------------------------------------------------------
MIG_FIXTURE = {
    "generation": "h100", "mesh": [4], "hbm_mib": 81079,
    "chips": [
        {"coords": [0], "mig": [{"slices": 3, "mib": 40448}] * 2},
        {"coords": [1], "mig": [{"slices": 3, "mib": 40448,
                                 "uuid": "MIG-1a"}, None,
                                {"slices": 3, "mib": 40448,
                                 "uuid": "MIG-1c"}]},
        {"coords": [2], "mig": [{"slices": 1, "mib": 9984}] * 7},
        {"coords": [3]}]}


def test_mig_structs_and_values_are_nvml_h_s():
    """``nvmlDeviceAttributes_t`` (pinned by a static_assert in the mock
    too) and the MIG mode and NOT_FOUND values as the nvml.h of the card
    machine's CUDA 12.8 toolkit defines them."""
    assert ctypes.sizeof(nvml.DeviceAttributes) == 40
    assert nvml.DeviceAttributes.gpuInstanceSliceCount.offset == 24
    assert nvml.DeviceAttributes.memorySizeMB.offset == 32
    assert (nvml.MIG_DISABLE, nvml.MIG_ENABLE, nvml.ERROR_NOT_FOUND) == (
        0, 1, 6)
    assert nvml.SIGNATURES["nvmlDeviceGetMigMode"][1:] == (
        ctypes.POINTER(ctypes.c_uint),) * 2


def test_mig_devices_over_the_mock(library, fixture_file):
    """MIG off, two 3g.40gb, two in slots 0 and 2 with slot 1 empty
    (NVML_ERROR_NOT_FOUND, skipped), seven 1g.10gb."""
    fixture_file(MIG_FIXTURE)
    b = backend.NvmlBackend(library)
    try:
        cards = b.cards()
        h = b.nvml.handle(1)
        assert b.nvml.mig_handle(h, 1) is None
        with pytest.raises(nvml.NvmlError) as ei:
            b.nvml.attributes(h)  # a card's own handle
        assert ei.value.code == nvml.ERROR_NOT_SUPPORTED
        inv = b.inventory()
    finally:
        b.close()
    modes = [c["mig"]["mode"] for c in cards]
    assert modes == [[1, 1]] * 3 + [[0, 0]]
    assert [c.mig_enabled for c in inv.chips] == [True] * 3 + [False]
    assert [[d["slot"] for d in c["mig"]["devices"]] for c in cards] == [
        [0, 1], [0, 2], list(range(7)), []]
    assert cards[1]["mig"]["devices"][1] == dict(
        slot=2, uuid="MIG-1c", slices=3, compute_slices=3, memory_mib=40448,
        hbm_mib=40448)
    assert [[m.profile for m in c.mig] for c in inv.chips] == [
        ["3g.40gb"] * 2, ["3g.40gb"] * 2, ["1g.10gb"] * 7, []]
    assert inv.chips[0].mig[0].uuid == "MIG-h100-mock-0-0"


def test_nvml_and_the_fixture_backend_agree_on_mig(library, fixture_file):
    path = fixture_file(MIG_FIXTURE)
    b = backend.NvmlBackend(library)
    try:
        got = b.inventory()
    finally:
        b.close()
    want = backend.MockBackend(path=str(path)).inventory()
    assert without_board(got, False) == without_board(want, False)


def test_a_refused_mig_query_is_mig_off(library, fixture_file, monkeypatch):
    """A driver that refuses nvmlDeviceGetMigMode as not supported: the
    call is recorded, and the card has no MIG device."""
    fixture_file(MIG_FIXTURE)
    monkeypatch.setenv("MOCK_NVML_NOT_SUPPORTED", "nvmlDeviceGetMigMode")
    b = backend.NvmlBackend(library)
    try:
        cards = b.cards()
        inv = b.inventory()
    finally:
        b.close()
    assert all(c["mig"] is None
               and c["not_supported"] == ["nvmlDeviceGetMigMode"]
               for c in cards)
    assert all(c.mig == () and not c.mig_enabled for c in inv.chips)


# A card with MIG on and no MIG device yet (the state between
# `nvidia-smi -mig 1` and making instances), and a GPU instance of three
# slices holding a compute instance of one.
MIG_EDGE_FIXTURE = {
    "generation": "h100", "mesh": [3], "hbm_mib": 81079,
    "chips": [{"coords": [0], "mig": []},
              {"coords": [1], "mig": [{"slices": 3, "compute_slices": 1,
                                       "mib": 40448}]},
              {"coords": [2]}]}


def test_mig_on_with_no_device_and_a_smaller_compute_instance(
        library, fixture_file):
    """NVML answers MIG on for card 0 with every slot NOT_FOUND, and card
    1's compute instance names its profile ``1c.3g.40gb``; the fixture
    backend agrees."""
    path = fixture_file(MIG_EDGE_FIXTURE)
    b = backend.NvmlBackend(library)
    try:
        cards = b.cards()
        inv = b.inventory()
    finally:
        b.close()
    assert [c["mig"]["mode"] for c in cards] == [[1, 1], [1, 1], [0, 0]]
    assert cards[0]["mig"]["devices"] == []
    assert [(c.mig_enabled, [m.profile for m in c.mig])
            for c in inv.chips] == [(True, []), (True, ["1c.3g.40gb"]),
                                    (False, [])]
    want = backend.MockBackend(path=str(path)).inventory()
    assert without_board(inv, False) == without_board(want, False)


@pytest.mark.parametrize("strategy", ["none", "single", "mixed"])
def test_a_mig_card_with_no_device_is_in_neither_view(
        library, fixture_file, strategy):
    """A card with MIG on runs no CUDA context on the parent whether or
    not a MIG device was made yet, so it is never in the whole-card view
    (kubelet's plugin, the register stream); with no MIG device no
    partition plugin serves it either, and the agent names it at start."""
    from k8s_vgpu_scheduler_tpu_torch.deviceplugin import partition, register
    from k8s_vgpu_scheduler_tpu_torch.util.config import Config

    fixture_file(MIG_EDGE_FIXTURE)
    b = backend.NvmlBackend(library)
    try:
        inv = b.inventory()
    finally:
        b.close()
    cfg = Config(node_name="n", partition_strategy=strategy)
    whole = [c.uuid for c in partition.whole_chip_view(inv).chips]
    card0, card1, card2 = (c.uuid for c in inv.chips)
    assert whole == [card2]
    assert [d.id for d in register.inventory_to_request("n", inv, cfg)
            .devices] == [card2]
    assert {p.chip_uuid for p in partition.enumerate_partitions(
        inv, cfg)} == {card1}
    assert partition.outside_both_views(inv, cfg) == (
        [card0, card1] if strategy == "none" else [card0])
    why = partition.single_refusal(inv, cfg)
    if strategy == "single":  # card 2 alone, MIG off, is stranded
        assert f"strand cards with MIG off ['{card2}']" in why
    else:
        assert why is None


# The H100 80GB's MIG profiles, at sizes just under their nominal GiB as
# the driver gives them: the name rounds the size up, where the JAX
# package's flavor (1c.<MiB // 1024>gb) rounds down.
H100_PROFILES = {"1g.10gb": (1, 9984), "1g.20gb": (1, 20096),
                 "2g.20gb": (2, 20096), "3g.40gb": (3, 40448),
                 "4g.40gb": (4, 40448), "7g.80gb": (7, 81152)}


@pytest.mark.parametrize("name", list(H100_PROFILES))
def test_profile_names_round_the_memory_up(name):
    from k8s_vgpu_scheduler_tpu_torch.tpulib.types import MigDevice

    slices, mib = H100_PROFILES[name]
    m = MigDevice(uuid="MIG-x", slices=slices, compute_slices=slices,
                  memory_mib=mib, hbm_mib=mib)
    assert m.profile == name
    assert mib // 1024 < int(name.split(".")[1][:-2])
    assert MigDevice("MIG-x", 3, 1, 40448, 40448).profile == "1c.3g.40gb"
