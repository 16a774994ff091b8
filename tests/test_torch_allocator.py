"""The port's kubelet-path slice allocator (``deviceplugin/allocator.py``)
and its plugin's ``GetPreferredAllocation`` against the JAX package's,
on the CPU.

Each fixture is one MockBackend fixture read by both packages' own
``MockBackend`` (the cards carry explicit UUIDs, so both sides name the
same virtual devices): the meshes and health of tests/test_allocator.py,
plus the port's NVLink ring of 8, a bridged pair and one card.  Its
cases, then seeded numpy draws of the available IDs, the must-include IDs
and the size, go through both allocators under all three policies, and
through both plugins' servicers; ``unsatisfiable_sizes`` and the node
annotation ``publish_unsatisfiable`` writes are held equal too.  Every
comparison is equality, order included.

A node without a fabric (``coords=()`` on every card of an ``(n,)``
mesh, what ``NvmlBackend`` reports without an all-pairs NVLink matrix):
the port's allocator answers ``[]`` so kubelet chooses, and its
unsatisfiable sizes are the JAX function's on the same inventory.
"""

import itertools

import grpc
import numpy as np
import pytest

from k8s_vgpu_scheduler_tpu.api import deviceplugin_pb2 as jpb
from k8s_vgpu_scheduler_tpu.deviceplugin import allocator as jalloc
from k8s_vgpu_scheduler_tpu.deviceplugin.plugin import TpuDevicePlugin
from k8s_vgpu_scheduler_tpu.k8s import FakeKube as JKube
from k8s_vgpu_scheduler_tpu.tpulib import MockBackend as JMock
from k8s_vgpu_scheduler_tpu.tpulib import types as jtypes
from k8s_vgpu_scheduler_tpu.util.config import Config as JConfig
from k8s_vgpu_scheduler_tpu_torch.api import deviceplugin_pb2 as tpb
from k8s_vgpu_scheduler_tpu_torch.api.kubelet import DevicePluginStub
from k8s_vgpu_scheduler_tpu_torch.deviceplugin import GpuDevicePlugin
from k8s_vgpu_scheduler_tpu_torch.deviceplugin import allocator as talloc
from k8s_vgpu_scheduler_tpu_torch.k8s import FakeKube as TKube
from k8s_vgpu_scheduler_tpu_torch.tpulib import MockBackend as TMock
from k8s_vgpu_scheduler_tpu_torch.tpulib import types as ttypes
from k8s_vgpu_scheduler_tpu_torch.util.config import Config as TConfig

POLICIES = ("best-effort", "restricted", "guaranteed")
NODE = "node-a"


def fixture(mesh, unhealthy=(), wrap=None) -> dict:
    """tests/test_allocator.py's make_inventory as a fixture: a card at
    every point of ``mesh``, named ``chip-<x>-<y>``."""
    chips = [{"coords": list(c), "uuid": "chip-" + "-".join(map(str, c)),
              "healthy": c not in set(unhealthy)}
             for c in itertools.product(*(range(d) for d in mesh))]
    fx = {"generation": "h100", "mesh": list(mesh), "hbm_mib": 81079,
          "chips": chips}
    if wrap is not None:
        fx["wraparound"] = list(wrap)
    return fx


FIXTURES = {
    "4x2": fixture((4, 2)),
    "4x4": fixture((4, 4)),
    "2x2": fixture((2, 2)),
    "2x2_dead": fixture((2, 2), unhealthy=[(0, 0)]),
    "4x1": fixture((4, 1)),
    "4x1_dead": fixture((4, 1), unhealthy=[(1, 0)]),
    "5x1_dead": fixture((5, 1), unhealthy=[(2, 0)]),
    "2x1": fixture((2, 1)),
    "ring8": fixture((8,), wrap=(True,)),
    "pair": fixture((2,), wrap=(False,)),
    "one_card": fixture((1,)),
}


def inventories(name):
    fx = FIXTURES[name]
    return JMock(fx).inventory(), TMock(fx).inventory()


def vids(inv, split=1, skip=()):
    return [f"{c.uuid}-{k}" for c in inv.chips if c.coords not in set(skip)
            for k in range(split)]


# tests/test_allocator.py's cases: (fixture, split, skip, must, size).
CASES = [
    ("4x2", 1, (), [], 2), ("4x4", 1, (), [], 4),
    ("4x2", 1, (), ["chip-3-1-0"], 2), ("4x2", 1, [(1, 0), (1, 1)], [], 4),
    ("2x2_dead", 1, (), [], 2), ("2x2", 1, (), [], 0),
    ("4x1", 1, [(1, 0)], [], 3), ("4x1", 1, [(1, 0)], [], 2),
    ("2x2", 1, (), [], 3), ("2x2", 4, (), [], 3), ("2x2", 4, (), [], 6),
    ("5x1_dead", 1, [(2, 0)], [], 2), ("ring8", 1, (), [], 4),
    ("ring8", 1, [(0,), (4,)], [], 3), ("ring8", 10, [(1,), (5,)], [], 12),
    ("pair", 10, (), ["chip-1-3"], 2), ("one_card", 10, (), [], 2),
    ("one_card", 10, (), ["chip-0-5"], 2),
]
DRAWS = 6


def drawn(name):
    """DRAWS cases of one fixture: a split, the available IDs (a random
    subset), up to two must-include IDs from them and a size."""
    _, t = inventories(name)
    rng = np.random.default_rng(sorted(FIXTURES).index(name))
    out = []
    for _ in range(DRAWS):
        split = int(rng.choice([1, 2, 10]))
        every = vids(t, split)
        keep = rng.random(len(every)) < rng.uniform(0.3, 1.0)
        avail = [v for v, k in zip(every, keep) if k]
        k = int(rng.integers(0, min(2, len(avail)) + 1))
        must = [avail[i] for i in sorted(rng.choice(len(avail), size=k,
                                                    replace=False))]
        out.append((avail, must, int(rng.integers(0, len(avail) + 2))))
    return out


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("case", range(len(CASES)))
def test_preferred_equals_the_jax_allocator_on_its_cases(case, policy):
    name, split, skip, must, size = CASES[case]
    j, t = inventories(name)
    avail = vids(t, split, skip)
    got = talloc.SliceAllocator(t, policy).preferred(avail, must, size)
    assert got == jalloc.SliceAllocator(j, policy).preferred(avail, must,
                                                             size)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_preferred_equals_the_jax_allocator_on_seeded_draws(name, policy):
    j, t = inventories(name)
    for avail, must, size in drawn(name):
        got = talloc.SliceAllocator(t, policy).preferred(avail, must, size)
        assert got == jalloc.SliceAllocator(j, policy).preferred(
            avail, must, size), (avail, must, size)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_unsatisfiable_sizes_and_annotation_equal_the_jax_ones(name):
    j, t = inventories(name)
    for policy in POLICIES:
        assert talloc.unsatisfiable_sizes(t, policy) == \
            jalloc.unsatisfiable_sizes(j, policy)
        for kube, mod, inv in ((JKube(), jalloc, j), (TKube(), talloc, t)):
            kube.add_node({"metadata": {"name": NODE, "annotations": {}}})
            mod.publish_unsatisfiable(kube, NODE, inv, policy)
            anns = kube.get_node(NODE)["metadata"].get("annotations", {})
            if mod is jalloc:
                want = anns.get(jalloc.UNSATISFIABLE_ANNOTATION)
            else:
                assert anns.get(talloc.UNSATISFIABLE_ANNOTATION) == want
    assert talloc.UNSATISFIABLE_ANNOTATION == jalloc.UNSATISFIABLE_ANNOTATION


def no_fabric(n, unhealthy=()):
    """A node without a fabric, as each package's inventory: ``n`` cards
    without coordinates on an (n,) mesh."""
    def chips(mod):
        return [mod.ChipInfo(index=i, uuid=f"chip-{i}", type="NVIDIA-h100",
                             hbm_mib=81079, coords=(),
                             healthy=i not in unhealthy) for i in range(n)]
    return (jtypes.NodeInventory(chips(jtypes), jtypes.TopologyDesc(
                "h100", (n,))),
            ttypes.NodeInventory(chips(ttypes), ttypes.TopologyDesc(
                "h100", (n,))))


@pytest.mark.parametrize("n,unhealthy", [(2, ()), (4, ()), (8, (3,))])
def test_a_node_without_a_fabric_leaves_kubelet_to_choose(n, unhealthy):
    j, t = no_fabric(n, unhealthy)
    assert not talloc.has_fabric(t)
    for policy in POLICIES:
        alloc = talloc.SliceAllocator(t, policy)
        for size in (1, 2, n):
            assert alloc.preferred(vids(t, 4), [], size) == []
        assert alloc.preferred(vids(t, 4), ["chip-0-1"], 2) == []
        assert talloc.unsatisfiable_sizes(t, policy) == \
            jalloc.unsatisfiable_sizes(j, policy) == \
            list(range(1, n - len(unhealthy) + 1))


def test_one_card_without_coordinates_is_no_fabric():
    """A card without coordinates, or two at one, spoils the fabric."""
    _, t = inventories("4x1")
    assert talloc.has_fabric(t)
    t.chips[2].coords = ()
    assert not talloc.has_fabric(t)
    t.chips[2].coords = t.chips[1].coords
    assert not talloc.has_fabric(t)
    assert talloc.SliceAllocator(t).preferred(vids(t), [], 2) == []


def plugins(name, policy):
    j, t = inventories(name)
    jp = TpuDevicePlugin(JKube(), j, JConfig(node_name=NODE,
                                             topology_policy=policy))
    tp = GpuDevicePlugin(TKube(), t, TConfig(node_name=NODE,
                                             topology_policy=policy))
    return (jp, jpb), (tp, tpb)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", ["4x2", "4x1_dead", "ring8", "one_card"])
def test_get_preferred_allocation_equals_the_jax_plugin(name, policy):
    """Both servicers answer one request of several containers: the seeded
    draws of the fixture and its CASES."""
    reqs = drawn(name) + [(vids(inventories(name)[1], s, sk), m, n)
                          for f, s, sk, m, n in CASES if f == name]
    answers = []
    for plugin, pb in plugins(name, policy):
        opts = plugin.GetDevicePluginOptions(pb.Empty(), None)
        assert opts.get_preferred_allocation_available
        resp = plugin.GetPreferredAllocation(pb.PreferredAllocationRequest(
            container_requests=[pb.ContainerPreferredAllocationRequest(
                available_deviceIDs=a, must_include_deviceIDs=m,
                allocation_size=n) for a, m, n in reqs]), None)
        answers.append([list(c.deviceIDs)
                        for c in resp.container_responses])
    assert answers[1] == answers[0]
    assert len(answers[1]) == len(reqs)


def test_preferred_allocation_over_the_socket(tmp_path):
    """Kubelet's calls on the port's plugin socket: the options offer a
    preferred allocation, and the answer is the allocator's."""
    _, t = inventories("ring8")
    plugin = GpuDevicePlugin(TKube(), t, TConfig(
        node_name=NODE, topology_policy="guaranteed"),
        socket_dir=str(tmp_path))
    plugin.serve()
    try:
        with grpc.insecure_channel(f"unix://{plugin.socket_path}") as ch:
            stub = DevicePluginStub(ch)
            opts = stub.GetDevicePluginOptions(tpb.Empty(), timeout=10)
            every = [d.ID for d in plugin.api_devices()]
            resp = stub.GetPreferredAllocation(
                tpb.PreferredAllocationRequest(container_requests=[
                    tpb.ContainerPreferredAllocationRequest(
                        available_deviceIDs=every, allocation_size=n,
                        must_include_deviceIDs=m)
                    for n, m in ((1, []), (12, []), (2, ["chip-5-0"]))]),
                timeout=10)
    finally:
        plugin.stop()
    assert opts.get_preferred_allocation_available
    got = [list(c.deviceIDs) for c in resp.container_responses]
    assert got == [plugin.allocator.preferred(every, m, n)
                   for n, m in ((1, []), (12, []), (2, ["chip-5-0"]))]
    assert {v.rsplit("-", 1)[0] for v in got[1]} == {"chip-0", "chip-1"}
