"""The port's fragmentation views (``placement/frag.py``), slice
reservations (``placement/reserve.py``) and shaped-box counts
(``placement/mesh.py``'s ``exists_realizing_box`` and
``shaped_box_availability``) against the JAX package's, on the CPU.

``TestAvailabilityMath`` and ``TestReservations`` are
``tests/test_placement.py``'s cases, each run on both packages with the
answers held equal (the scheduler cases: the same fleet of 16,384 MiB
cards on a (4, 2) fabric, the same pods in the port's resource names, the
JAX side serial).  A reservation and its release each bump the node's
inventory revision on both (``NodeManager.touch``, which the optimistic
commit validates against).
"""

import itertools
import random

import pytest

from k8s_vgpu_scheduler_tpu.health.faults import SimClock as JClock
from k8s_vgpu_scheduler_tpu.placement import frag as jfrag
from k8s_vgpu_scheduler_tpu.placement import mesh as jmesh
from k8s_vgpu_scheduler_tpu.placement import reserve as jreserve
from k8s_vgpu_scheduler_tpu.tpulib import TopologyDesc as JTopo
from k8s_vgpu_scheduler_tpu_torch.health.faults import SimClock as TClock
from k8s_vgpu_scheduler_tpu_torch.placement import frag as tfrag
from k8s_vgpu_scheduler_tpu_torch.placement import mesh as tmesh
from k8s_vgpu_scheduler_tpu_torch.placement import reserve as treserve
from k8s_vgpu_scheduler_tpu_torch.tpulib.types import TopologyDesc as TTopo
from tests.test_torch_defrag import Side

#: (JAX, port) modules and types, as ``port`` picks them.
MODS = {False: (jfrag, jmesh, jreserve, JTopo, JClock),
        True: (tfrag, tmesh, treserve, TTopo, TClock)}
MESHES = {"4x2": ((4, 2), ()), "4x4": ((4, 4), ()),
          "ring8": ((8,), (True,)), "2x2x2": ((2, 2, 2), ())}


def coords(mesh):
    return [tuple(c) for c in itertools.product(*(range(d) for d in mesh))]


def view(port, name, topo, free):
    frag = MODS[port][0]
    return frag.NodeFreeView(
        node=name, topo=topo,
        free={c: f"{name}-{i}" for i, c in enumerate(sorted(free))},
        max_box=MODS[port][1].max_free_box_volume(topo, frozenset(free)))


def both(fn):
    """``fn(port)`` on each package; the port's answer, held equal."""
    got, want = fn(True), fn(False)
    assert got == want
    return got


class TestAvailabilityMath:
    def test_max_free_box(self):
        def answers(port):
            mesh = MODS[port][1]
            topo = MODS[port][3](generation="h100", mesh=(4, 2))
            checker = frozenset(c for c in coords((4, 2)) if sum(c) % 2 == 0)
            return [mesh.max_free_box_volume(topo, frozenset(coords((4, 2)))),
                    mesh.max_free_box_volume(topo, checker),
                    mesh.max_free_box_volume(topo, frozenset())]

        assert both(answers) == [8, 1, 0]

    def test_disjoint_box_counts(self):
        def answers(port):
            topo = MODS[port][3](generation="h100", mesh=(4, 4))
            return MODS[port][0].slice_availability(
                [view(port, "n", topo, frozenset(coords((4, 4))))],
                [2, 4, 8, 16])

        assert both(answers) == {2: 8, 4: 4, 8: 2, 16: 1}


@pytest.mark.parametrize("name", sorted(MESHES))
def test_shaped_boxes_equal_the_jax_counts(name):
    """``exists_realizing_box`` and ``shaped_box_availability`` on seeded
    free sets, for every mesh shape a fabric of this size realizes, and
    the fleet views, availability and largest box over them."""
    dims, wrap = MESHES[name]
    rng = random.Random(7)
    cells = coords(dims)
    draws = [frozenset(cells)] + [
        frozenset(c for c in cells if rng.random() < p)
        for p in (0.3, 0.5, 0.7, 0.9) for _ in range(4)]
    logical = [(2,), (4,), (2, 2), (2, 4), (4, 2), (2, 2, 2), (8,), (1, 2)]

    def answers(port):
        frag, mesh, _, Topo, _ = MODS[port]
        topo = Topo(generation="h100", mesh=dims, wraparound=wrap)
        out = []
        for free in draws:
            for m in logical:
                shapes = mesh.mesh_box_shapes(m, topo.mesh)
                out.append([mesh.exists_realizing_box(topo, free, shapes),
                            mesh.shaped_box_availability(topo, free,
                                                         shapes)])
            views = [view(port, "a", topo, free),
                     view(port, "b", topo, frozenset(cells) - free)]
            out.append([sorted(frag.slice_availability(views).items()),
                        frag.largest_free_box(views)])
        return out

    got = both(answers)
    assert any(row[0] is True for row in got if isinstance(row[0], bool))


class TestReservations:
    @staticmethod
    def node_side(port):
        return Side(port, n_nodes=1, enable_defrag=False,
                    topology_policy="best-effort")

    def test_reserved_chips_leave_the_snapshot(self):
        def answers(port):
            side = self.node_side(port)
            node = side.names[0]
            card = f"{node}-gpu-0"
            side.s.reservations.reserve(node, {card}, "who")
            out = [card in side.s.snapshot()[node].usage]
            # Nothing places on it: 8 cards, 7 schedulable.
            got = 0
            for i in range(8):
                p = {"metadata": {"name": f"x{i}", "namespace": "default",
                                  "uid": f"ux{i}", "annotations": {}},
                     "spec": {"containers": [{"name": "main", "resources": {
                         "limits": {"nvidia.com/gpu": "1",
                                    "nvidia.com/gpumem": "4000",
                                    "nvidia.com/gpucores": "100"}}}]}}
                side.create(p)
                if side.filter(p)["node"]:
                    got += 1
            out.append(got)
            out.append(sorted(d.uuid for p in side.s.pods.list_pods()
                              for c in p.devices for d in c))
            side.close()
            return out

        got = both(answers)
        assert got[0] is False and got[1] == 7
        assert "node-0-gpu-0" not in got[2]

    def test_release_returns_chips_and_bumps_rev(self):
        """The cards come back, and the reservation and its release each
        bump the node's inventory revision, on both."""
        def answers(port):
            side = self.node_side(port)
            node = side.names[0]
            card = f"{node}-gpu-0"
            revs = [side.s.nodes.rev_of(node)]
            side.s.reservations.reserve(node, {card}, "who")
            revs.append(side.s.nodes.rev_of(node))
            out = [card in side.s.snapshot()[node].usage]
            released = side.s.reservations.release_for("who")
            out += [[r.for_key for r in released],
                    card in side.s.snapshot()[node].usage,
                    side.s.reservations.total_chips()]
            revs.append(side.s.nodes.rev_of(node))
            assert revs[0] < revs[1] < revs[2], revs
            side.close()
            return out

        assert both(answers) == [False, ["who"], True, 0]

    def test_ttl_expiry(self):
        def answers(port):
            _, _, reserve, _, Clock = MODS[port]
            clock = Clock()
            calls = []
            res = reserve.SliceReservations(clock=clock,
                                            on_change=calls.append,
                                            ttl_s=10.0)
            r = res.reserve("n", {"c1", "c2"}, "k")
            out = [res.total_chips(), r.reserved_at, r.expires_at,
                   res.holds_for("k"), res.count_for("k"),
                   sorted(res.reserved_on("n"))]
            clock.advance(11.0)
            expired = res.sweep()
            out += [len(expired), res.total_chips(), calls,
                    res.reserved_total, res.expired_total, res.active()]
            return out

        got = both(answers)
        assert got[0] == 2 and got[6:9] == [1, 0, ["n", "n"]]

    def test_release_drops_exactly_one(self):
        """An aborted plan returns ITS box: ``release`` drops one
        reservation and leaves the same key's others."""
        def answers(port):
            res = MODS[port][2].SliceReservations(clock=MODS[port][4]())
            a = res.reserve("n1", {"a"}, "g")
            res.reserve("n2", {"b", "c"}, "g")
            out = [res.release(a), res.release(a), res.count_for("g"),
                   res.total_chips(), sorted(res.reserved_on("n2"))]
            return out

        assert both(answers) == [True, False, 1, 2, ["b", "c"]]
