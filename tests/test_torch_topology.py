"""The port's slice engine (``topology/torus.py``) and mesh placement
(``placement/mesh.py``) against the JAX package's, on the CPU.

The results are combinatorial, so every comparison is equality of lists,
order included: the packing score and the tie order must be the JAX
module's.  The meshes are those of tests/test_topology.py,
tests/test_placement.py and tests/test_properties.py, 1-D to 3-D, with
and without wraparound, plus the port's own: an NVLink ring of 8 (an
NVSwitch board) and a bridged pair.  The free sets, sizes, must-include
cards and capacities are numpy draws from a fixed seed, a fixed number a
mesh, each under all three policies.
"""

import numpy as np
import pytest

from k8s_vgpu_scheduler_tpu.placement import mesh as jmesh
from k8s_vgpu_scheduler_tpu.topology import torus as jtorus
from k8s_vgpu_scheduler_tpu.tpulib.types import TopologyDesc as JTopo
from k8s_vgpu_scheduler_tpu_torch import placement, topology
from k8s_vgpu_scheduler_tpu_torch.placement import mesh as tmesh
from k8s_vgpu_scheduler_tpu_torch.topology import torus as ttorus
from k8s_vgpu_scheduler_tpu_torch.tpulib.types import TopologyDesc as TTopo

MESHES = {
    "ring8": ((8,), (True,)),
    "line8": ((8,), ()),
    "pair": ((2,), (False,)),
    "ring4": ((4,), (True,)),
    "line4x1": ((4, 1), ()),
    "ring4x1": ((4, 1), (True, False)),
    "v5e_4x2": ((4, 2), ()),
    "v5e_4x4": ((4, 4), ()),
    "torus_4x4": ((4, 4), (True, True)),
    "cube_2x2x2": ((2, 2, 2), ()),
    "v4_2x2x1": ((2, 2, 1), ()),
    "v5p_4x2x2": ((4, 2, 2), (True, False, False)),
}
POLICIES = ("best-effort", "restricted", "guaranteed")
DRAWS = 10
# Logical meshes a pod may declare, against every fabric above.
LOGICAL = [(1,), (2,), (4,), (8,), (2, 2), (2, 4), (4, 2), (1, 8), (2, 2, 2),
           (4, 4), (2, 1, 2), (16,)]


def topos(name):
    mesh, wrap = MESHES[name]
    return (JTopo(generation="t", mesh=mesh, wraparound=wrap),
            TTopo(generation="t", mesh=mesh, wraparound=wrap))


def cells(topo):
    return list(ttorus.box_coords_origins(topo))


def draws(name):
    """DRAWS cases of one mesh: a free set, a size, must-include cells
    and a capacity per free cell, from ``default_rng`` seeded by the
    mesh's place in MESHES."""
    _, t = topos(name)
    every = cells(t)
    rng = np.random.default_rng(list(MESHES).index(name))
    out = []
    for _ in range(DRAWS):
        keep = rng.random(len(every)) < rng.uniform(0.3, 1.0)
        free = [c for c, k in zip(every, keep) if k]
        n = int(rng.integers(0, len(every) + 2))
        k = int(rng.integers(0, min(2, len(free)) + 1))
        must = [free[i] for i in sorted(rng.choice(len(free), size=k,
                                                   replace=False))]
        cap = {c: int(rng.integers(1, 5)) for c in free}
        out.append((free, n, must, cap))
    return out


@pytest.mark.parametrize("name", list(MESHES))
def test_shapes_boxes_and_contiguity_equal_the_jax_engine(name):
    j, t = topos(name)
    total = len(cells(t))
    for n in range(total + 2):
        assert ttorus.factor_shapes(n, t.mesh) == jtorus.factor_shapes(
            n, j.mesh)
        for shape in ttorus.factor_shapes(n, t.mesh):
            for origin in cells(t):
                got = ttorus.box_coords(origin, shape, t)
                assert got == jtorus.box_coords(origin, shape, j)
                if got is not None:
                    assert ttorus.is_contiguous(got, t) is True
    for free, n, _, _ in draws(name):
        subset = free[:n]
        assert ttorus.is_contiguous(subset, t) == \
            jtorus.is_contiguous(subset, j)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", list(MESHES))
def test_find_slice_equals_the_jax_engine(name, policy):
    j, t = topos(name)
    for free, n, must, _ in draws(name):
        for m in ([], must):
            got = ttorus.find_slice(t, free, n, policy, must=m)
            assert got == jtorus.find_slice(j, free, n, policy, must=m)
            if got and policy == "guaranteed":
                assert ttorus.is_contiguous(got, t)
        assert ttorus.exists_slice(t, free, n) == \
            jtorus.exists_slice(j, free, n)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", list(MESHES))
def test_find_capacitated_slice_equals_the_jax_engine(name, policy):
    j, t = topos(name)
    for free, n, must, cap in draws(name):
        for size in (n, 2 * n + 1):
            got = ttorus.find_capacitated_slice(t, cap, size, must, policy)
            assert got == jtorus.find_capacitated_slice(j, cap, size, must,
                                                        policy)


@pytest.mark.parametrize("name", list(MESHES))
def test_link_groups_equal_the_jax_engine(name):
    j, t = topos(name)
    for free, _, _, _ in draws(name):
        got = [sorted(g) for g in ttorus.link_groups(t, free)]
        assert got == [sorted(g) for g in jtorus.link_groups(j, free)]


@pytest.mark.parametrize("name", list(MESHES))
def test_mesh_placement_equals_the_jax_engine(name):
    j, t = topos(name)
    for free, _, _, _ in draws(name) + [(cells(t), 0, [], {})]:
        fs = frozenset(free)
        assert tmesh.max_free_box_volume(t, fs) == \
            jmesh.max_free_box_volume(j, fs)
        sizes = range(1, len(cells(t)) + 1)
        assert tmesh.box_availability(t, fs, sizes) == \
            jmesh.box_availability(j, fs, sizes)
        for logical in LOGICAL:
            assert tmesh.find_mesh_slice(t, free, logical) == \
                jmesh.find_mesh_slice(j, free, logical)
            for nums in (None, 1, 2, 4, 8):
                assert tmesh.mesh_fits_topology(logical, t, nums) == \
                    jmesh.mesh_fits_topology(logical, j, nums)


@pytest.mark.parametrize("value", [
    "2x4", "2X2x2", "8", " 2 x 4 ", "", "x", "2x", "ax4", "0x4",
    "2x2x2x2x2", "-1x4", "2.5x2", "1x1x1x1"])
def test_parse_mesh_equals_the_jax_parser(value):
    try:
        want = jmesh.parse_mesh(value)
    except ValueError as e:
        with pytest.raises(ValueError) as ei:
            tmesh.parse_mesh(value)
        assert str(ei.value) == str(e)
        return
    assert tmesh.parse_mesh(value) == want


@pytest.mark.parametrize("logical", LOGICAL + [(6,), (4, 3), (3, 2)])
def test_local_mesh_equals_the_jax_rule(logical):
    for nums in range(0, 17):
        assert tmesh.local_mesh_for(logical, nums) == \
            jmesh.local_mesh_for(logical, nums)


@pytest.mark.parametrize("fleet", [[], ["ring8"], ["line8"], ["pair"],
                                   ["v5e_4x4", "ring4x1"],
                                   ["cube_2x2x2", "pair"]],
                         ids=["empty", "ring8", "line8", "pair",
                              "grid_and_ring", "cube_and_pair"])
def test_validate_mesh_messages_equal_the_jax_ones(fleet):
    """The admission messages, the JAX side's "TPU" read as "GPU" (its
    one message that names the device)."""
    jt = [topos(n)[0] for n in fleet]
    tt = [topos(n)[1] for n in fleet]
    for value in ("2x4", "4", "2x2", "8", "2x", "2x2x2", "16", "0x2",
                  "4x4", "2x3"):
        for nums in (0, 1, 2, 4, 8, 16):
            for gang in (1, 2, 4):
                want = jmesh.validate_mesh(value, nums, gang, jt)
                got = tmesh.validate_mesh(value, nums, gang, tt)
                assert got == (want and want.replace("TPU", "GPU"))


def test_the_packages_export_what_the_jax_ones_do():
    from k8s_vgpu_scheduler_tpu import topology as jtopology
    assert topology.__all__ == jtopology.__all__
    assert set(placement.__all__) == {
        "MESH_ANNOTATION", "box_availability", "find_mesh_slice",
        "local_mesh_for", "max_free_box_volume", "mesh_fits_topology",
        "parse_mesh", "validate_mesh"}
    assert placement.MESH_ANNOTATION == jmesh.MESH_ANNOTATION
