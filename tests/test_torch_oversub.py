"""The port's host swap (``shim/oversub.py``) against the JAX package's, on
the CPU.

The same sequences of register, suspend, resume, ``spill_until``,
``suspend_all``/``resume_all`` and ``PressureSpiller`` checks (the cases of
tests/test_oversub.py's ``TestHostSwapStore`` and ``TestPressureSpiller``)
run on ``jax`` arrays in the JAX store and on tensors in the port's, made
from the same numpy data.  Required: the same ``stats()`` after every
step, the same entries on the device (the eviction order), the same bytes
returned, and round trips that are bitwise, in f32 and bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_vgpu_scheduler_tpu.shim import oversub as joversub
from k8s_vgpu_scheduler_tpu_torch.shim import oversub as toversub

DTYPES = {"float32": (jnp.float32, torch.float32, np.uint32, torch.int32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, np.uint16, torch.int16)}


class Pair:
    """One JAX store and one port store driven in lockstep."""

    def __init__(self, dtype="float32"):
        self.j, self.t = joversub.HostSwapStore(), toversub.HostSwapStore()
        self.jdt, self.tdt, self.nbits, self.tbits = DTYPES[dtype]
        self.rng = np.random.RandomState(0)

    def leaf(self, shape):
        x = self.rng.standard_normal(shape).astype(np.float32)
        return (jnp.asarray(x).astype(self.jdt),
                torch.from_numpy(x).to(self.tdt))

    def register(self, name, shapes):
        """Register a dict of leaves (a nested list when ``shapes`` is a
        list of lists); returns the port's tree and a bitwise copy."""
        jt, tt = {}, {}
        for k, shape in shapes.items():
            if isinstance(shape, list):
                pairs = [self.leaf(s) for s in shape]
                jt[k], tt[k] = [p[0] for p in pairs], [p[1] for p in pairs]
            else:
                jt[k], tt[k] = self.leaf(shape)
        self.j.register(name, jt)
        self.t.register(name, tt)
        return tt, [x.clone() for x in toversub.tree_leaves(tt)]

    def same(self):
        assert self.t.stats() == self.j.stats()
        on = {n: e.on_device for n, e in self.t._entries.items()}
        assert on == {n: e.on_device for n, e in self.j._entries.items()}
        return on

    def call(self, method, *args):
        out_j = getattr(self.j, method)(*args)
        out_t = getattr(self.t, method)(*args)
        self.same()
        return out_j, out_t

    def bits(self, name):
        """Both stores' leaves of ``name`` as integer bit patterns."""
        jl = jax.tree_util.tree_leaves(self.j._entries[name].tree)
        tl = toversub.tree_leaves(self.t._entries[name].tree)
        return ([np.asarray(x).view(self.nbits) for x in jl],
                [x.view(self.tbits).numpy().view(self.nbits) for x in tl])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_suspend_resume_round_trip_is_bitwise(dtype):
    p = Pair(dtype)
    tree, before = p.register("x", {"a": (1024,), "b": [(8, 8), (3,)]})
    freed_j, freed_t = p.call("suspend", "x")
    assert freed_t == freed_j == (1024 + 64 + 3) * (4 if dtype == "float32"
                                                     else 2)
    back_j, back_t = p.call("resume", "x")
    assert back_t is tree  # resumed in place: the caller's tree is whole
    for x, y in zip(toversub.tree_leaves(tree), before):
        assert torch.equal(x.view(p.tbits), y.view(p.tbits))
    jbits, tbits = p.bits("x")
    for a, b in zip(jbits, tbits):
        np.testing.assert_array_equal(a, b)


def test_get_remaps_transparently():
    p = Pair()
    p.register("w", {"w": (16,)})
    p.call("suspend", "w")
    p.call("get", "w")
    assert p.t.device_bytes() == 64 and p.t.host_bytes() == 0


def test_suspend_is_idempotent():
    p = Pair()
    p.register("w", {"w": (16,)})
    assert p.call("suspend", "w") == (64, 64)
    assert p.call("suspend", "w") == (0, 0)


def test_spill_until_evicts_lru_first():
    p = Pair()
    for name in ("old", "mid", "new"):
        p.register(name, {"a": (256,)})
    p.call("resume", "mid")  # touch: "old" is now least recently used
    p.call("resume", "new")
    assert p.call("spill_until", 1) == (1024, 1024)
    assert p.same() == {"old": False, "mid": True, "new": True}


def test_spill_until_frees_enough():
    p = Pair()
    for i in range(4):
        p.register(f"e{i}", {"a": (256,)})
    freed_j, freed_t = p.call("spill_until", 3 * 1024)
    assert freed_t == freed_j >= 3 * 1024
    assert p.same() == {"e0": False, "e1": False, "e2": False, "e3": True}


def test_suspend_all_resume_all():
    p = Pair()
    p.register("p", {"w": (8, 8)})
    p.register("q", {"z": (4,)})
    freed_j, freed_t = p.call("suspend_all")
    assert freed_t == freed_j == 4 * (64 + 4)
    assert p.t.device_bytes() == 0
    p.call("resume_all")
    assert p.t.host_bytes() == 0


def test_spill_on_one_device_skips_entries_elsewhere():
    """Pressure is per device: entries with nothing on the pressured
    device are left alone (the JAX store: another CPU device; the port's:
    a card, while everything lies on the CPU)."""
    p = Pair()
    p.register("near", {"a": (64,)})
    freed_j = p.j.spill_until(1, device=jax.devices()[1])
    freed_t = p.t.spill_until(1, device=torch.device("cuda", 0))
    assert freed_t == freed_j == 0
    freed_j = p.j.spill_until(1, device=jax.devices()[0])
    freed_t = p.t.spill_until(1, device=torch.device("cpu"))
    assert freed_t == freed_j == 256
    assert p.same() == {"near": False}


@pytest.mark.parametrize("case", ["over_ceiling", "below_ceiling",
                                  "no_physical_size"])
def test_pressure_spiller(case):
    p = Pair()
    p.register("x", {"a": (1024,)})
    nbytes = 4096
    physical, headroom, in_use = {
        "over_ceiling": (10 * nbytes, nbytes, 10 * nbytes - 1),
        "below_ceiling": (1 << 30, 0, 1024),
        "no_physical_size": (0, 512 << 20, 1 << 40),
    }[case]
    spilled = [
        mod.PressureSpiller(store, physical_bytes=physical,
                            headroom_bytes=headroom).check_once(in_use=in_use)
        for mod, store in ((joversub, p.j), (toversub, p.t))]
    assert spilled[1] == spilled[0] == (nbytes if case == "over_ceiling"
                                        else 0)
    p.same()


def test_spiller_reads_no_card_before_cuda_is_up():
    """The pressure check never brings CUDA up: with no card in use it
    sees no device and spills nothing."""
    store = toversub.HostSwapStore()
    store.register("x", torch.ones(16))
    assert toversub._devices_bytes_in_use() == []
    assert toversub.PressureSpiller(store, 1).check_once() == 0


@pytest.mark.parametrize("value,on", [("true", True), ("1", True),
                                      ("yes", False), ("", False)])
def test_enabled_from_env_reads_cuda_oversubscribe(monkeypatch, value, on):
    monkeypatch.setenv("CUDA_OVERSUBSCRIBE", value)
    monkeypatch.setenv("TPU_OVERSUBSCRIBE", value)
    assert toversub.enabled_from_env() is on is joversub.enabled_from_env()


def test_global_store_is_one_store():
    assert toversub.global_store() is toversub.global_store()
