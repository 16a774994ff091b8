"""The port's enforcement layer against the JAX package's, on the CPU.

The port's native library (``csrc/vgpu/``, built with g++ into
``libvgpu_torch.so``) and the JAX package's (``lib/tpu``, built with its
Makefile into ``libvtpu.so``) are driven through the same sequences in
child processes, each from its own env names (``CUDA_*`` for the port,
``TPU_*`` for the reference), and must agree exactly: everything compared
is an integer or a byte.

- The region ABI: a region the port writes reads, through the JAX
  package's monitor reader, exactly like one the TPU library writes, and
  the files are the same bytes apart from the writer's pid and the mutex;
  both monitors' readers clear a dead process's slot in either.
- The limiter on its test clock: the same acquires and feedback give the
  same waits, clock, QoS wait/cost counters and wait histogram.
- The cases of tests/test_shim.py that do not need jax, on both.
- The Python shim's dispatch gate (cost model, nesting, the identity when
  nothing is installed), host swap at the gate, and the memory cap's
  arithmetic, with a pod's other processes in the region.
"""

import contextlib
import ctypes
import ctypes.util
import dataclasses
import json
import os
import random
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from k8s_vgpu_scheduler_tpu.monitor.reader import RegionReader
from k8s_vgpu_scheduler_tpu.util.nativebuild import build_native
from k8s_vgpu_scheduler_tpu_torch.models import serve as tserve
from k8s_vgpu_scheduler_tpu_torch.models import train as ttrain
from k8s_vgpu_scheduler_tpu_torch.models.convert import init_weights
from k8s_vgpu_scheduler_tpu_torch.models.llama import LlamaConfig
from k8s_vgpu_scheduler_tpu_torch.monitor.reader import \
    RegionReader as PortRegionReader
from k8s_vgpu_scheduler_tpu_torch.ops import _kernels
from k8s_vgpu_scheduler_tpu_torch.shim import core, oversub

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
TPU_LIB = REPO / "lib" / "tpu" / "build" / "libvtpu.so"
MIB = 1 << 20


@dataclasses.dataclass(frozen=True)
class Flavor:
    """One of the two libraries and the env names its region reads."""
    name: str
    prefix: str
    limit: str     # + "_<i>"
    sm: str
    uuids: str
    priority: str
    oversub: str
    cache: str
    policy: str


PORT = Flavor("port", "vgpu_", "CUDA_DEVICE_MEMORY_LIMIT",
              "CUDA_DEVICE_SM_LIMIT", "NVIDIA_VISIBLE_DEVICES",
              "CUDA_TASK_PRIORITY", "CUDA_OVERSUBSCRIBE",
              "CUDA_DEVICE_MEMORY_SHARED_CACHE", "GPU_CORE_UTILIZATION_POLICY")
TPU = Flavor("tpu", "vtpu_", "TPU_DEVICE_MEMORY_LIMIT",
             "TPU_DEVICE_CORE_LIMIT", "TPU_VISIBLE_CHIPS",
             "TPU_TASK_PRIORITY", "TPU_OVERSUBSCRIBE",
             "TPU_DEVICE_MEMORY_SHARED_CACHE", "TPU_CORE_UTILIZATION_POLICY")
FLAVORS = [PORT, TPU]


@pytest.fixture(scope="module")
def libs():
    build_native(check=True)
    return {"port": str(_kernels.build_vgpu()), "tpu": str(TPU_LIB)}


def grant_env(flavor, region, limits_mib=None, sm=None, uuids=None,
              priority=None, oversub=None, qos=None, policy=None):
    """The env a device plugin would give a container, in ``flavor``'s
    names, over a clean copy of ours (no inherited grant)."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("CUDA_", "TPU_", "VTPU_", "NVIDIA_",
                                "GPU_CORE"))}
    env[flavor.cache] = str(region)
    for i, mib in (limits_mib or {}).items():
        env[f"{flavor.limit}_{i}"] = f"{mib}m"
    for name, value in ((flavor.sm, sm), (flavor.priority, priority),
                        (flavor.oversub, oversub), (flavor.policy, policy),
                        ("VTPU_QOS_CLASS", qos)):
        if value is not None:
            env[name] = str(value)
    if uuids:
        env[flavor.uuids] = ",".join(uuids)
    return env


# Binds the library named by T_LIB under the prefix T_PREFIX, so one child
# script drives either library.
PRELUDE = """
import ctypes, json, os, subprocess, sys, time
P = os.environ["T_PREFIX"]
lib = ctypes.CDLL(os.environ["T_LIB"])
u64, vp = ctypes.c_uint64, ctypes.c_void_p
def fn(name, argtypes, restype=ctypes.c_int):
    f = getattr(lib, P + name)
    f.argtypes, f.restype = argtypes, restype
    return f
init = fn("init_path", [ctypes.c_char_p])
try_alloc = fn("try_alloc", [ctypes.c_int, u64])
get_used = fn("get_used", [ctypes.c_int], u64)
free = fn("free", [ctypes.c_int, u64], None)
shutdown = fn("shutdown", [], None)
proc_count = fn("proc_count", [])
acquire = fn("rate_acquire", [ctypes.c_int, u64], None)
feedback = fn("rate_feedback", [ctypes.c_int, u64], None)
test_mode = fn("rate_test_mode", [ctypes.c_int], None)
advance = fn("rate_test_advance", [u64], None)
now = fn("rate_test_now", [], u64)
region = fn("region", [], vp)
set_switch = fn("r_set_switch", [vp, ctypes.c_int], None)
r_qos = {k: fn("r_qos_" + k, [vp], u64)
         for k in ("wait_count", "wait_us_total", "cost_us_total")}
wait_hist = fn("r_qos_wait_hist", [vp, ctypes.POINTER(u64), ctypes.c_int])
MIB = 1 << 20
"""
ATTACH = "assert init(None) == 0\n"


def run_child(flavor, libs, code, env, timeout=60, check=True):
    env = dict(env, T_PREFIX=flavor.prefix, T_LIB=libs[flavor.name],
               PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", PRELUDE + code], env=env,
                         capture_output=True, text=True, timeout=timeout,
                         cwd=REPO)
    if check:
        assert res.returncode == 0, f"{flavor.name} child: {res.stderr}"
    return res


# -- the region ABI -------------------------------------------------------


def test_region_layouts_are_one_abi(tmp_path):
    """Both headers, compiled into one translation unit: the same size and
    every field at the same offset."""
    fields = ("magic", "abi_version", "initialized", "num_devices",
              "owner_pid", "generation", "lock", "uuids", "limit",
              "sm_limit", "utilization_switch", "recent_kernel", "priority",
              "oversubscribe", "proc_num", "procs", "qos_class",
              "qos_weight_pct", "qos_yield", "qos_wait_count",
              "qos_wait_us_total", "qos_cost_us_total", "qos_wait_hist")
    slot = ("pid", "hostpid", "status", "pidns", "used", "monitor_used")
    lines = ['#include <stddef.h>',
             '#include "vtpu/shared_region.h"',
             '#include "vgpu/shared_region.h"',
             "static_assert(sizeof(vgpu_region_t) == sizeof(vtpu_region_t));",
             "static_assert(sizeof(vgpu_proc_slot_t) == "
             "sizeof(vtpu_proc_slot_t));",
             "static_assert(VGPU_MAGIC == VTPU_MAGIC);",
             "static_assert(VGPU_ABI_VERSION == VTPU_ABI_VERSION);",
             "static_assert(VGPU_MAX_DEVICES == VTPU_MAX_DEVICES);",
             "static_assert(VGPU_MAX_PROCS == VTPU_MAX_PROCS);",
             "static_assert(VGPU_UUID_LEN == VTPU_UUID_LEN);",
             "static_assert(VGPU_QOS_WAIT_BUCKETS == VTPU_QOS_WAIT_BUCKETS);"]
    lines += [f"static_assert(offsetof(vgpu_region_t, {f}) == "
              f"offsetof(vtpu_region_t, {f}), \"{f}\");" for f in fields]
    lines += [f"static_assert(offsetof(vgpu_proc_slot_t, {f}) == "
              f"offsetof(vtpu_proc_slot_t, {f}), \"{f}\");" for f in slot]
    src = tmp_path / "abi.cc"
    src.write_text("\n".join(lines) + "\nint main() { return 0; }\n")
    res = subprocess.run(
        ["g++", "-std=c++17", "-fsyntax-only",
         f"-I{REPO / 'lib' / 'tpu' / 'include'}", f"-I{_kernels.CSRC}",
         str(src)], capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _monitor_view(region_path):
    """What the JAX package's node monitor reads from a region file."""
    r = RegionReader(str(TPU_LIB)).open(str(region_path))
    assert r is not None, f"monitor cannot open {region_path}"
    try:
        n = r.num_devices
        return {
            "num_devices": n, "uuids": r.uuids(),
            "limit": [r.limit(i) for i in range(n)],
            "sm_limit": [r.sm_limit(i) for i in range(n)],
            "used": [r.used(i) for i in range(n)],
            "priority": r.priority, "oversubscribe": r.oversubscribe,
            "pids": r.proc_pids(), "qos_class": r.qos_class,
            "qos_wait_count": r.qos_wait_count(),
            "qos_wait_us_total": r.qos_wait_us_total(),
            "qos_cost_us_total": r.qos_cost_us_total(),
            "qos_wait_hist": r.qos_wait_hist(),
        }
    finally:
        r.close()


# Bytes that differ between two writers of the same grant: the creator's
# pid, the mutex (its robust-list links) and slot 0's pid.
UNSHARED = [(16, 24), (32, 72), (1376, 1380)]


def _masked(path):
    data = bytearray(Path(path).read_bytes())
    for lo, hi in UNSHARED:
        data[lo:hi] = bytes(hi - lo)
    return bytes(data)


@pytest.mark.parametrize("qos", [None, "best-effort", "latency-critical"],
                         ids=["flat", "best_effort", "latency_critical"])
@pytest.mark.parametrize("n_devices", [1, 4])
def test_monitor_reads_the_ports_region_like_the_tpu_one(
        tmp_path, libs, n_devices, qos):
    grant = dict(
        limits_mib={i: 24000 - 1000 * i for i in range(n_devices)}, sm=30,
        uuids=[f"GPU-{i:08x}-1111-2222-3333-44445555666{i}"
               for i in range(n_devices)],
        priority=1, oversub="true" if n_devices > 1 else None, qos=qos)
    code = ATTACH + """
for i in range(int(os.environ["N_DEV"])):
    assert try_alloc(i, (i + 3) * MIB) == 0
acquire(0, 5000)  # recorded by the QoS plane only
print(os.getpid())
os._exit(0)  # the slot stays, as for a live process
"""
    views, pids = {}, {}
    for flavor in FLAVORS:
        path = tmp_path / f"{flavor.name}.cache"
        env = dict(grant_env(flavor, path, **grant), N_DEV=str(n_devices))
        pids[flavor.name] = int(run_child(flavor, libs, code, env).stdout)
        views[flavor.name] = _monitor_view(path)
    port, tpu = views["port"], views["tpu"]
    assert port["pids"] == [pids["port"]] and tpu["pids"] == [pids["tpu"]]
    port["pids"] = tpu["pids"] = None
    assert port == tpu
    assert port["num_devices"] == n_devices
    assert port["uuids"] == grant["uuids"]
    assert port["limit"] == [mib * MIB for mib in grant["limits_mib"].values()]
    assert port["used"] == [(i + 3) * MIB for i in range(n_devices)]
    assert port["qos_class"] == {None: -1, "best-effort": 0,
                                 "latency-critical": 1}[qos]
    # The port's own reader agrees with the monitor's.
    own = core.Native(libs["port"]).read_region(str(tmp_path / "port.cache"))
    own["pids"] = None
    assert own == port
    assert _masked(tmp_path / "port.cache") == _masked(tmp_path / "tpu.cache")


# -- the limiter on its test clock ----------------------------------------

LIMITER = ATTACH + """
rng_ops = json.loads(os.environ["OPS"])
if os.environ.get("SWITCH"):
    set_switch(region(), 1)
test_mode(1)
waits = []
for op, a, b in rng_ops:
    if op == "acquire":
        t = now()
        acquire(0, a)
        waits.append(now() - t)
    else:
        feedback(0, a)
    advance(b * 1000)
hist = (u64 * 20)()
wait_hist(region(), hist, 20)
print(json.dumps({"waits": waits, "clock": now(),
                  "qos": {k: f(region()) for k, f in r_qos.items()},
                  "hist": list(hist)}))
"""

MODES = {
    "low_priority_contended": dict(priority=1, switch=True),
    "forced": dict(priority=0, policy="force"),
    "best_effort": dict(priority=1, switch=True, qos="best-effort"),
    "latency_critical": dict(qos="latency-critical"),
}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("grant", [10, 30, 50, 100])
def test_limiters_account_waits_identically(tmp_path, libs, grant, mode):
    rng = random.Random(grant * 100 + len(mode))
    ops = []
    for _ in range(300):
        if rng.random() < 0.2:
            ops.append(("feedback", rng.randint(500, 40000), 0))
        else:
            cost = 0 if rng.random() < 0.2 else rng.randint(500, 60000)
            ops.append(("acquire", cost, rng.randint(0, 20000)))
    spec = dict(MODES[mode])
    switch = spec.pop("switch", False)
    out = {}
    for flavor in FLAVORS:
        env = grant_env(flavor, tmp_path / f"{flavor.name}.cache",
                        limits_mib={0: 1000}, sm=grant, **spec)
        env["OPS"] = json.dumps(ops)
        if switch:
            env["SWITCH"] = "1"
        out[flavor.name] = json.loads(
            run_child(flavor, libs, LIMITER, env).stdout)
    assert out["port"] == out["tpu"]
    throttled = sum(out["port"]["waits"]) > 0
    assert throttled == (grant < 100)
    if "qos" in spec and grant < 100:  # an uncapped grant records nothing
        assert out["port"]["qos"]["wait_count"] == \
            sum(op == "acquire" for op, _, _ in ops)


# -- tests/test_shim.py's cases that need no jax, on both libraries ------


@pytest.mark.parametrize("flavor", FLAVORS, ids=lambda f: f.name)
def test_oom_check_enforced(tmp_path, libs, flavor):
    out = run_child(flavor, libs, ATTACH + """
print(try_alloc(0, 50*MIB))   # fits
print(try_alloc(0, 60*MIB))   # would exceed the 100 MiB cap
print(try_alloc(0, 50*MIB))   # exactly fills
print(get_used(0)//MIB)
free(0, 30*MIB)
print(try_alloc(0, 20*MIB))   # fits again after free
""", grant_env(flavor, tmp_path / "r.cache", limits_mib={0: 100})).stdout
    assert out.split() == ["0", "-12", "0", "100", "0"]


@pytest.mark.parametrize("flavor", FLAVORS, ids=lambda f: f.name)
def test_cross_process_accounting(tmp_path, libs, flavor):
    """Two live processes share one region: the second sees the first's
    use and is refused where the sum would pass the cap."""
    env = grant_env(flavor, tmp_path / "r.cache", limits_mib={0: 100})
    ready, done = tmp_path / "ready", tmp_path / "done"
    holder = subprocess.Popen(
        [sys.executable, "-c", PRELUDE + ATTACH + f"""
assert try_alloc(0, 70*MIB) == 0
open({str(ready)!r}, "w").close()
t0 = time.time()
while not os.path.exists({str(done)!r}) and time.time() - t0 < 30:
    time.sleep(0.02)
"""], env=dict(env, T_PREFIX=flavor.prefix, T_LIB=libs[flavor.name]))
    try:
        t0 = time.time()
        while not ready.exists() and time.time() - t0 < 30:
            time.sleep(0.02)
        assert ready.exists(), "the first process never attached"
        out = run_child(flavor, libs, ATTACH + """
print(get_used(0)//MIB, try_alloc(0, 40*MIB), try_alloc(0, 20*MIB))
""", env).stdout
        assert out.split() == ["70", "-12", "0"]
    finally:
        done.touch()
        holder.wait(timeout=30)


@pytest.mark.parametrize("flavor", FLAVORS, ids=lambda f: f.name)
def test_slot_released_on_shutdown(tmp_path, libs, flavor):
    env = grant_env(flavor, tmp_path / "r.cache", limits_mib={0: 100})
    run_child(flavor, libs, ATTACH + """
assert try_alloc(0, 70*MIB) == 0
shutdown()
""", env)
    out = run_child(flavor, libs, ATTACH + """
print(get_used(0)//MIB, proc_count())
""", env).stdout
    assert out.split() == ["0", "1"]


@pytest.mark.parametrize("flavor", FLAVORS, ids=lambda f: f.name)
def test_uncapped_never_sleeps(tmp_path, libs, flavor):
    out = run_child(flavor, libs, ATTACH + """
t0 = time.monotonic()
for _ in range(100):
    acquire(0, 10000)
print(int((time.monotonic() - t0) * 1000))
""", grant_env(flavor, tmp_path / "r.cache", limits_mib={0: 100})).stdout
    assert int(out) < 200


@pytest.mark.parametrize("flavor", FLAVORS, ids=lambda f: f.name)
def test_attach_reaps_same_namespace_dead_slots(tmp_path, libs, flavor):
    env = grant_env(flavor, tmp_path / "r.cache", limits_mib={0: 100})
    run_child(flavor, libs, ATTACH + """
assert try_alloc(0, 70*MIB) == 0
os._exit(0)  # no shutdown: the slot leaks like a SIGKILLed process's
""", env)
    out = run_child(flavor, libs, ATTACH + """
print(get_used(0), try_alloc(0, 70*MIB))
""", env).stdout
    assert out.split() == ["0", "0"]


@pytest.mark.parametrize("flavor", FLAVORS, ids=lambda f: f.name)
def test_refusal_path_reaps_dead_slots(tmp_path, libs, flavor):
    env = grant_env(flavor, tmp_path / "r.cache", limits_mib={0: 100})
    out = run_child(flavor, libs, ATTACH + """
assert try_alloc(0, 20*MIB) == 0  # attached first: the reap must come later
child = PRELUDE + "assert init(None) == 0\\nassert try_alloc(0, 70*MIB) == 0\\nos._exit(0)"
subprocess.run([sys.executable, "-c", child], check=True)
print(try_alloc(0, 50*MIB), get_used(0)//MIB)
""".replace("PRELUDE", repr(PRELUDE)), env).stdout
    assert out.split() == ["0", "70"]  # 20 + 50; the dead 70 reaped


@pytest.mark.parametrize("flavor", FLAVORS, ids=lambda f: f.name)
def test_monitor_gc_clears_dead_slots(tmp_path, libs, flavor):
    """Through the JAX package's reader and through the port's, each on a
    slot that a process left behind in ``flavor``'s region."""
    path = tmp_path / "r.cache"
    for reader in (RegionReader(str(TPU_LIB)),
                   PortRegionReader(libs["port"])):
        run_child(flavor, libs, ATTACH + """
assert try_alloc(0, 70*MIB) == 0
os._exit(0)
""", grant_env(flavor, path, limits_mib={0: 100}))
        r = reader.open(str(path))
        try:
            assert r.used(0) == 70 * MIB
            assert r.gc([]) == 1
            assert r.used(0) == 0
        finally:
            r.close()


# -- the Python shims -----------------------------------------------------

# Brings up flavor's Python shim (no hooks, no memory cap or ballast).
SHIM = {
    "port": """
sys.path.insert(0, os.environ["PYTHONPATH"])
from k8s_vgpu_scheduler_tpu_torch.shim import core
shim = core.install(torch_hooks=False, memory_cap=False, watchdog=WATCHDOG,
                    native=core.Native(os.environ["T_LIB"]))
""",
    "tpu": """
sys.path.insert(0, os.environ["PYTHONPATH"])
os.environ["VTPU_LIBRARY"] = os.environ["T_LIB"]
from k8s_vgpu_scheduler_tpu.shim import core
shim = core.install(jax_hooks=False, ballast=False, watchdog=WATCHDOG)
""",
}


def shim_child(flavor, watchdog=False):
    return SHIM[flavor.name].replace("WATCHDOG", str(watchdog))


@pytest.mark.parametrize("flavor", FLAVORS, ids=lambda f: f.name)
def test_install_and_memory_info(tmp_path, libs, flavor):
    out = run_child(flavor, libs, shim_child(flavor) + """
info = shim.memory_info(0)
print(info["total"] // MIB, info["used"])
try_alloc(0, 10*MIB)
print(shim.memory_info(0)["used"] // MIB)
""", grant_env(flavor, tmp_path / "r.cache", limits_mib={0: 3000})).stdout
    assert out.splitlines() == ["3000 0", "10"]


@pytest.mark.parametrize("qos", [None, "latency-critical"],
                         ids=["unclassed", "latency_critical"])
@pytest.mark.parametrize("flavor", FLAVORS, ids=lambda f: f.name)
def test_qos_info(tmp_path, libs, flavor, qos):
    out = run_child(flavor, libs, shim_child(flavor) + """
info = shim.qos_info()
print(info["class"], info["duty_weight_pct"], info["yield"], info["wait_count"])
acquire(0, 5000)
print(shim.qos_info()["wait_count"])
""", grant_env(flavor, tmp_path / "r.cache", limits_mib={0: 3000}, sm=50,
               qos=qos)).stdout
    want = ["None None False 0", "0"] if qos is None else \
        ["latency-critical 100 False 0", "1"]
    assert out.splitlines() == want


@pytest.mark.parametrize("flavor", FLAVORS, ids=lambda f: f.name)
def test_exit_action_ends_an_overlimit_process_with_137(
        tmp_path, libs, flavor):
    env = grant_env(flavor, tmp_path / "r.cache", limits_mib={0: 100})
    env["VTPU_OOM_ACTION"] = "exit"
    res = run_child(flavor, libs, shim_child(flavor, watchdog=True) + """
getattr(shim.native.lib, P + "set_used")(0, 200 * MIB)  # twice the grant
time.sleep(15)
print("SURVIVED")
""", env, check=False)
    assert res.returncode == 137, res.stderr
    assert "SURVIVED" not in res.stdout


def test_active_oom_killer_env_kills(tmp_path, libs):
    """The reference's ACTIVE_OOM_KILLER=true is the port's kill action."""
    env = grant_env(PORT, tmp_path / "r.cache", limits_mib={0: 100})
    env["ACTIVE_OOM_KILLER"] = "true"
    res = run_child(PORT, libs, shim_child(PORT, watchdog=True) + """
shim.native.lib.vgpu_set_used(0, 200 * MIB)
time.sleep(15)
print("SURVIVED")
""", env, check=False)
    assert res.returncode == -9, res.stderr
    assert "SURVIVED" not in res.stdout


@pytest.mark.parametrize("flavor", FLAVORS, ids=lambda f: f.name)
def test_duty_within_10pct_of_the_grant_on_a_cpu_busy_loop(
        tmp_path, libs, flavor):
    """A 30% grant, forced, on a 5 ms busy loop gated by the shim's
    ``throttled`` wrapper (a synchronous callable: its wall time is its
    cost): busy time over wall time within 10% of 30% (real clock)."""
    out = run_child(flavor, libs, shim_child(flavor) + """
spins = []
def spin():
    t = time.monotonic()
    while time.monotonic() - t < 0.005:
        pass
    spins.append(time.monotonic() - t)
gated = shim.throttled(spin)
acquire(0, 200000)  # drain the initial burst
t0 = time.monotonic()
while time.monotonic() - t0 < 1.5:
    gated()
print(sum(spins) / (time.monotonic() - t0))
""", grant_env(flavor, tmp_path / "r.cache", limits_mib={0: 100}, sm=30,
               policy="force"))
    duty = float(out.stdout)
    assert 0.27 <= duty <= 0.33, duty


# -- the port's dispatch gate, over a stub native --------------------------


class FakeLib:
    def __init__(self, limits=None):
        self.acquires, self.feedbacks = [], []
        self.limits = limits or {}
        self.used = {}  # the region's total, per device

    def vgpu_get_used(self, i):
        return self.used.get(i, 0)

    def vgpu_gc_dead(self):
        return 0

    def vgpu_rate_acquire(self, s, c):
        self.acquires.append((int(s), int(c)))

    def vgpu_rate_feedback(self, s, c):
        self.feedbacks.append((int(s), int(c)))

    def vgpu_get_limit(self, i):
        return self.limits.get(i, 0)


class FakeNative:
    def __init__(self, limits=None):
        self.lib = FakeLib(limits)


class FakeCuda:
    """The slice of torch.cuda the gate uses when CUDA is up: events whose
    record and synchronize are logged."""

    def __init__(self, log):
        self.log = log
        fake = self

        class Event:
            def record(self, stream):
                fake.log.append(("record", stream))

            def synchronize(self):
                fake.log.append("sync")

        self.Event = Event

    def current_stream(self, s):
        return f"stream{s}"

    def current_device(self):
        return 0


def fake_shim(monkeypatch, sync_every=2, read_cost=0.0, on_card=True):
    """A shim over a stub native whose clock advances ``read_cost`` s per
    read; a dispatched callable models its device time by advancing
    ``shim.t[0]``.  With ``on_card`` the gate sees CUDA as up."""
    t = [0.0]

    def clock():
        t[0] += read_cost
        return t[0]

    monkeypatch.setenv("VTPU_SYNC_EVERY", str(sync_every))
    shim = core.Shim(FakeNative(), clock=clock)
    shim.t, shim.log = t, []
    cuda = FakeCuda(shim.log)
    fake_torch = types.SimpleNamespace(cuda=cuda)
    monkeypatch.setattr(core, "_cuda_ready",
                        lambda: fake_torch if on_card else None)
    return shim


def costs(shim):
    return [c for s, c in shim.native.lib.feedbacks if s == 0]


def test_synced_sample_drains_the_previous_dispatch_first(monkeypatch):
    """Every sample is exactly one dispatch's 1000 us: the sync turn first
    waits on the events recorded after the previous dispatch, outside the
    timed window."""
    shim = fake_shim(monkeypatch, sync_every=2)

    def f():
        shim.log.append("run")
        shim.t[0] += 0.001

    for _ in range(4):
        shim._gated_call(f, (), {})
    assert costs(shim) == [1000] * 4
    # Turn 2 (a sync turn): drain turn 1's event, run, record, sync, and
    # sync again for the overhead sample.
    assert shim.log[:9] == ["run", ("record", "stream0"),
                            "sync", "run", ("record", "stream0"),
                            "sync", "sync", "run", ("record", "stream0")]
    assert shim.native.lib.acquires[0] == (0, 0)
    assert shim.native.lib.acquires[1:] == [(0, 1000)] * 3


def test_synced_sample_subtracts_the_sync_round_trip(monkeypatch):
    shim = fake_shim(monkeypatch, sync_every=1, read_cost=0.0005)

    def f():
        shim.t[0] += 0.002  # true device time: 2000 us

    for _ in range(3):
        shim._gated_call(f, (), {})
    assert costs(shim) == [2000] * 3


def test_compensated_sample_floors_at_100us(monkeypatch):
    shim = fake_shim(monkeypatch, sync_every=1, read_cost=0.0005)
    shim._gated_call(lambda: None, (), {})
    assert costs(shim) == [100]


def test_unsynced_samples_only_raise_the_estimate(monkeypatch):
    shim = fake_shim(monkeypatch, sync_every=4)
    durations = iter([0.003, 0.001, 0.002, 0.0005, 0.001])

    def f():
        shim.t[0] += next(durations)

    for _ in range(5):
        shim._gated_call(f, (), {})
    # Unsynced: 3000, then at least 3000; turn 4 is synced and resets the
    # estimate; turn 5 is unsynced again and may only raise it.
    assert costs(shim) == [3000, 3000, 3000, 500, 1000]


def test_without_cuda_the_wall_time_is_the_cost(monkeypatch):
    shim = fake_shim(monkeypatch, sync_every=1, on_card=False)
    durations = iter([0.003, 0.001])

    def f():
        shim.t[0] += next(durations)

    shim._gated_call(f, (), {})
    shim._gated_call(f, (), {})
    assert costs(shim) == [3000, 1000]  # the last sample wins
    assert shim.log == []  # no event recorded or waited on


def test_a_nested_dispatch_unit_is_part_of_the_outer_one(monkeypatch):
    """OffloadedTrainStep around a train step is one dispatch, not two."""
    shim = fake_shim(monkeypatch, on_card=False)
    monkeypatch.setattr(core, "_GATE", shim)
    inner = core.gated(lambda x: x + 1)
    outer = core.gated(lambda x: inner(x) * 2)
    assert outer(1) == 4
    assert len(shim.native.lib.acquires) == 1
    assert shim.dispatches == 1


def test_throttled_charges_a_fixed_slot(monkeypatch):
    shim = fake_shim(monkeypatch, on_card=True)
    gated = shim.throttled(lambda: shim.t.__setitem__(0, shim.t[0] + 0.004),
                           dev=3)
    gated()
    gated()
    assert shim.native.lib.acquires == [(3, 0), (3, 4000)]
    assert shim.log == []  # synchronous: no events


def test_cuda_graph_replay_is_a_dispatch_unit(monkeypatch):
    replayed = []
    monkeypatch.setattr(torch.cuda.CUDAGraph, "replay",
                        lambda graph: replayed.append(graph))
    monkeypatch.setattr(core, "_GATE", None)
    shim = fake_shim(monkeypatch, on_card=False)
    shim.install_torch_hooks()
    assert core._GATE is shim
    graph = object()
    torch.cuda.CUDAGraph.replay(graph)
    assert replayed == [graph]
    assert shim.dispatches == 1


# -- host swap at the gate ---------------------------------------------------


def always_over(store):
    """A spiller that finds the card (here the CPU) over its size at every
    check, so every idle gate spills what it may."""
    return oversub.PressureSpiller(
        store, physical_bytes=1, headroom_bytes=0,
        sample=lambda: [(torch.device("cpu"), 1 << 40, 1)])


@contextlib.contextmanager
def pinned_cpu_math():
    """One thread, rounding to nearest, denormals kept: the CPU's
    floating-point state for a bitwise comparison of two train runs,
    whatever an earlier test in the same worker process left.  With more
    than one thread, OpenMP's worker threads compute a share of each op,
    and a worker keeps the floating-point environment (the MXCSR rounding
    mode) of the thread that started it: a team started while the
    rounding mode was not to-nearest moves plain_train's losses in their
    last bits (6.1967148, 6.1967168 or 6.1967139 against 6.1967158 at
    step 0) for the rest of the process."""
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    threads, mode = torch.get_num_threads(), libm.fegetround()
    torch.set_num_threads(1)
    libm.fesetround(0)  # FE_TONEAREST
    torch.set_flush_denormal(False)
    try:
        yield
    finally:
        libm.fesetround(mode)
        torch.set_num_threads(threads)


def plain_train(steps=3):
    """Losses and final AdamW state of ``steps`` ungated train steps."""
    model = tiny_model()
    opt = ttrain.make_optimizer()
    state = ttrain.TrainState.for_model(model, opt)
    step = ttrain.make_train_step(model, opt)
    losses = [step(state, tokens(16, seed))[1].item()
              for seed in range(steps)]
    return losses, [t.clone() for t in state.opt_state.mu + state.opt_state.nu]


def swapped_train(monkeypatch):
    """A tiny train setup whose AdamW state is registered in a store the
    shim spills from at every idle gate; suspends are logged with whether
    a step was running."""
    model = tiny_model()
    opt = ttrain.make_optimizer()
    state = ttrain.TrainState.for_model(model, opt)
    step = ttrain.make_train_step(model, opt)
    store = oversub.HostSwapStore()
    store.register("adamw", {"mu": state.opt_state.mu,
                             "nu": state.opt_state.nu})
    shim = fake_shim(monkeypatch, on_card=False)
    shim._spiller = always_over(store)
    monkeypatch.setattr(core, "_GATE", shim)
    running = threading.Event()
    suspends = []
    suspend = store.suspend

    def logged(name):
        suspends.append(running.is_set())
        return suspend(name)

    store.suspend = logged

    def held_step(state, tokens):
        """One dispatch that holds the state a while, as a step on the
        card does until its work drains."""
        running.set()
        try:
            assert store._entries["adamw"].on_device, "ran on spilled state"
            out = step(state, tokens)  # nested: part of this dispatch
            time.sleep(0.02)
            return out
        finally:
            running.clear()

    return state, store, held_step, suspends


def same_bits(got, want):
    return all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(got, want))


def test_a_dispatch_brings_its_spilled_state_back(monkeypatch):
    """A dispatch that does not hold the state spills it; the next step's
    gate brings it back before the step runs: the same losses and state,
    bit for bit, as steps that were never spilled."""
    monkeypatch.setattr(core, "_GATE", None)  # the reference: no gate
    with pinned_cpu_math():
        want_losses, want_state = plain_train()
        state, store, held_step, suspends = swapped_train(monkeypatch)
        losses = []
        for seed in range(3):
            losses.append(core.gate(held_step, state,
                                    tokens(16, seed))[1].item())
            core.gate(lambda: None)  # holds nothing: spills the state
            assert not store._entries["adamw"].on_device
    assert suspends == [False] * 3
    store.resume_all()
    assert losses == want_losses
    assert same_bits(state.opt_state.mu + state.opt_state.nu, want_state)


def test_the_interposed_gate_spills_and_restores_without_the_limiter(
        monkeypatch):
    """Under the interposer (here its symbol, monkeypatched) with
    CUDA_OVERSUBSCRIBE=true the gate only spills and restores: a dispatch
    that does not hold the state spills it, the next step's gate brings it
    back, and the losses and state are those of steps never spilled, bit
    for bit; the limiter is never called and nothing is charged."""
    monkeypatch.setenv("CUDA_OVERSUBSCRIBE", "true")
    monkeypatch.setattr(core, "interposer_active", lambda: True)
    monkeypatch.setattr(core, "_GATE", None)  # the reference: no gate
    with pinned_cpu_math():
        want_losses, want_state = plain_train()
        state, store, held_step, suspends = swapped_train(monkeypatch)
        shim = core._GATE
        assert shim.interposed
        losses = []
        for seed in range(3):
            losses.append(core.gate(held_step, state,
                                    tokens(16, seed))[1].item())
            core.gate(lambda: None)
            assert not store._entries["adamw"].on_device
    assert suspends == [False] * 3
    store.resume_all()
    assert losses == want_losses
    assert same_bits(state.opt_state.mu + state.opt_state.nu, want_state)
    lib = shim.native.lib
    assert (lib.acquires, lib.feedbacks, shim.last_cost_us,
            shim.dispatches) == ([], [], {}, 0)


class InterposedCard:
    """One card as CUDA reports it through the interposer, for a process
    whose caching allocator holds ``other`` allocated and ``cached`` free
    bytes beside the store's state: the interposer charges the
    allocator's segments and a fixed ``context``, and refuses past
    ``grant``.  The store's tensors lie on the CPU; the spiller is shown
    them as this card's."""

    def __init__(self, store, grant, context, other, cached):
        self.store, self.grant, self.context = store, grant, context
        self.other = other
        self.reserved = other + cached + store.device_bytes()
        self.released = 0

    def allocated(self):
        return self.other + self.store.device_bytes()

    def used(self):  # the region's `used`
        self.reserved = max(self.reserved, self.allocated())
        return self.context + self.reserved

    def memory_reserved(self, i):
        return self.reserved

    def mem_get_info(self, i):
        return self.grant - self.used(), self.grant

    def empty_cache(self):
        self.released += self.reserved - self.allocated()
        self.reserved = self.allocated()


@pytest.mark.parametrize(
    "other_mib,cached_mib,spills",
    [(1024, 0, True), (512, 0, False), (512, 512, False)],
    ids=["past_the_pressure_point", "below_it", "past_it_by_its_cache"])
def test_the_interposed_pressure_point_counts_what_the_interposer_charges(
        monkeypatch, other_mib, cached_mib, spills):
    """Under the interposer the spiller reads the card as the interposer
    charges it: the grant as its size, the segments and the context as
    its use.  With 1024 MiB allocated beside the state, the allocated
    bytes and the headroom stay below the 2048 MiB grant, but the 640 MiB
    context takes the charge past the pressure point: the idle gate
    spills the state, the allocator's freed blocks go back, so the charge
    falls by the state's bytes, and the next dispatch that takes the state
    brings it back bit for bit.  With 512 MiB nothing spills; with 512 MiB
    more in the allocator's cache the charge is past the pressure point
    until the cache goes back, and then nothing spills."""
    monkeypatch.setenv("CUDA_OVERSUBSCRIBE", "true")
    monkeypatch.setattr(core, "interposer_active", lambda: True)
    store = oversub.HostSwapStore()
    monkeypatch.setattr(oversub, "_GLOBAL_STORE", store)
    state = {"mu": [torch.randn(4096) for _ in range(4)]}
    kept = [t.clone() for t in state["mu"]]
    store.register("adamw", state)
    nbytes = store.device_bytes()
    card = InterposedCard(store, grant=2048 * MIB, context=640 * MIB,
                          other=other_mib * MIB, cached=cached_mib * MIB)
    assert card.allocated() + 512 * MIB < card.grant
    monkeypatch.setattr(oversub, "_cards",
                        lambda: [(0, torch.device("cpu"))])
    for name in ("memory_reserved", "mem_get_info", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, getattr(card, name))
    shim = fake_shim(monkeypatch, on_card=False)
    assert shim.interposed
    shim.attach_pressure_spiller()
    monkeypatch.setattr(core, "_GATE", shim)
    charged = card.used()
    core.gate(lambda: None)  # holds nothing: may spill the state
    assert store._entries["adamw"].on_device is not spills
    assert charged - card.used() == card.released == (
        nbytes if spills else cached_mib * MIB)
    core.gate(lambda state: None, state)
    assert store._entries["adamw"].on_device
    assert same_bits(state["mu"], kept)
    lib = shim.native.lib
    assert (lib.acquires, lib.feedbacks, shim.dispatches) == ([], [], 0)


def test_no_spill_while_a_gated_step_holds_the_state(monkeypatch):
    """Another thread's dispatches find the card over its size the whole
    time: they spill only between steps, never during one, and the steps
    run without error to the same results, bit for bit."""
    want_losses, want_state = plain_train()
    state, store, held_step, suspends = swapped_train(monkeypatch)
    stop = threading.Event()

    def pressure():
        while not stop.is_set():
            core.gate(lambda: None)

    other = threading.Thread(target=pressure)
    other.start()
    try:
        losses = []
        for seed in range(3):
            losses.append(
                core.gate(held_step, state, tokens(16, seed))[1].item())
            time.sleep(0.02)  # a gap between steps for the spills
    finally:
        stop.set()
        other.join(timeout=30)
    assert suspends and not any(suspends), suspends
    store.resume_all()
    assert losses == want_losses
    assert same_bits(state.opt_state.mu + state.opt_state.nu, want_state)


def tiny_model():
    cfg = LlamaConfig(vocab=256, dim=64, n_layers=2, n_heads=4,
                      n_kv_heads=2, ffn_hidden=128, dtype="float32")
    return init_weights(cfg, torch.Generator().manual_seed(0), device="cpu")


def tokens(n, seed=0):
    return torch.from_numpy(
        np.random.RandomState(seed).randint(0, 256, (2, n + 1)))


def train_losses(step_kind):
    """Three steps' losses, and the dispatches they are (one a step)."""
    model = tiny_model()
    opt = ttrain.make_optimizer()
    state = ttrain.TrainState.for_model(model, opt)
    step = ttrain.make_train_step(model, opt)
    if step_kind == "offloaded":
        state = ttrain.offload_state(state)
        step = ttrain.OffloadedTrainStep(step)
    return [step(state, tokens(16, seed))[1].item() for seed in range(3)], 3


def engine_tokens():
    """The engine's completions, and the dispatches they are (one a
    prefill, one a decode horizon)."""
    eng = tserve.ServingEngine(tiny_model(), max_slots=2, max_len=48,
                               horizon=2)
    rng = np.random.RandomState(1)
    for n in (5, 9, 17):
        eng.submit(rng.randint(1, 256, n).tolist(), 6)
    done = sorted((c.request_id, c.tokens) for c in eng.run())
    return done, eng.stats["prefills"] + eng.stats["decode_dispatches"]


@pytest.mark.parametrize("run", [
    lambda: train_losses("device"), lambda: train_losses("offloaded"),
    engine_tokens], ids=["train_step", "offloaded_train_step",
                         "serving_engine"])
def test_the_gate_is_the_identity_without_a_shim(monkeypatch, run):
    """No shim installed: the step callables run as they are.  Gated by a
    shim over a stub native: the same outputs bit for bit, and one
    dispatch per step callable."""
    monkeypatch.setattr(core, "_GATE", None)
    plain, _ = run()
    shim = fake_shim(monkeypatch, on_card=False)
    monkeypatch.setattr(core, "_GATE", shim)
    gated, dispatches = run()
    assert gated == plain
    assert shim.dispatches == dispatches > 0
    assert len(shim.native.lib.acquires) == dispatches


def test_gate_returns_the_callables_own_result(monkeypatch):
    monkeypatch.setattr(core, "_GATE", None)
    out = object()
    assert core.gate(lambda a, b=None: (a, b, out), 1, b=2) == (1, 2, out)


# -- the memory cap's arithmetic --------------------------------------------


def test_memory_cap_fraction_is_the_grant_over_the_total():
    total = 85_031_714_816  # an injected card size
    got = core.memory_cap_fractions({0: 24000 * MIB, 1: 0, 2: 8000 * MIB},
                                    {0: total, 2: total})
    assert got == {0: 24000 * MIB / total, 2: 8000 * MIB / total}
    assert core.memory_cap_fractions({0: 2 * total}, {0: total}) == {0: 1.0}


@pytest.mark.parametrize("others_mib,want_mib", [
    (0, 24000), (10000, 14000), (24000, 0), (30000, 0)])
def test_memory_cap_fraction_leaves_out_the_pods_other_processes(
        others_mib, want_mib):
    total = 85_031_714_816
    got = core.memory_cap_fractions({0: 24000 * MIB}, {0: total},
                                    {0: others_mib * MIB})
    assert got == {0: want_mib * MIB / total}


def test_apply_memory_cap_sets_one_fraction_per_granted_device(monkeypatch):
    total = 80 * 1024 * MIB
    set_calls = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.setattr(
        torch.cuda, "get_device_properties",
        lambda i: type("Props", (), {"total_memory": total})())
    monkeypatch.setattr(torch.cuda, "set_per_process_memory_fraction",
                        lambda f, i: set_calls.append((f, i)))
    shim = core.Shim(FakeNative({0: 24000 * MIB, 1: 0}))
    assert shim.apply_memory_cap() == {0: 24000 * MIB / total}
    assert set_calls == [(24000 * MIB / total, 0)]
    # A grant for a device torch does not see is a cap that cannot hold.
    shim = core.Shim(FakeNative({0: 24000 * MIB, 3: 1000 * MIB}))
    with pytest.raises(RuntimeError, match=r"devices \[3\]"):
        shim.apply_memory_cap()


def test_watchdog_refresh_follows_the_pods_other_processes(monkeypatch):
    """The cap is set again from the region each watchdog interval: the
    grant less what the other processes published, this process's own
    publication left out."""
    total = 80 * 1024 * MIB
    set_calls = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.setattr(
        torch.cuda, "get_device_properties",
        lambda i: type("Props", (), {"total_memory": total})())
    monkeypatch.setattr(torch.cuda, "set_per_process_memory_fraction",
                        lambda f, i: set_calls.append((f, i)))
    monkeypatch.setattr(core, "_cuda_ready", lambda: torch)
    shim = core.Shim(FakeNative({0: 24000 * MIB}))
    lib = shim.native.lib
    shim.apply_memory_cap()
    shim._published[0] = 3000 * MIB  # this process's own use
    lib.used[0] = 3000 * MIB + 10000 * MIB  # and another's
    shim.refresh_memory_cap()
    shim.refresh_memory_cap()  # unchanged: not set again
    lib.used[0] = 3000 * MIB  # the other process is gone
    shim.refresh_memory_cap()
    assert set_calls == [(24000 * MIB / total, 0), (14000 * MIB / total, 0),
                         (24000 * MIB / total, 0)]


@pytest.mark.parametrize("held_mib", [10000, 30000])
def test_cap_leaves_out_a_second_process_of_the_pod(tmp_path, libs, held_mib):
    """Two processes of one pod under a 24000 MiB grant: while the first
    has published ``held_mib``, the second's cap is what the grant leaves;
    once the first has gone, the whole grant."""
    total = 85_031_714_816
    env = grant_env(PORT, tmp_path / "r.cache", limits_mib={0: 24000})
    ready, done = tmp_path / "ready", tmp_path / "done"
    holder = subprocess.Popen(
        [sys.executable, "-c", PRELUDE + ATTACH + f"""
fn("set_used", [ctypes.c_int, u64], None)(0, {held_mib} * MIB)
open({str(ready)!r}, "w").close()
t0 = time.time()
while not os.path.exists({str(done)!r}) and time.time() - t0 < 30:
    time.sleep(0.02)
shutdown()
"""], env=dict(env, T_PREFIX=PORT.prefix, T_LIB=libs["port"]))
    second = shim_child(PORT) + f"print(shim.cap_fractions({{0: {total}}}))"
    try:
        t0 = time.time()
        while not ready.exists() and time.time() - t0 < 30:
            time.sleep(0.02)
        assert ready.exists(), "the first process never attached"
        shared = run_child(PORT, libs, second, env).stdout
    finally:
        done.touch()
        holder.wait(timeout=30)
    alone = run_child(PORT, libs, second, env).stdout
    left = max(0, 24000 - held_mib) * MIB
    assert shared.strip() == str({0: left / total})
    assert alone.strip() == str({0: 24000 * MIB / total})


@pytest.mark.parametrize("interval", [0.05, 0.2])
def test_stop_ends_the_watchdog_within_two_intervals(interval):
    """The counterpart of the JAX shim's stop(): the watchdog waits on an
    event between ticks, so stop() ends it within an interval, and the
    host-swap spiller is detached."""
    shim = core.Shim(FakeNative({0: 1000 * MIB}))
    shim._spiller = object()  # attached, as attach_pressure_spiller does
    shim.start_watchdog(interval=interval)
    time.sleep(interval * 1.5)  # mid-wait, one tick done
    assert shim._watchdog.is_alive()
    t0 = time.monotonic()
    shim.stop()
    shim._watchdog.join(timeout=2 * interval)
    assert not shim._watchdog.is_alive()
    assert time.monotonic() - t0 < 2 * interval
    assert shim._spiller is None
