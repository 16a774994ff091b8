"""The port's CUDA driver-API interposer against the JAX package's PJRT one.

``csrc/vgpu/cuda_interposer.cc`` is preloaded (``LD_PRELOAD``) into a C
driver (``csrc/vgpu/test_interposer.cc``) that reaches the driver the way
the CUDA runtime does: ``dlopen("libcuda.so.1")``, ``dlsym`` of
``cuGetProcAddress_v2``, every other entry point through that.  The driver
it finds is ``csrc/vgpu/mock_cuda.cc`` (``LD_LIBRARY_PATH``), as the JAX
package's ``lib/tpu/src/test_interposer.cc`` drives its interposer over
``mock_pjrt.cc``.  Every check of that driver that has a CUDA counterpart
is in the port's ``main`` mode:

=========================================  ====================================
lib/tpu/src/test_interposer.cc             csrc/vgpu/test_interposer.cc (main)
=========================================  ====================================
GetPjrtApi returns a table                 dlsym(libcuda, cuGetProcAddress_v2)
                                           returns the interposer's hook
interposer exports the vtpu control        interposer exports the vgpu control
surface                                    surface (+ attached to the region)
Client_Create                              cuInit and primary contexts
AddressableDevices passthrough             device count passthrough
50 MiB alloc inside grant                  50 MiB alloc inside grant
60 MiB over-grant alloc refused            60 MiB over-grant alloc refused
refusal is RESOURCE_EXHAUSTED              ... with CUDA_ERROR_OUT_OF_MEMORY;
                                           the refused alloc never reached the
                                           driver
refusal message names vtpu                 (none: a CUresult carries no text)
MemoryStats fabricated                     (none: the driver has memory info)
bytes_limit reports the grant              cuMemGetInfo total reports the grant
bytes_in_use reports accounted usage       cuMemGetInfo reports the accounted
                                           usage; nvmlDeviceGetMemoryInfo too
Buffer_Destroy                             cuMemFree
60 MiB fits after free                     60 MiB fits after free
copy to empty dev1 inside its grant        60 MiB on uncapped device 1
over-grant copy to dev0 refused            over-grant alloc on device 0 refused
Execute passthrough                        cuLaunchKernel passthrough;
                                           per-thread-stream lookup reaches
                                           cuLaunchKernel_ptsz
execute output charged post-hoc            stream-ordered alloc charged
                                           (60 + 1 MiB)
non-JAX client throttled to duty cycle     launches throttled to the duty cycle
throttle wait bounded                      throttle wait bounded; each launch
                                           charged its event-timed device time;
                                           waits are the charge over the rate
(none: one client a chip)                  launches timed beside a sharer (the
                                           switch on) do not raise the
                                           estimate, shorter ones lower it;
                                           alone again, it follows
old-ABI caller (small struct_size)         cuCtxCreate at 3020, 11040, 12080
                                           reach the _v2, _v3, _v4 hooks; an
                                           unhooked entry point is the
                                           driver's own
Destroy invalidates the output-count       (none: no executable cache)
cache; Execute after Destroy
=========================================  ====================================

The scenario: a 100 MiB grant on device 0; 50 MiB in; 60 MiB refused with
CUDA_ERROR_OUT_OF_MEMORY; the free releases it and 60 MiB then fits; memory
info virtualised; a 30% duty waits in test-clock mode (400 launches of 2 ms
of mock device time, read through the mock's events).  Beyond it: each
context is charged its fixed footprint, with or without NVML, and the VMM
pair is charged and released; no hook is
missing from either lookup path; outside a managed container every call
passes through; two processes of a pod are refused together at one grant
(the CPU check of a pod's processes under one grant, beside
test_torch_shim.py's test_cap_leaves_out_a_second_process_of_the_pod);
the Python shim stands down under the interposer; and the same sequence
through the JAX package's PJRT interposer (its own built artifacts, as
tests/test_pjrt_interposer.py runs them) leaves the same region readings.
"""

import json
import os
import subprocess
import sys
import sysconfig
import time
from pathlib import Path

import pytest

from k8s_vgpu_scheduler_tpu.monitor.reader import RegionReader
from k8s_vgpu_scheduler_tpu.util.nativebuild import build_native
from k8s_vgpu_scheduler_tpu_torch.ops import _kernels

REPO = Path(__file__).resolve().parent.parent
TPU_BUILD = REPO / "lib" / "tpu" / "build"
MIB = 1 << 20

# The hooks the interposer must have, by exported (versioned) name.
EXPECTED_HOOKS = {
    "cuInit", "cuGetProcAddress", "cuGetProcAddress_v2",
    "cuMemAlloc_v2", "cuMemAllocPitch_v2", "cuMemAllocManaged",
    "cuMemFree_v2", "cuMemAllocAsync", "cuMemAllocAsync_ptsz",
    "cuMemAllocFromPoolAsync", "cuMemAllocFromPoolAsync_ptsz",
    "cuMemFreeAsync", "cuMemFreeAsync_ptsz", "cuMemCreate", "cuMemRelease",
    "cuMemGetInfo_v2", "cuDeviceTotalMem_v2", "cuDevicePrimaryCtxRetain",
    "cuCtxCreate_v2", "cuCtxCreate_v3", "cuCtxCreate_v4",
    "cuLaunchKernel", "cuLaunchKernel_ptsz", "cuLaunchKernelEx",
    "cuLaunchKernelEx_ptsz", "cuLaunchCooperativeKernel",
    "cuLaunchCooperativeKernel_ptsz", "cuGraphLaunch", "cuGraphLaunch_ptsz",
    "nvmlDeviceGetMemoryInfo", "nvmlDeviceGetMemoryInfo_v2",
}
NVML_HOOKS = {"nvmlDeviceGetMemoryInfo", "nvmlDeviceGetMemoryInfo_v2"}


@pytest.fixture(scope="module")
def built():
    return {"interposer": _kernels.build_interposer(),
            "mock": _kernels.build_mock_cuda(),
            "driver": _kernels.build_interposer_test()}


def clean_env():
    """Our env without any grant, preload or mock setting."""
    return {k: v for k, v in os.environ.items()
            if not k.startswith(("CUDA_", "TPU_", "VTPU_", "NVIDIA_",
                                 "GPU_CORE", "MOCK_", "LD_PRELOAD"))}


def preload_env(built, region=None, **extra):
    """A container's env: the interposer preloaded, the mock driver found
    as libcuda.so.1, and (with ``region``) a managed container's grant.  A
    context is charged what the mock's takes (nothing, unless
    ``MOCK_CTX_BYTES`` says), so the reference scenario's numbers hold."""
    env = clean_env()
    env["LD_PRELOAD"] = str(built["interposer"])
    env["LD_LIBRARY_PATH"] = str(built["mock"])
    env["VTPU_CONTEXT_MIB"] = "0"
    if region is not None:
        env["CUDA_DEVICE_MEMORY_SHARED_CACHE"] = str(region)
    env.update({k: str(v) for k, v in extra.items()})
    return env


def drive(built, env, *args, check=True, timeout=120):
    res = subprocess.run([str(built["driver"]), *args], env=env,
                         capture_output=True, text=True, timeout=timeout)
    if check:
        assert res.returncode == 0 and "RESULT PASS" in res.stdout, (
            f"driver {args} failed:\n{res.stdout}\n{res.stderr}")
        assert "FAIL" not in res.stdout
    return res


def passes(res):
    return [line[5:] for line in res.stdout.splitlines()
            if line.startswith("PASS ")]


@pytest.mark.parametrize("entries", ["exported", "internal"])
def test_runtime_path_capped_and_throttled(built, tmp_path, entries):
    """The reference driver's scenario (see the table above).  With
    ``internal`` the driver's lookup hands out entry points that are not
    its exported symbols (cuMemAlloc_v2, cuLaunchKernel_ptsz): the hooks are
    then found by name, CUDA version and stream flag."""
    extra = {"MOCK_INTERNAL_ENTRIES": 1} if entries == "internal" else {}
    res = drive(built, preload_env(
        built, tmp_path / "r.cache", CUDA_DEVICE_MEMORY_LIMIT_0="100m",
        CUDA_DEVICE_SM_LIMIT=30, CUDA_TASK_PRIORITY=1, **extra))
    assert len(passes(res)) == 28


@pytest.mark.parametrize("nvml", [True, False], ids=["nvml", "no_nvml"])
def test_context_modules_and_vmm_are_charged(built, tmp_path, nvml):
    """Each primary and created context is charged VTPU_CONTEXT_MIB when it
    is made, not what the device's free memory fell by (the mock takes
    MOCK_CTX_BYTES, set to differ: on a shared card that fall counts other
    processes too), and a context the grant cannot hold is refused before
    the driver is called; launches charge nothing; cuMemCreate/cuMemRelease,
    pitched and managed allocations are charged and released;
    cuDeviceTotalMem and NVML's _v2 report the grant.  Without
    libnvidia-ml (a directory holding the mock libcuda alone) every charge
    is the same: none comes through NVML."""
    env = preload_env(
        built, tmp_path / "r.cache", CUDA_DEVICE_MEMORY_LIMIT_0="1000m",
        CUDA_DEVICE_MEMORY_LIMIT_1="1000m", MOCK_CTX_BYTES=64 * MIB,
        VTPU_CONTEXT_MIB=70)
    if not nvml:
        alone = tmp_path / "driver_only"
        alone.mkdir()
        (alone / "libcuda.so.1").symlink_to(built["mock"] / "libcuda.so.1")
        env["LD_LIBRARY_PATH"] = str(alone)
    res = drive(built, env, "context")
    assert ("NVML absent" in res.stdout) != nvml
    assert len(passes(res)) == (17 if nvml else 16)


def test_a_fixed_charge_outside_the_allocations(built, tmp_path):
    """vgpu_interposer_charge (what a process charges for a tracer's
    buffers): taken where the grant holds it, shown by cuMemGetInfo and
    counted; refused past the grant, taking nothing; allocations then get
    only what it leaves."""
    res = drive(built, preload_env(
        built, tmp_path / "r.cache", CUDA_DEVICE_MEMORY_LIMIT_0="100m"),
        "charge")
    assert len(passes(res)) == 9


@pytest.mark.parametrize("path", ["dlsym", "lookup"])
def test_no_hook_is_missing(built, tmp_path, path):
    """Every expected hook is what dlsym(libcuda or libnvidia-ml, name)
    returns, and what cuGetProcAddress_v2 returns for the name, CUDA version
    and stream flag that select it; the interposer lists no other."""
    res = drive(built, preload_env(
        built, tmp_path / "r.cache", CUDA_DEVICE_MEMORY_LIMIT_0="100m"),
        "hooks")
    listed = next(line for line in res.stdout.splitlines()
                  if line.startswith("HOOKS "))[6:].split(",")
    assert set(listed) == EXPECTED_HOOKS and len(listed) == len(set(listed))
    found = {}
    for line in res.stdout.splitlines():
        parts = line.split()
        if parts[:2] == ["HOOK", path]:
            found[parts[2]] = parts[3]
    want = EXPECTED_HOOKS if path == "dlsym" else EXPECTED_HOOKS - NVML_HOOKS
    assert found == dict.fromkeys(want, "ok")


@pytest.mark.parametrize("sm_limit", [None, 30])
def test_launch_cost_times_both_paths(built, tmp_path, sm_limit):
    """The driver's launch_cost mode (chip_smoke.py runs it on the card):
    a null kernel loaded from PTX, launched through the hooks and straight
    to the driver, both timed; the hooked launches are the ones counted."""
    extra = {} if sm_limit is None else {
        "CUDA_DEVICE_SM_LIMIT": sm_limit,
        "GPU_CORE_UTILIZATION_POLICY": "force"}
    res = drive(built, preload_env(built, tmp_path / "r.cache", **extra),
                "launch_cost", "2000")
    line = next(x for x in res.stdout.splitlines()
                if x.startswith("LAUNCH_NS "))
    _, _, hooked, _, direct = line.split()
    assert float(hooked) > 0 and float(direct) > 0


@pytest.mark.parametrize("marked", ["unmanaged", "disabled"])
def test_outside_a_managed_container_every_call_passes_through(
        built, tmp_path, marked):
    """No region env, or VTPU_DISABLE: nothing attaches, nothing is capped,
    counted or throttled, and the memory info is the mock's physical."""
    extra = {} if marked == "unmanaged" else {
        "CUDA_DEVICE_MEMORY_SHARED_CACHE": tmp_path / "r.cache",
        "VTPU_DISABLE": 1}
    drive(built, preload_env(built, None, CUDA_DEVICE_MEMORY_LIMIT_0="100m",
                             CUDA_DEVICE_SM_LIMIT=30, **extra), "passthrough")
    assert not (tmp_path / "r.cache").exists()


def test_a_failed_attach_fails_cuinit_loudly(built, tmp_path):
    """A managed container whose region cannot be attached never runs
    CUDA unenforced: cuInit fails and says why."""
    blocker = tmp_path / "file"
    blocker.write_text("")
    res = drive(built, preload_env(built, blocker / "r.cache",
                                   CUDA_DEVICE_MEMORY_LIMIT_0="100m"),
                check=False)
    assert res.returncode == 1
    assert "FAIL cuInit and primary contexts" in res.stdout
    assert "vgpu-interposer" in res.stderr and "cuInit refused" in res.stderr


@pytest.mark.parametrize("block_mib", [10, 7])
def test_two_processes_of_a_pod_are_refused_together(built, tmp_path,
                                                     block_mib):
    """Two processes of one pod share one region and one 100 MiB grant and
    take blocks at the same time: each allocation is charged atomically
    against the pod's total, so together they hold what the grant admits
    and no more, with no watchdog interval in between."""
    region = tmp_path / "r.cache"
    go, done = tmp_path / "go", tmp_path / "done"
    procs = []
    for i in range(2):
        env = preload_env(built, region, CUDA_DEVICE_MEMORY_LIMIT_0="100m",
                          POD_READY=tmp_path / f"ready{i}", POD_GO=go,
                          POD_DONE=done)
        procs.append(subprocess.Popen(
            [str(built["driver"]), "pod", str(block_mib)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        t0 = time.time()
        while not all((tmp_path / f"ready{i}").exists() for i in range(2)):
            assert time.time() - t0 < 30, "the pod's processes never started"
            time.sleep(0.01)
        go.touch()
        blocks, lines = [], []
        for p in procs:  # each prints BLOCKS, then holds them until done
            line = ""
            while not line.startswith("BLOCKS"):
                line = p.stdout.readline()
                assert line, "a pod process ended before taking its blocks"
            lines.append(line)
            blocks.append(int(line.split()[1]))
        r = RegionReader(str(TPU_BUILD / "libvtpu.so")).open(str(region))
        try:
            used, pids = r.used(0), r.proc_pids()
        finally:
            r.close()
    finally:
        done.touch()
        outs = [p.communicate(timeout=30) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert sum(blocks) == 100 // block_mib, lines
    assert used == sum(blocks) * block_mib * MIB <= 100 * MIB
    assert sorted(pids) == sorted(p.pid for p in procs)


SHIM_CHILD = """
import json, os, sys
sys.path.insert(0, os.environ["REPO"])
from k8s_vgpu_scheduler_tpu_torch.shim import core
shim = core.install(watchdog=False, **json.loads(os.environ["INSTALL"]))
region = shim.native.read_region(os.environ["CUDA_DEVICE_MEMORY_SHARED_CACHE"])
limiter = []
for name in ("vgpu_rate_acquire", "vgpu_rate_feedback"):
    setattr(shim.native.lib, name,
            lambda *a, name=name, real=getattr(shim.native.lib, name):
            (limiter.append(name), real(*a))[1])
gated = core.gate(lambda: "ran")
print(json.dumps(dict(
    active=core.interposer_active(), interposed=shim.interposed,
    native_is_the_process=shim.native.interposed, gate=core._GATE is not None,
    fractions=shim.fractions, spiller=shim._spiller is not None,
    dispatches=shim.dispatches, gated=gated, pids=region["pids"],
    limiter=limiter, costs=shim.last_cost_us,
    pid=os.getpid(), charge=core.interposer_charge(0, 1 << 20),
    overcharge=core.interposer_charge(0, 1 << 30))))
"""


@pytest.mark.parametrize("preloaded,oversubscribed",
                         [(True, True), (False, False), (True, False)],
                         ids=["interposed", "alone", "interposed_flat"])
def test_python_shim_stands_down_under_the_interposer(built, tmp_path,
                                                      preloaded,
                                                      oversubscribed):
    """With the interposer loaded the shim finds its symbol in the process,
    binds to its vgpu_* (one proc slot, one attach), and sets no memory
    fraction and limits nothing, whatever install is asked for; an
    oversubscribed grant (CUDA_OVERSUBSCRIBE=true) gets the host-swap
    spiller and its spill-only gate, as the JAX shim keeps its spiller
    under its PJRT interposer: a dispatch through the gate runs, and the
    limiter is never called and charged nothing; a grant that does not
    oversubscribe gets no gate at all.  Without the interposer,
    install brings the rate-limiting gate up (the memory cap and the
    spiller need a card).  ``interposer_charge`` reaches the interposer's
    charge from Python, and answers None without it."""
    env = preload_env(built, tmp_path / "r.cache", REPO=REPO,
                      CUDA_DEVICE_MEMORY_LIMIT_0="100m",
                      INSTALL=json.dumps({}))
    if oversubscribed:
        env["CUDA_OVERSUBSCRIBE"] = "true"
    if not preloaded:
        del env["LD_PRELOAD"]
        env["INSTALL"] = json.dumps({"memory_cap": False})
    res = subprocess.run([sys.executable, "-c", SHIM_CHILD], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    got = json.loads(res.stdout.splitlines()[-1])
    assert got["pids"] == [got["pid"]] and got["gated"] == "ran"
    assert got["fractions"] == {}
    assert got["dispatches"] == (0 if preloaded else 1)
    # interposer_charge (a tracer's footprint): taken inside the grant,
    # refused past it; None where no interposer enforces.
    assert (got["charge"], got["overcharge"]) == (
        (True, False) if preloaded else (None, None))
    if preloaded:
        assert got["active"] and got["interposed"]
        assert got["native_is_the_process"]
        assert got["gate"] == got["spiller"] == oversubscribed
        assert got["limiter"] == [] and got["costs"] == {}
    else:
        assert not got["active"] and not got["interposed"]
        assert not got["native_is_the_process"]
        assert got["gate"] and not got["spiller"]
        assert got["limiter"] == ["vgpu_rate_acquire", "vgpu_rate_feedback"]


# The PJRT side of the same sequence, compiled against the same
# pjrt_c_api.h as lib/tpu's own driver: BufferFromHostBuffer for an
# allocation, Buffer_Destroy for a free, CopyToDevice onto another device,
# Execute with no outputs for a launch.
PJRT_STEPS = r"""
#include <dlfcn.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include "xla/pjrt/c/pjrt_c_api.h"

static const PJRT_Api* api;
static uint64_t (*used)(int);
static PJRT_Client* client;

static void step(const char* name, PJRT_Error* e) {
  int refused = 0;
  if (e) {
    PJRT_Error_GetCode_Args c;
    memset(&c, 0, sizeof(c));
    c.struct_size = PJRT_Error_GetCode_Args_STRUCT_SIZE;
    c.error = e;
    api->PJRT_Error_GetCode(&c);
    refused = c.code == PJRT_Error_Code_RESOURCE_EXHAUSTED;
    PJRT_Error_Destroy_Args d;
    memset(&d, 0, sizeof(d));
    d.struct_size = PJRT_Error_Destroy_Args_STRUCT_SIZE;
    d.error = e;
    api->PJRT_Error_Destroy(&d);
  }
  printf("STEP %s refused=%d used0=%llu used1=%llu\n", name, refused,
         (unsigned long long)used(0), (unsigned long long)used(1));
}

static PJRT_Error* alloc(PJRT_Device* dev, uint64_t mib, PJRT_Buffer** out) {
  static char data[1];
  int64_t dims[1] = {(int64_t)(mib << 20)};
  PJRT_Client_BufferFromHostBuffer_Args a;
  memset(&a, 0, sizeof(a));
  a.struct_size = PJRT_Client_BufferFromHostBuffer_Args_STRUCT_SIZE;
  a.client = client;
  a.data = data;
  a.type = PJRT_Buffer_Type_U8;
  a.dims = dims;
  a.num_dims = 1;
  a.device = dev;
  PJRT_Error* e = api->PJRT_Client_BufferFromHostBuffer(&a);
  *out = e ? nullptr : a.buffer;
  return e;
}

static PJRT_Error* destroy(PJRT_Buffer* b) {
  PJRT_Buffer_Destroy_Args d;
  memset(&d, 0, sizeof(d));
  d.struct_size = PJRT_Buffer_Destroy_Args_STRUCT_SIZE;
  d.buffer = b;
  return api->PJRT_Buffer_Destroy(&d);
}

static PJRT_Error* copy(PJRT_Buffer* b, PJRT_Device* dev) {
  PJRT_Buffer_CopyToDevice_Args c;
  memset(&c, 0, sizeof(c));
  c.struct_size = PJRT_Buffer_CopyToDevice_Args_STRUCT_SIZE;
  c.buffer = b;
  c.dst_device = dev;
  return api->PJRT_Buffer_CopyToDevice(&c);
}

int main() {
  void* h = dlopen(getenv("VTPU_INTERPOSER_SO"), RTLD_NOW);
  if (!h) return 2;
  api = ((const PJRT_Api* (*)(void))dlsym(h, "GetPjrtApi"))();
  used = (uint64_t(*)(int))dlsym(h, "vtpu_get_used");
  uint64_t (*limit)(int) = (uint64_t(*)(int))dlsym(h, "vtpu_get_limit");
  if (!api || !used || !limit) return 2;
  PJRT_Client_Create_Args ca;
  memset(&ca, 0, sizeof(ca));
  ca.struct_size = PJRT_Client_Create_Args_STRUCT_SIZE;
  if (api->PJRT_Client_Create(&ca)) return 2;
  client = ca.client;
  PJRT_Client_AddressableDevices_Args da;
  memset(&da, 0, sizeof(da));
  da.struct_size = PJRT_Client_AddressableDevices_Args_STRUCT_SIZE;
  da.client = client;
  if (api->PJRT_Client_AddressableDevices(&da)) return 2;
  PJRT_Device* dev0 = da.addressable_devices[0];
  PJRT_Device* dev1 = da.addressable_devices[1];
  printf("LIMIT %llu %llu\n", (unsigned long long)limit(0),
         (unsigned long long)limit(1));
  PJRT_Buffer *b50, *b60, *b60b;
  step("alloc50", alloc(dev0, 50, &b50));
  step("alloc60", alloc(dev0, 60, &b60));
  step("free50", destroy(b50));
  step("alloc60b", alloc(dev0, 60, &b60b));
  step("dev1_60", copy(b60b, dev1));
  step("dev0_60", copy(b60b, dev0));
  step("free60b", destroy(b60b));
  for (int i = 0; i < 3; ++i) {
    PJRT_LoadedExecutable_Execute_Args ea;
    memset(&ea, 0, sizeof(ea));
    ea.struct_size = PJRT_LoadedExecutable_Execute_Args_STRUCT_SIZE;
    ea.executable = (PJRT_LoadedExecutable*)&ea;
    ea.num_devices = 1;
    PJRT_Error* e = api->PJRT_LoadedExecutable_Execute(&ea);
    if (e) return 3;
  }
  step("launch3", nullptr);
  return 0;
}
"""


def pjrt_include():
    """Where lib/tpu's Makefile finds pjrt_c_api.h (the tensorflow wheel)."""
    path = Path(sysconfig.get_paths()["purelib"]) / "tensorflow" / "include"
    return path if (path / "xla/pjrt/c/pjrt_c_api.h").exists() else None


def region_view(path):
    r = RegionReader(str(TPU_BUILD / "libvtpu.so")).open(str(path))
    assert r is not None, f"cannot open {path}"
    try:
        n = r.num_devices
        return {"num_devices": n, "limit": [r.limit(i) for i in range(n)],
                "used": [r.used(i) for i in range(n)],
                "procs": len(r.proc_pids())}
    finally:
        r.close()


def test_region_readings_equal_the_pjrt_interposers(built, tmp_path):
    """The JAX package's PJRT interposer (libvtpu_pjrt.so over
    mock_pjrt.so) and the port's interposer (over the mock driver) run the
    same grant and the same allocation and launch sequence: each region's
    limit, its used after each step and the proc count after exit agree."""
    include = pjrt_include()
    if include is None:
        pytest.skip("no pjrt_c_api.h: the PJRT interposer cannot be built")
    build_native(check=True)
    src = tmp_path / "pjrt_steps.cc"
    src.write_text(PJRT_STEPS)
    exe = tmp_path / "pjrt_steps"
    subprocess.run(["g++", "-O2", "-std=c++17", f"-I{include}", str(src),
                    "-ldl", "-o", str(exe)], check=True, capture_output=True)
    jax_env = clean_env()
    jax_env.update(VTPU_INTERPOSER_SO=str(TPU_BUILD / "libvtpu_pjrt.so"),
                   VTPU_REAL_PJRT_PLUGIN=str(TPU_BUILD / "mock_pjrt.so"),
                   TPU_DEVICE_MEMORY_SHARED_CACHE=str(tmp_path / "jax.cache"),
                   TPU_DEVICE_MEMORY_LIMIT_0="100",
                   TPU_VISIBLE_CHIPS="mock-0,mock-1", MOCK_EXEC_US="0")
    jax = subprocess.run([str(exe)], env=jax_env, capture_output=True,
                         text=True, timeout=60)
    assert jax.returncode == 0, jax.stderr
    port = drive(built, preload_env(
        built, tmp_path / "port.cache", CUDA_DEVICE_MEMORY_LIMIT_0="100m",
        NVIDIA_VISIBLE_DEVICES="GPU-a,GPU-b"), "steps")

    def steps(out):
        return [line for line in out.splitlines()
                if line.startswith(("STEP ", "LIMIT "))]

    want = steps(jax.stdout)
    assert len(want) == 9 and want[0] == f"LIMIT {100 * MIB} 0"
    assert steps(port.stdout) == want
    after = region_view(tmp_path / "jax.cache")
    assert region_view(tmp_path / "port.cache") == after
    assert after == {"num_devices": 2, "limit": [100 * MIB, 0],
                     "used": [0, 0], "procs": 0}
