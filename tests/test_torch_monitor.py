"""The port's node monitor against the JAX package's, on the CPU.

The port's reader, feedback loop, QoS controller, usage sampler and
entry point (``k8s_vgpu_scheduler_tpu_torch/monitor/``, ``accounting/``,
``cmd/monitor.py``) are driven through the same sequences as the JAX
package's and must agree exactly: everything compared is an integer, a
flag or region state, so the tolerance is 0.  Workload children write
their regions through each native library (``libvgpu_torch`` for the
port, ``libvtpu`` for the reference) and are stepped by a line handshake
on their stdin, and every monitor tick is driven by hand: nothing here
times anything by the wall clock.
"""

import dataclasses
import shutil
import subprocess
import sys
import threading
import types

import pytest

from k8s_vgpu_scheduler_tpu.accounting import sampler as jax_sampler
from k8s_vgpu_scheduler_tpu.cmd import monitor as jax_cmd
from k8s_vgpu_scheduler_tpu.health.faults import SimClock
from k8s_vgpu_scheduler_tpu.monitor import feedback as jax_feedback
from k8s_vgpu_scheduler_tpu.monitor import reader as jax_reader
from k8s_vgpu_scheduler_tpu_torch.accounting import sampler as port_sampler
from k8s_vgpu_scheduler_tpu_torch.cmd import monitor as port_cmd
from k8s_vgpu_scheduler_tpu_torch.monitor import feedback as port_feedback
from k8s_vgpu_scheduler_tpu_torch.monitor import reader as port_reader
from tests.test_torch_shim import (  # noqa: F401 — libs is a fixture
    FLAVORS, PORT, PRELUDE, REPO, TPU, grant_env, libs)

MIB = 1 << 20
UUIDS = ["GPU-0a1b2c3d-4e5f-6071-8293-a4b5c6d7e8f9",
         "GPU-1a1b2c3d-4e5f-6071-8293-a4b5c6d7e8f9"]
# The monitor stack of each side: its reader, feedback loop and sampler.
STACKS = {"port": (port_reader, port_feedback, port_sampler),
          "tpu": (jax_reader, jax_feedback, jax_sampler)}


def reader_for(flavor, libs):
    return STACKS[flavor.name][0].RegionReader(libs[flavor.name])


def loop_for(flavor, libs, root, qos=None):
    _, fb, _ = STACKS[flavor.name]
    return fb.FeedbackLoop(str(root), reader=reader_for(flavor, libs),
                           qos=qos)


# A workload: attaches, allocates, says "ready", then answers one command
# a line: "acquire <cost_us>" (one gated dispatch, which marks activity),
# "exit" (clean shutdown) or "crash" (no destructor: the slot leaks like a
# SIGKILLed process's).
WORKLOAD = PRELUDE + """
assert init(None) == 0
for i in range(int(os.environ["N_DEV"])):
    assert try_alloc(i, int(os.environ["ALLOC_MIB"]) * MIB) == 0
print("ready", os.getpid(), flush=True)
for line in sys.stdin:
    cmd, *arg = line.split()
    if cmd == "acquire":
        acquire(0, int(arg[0]))
    elif cmd == "crash":
        os._exit(0)
    elif cmd == "exit":
        break
    print("ok", flush=True)
shutdown()
"""


class Workload:
    """A child holding a region at ``<root>/<key>/cudevshr.cache`` through
    ``flavor``'s library, stepped by commands on its stdin."""

    def __init__(self, flavor, libs, root, key, uuids=UUIDS[:1], priority=0,
                 sm=30, alloc_mib=100, qos=None):
        self.key = key
        self.path = root / key / "cudevshr.cache"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        env = grant_env(flavor, self.path,
                        limits_mib={i: 1000 for i in range(len(uuids))},
                        sm=sm, uuids=uuids, priority=priority, qos=qos)
        env.update(T_PREFIX=flavor.prefix, T_LIB=libs[flavor.name],
                   PYTHONPATH=str(REPO), N_DEV=str(len(uuids)),
                   ALLOC_MIB=str(alloc_mib))
        self.proc = subprocess.Popen(
            [sys.executable, "-c", WORKLOAD], env=env, cwd=REPO, text=True,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE)
        ready, pid = self.proc.stdout.readline().split()
        assert ready == "ready"
        self.pid = int(pid)

    def send(self, cmd: str) -> None:
        self.proc.stdin.write(cmd + "\n")
        self.proc.stdin.flush()
        assert self.proc.stdout.readline() == "ok\n", cmd

    def dispatch(self, cost_us: int = 0) -> None:
        self.send(f"acquire {cost_us}")

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.stdin.write("exit\n")
            self.proc.stdin.close()
        self.proc.wait(timeout=60)

    def crash(self) -> None:
        self.proc.stdin.write("crash\n")
        self.proc.stdin.close()
        self.proc.wait(timeout=60)

    def kill(self) -> None:
        self.proc.kill()
        self.proc.wait(timeout=60)


@pytest.fixture
def workloads():
    started = []

    def start(*args, **kwargs):
        w = Workload(*args, **kwargs)
        started.append(w)
        return w

    yield start
    for w in started:
        if w.proc.poll() is None:
            w.kill()


# -- the reader ------------------------------------------------------------


def region_view(r):
    """Every property a monitor reads off a region, then what its writes
    leave there (switch, QoS weight and yield, one aging step)."""
    n = r.num_devices
    view = {
        "num_devices": n, "uuids": r.uuids(),
        "limit": [r.limit(i) for i in range(n)],
        "sm_limit": [r.sm_limit(i) for i in range(n)],
        "used": [r.used(i) for i in range(n)],
        "oversubscribe": r.oversubscribe, "priority": r.priority,
        "switch": r.utilization_switch, "n_pids": len(r.proc_pids()),
        "qos_class": r.qos_class, "qos_weight": r.qos_weight,
        "qos_yield": r.qos_yield, "qos_wait_count": r.qos_wait_count(),
        "qos_wait_us_total": r.qos_wait_us_total(),
        "qos_cost_us_total": r.qos_cost_us_total(),
        "qos_wait_hist": r.qos_wait_hist(),
    }
    view["age"] = [r.age_kernel() for _ in range(4)]
    r.set_switch(True)
    r.set_qos_weight(145)
    r.set_qos_yield(True)
    view["written"] = (r.utilization_switch, r.qos_weight, r.qos_yield)
    r.set_switch(False)
    view["cleared"] = r.utilization_switch
    return view


@pytest.mark.parametrize("qos", [None, "best-effort", "latency-critical"],
                         ids=["flat", "best_effort", "latency_critical"])
@pytest.mark.parametrize("n_devices", [1, 2])
def test_port_reader_reads_every_property_like_the_jax_one(
        tmp_path, libs, workloads, n_devices, qos):
    views = {}
    for flavor in FLAVORS:
        w = workloads(flavor, libs, tmp_path / flavor.name, "uid1_pod",
                      uuids=UUIDS[:n_devices], priority=1, qos=qos)
        w.dispatch(5000)  # QoS regions record it; every region marks it
        w.dispatch(0)
        r = reader_for(flavor, libs).open(str(w.path))
        try:
            assert r.proc_pids() == [w.pid]
            views[flavor.name] = region_view(r)
        finally:
            r.close()
        w.stop()
    assert views["port"] == views["tpu"]
    port = views["port"]
    assert port["uuids"] == UUIDS[:n_devices]
    assert port["used"] == [100 * MIB] * n_devices
    assert port["age"] == [3, 2, 1, 0]
    assert port["written"] == (1, 145, 1) and port["cleared"] == 0
    assert port["qos_class"] == {None: -1, "best-effort": 0,
                                 "latency-critical": 1}[qos]
    assert port["qos_wait_count"] == (0 if qos is None else 2)


def test_port_reader_reads_a_tpu_written_region(tmp_path, libs, workloads):
    """One ABI: the port's reader sees a region the TPU library wrote as
    the JAX reader does."""
    w = workloads(TPU, libs, tmp_path, "uid1_pod", uuids=UUIDS, priority=1,
                  qos="latency-critical")
    w.dispatch(5000)
    w.stop()
    views = []
    for flavor in (PORT, TPU):  # each on its own copy: a view writes
        copy = tmp_path / f"{flavor.name}.cache"
        shutil.copy(w.path, copy)
        r = reader_for(flavor, libs).open(str(copy))
        views.append(region_view(r))
        r.close()
    assert views[0] == views[1]
    assert views[0]["age"] == [3, 2, 1, 0]


def test_reader_opens_nothing_where_no_region_is(tmp_path, libs):
    assert port_reader.RegionReader(libs["port"]).open(
        str(tmp_path / "none.cache")) is None


def test_scan_container_dirs_is_the_jax_scan(tmp_path):
    for d, files in (("uid1_a", ["cudevshr.cache"]), ("uid2_b", ["x.txt"]),
                     ("uid3_c", ["x.txt", "vgpu.cache"])):
        (tmp_path / d).mkdir()
        for f in files:
            (tmp_path / d / f).write_bytes(b"")
    (tmp_path / "stray.cache").write_bytes(b"")
    got = port_reader.scan_container_dirs(str(tmp_path))
    assert got == jax_reader.scan_container_dirs(str(tmp_path))
    assert set(got) == {"uid1_a", "uid3_c"}
    assert port_reader.scan_container_dirs(str(tmp_path / "gone")) == {}


# -- the feedback loop: the switch, tick by tick ----------------------------

# Three workloads: a priority-0 pod and a priority-1 pod sharing UUIDS[0],
# and a priority-1 pod alone on UUIDS[1].  Each row is one tick: the
# workloads that dispatch before it.
SCHEDULE = [(), ("hi", "lo"), ("hi", "lo"), ("hi",), (), (), ("lo",), (),
            ("hi", "other"), (), (), (), ("lo", "other"), ("hi",), (), (),
            (), ()]


def switch_timeline(flavor, libs, root, workloads):
    pods = {
        "hi": workloads(flavor, libs, root, "uid1_hi", [UUIDS[0]], 0),
        "lo": workloads(flavor, libs, root, "uid2_lo", [UUIDS[0]], 1),
        "other": workloads(flavor, libs, root, "uid3_other", [UUIDS[1]], 1),
    }
    loop = loop_for(flavor, libs, root)
    timeline = []
    try:
        for active in SCHEDULE:
            for name in active:
                pods[name].dispatch()
            loop.tick()
            timeline.append(
                {c.key: (c.region.utilization_switch, c.active)
                 for c in loop.containers.values()})
    finally:
        loop.close()
        for w in pods.values():
            w.stop()
    return timeline


def test_switch_timeline_equals_the_jax_loop(tmp_path, libs, workloads):
    port = switch_timeline(PORT, libs, tmp_path / "port", workloads)
    tpu = switch_timeline(TPU, libs, tmp_path / "tpu", workloads)
    assert port == tpu
    lo = [t["uid2_lo"][0] for t in port]
    # On one tick after the priority-0 pod first dispatched; off once its
    # activity has aged out (set to 3, aged 1 a tick), on again after.
    assert lo == [0, 1, 1, 1, 1, 1, 0, 0, 1, 1, 1, 0, 0, 1, 1, 1, 0, 0]
    assert all(t["uid1_hi"][0] == 0 and t["uid3_other"][0] == 0
               for t in port)


# -- the feedback loop, after tests/test_monitor.py -------------------------


@pytest.fixture
def port_loop(tmp_path, libs):
    loop = loop_for(PORT, libs, tmp_path)
    yield tmp_path, loop
    loop.close()


class TestFeedback:
    def test_scan_discovers_containers(self, port_loop, libs, workloads):
        root, loop = port_loop
        workloads(PORT, libs, root, "uid1_podA", [UUIDS[0]])
        workloads(PORT, libs, root, "uid2_podB", [UUIDS[1]])
        loop.rescan()
        assert set(loop.containers) == {"uid1_podA", "uid2_podB"}
        assert loop.containers["uid1_podA"].region.uuid(0) == UUIDS[0]
        assert loop.containers["uid1_podA"].region.used(0) == 100 * MIB

    def test_priority_contention_flips_switch(self, port_loop, libs,
                                              workloads):
        """High-priority activity on a shared GPU throttles the
        low-priority sharer; idle high-priority releases it."""
        root, loop = port_loop
        hi = workloads(PORT, libs, root, "uid1_hi", [UUIDS[0]], priority=0)
        lo = workloads(PORT, libs, root, "uid2_lo", [UUIDS[0]], priority=1)
        workloads(PORT, libs, root, "uid3_other", [UUIDS[1]], priority=1)
        for _ in range(2):
            hi.dispatch()
            lo.dispatch()
            loop.tick()
        switch = {k: c.region.utilization_switch
                  for k, c in loop.containers.items()}
        # On for the low-priority sharer only: never for the
        # high-priority pod itself, nor for a pod alone on another GPU.
        assert switch == {"uid1_hi": 0, "uid2_lo": 1, "uid3_other": 0}
        # High-priority goes idle → aging drains its counter → release.
        for ticks in range(1, 10):
            lo.dispatch()
            loop.tick()
            if loop.containers["uid2_lo"].region.utilization_switch == 0:
                break
        assert ticks == 3

    def test_gc_after_sigkill(self, port_loop, libs, workloads):
        root, loop = port_loop
        w = workloads(PORT, libs, root, "uid1_crash", [UUIDS[0]])
        loop.rescan()
        assert loop.containers["uid1_crash"].region.used(0) > 0
        w.kill()  # SIGKILL: no destructor, slot leaks
        loop.tick()  # gc probes /proc and clears the dead slot
        assert loop.containers["uid1_crash"].region.used(0) == 0

    def test_vanished_container_dir_closes_region(self, port_loop, libs,
                                                  workloads):
        root, loop = port_loop
        w = workloads(PORT, libs, root, "uid1_gone", [UUIDS[0]])
        loop.rescan()
        assert "uid1_gone" in loop.containers
        w.stop()
        shutil.rmtree(root / "uid1_gone")
        loop.rescan()
        assert "uid1_gone" not in loop.containers

    def test_gc_keeps_live_slots_and_clears_exited_ones(self, port_loop,
                                                        libs, workloads):
        root, loop = port_loop
        a = workloads(PORT, libs, root, "uid1_a", [UUIDS[0]])
        workloads(PORT, libs, root, "uid2_b", [UUIDS[0]])
        loop.rescan()
        assert loop.gc_dead_procs() == 0  # both live: nothing cleared
        a.crash()
        assert loop.gc_dead_procs() == 1
        assert loop.containers["uid1_a"].region.proc_pids() == []
        assert loop.containers["uid2_b"].region.used(0) == 100 * MIB


class TestHostPidMapping:
    def test_find_host_pid_same_namespace(self, port_loop, libs, workloads):
        root, loop = port_loop
        workloads(PORT, libs, root, "uid1_ns", [UUIDS[0]])
        loop.rescan()
        region = loop.containers["uid1_ns"].region
        pids = region.proc_pids()
        assert pids
        assert port_feedback.find_host_pid(region.path, pids[0]) == pids[0]

    def test_find_host_pid_rejects_wrong_pid(self, port_loop, libs,
                                             workloads):
        root, loop = port_loop
        workloads(PORT, libs, root, "uid1_ns2", [UUIDS[0]])
        loop.rescan()
        region = loop.containers["uid1_ns2"].region
        # A pid that exists but does not map this region (pid 1).
        assert port_feedback.find_host_pid(region.path, 1) is None

    def test_default_gc_uses_namespace_probe(self, port_loop, libs,
                                             workloads):
        root, loop = port_loop
        w = workloads(PORT, libs, root, "uid1_nsgc", [UUIDS[0]])
        loop.rescan()
        assert loop.containers["uid1_nsgc"].region.used(0) > 0
        w.kill()
        loop.gc_dead_procs()
        assert loop.containers["uid1_nsgc"].region.used(0) == 0


def fake_proc(root, statuses, maps=None):
    """A /proc of ``statuses`` (pid → its status text, None for no status
    file) and, for some pids, a ``maps`` text."""
    root.mkdir()
    (root / "self").mkdir()
    for pid, status in statuses.items():
        (root / str(pid)).mkdir()
        if status is not None:
            (root / str(pid) / "status").write_text(status)
        if maps and pid in maps:
            (root / str(pid) / "maps").write_text(maps[pid])
    return str(root)


def test_nspid_index_takes_a_pid_without_nspid_as_itself(tmp_path):
    """A kernel that reports no pid namespaces (before Linux 4.1, or
    gVisor's) writes no NSpid line: the port's
    index maps such a pid to itself, where the JAX package's leaves it out
    (and its GC then clears every live slot).  Where NSpid is reported,
    both agree."""
    proc = fake_proc(tmp_path / "proc", {
        10: "Name:\tx\nNSpid:\t10\t3\n", 11: "Name:\ty\nPid:\t11\n",
        12: "Name:\tz\nNSpid:\t12\n", 13: None})
    assert port_feedback.build_nspid_index(proc) == \
        {3: [10], 11: [11], 12: [12]}
    assert jax_feedback.build_nspid_index(proc) == {3: [10], 12: [12]}
    nspid = fake_proc(tmp_path / "nspid", {
        10: "NSpid:\t10\t3\n", 12: "NSpid:\t12\n", 14: "NSpid:\t14\t3\n"})
    port, ref = (
        {k: sorted(v) for k, v in m.build_nspid_index(nspid).items()}
        for m in (port_feedback, jax_feedback))
    assert port == ref == {3: [10, 14], 12: [12]}


def test_find_host_pid_without_nspid_confirms_by_maps(tmp_path):
    region = tmp_path / "uid1_pod" / "cudevshr.cache"
    region.parent.mkdir()
    region.write_bytes(b"")
    proc = fake_proc(tmp_path / "proc", {
        21: "Pid:\t21\n", 22: "Pid:\t22\n"},
        maps={21: f"7f00-7f01 rw-s 0 00:11 3 {region}\n",
              22: "7f00-7f01 r-xp 0 00:11 4 /usr/lib/libc.so.6\n"})
    assert port_feedback.find_host_pid(str(region), 21, proc_root=proc) == 21
    assert port_feedback.find_host_pid(str(region), 22, proc_root=proc) is None
    assert jax_feedback.find_host_pid(str(region), 21, proc_root=proc) is None


class TestAgingGcInteraction:
    def test_reused_pid_does_not_resurrect_dead_slot(
            self, port_loop, libs, workloads, monkeypatch):
        """A host pid recycled after SIGKILL must not resurrect a dead
        slot: the region-mapping confirmation gates the NSpid match."""
        root, loop = port_loop
        w = workloads(PORT, libs, root, "uid1_reuse", [UUIDS[0]])
        loop.rescan()
        region = loop.containers["uid1_reuse"].region
        pids = region.proc_pids()
        assert pids and region.used(0) > 0
        victim_pid = pids[0]
        w.kill()
        dummy = subprocess.Popen([sys.executable, "-c",
                                  "import sys; sys.stdin.read()"],
                                 stdin=subprocess.PIPE)
        try:
            monkeypatch.setattr(
                port_feedback, "build_nspid_index",
                lambda proc_root="/proc": {victim_pid: [dummy.pid]})
            loop._hostpid_cache[("uid1_reuse", victim_pid)] = dummy.pid
            assert loop.gc_dead_procs() >= 1
            assert loop.containers["uid1_reuse"].region.used(0) == 0
            assert ("uid1_reuse", victim_pid) not in loop._hostpid_cache
        finally:
            dummy.kill()
            dummy.wait(timeout=30)

    def test_sigkill_gc_stops_counter_accrual(self, port_loop, libs,
                                              workloads):
        """After SIGKILL + slot GC the sampler stops accruing
        HBM-byte-seconds for the dead slot and keeps what it earned."""
        root, loop = port_loop
        clock = SimClock()
        w = workloads(PORT, libs, root, "uid1_meter", [UUIDS[0]])
        sampler = port_sampler.UsageSampler(loop, clock=clock)
        loop.rescan()
        loop.observe()
        sampler.sample()
        clock.advance(0.1)
        loop.observe()
        sampler.sample()
        before = sampler.get("uid1_meter")
        assert before.hbm_byte_seconds > 0
        w.kill()
        loop.gc_dead_procs(pid_alive=lambda p: False)
        assert loop.containers["uid1_meter"].region.used(0) == 0
        sampler.sample()
        baseline = sampler.get("uid1_meter").hbm_byte_seconds
        assert baseline >= before.hbm_byte_seconds
        clock.advance(0.1)
        loop.observe()
        sampler.sample()
        assert sampler.get("uid1_meter").hbm_byte_seconds == baseline


# -- the QoS controller, each case of tests/test_qos.py on both -------------


class FakeQosRegion:
    def __init__(self, cls, uuids=("gpuX",)):
        self.qos_class = cls
        self.qos_weight = 100
        self.qos_yield = 0
        self.hist = [0] * 20
        self._uuids = list(uuids)

    def uuids(self):
        return self._uuids

    def qos_wait_hist(self):
        return list(self.hist)

    def set_qos_weight(self, pct):
        self.qos_weight = pct

    def set_qos_yield(self, on):
        self.qos_yield = 1 if on else 0

    def waited(self, us, n=1):
        """Record n dispatches that waited ``us`` microseconds."""
        idx = 0
        w = us
        while w > 0 and idx < len(self.hist) - 1:
            w >>= 1
            idx += 1
        self.hist[idx] += n


class Trace:
    """One side's controller and the state it leaves after each tick."""

    def __init__(self, fb, **cfg):
        self.fb = fb
        self.ctl = fb.QosController(fb.QosConfig(**cfg) if cfg else None)
        self.states = []

    def observe(self, **regions):
        self.ctl.observe({k: self.fb.ContainerState(key=k, region=r)
                          for k, r in regions.items()})
        self.states.append((
            {k: (r.qos_weight, r.qos_yield) for k, r in regions.items()},
            dict(self.ctl.critical_p99_us), self.ctl.reweights_total,
            dict(self.ctl._good), dict(self.ctl._quiet)))


def case_breach_shifts_duty_and_raises_yield(fb):
    lc, be = FakeQosRegion(1), FakeQosRegion(0)
    t = Trace(fb, target_p99_us=5000, step_pct=15)
    lc.waited(50000, n=10)
    t.observe(a=lc, b=be)
    assert lc.qos_weight == 115 and be.qos_weight == 85
    assert be.qos_yield == 1 and t.ctl.reweights_total == 1
    return t.states


def case_weights_clamped_at_floor_and_ceiling(fb):
    lc, be = FakeQosRegion(1), FakeQosRegion(0)
    t = Trace(fb, target_p99_us=5000, step_pct=50, min_weight_pct=25,
              max_weight_pct=175)
    for _ in range(5):
        lc.waited(50000, n=10)
        t.observe(a=lc, b=be)
    assert lc.qos_weight == 175 and be.qos_weight == 25
    return t.states


def case_recovery_returns_duty_with_hysteresis(fb):
    lc, be = FakeQosRegion(1), FakeQosRegion(0)
    t = Trace(fb, target_p99_us=5000, step_pct=15, recover_ticks=2)
    lc.waited(50000, n=10)
    t.observe(a=lc, b=be)
    assert (lc.qos_weight, be.qos_weight) == (115, 85)
    t.observe(a=lc, b=be)
    assert (lc.qos_weight, be.qos_weight) == (115, 85)
    t.observe(a=lc, b=be)
    assert (lc.qos_weight, be.qos_weight) == (100, 100)
    assert be.qos_yield == 0
    return t.states


def case_dead_band_holds_weights(fb):
    lc, be = FakeQosRegion(1), FakeQosRegion(0)
    t = Trace(fb, target_p99_us=5000, step_pct=15, recover_ticks=1,
              recover_frac=0.5)
    lc.waited(50000, n=10)
    t.observe(a=lc, b=be)
    assert be.qos_weight == 85
    lc.waited(4000, n=100)  # under target, above target/2: hold
    t.observe(a=lc, b=be)
    assert be.qos_weight == 85
    return t.states


def case_container_restart_counter_reset_tolerated(fb):
    lc = FakeQosRegion(1)
    t = Trace(fb, target_p99_us=5000)
    lc.waited(50000, n=10)
    t.observe(a=lc)
    lc.hist = [0] * 20  # in-place restart: counters start over
    lc.waited(0, n=5)
    t.observe(a=lc)
    assert t.ctl.critical_p99_us["gpuX"] == 0.0
    return t.states


def case_no_qos_regions_noop(fb):
    flat = FakeQosRegion(-1)
    t = Trace(fb)
    t.observe(a=flat)
    assert flat.qos_weight == 100 and flat.qos_yield == 0
    assert t.ctl.reweights_total == 0
    return t.states


def case_multichip_region_gets_one_consistent_write_per_tick(fb):
    lc = FakeQosRegion(1, uuids=("gpuA",))
    be = FakeQosRegion(0, uuids=("gpuA", "gpuB"))
    t = Trace(fb, target_p99_us=5000, step_pct=15)
    lc.waited(50000, n=10)
    t.observe(a=lc, b=be)
    assert be.qos_yield == 1 and be.qos_weight == 85
    lc2 = FakeQosRegion(1, uuids=("gpuA", "gpuB"))
    t2 = Trace(fb, target_p99_us=5000, step_pct=15)
    lc2.waited(50000, n=10)  # breaches on both of its GPUs
    t2.observe(a=lc2)
    assert lc2.qos_weight == 115
    return t.states + t2.states


def case_multichip_region_returns_only_when_all_chips_ready(fb):
    lc_a = FakeQosRegion(1, uuids=("gpuA",))
    be = FakeQosRegion(0, uuids=("gpuA", "gpuB"))
    t = Trace(fb, target_p99_us=5000, step_pct=15, recover_ticks=1)
    lc_a.waited(50000, n=10)
    t.observe(a=lc_a, b=be)
    assert be.qos_weight == 85
    lc_a.waited(50000, n=10)
    t.observe(a=lc_a, b=be)
    assert be.qos_weight == 70
    return t.states


def case_state_cleared_when_last_qos_container_leaves(fb):
    lc = FakeQosRegion(1)
    t = Trace(fb, target_p99_us=5000)
    lc.waited(50000, n=10)
    t.observe(a=lc)
    assert t.ctl.critical_p99_us
    t.observe()  # pod gone: GPU memory must not outlive it
    assert not t.ctl.critical_p99_us
    assert not t.ctl._good and not t.ctl._quiet
    return t.states


def case_critical_only_chip_never_yields_anyone(fb):
    lc = FakeQosRegion(1)
    t = Trace(fb, target_p99_us=5000)
    lc.waited(50000, n=10)
    t.observe(a=lc)
    assert lc.qos_weight == 115  # credit grows even with no donor
    return t.states


def case_long_mixed_run(fb):
    """Breach, dead band, quiet and recovery interleaved over two GPUs,
    with a best-effort neighbour on each and a restart midway."""
    a, b = FakeQosRegion(1, ("gpuA",)), FakeQosRegion(1, ("gpuB",))
    be_a, be_ab = FakeQosRegion(0, ("gpuA",)), FakeQosRegion(0,
                                                             ("gpuA", "gpuB"))
    t = Trace(fb)
    waits = [(30000, 0), (0, 25000), (12000, 12000), (0, 0), (9000, 0),
             (0, 0), (0, 0), (0, 0), (40000, 40000), (0, 0), (0, 0),
             (0, 0), (0, 0), (0, 0), (0, 0)]
    for i, (wa, wb) in enumerate(waits):
        a.waited(wa, n=3)
        b.waited(wb, n=2)
        a.waited(0, n=50)
        if i == 7:
            b.hist = [0] * 20
        t.observe(a=a, b=b, c=be_a, d=be_ab)
    return t.states


QOS_CASES = [v for k, v in sorted(globals().items())
             if k.startswith("case_")]


@pytest.mark.parametrize("case", QOS_CASES,
                         ids=[c.__name__[5:] for c in QOS_CASES])
def test_qos_controller_decisions_equal_the_jax_ones(case):
    assert case(port_feedback) == case(jax_feedback)


@pytest.mark.parametrize("delta", [[0] * 20, [5] + [0] * 19,
                                   [98] + [0] * 13 + [2] + [0] * 5,
                                   [0] * 31 + [1], [3, 1, 4, 1, 5, 9, 2, 6]])
def test_hist_p99_equals_the_jax_one(delta):
    assert port_feedback.hist_p99_us(delta) == \
        jax_feedback.hist_p99_us(delta)


def test_qos_config_defaults_equal_the_jax_ones():
    assert dataclasses.asdict(port_feedback.QosConfig()) == \
        dataclasses.asdict(jax_feedback.QosConfig())
    assert port_feedback.QosConfig() == port_feedback.QosConfig(
        target_p99_us=20_000, step_pct=15, min_weight_pct=25,
        max_weight_pct=175, recover_ticks=3, recover_frac=0.5)


# -- the usage sampler ------------------------------------------------------


class FakeRegion:
    """The surface UsageSampler reads off a region."""

    def __init__(self, chips=1, used=0, switch=0, oversub=0, qos=-1):
        self.num_devices = chips
        self._used = used
        self.utilization_switch = switch
        self.oversubscribe = oversub
        self.qos_class = qos
        self.qos_weight = 100
        self.wait_us = 0
        self.hist = [0] * 8

    def used(self, _dev):
        return self._used

    def qos_wait_us_total(self):
        return self.wait_us

    def qos_wait_hist(self):
        return list(self.hist)


class FakeLoop:
    def __init__(self):
        self.lock = threading.RLock()
        self.containers = {}


def sampler_rows(sampler_mod):
    """A scripted run: containers that come, go, throttle, oversubscribe,
    restart in place (a QoS counter reset) and age out of retention; the
    snapshot rows after every sample."""
    clock = SimClock()
    loop = FakeLoop()
    s = sampler_mod.UsageSampler(loop, clock=clock, retention_s=10.0)

    def state(region, active):
        return types.SimpleNamespace(region=region, active=active)

    serve = FakeRegion(chips=1, used=24000 * MIB, qos=1)
    train = FakeRegion(chips=2, used=40000 * MIB, switch=1, oversub=1, qos=0)
    flat = FakeRegion(chips=1, used=3 * MIB)
    out = []
    for tick in range(24):
        if tick == 0:
            loop.containers["uidS_serve"] = state(serve, False)
            loop.containers["uidT_train"] = state(train, True)
        if tick == 2:
            loop.containers["uidF_flat"] = state(flat, True)
        serve.hist[tick % 5] += tick
        serve.wait_us += 700 * tick
        train.hist[1] += 1
        train.wait_us += 50
        loop.containers["uidS_serve"].active = tick % 3 != 0
        train.utilization_switch = int(tick % 4 < 2)
        train.qos_weight = 100 - 5 * (tick % 3)
        if tick == 9:  # the serving pod restarts in place
            serve = FakeRegion(chips=1, used=1000 * MIB, qos=1)
            serve.hist[0] = 2
            serve.wait_us = 10
            loop.containers["uidS_serve"] = state(serve, True)
        if tick == 12:
            del loop.containers["uidF_flat"]
        if tick == 14:
            loop.containers["uidT_train"].region._used = 0
        if tick == 16:
            del loop.containers["uidT_train"]
        clock.advance(2.5 + 1.25 * (tick % 3))
        credited = s.sample()
        out.append((credited, s.snapshot(), s.qos_retired()))
    return out


def test_sampler_rows_equal_the_jax_ones():
    port = sampler_rows(port_sampler)
    assert port == sampler_rows(jax_sampler)
    last = dict((r["ctrkey"], r) for r in port[-1][1])
    assert set(last) == {"uidS_serve"}  # the others aged out of retention
    assert "best-effort" in port[-1][2]  # the trainer's waits, retired
    assert port_sampler.USAGE_FIELDS == jax_sampler.USAGE_FIELDS
    assert tuple(last["uidS_serve"]) == port_sampler.USAGE_FIELDS
    assert port_sampler.QOS_CLASS_NAMES == {0: "best-effort",
                                            1: "latency-critical"}


# -- the entry point --------------------------------------------------------

KEPT_FLAGS = ("interval", "qos_target_p99_ms", "qos_step_pct",
              "qos_min_weight", "qos_max_weight", "qos_recover_ticks",
              "verbose", "metrics_port", "grpc_port", "grpc_bind",
              "debug_port", "no_backend")


def test_kept_flags_default_as_the_jax_ones():
    port, ref = port_cmd.parse_args([]), jax_cmd.parse_args([])
    assert {k: getattr(port, k) for k in KEPT_FLAGS} == \
        {k: getattr(ref, k) for k in KEPT_FLAGS}
    assert port.container_root == "/tmp/vgpu/containers"
    cfg = port_cmd.qos_config(port_cmd.parse_args(
        ["--qos-target-p99-ms", "5", "--qos-step-pct", "30",
         "--qos-recover-ticks", "2"]))
    assert (cfg.target_p99_us, cfg.step_pct, cfg.recover_ticks) == \
        (5000, 30, 2)


def test_monitor_loop_turns_a_sharers_switch_on(tmp_path, libs, workloads):
    """The entry point's loop, stopped by its event: over a container
    root with two pods on one GPU, the priority-1 pod's switch turns on
    once the priority-0 pod launches, and the sampler meters the
    throttled time.  Each tick drives the pods by hand."""
    hi = workloads(PORT, libs, tmp_path, "uid1_serve", [UUIDS[0]], 0)
    lo = workloads(PORT, libs, tmp_path, "uid2_train", [UUIDS[0]], 1)
    loop = loop_for(PORT, libs, tmp_path)
    clock = SimClock()
    sampler = port_sampler.UsageSampler(loop, clock=clock)
    stop = threading.Event()
    seen = []

    def on_tick():
        seen.append({k: c.region.utilization_switch
                     for k, c in loop.containers.items()})
        clock.advance(2.0)
        if len(seen) == 4:
            stop.set()
        lo.dispatch()
        if len(seen) >= 2:
            hi.dispatch()

    port_cmd.run(loop, sampler, 0.0, stop, on_tick=on_tick)
    loop.close()
    assert [s["uid2_train"] for s in seen] == [0, 0, 1, 1]
    assert all(s["uid1_serve"] == 0 for s in seen)
    rows = {r["ctrkey"]: r for r in sampler.snapshot()}
    assert rows["uid2_train"]["throttled_seconds"] == 4.0
    assert rows["uid1_serve"]["throttled_seconds"] == 0.0


def test_main_returns_when_stopped(tmp_path, libs):
    stop = threading.Event()
    stop.set()
    port_cmd.main(["--container-root", str(tmp_path), "--library",
                   libs["port"], "--metrics-port", "0", "--grpc-port", "0",
                   "--no-backend"], stop=stop)
