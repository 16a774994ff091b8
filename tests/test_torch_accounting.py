"""The port's usage accounting against the JAX package's, on the CPU.

Every case of ``tests/test_accounting.py`` runs on each package (``SIDES``)
with the same expectations: the sampler, the ledger, the granted-vs-actual
join, the register-stream transport, ``score_by_actual`` on the serial
Filter (the JAX side with ``optimistic_commit=False``), the rescuer's
idle-grant flag, showback, ``/usagez`` over HTTP, the report's formats and
the two collectors' accounting families.  Where the two can be held to
each other on the same inputs (ledger states, efficiency joins, showback
exports, the report's text and CSV, decoded rows), they are compared
exactly.  The piggyback also runs end to end over real sockets: the
port's NodeTPUInfo, ``monitor_usage_source``, the register stream into the
port's scheduler, then the ledger.  And NodeTPUInfo is held to the JAX
server's cases (``tests/test_monitor.py``'s ``TestNodeRPC``): full and
``usage_only`` replies, the ``ctrkey`` filter, a failed bind that raises,
with a JAX client on the port's server and the port's client on the JAX
server.  Pods differ by the name table alone (``nvidia.com/gpu`` for
``google.com/tpu``); every clock is a SimClock: nothing sleeps."""

import dataclasses
import json
import threading
import time
import types
import urllib.request

import pytest

from k8s_vgpu_scheduler_tpu.health.faults import SimClock

MIB = 1024 * 1024


def side(name: str):
    """One package's accounting, scheduler and report modules."""
    if name == "port":
        from k8s_vgpu_scheduler_tpu_torch import accounting as acc
        from k8s_vgpu_scheduler_tpu_torch.accounting import efficiency
        from k8s_vgpu_scheduler_tpu_torch.accounting import ledger
        from k8s_vgpu_scheduler_tpu_torch.cmd import vgpu_report as report
        from k8s_vgpu_scheduler_tpu_torch.k8s import FakeKube
        from k8s_vgpu_scheduler_tpu_torch.monitor import metrics as nmetrics
        from k8s_vgpu_scheduler_tpu_torch.scheduler import Scheduler
        from k8s_vgpu_scheduler_tpu_torch.scheduler import metrics as smetrics
        from k8s_vgpu_scheduler_tpu_torch.scheduler.nodes import (
            DeviceInfo, NodeInfo)
        from k8s_vgpu_scheduler_tpu_torch.scheduler.pods import PodInfo
        from k8s_vgpu_scheduler_tpu_torch.tpulib import TopologyDesc
        from k8s_vgpu_scheduler_tpu_torch.util.config import Config
        from k8s_vgpu_scheduler_tpu_torch.util.types import ContainerDevice
        res = ("nvidia.com/gpu", "nvidia.com/gpumem")
        serial = {"optimistic_commit": False}
    else:
        from k8s_vgpu_scheduler_tpu import accounting as acc
        from k8s_vgpu_scheduler_tpu.accounting import efficiency
        from k8s_vgpu_scheduler_tpu.accounting import ledger
        from k8s_vgpu_scheduler_tpu.cmd import vtpu_report as report
        from k8s_vgpu_scheduler_tpu.k8s import FakeKube
        from k8s_vgpu_scheduler_tpu.monitor import metrics as nmetrics
        from k8s_vgpu_scheduler_tpu.scheduler import Scheduler
        from k8s_vgpu_scheduler_tpu.scheduler import metrics as smetrics
        from k8s_vgpu_scheduler_tpu.scheduler.nodes import (
            DeviceInfo, NodeInfo)
        from k8s_vgpu_scheduler_tpu.scheduler.pods import PodInfo
        from k8s_vgpu_scheduler_tpu.tpulib import TopologyDesc
        from k8s_vgpu_scheduler_tpu.util.config import Config
        from k8s_vgpu_scheduler_tpu.util.types import ContainerDevice
        res = ("google.com/tpu", "google.com/tpumem")
        serial = {"optimistic_commit": False}
    return types.SimpleNamespace(
        name=name, acc=acc, eff=efficiency, ledger=ledger, report=report,
        FakeKube=FakeKube, nmetrics=nmetrics, smetrics=smetrics,
        Scheduler=Scheduler, DeviceInfo=DeviceInfo, NodeInfo=NodeInfo,
        PodInfo=PodInfo, TopologyDesc=TopologyDesc,
        Config=lambda **kw: Config(**serial, **kw), res=res,
        ContainerDevice=ContainerDevice)


SIDES = ("port", "jax")


@pytest.fixture(params=SIDES)
def S(request):
    return side(request.param)


def close(s) -> None:
    if hasattr(s, "close"):  # the JAX scheduler's background machinery
        s.close()


# -- fakes ---------------------------------------------------------------------


class FakeRegion:
    """The surface the sampler and the node collector read off a region."""

    def __init__(self, chips=1, used=0, switch=0, oversub=0):
        self.num_devices = chips
        self._used = used
        self.utilization_switch = switch
        self.oversubscribe = oversub
        self.priority = 0

    def used(self, _dev):
        return self._used

    def uuid(self, dev):
        return f"chip-{dev}"

    def limit(self, _dev):
        return 0

    def sm_limit(self, _dev):
        return 0

    def proc_pids(self):
        return []


class FakeState:
    def __init__(self, region, active=False, key=""):
        self.region, self.active, self.key = region, active, key


class FakeLoop:
    def __init__(self):
        self.lock = threading.RLock()
        self.containers = {}


def counter_row(ctrkey, chip_seconds=0.0, hbm=0.0, chips=1, active=True,
                oversub=False, throttled=0.0, spill=0.0, window=0.0,
                qos_class="", qos_weight=100, qos_wait_s=0.0, qos_hist=()):
    return {"ctrkey": ctrkey, "chips": chips, "active": active,
            "oversubscribe": oversub, "chip_seconds": chip_seconds,
            "hbm_byte_seconds": hbm, "throttled_seconds": throttled,
            "oversub_spill_seconds": spill, "window_s": window,
            "qos_class": qos_class, "qos_weight_pct": qos_weight,
            "qos_wait_seconds_total": qos_wait_s,
            "qos_wait_hist": list(qos_hist)}


def register_node(S, s, name, chips=4, devmem=16384):
    devices = [S.DeviceInfo(id=f"{name}-chip-{i}", count=10, devmem=devmem,
                            type="NVIDIA-h100", health=True, coords=(i, 0))
               for i in range(chips)]
    s.nodes.add_node(name, S.NodeInfo(
        name=name, devices=devices,
        topology=S.TopologyDesc(generation="h100", mesh=(chips, 1))))


def grant(S, uid, name, node, chips=1, mem=3000, cores=30, namespace="team"):
    return S.PodInfo(uid=uid, name=name, namespace=namespace, node=node,
                     devices=[[S.ContainerDevice(
                         uuid=f"{node}-chip-{i}", type="NVIDIA-h100",
                         usedmem=mem, usedcores=cores)
                         for i in range(chips)]])


def card_pod(S, name, uid, mem="3000", nums="1"):
    return {"metadata": {"name": name, "namespace": "default", "uid": uid,
                         "annotations": {}},
            "spec": {"containers": [{"name": "main", "resources": {
                "limits": {S.res[0]: nums, S.res[1]: mem}}}]}}


def acct_view(a) -> dict:
    """A ledger account as plain data, its series included."""
    d = dataclasses.asdict(a)
    d["_series"] = list(a._series)
    return d


# -- the sampler -----------------------------------------------------------------


def test_sampler_integrates_duty_cycle_and_occupancy(S):
    clock, loop = SimClock(), FakeLoop()
    loop.containers["u1_podA"] = FakeState(FakeRegion(chips=2,
                                                      used=100 * MIB))
    s = S.acc.UsageSampler(loop, clock=clock)
    s.sample()
    loop.containers["u1_podA"].active = True
    clock.advance(5.0)
    s.sample()
    cs = s.get("u1_podA")
    assert cs.chip_seconds == 10.0
    assert cs.hbm_byte_seconds == 5.0 * 2 * 100 * MIB
    loop.containers["u1_podA"].active = False
    clock.advance(5.0)
    s.sample()
    cs = s.get("u1_podA")
    assert cs.chip_seconds == 10.0
    assert cs.hbm_byte_seconds == 10.0 * 2 * 100 * MIB


def test_sampler_throttled_and_oversub_spill_seconds(S):
    clock, loop = SimClock(), FakeLoop()
    region = FakeRegion(chips=1, used=MIB, switch=1, oversub=1)
    loop.containers["u1_p"] = FakeState(region, active=True)
    s = S.acc.UsageSampler(loop, clock=clock)
    s.sample()
    clock.advance(4.0)
    s.sample()
    assert (s.get("u1_p").throttled_seconds,
            s.get("u1_p").oversub_spill_seconds) == (4.0, 4.0)
    loop.containers["u1_p"].active = False
    region.utilization_switch = 0
    clock.advance(4.0)
    s.sample()
    assert (s.get("u1_p").throttled_seconds,
            s.get("u1_p").oversub_spill_seconds) == (4.0, 4.0)


def test_sampler_counters_survive_region_replacement(S):
    clock, loop = SimClock(), FakeLoop()
    loop.containers["u1_p"] = FakeState(FakeRegion(used=50 * MIB),
                                        active=True)
    s = S.acc.UsageSampler(loop, clock=clock)
    s.sample()
    clock.advance(10.0)
    s.sample()
    before = s.get("u1_p")
    assert before.chip_seconds == 10.0
    loop.containers["u1_p"] = FakeState(FakeRegion(used=0), active=False)
    clock.advance(10.0)
    s.sample()
    after = s.get("u1_p")
    assert (after.chip_seconds, after.hbm_byte_seconds) == (
        before.chip_seconds, before.hbm_byte_seconds)


def test_sampler_ended_container_retained_then_gced(S):
    clock, loop = SimClock(), FakeLoop()
    loop.containers["u1_p"] = FakeState(FakeRegion(), active=True)
    s = S.acc.UsageSampler(loop, clock=clock, retention_s=60.0)
    s.sample()
    clock.advance(5.0)
    s.sample()
    del loop.containers["u1_p"]
    clock.advance(30.0)
    s.sample()
    assert [r["ctrkey"] for r in s.snapshot()] == ["u1_p"]
    clock.advance(60.0)
    s.sample()
    assert s.snapshot() == []


# -- the ledger ---------------------------------------------------------------------


def test_ledger_accumulates_and_handles_counter_reset(S):
    clock = SimClock()
    led = S.acc.UsageLedger(clock=clock)
    led.record("node-a", [counter_row("u1_p", chip_seconds=10.0, hbm=100.0)])
    clock.advance(5.0)
    led.record("node-a", [counter_row("u1_p", chip_seconds=14.0, hbm=150.0)])
    assert (led.get("u1").chip_seconds, led.get("u1").hbm_byte_seconds) == \
        (14.0, 150.0)
    clock.advance(5.0)
    led.record("node-a", [counter_row("u1_p", chip_seconds=3.0, hbm=20.0)])
    assert (led.get("u1").chip_seconds, led.get("u1").hbm_byte_seconds) == \
        (17.0, 170.0)
    assert led.resets_observed >= 1


def test_ledger_window_usage_covers_trailing_window(S):
    clock = SimClock()
    led = S.acc.UsageLedger(clock=clock)
    for i in range(10):
        led.record("n", [counter_row("u1_p", chip_seconds=float(10 * i))])
        clock.advance(10.0)
    assert led.window_usage("u1", 30.0) == (20.0, 0.0, 20.0)


def test_ledger_node_busy_chips_and_prune(S):
    clock = SimClock()
    led = S.acc.UsageLedger(clock=clock, retention_s=100.0)
    led.record("n1", [counter_row("u1_a", chips=2, active=True),
                      counter_row("u2_b", chips=4, active=False)])
    led.record("n2", [counter_row("u3_c", chips=1, active=True)])
    assert (led.node_busy_chips("n1"), led.node_busy_chips("n2")) == (2, 1)
    clock.advance(200.0)
    led.record("n2", [counter_row("u3_c", chips=1, active=True)])
    assert led.node_busy_chips("n1") is None and led.get("u1") is None
    assert led.get("u3") is not None


def ledger_script(S):
    """Resets, QoS rows, pruning and windows on one ledger."""
    clock = SimClock()
    led = S.acc.UsageLedger(clock=clock, retention_s=50.0, series_len=4)
    out = []
    for i in range(8):
        rows = [counter_row("u1_a", chip_seconds=3.0 * i, hbm=7.0 * i,
                            chips=2, active=i % 2 == 0),
                counter_row(f"u{2 + i // 4}_b", chip_seconds=(i % 3) * 1.5,
                            qos_class="latency-critical", qos_weight=130,
                            qos_wait_s=0.1 * i, qos_hist=[i, 1, 2])]
        out.append(led.record(f"n{i % 2}", rows))
        clock.advance(20.0)
        out.append([acct_view(a) for a in led.accounts()])
        out.append([led.window_usage("u1", w) for w in (15.0, 45.0, 500.0)])
        out.append([led.node_busy_chips(n) for n in ("n0", "n1")])
    out.append(led.qos_retired())
    out.append(led.resets_observed)
    out.append(led.records_total)
    return out


def test_the_ledger_holds_the_jax_ledger_state():
    assert ledger_script(side("port")) == ledger_script(side("jax"))


def test_decode_usage_reads_either_packages_messages():
    from k8s_vgpu_scheduler_tpu.api import device_register_pb2 as jpb
    from k8s_vgpu_scheduler_tpu_torch.accounting.ledger import decode_usage
    from k8s_vgpu_scheduler_tpu_torch.deviceplugin.register import \
        usage_to_proto

    rows = [counter_row("u1_a", chip_seconds=1.5, hbm=2.5, chips=3,
                        oversub=True, throttled=0.5, spill=0.25, window=9.0,
                        qos_class="best-effort", qos_weight=60,
                        qos_wait_s=0.75, qos_hist=[4, 0, 1])]
    port = usage_to_proto(rows)
    jax = [jpb.UsageCounters.FromString(m.SerializeToString()) for m in port]
    assert decode_usage(port) == decode_usage(jax) == rows
    assert side("jax").ledger.decode_usage(port) == rows


# -- the efficiency join ----------------------------------------------------------


def busy_and_squatter(S, clock):
    led = S.acc.UsageLedger(clock=clock)
    for i in range(13):
        led.record("node-a", [
            counter_row("u1_busy", chip_seconds=float(10 * i), chips=1,
                        active=True),
            counter_row("u2_squat", chips=2, active=False, oversub=True)])
        clock.advance(10.0)
    return led


def test_efficiency_and_idle_findings(S):
    clock = SimClock()
    led = busy_and_squatter(S, clock)
    pods = [grant(S, "u1", "busy", "node-a"),
            grant(S, "u2", "squat", "node-a", chips=2),
            grant(S, "u9", "unmonitored", "node-b")]
    fleet = S.eff.grant_efficiency(
        pods, led, S.acc.EfficiencyConfig(window_s=60.0, idle_grace_s=30.0),
        now=clock())
    by = {p.name: p for p in fleet.pods}
    assert 0.9 <= by["busy"].efficiency <= 1.1 and not by["busy"].idle
    assert by["squat"].efficiency == 0.0 and by["squat"].idle
    assert by["squat"].oversubscribe
    assert by["unmonitored"].efficiency is None
    assert not by["unmonitored"].idle
    assert [p.name for p in fleet.idle] == ["squat"]
    assert 0.0 < fleet.fleet_efficiency < 1.0


def test_idle_needs_grace_not_just_a_quiet_sample(S):
    clock = SimClock()
    led = S.acc.UsageLedger(clock=clock)
    led.record("n", [counter_row("u1_p", active=False)])
    clock.advance(5.0)
    led.record("n", [counter_row("u1_p", active=False)])
    cfg = S.acc.EfficiencyConfig(window_s=60.0, idle_grace_s=600.0)
    pods = [grant(S, "u1", "p", "n")]
    assert not S.eff.grant_efficiency(pods, led, cfg,
                                      now=clock()).pods[0].idle
    clock.advance(600.0)
    assert S.eff.grant_efficiency(pods, led, cfg, now=clock()).pods[0].idle


def test_a_pod_launching_its_whole_window_reads_above_one(S):
    """A known fault of the join, on both packages (ROADMAP C.9): it
    divides GPU-seconds counted on the monitor's clock by a window on the
    ledger's.  A pod launches from its region's first tick at 0.5 s; that
    tick's row (nothing credited yet) reaches the ledger at 2 s, a beat
    and a tick late, and each later row a beat late.  The window starts
    1.5 s after the counting did but ends 1 s after it, so the ratio
    reads 8.5 / 8 = 1.0625."""
    clock = SimClock()
    led = S.acc.UsageLedger(clock=clock)
    clock.advance(2.0)
    led.record("n", [counter_row("u1_p", chip_seconds=0.0)])
    for beat in range(3, 11):
        clock.advance(1.0)
        led.record("n", [counter_row("u1_p", chip_seconds=beat - 1.5)])
    [pe] = S.eff.grant_efficiency(
        [grant(S, "u1", "p", "n")], led,
        S.acc.EfficiencyConfig(window_s=60.0), now=clock()).pods
    assert (pe.window_s, pe.actual_chip_seconds) == (8.0, 8.5)
    assert pe.efficiency == 1.0625


def test_the_join_is_the_jax_join():
    got = {}
    for name in SIDES:
        S = side(name)
        clock = SimClock()
        led = busy_and_squatter(S, clock)
        pods = [grant(S, "u1", "busy", "node-a"),
                grant(S, "u2", "squat", "node-a", chips=2),
                grant(S, "u9", "unmonitored", "node-b", chips=3)]
        fleet = S.eff.grant_efficiency(
            pods, led, S.acc.EfficiencyConfig(window_s=60.0,
                                              idle_grace_s=30.0),
            now=clock())
        got[name] = ([dataclasses.asdict(p) for p in fleet.pods],
                     [p.uid for p in fleet.idle], fleet.fleet_efficiency,
                     [S.eff.actual_idle_bonus(led, n, 4)
                      for n in ("node-a", "node-b")],
                     S.eff.showback(pods, led, now=clock(), window_s=40.0))
    assert got["port"] == got["jax"]


# -- the transports -------------------------------------------------------------


def test_register_request_roundtrip_feeds_ledger():
    """Node → scheduler: rows ride RegisterRequest.usage through real
    serialization into observe_registration, on the port and, off the
    port's own message, on the JAX scheduler alike."""
    from k8s_vgpu_scheduler_tpu.api import device_register_pb2 as jpb
    from k8s_vgpu_scheduler_tpu_torch.deviceplugin.register import \
        inventory_to_request
    from k8s_vgpu_scheduler_tpu_torch.tpulib import MockBackend

    inv = MockBackend({"generation": "h100", "mesh": [2],
                       "hbm_mib": 81079}).inventory()
    port, jax = side("port"), side("jax")
    rows = [counter_row("u1_podA", chip_seconds=42.0, hbm=7.0, chips=2,
                        window=60.0)]
    req = inventory_to_request("node-a", inv, port.Config(), usage=rows)
    assert [u.ctrkey for u in req.usage] == ["u1_podA"]
    wire = jpb.RegisterRequest.FromString(req.SerializeToString())
    got = {}
    for S, msg in ((port, req), (jax, wire)):
        from importlib import import_module

        core = import_module(S.Scheduler.__module__)
        s = S.Scheduler(S.FakeKube(), S.Config(), clock=SimClock())
        try:
            s.observe_registration("node-a", core.decode_register_request(
                msg), usage=S.ledger.decode_usage(msg.usage))
            s.observe_registration("node-b", core.decode_register_request(
                msg), usage=[])
            got[S.name] = acct_view(s.ledger.get("u1"))
        finally:
            close(s)
    assert got["port"]["chip_seconds"] == 42.0
    assert got["port"]["node"] == "node-a"
    assert got["port"] == got["jax"]


def test_handle_register_stream_absorbs_the_usage():
    from k8s_vgpu_scheduler_tpu_torch.deviceplugin.register import \
        inventory_to_request
    from k8s_vgpu_scheduler_tpu_torch.tpulib import MockBackend

    S = side("port")
    s = S.Scheduler(S.FakeKube(), S.Config(), clock=SimClock())
    inv = MockBackend({"generation": "h100", "mesh": [1]}).inventory()
    msgs = [inventory_to_request("n", inv, S.Config(), usage=[
        counter_row("u7_p", chip_seconds=v)]) for v in (2.0, 5.0)]
    assert s.handle_register_stream(iter(msgs)) == "n"
    assert s.ledger.get("u7").chip_seconds == 5.0


def test_usage_to_proto_and_usage_report_agree():
    from k8s_vgpu_scheduler_tpu_torch.accounting.ledger import decode_usage
    from k8s_vgpu_scheduler_tpu_torch.deviceplugin.register import \
        usage_to_proto
    from k8s_vgpu_scheduler_tpu_torch.monitor.noderpc import usage_report

    rows = [counter_row("u1_a", chip_seconds=1.5, hbm=2.5, chips=3,
                        active=True, oversub=True, throttled=0.5,
                        spill=0.25, window=9.0)]
    assert decode_usage(usage_to_proto(rows)) == \
        decode_usage(usage_report("node-x", rows).counters) == rows


def test_the_usage_source_never_blocks_and_keeps_its_cache():
    """monitor_usage_source answers at once from its cache; a dead
    endpoint leaves the cache empty and raises nothing."""
    from k8s_vgpu_scheduler_tpu_torch.deviceplugin.register import \
        monitor_usage_source

    fetch = monitor_usage_source("127.0.0.1:1")
    t0 = time.monotonic()
    assert fetch() == [] and fetch() == []
    assert time.monotonic() - t0 < 1.0


# -- the piggyback end to end over real sockets ---------------------------------


def test_the_piggyback_reaches_the_ledger_over_real_sockets(tmp_path):
    """A monitor's sampler behind the port's NodeTPUInfo on loopback; a
    DeviceRegister with ``monitor_usage_source`` of it streams to the
    port's register service; the scheduler's ledger ends with the
    sampler's counters."""
    from k8s_vgpu_scheduler_tpu_torch.cmd.scheduler import \
        start_register_service
    from k8s_vgpu_scheduler_tpu_torch.deviceplugin import DeviceRegister
    from k8s_vgpu_scheduler_tpu_torch.deviceplugin.register import \
        monitor_usage_source
    from k8s_vgpu_scheduler_tpu_torch.monitor.noderpc import \
        NodeTPUInfoServer
    from k8s_vgpu_scheduler_tpu_torch.tpulib import MockBackend

    S = side("port")
    clock, loop = SimClock(), FakeLoop()
    loop.containers["u5_podU"] = FakeState(FakeRegion(used=10 * MIB),
                                           active=True, key="u5_podU")
    sampler = S.acc.UsageSampler(loop, clock=clock)
    sampler.sample()
    clock.advance(3.0)
    sampler.sample()
    rpc = NodeTPUInfoServer(loop, "node-u", sampler=sampler)
    port = rpc.serve(0, "127.0.0.1")
    s = S.Scheduler(S.FakeKube(), S.Config(), clock=SimClock())
    sock = tmp_path / "sched.sock"
    grpc_server = start_register_service(s, f"unix:{sock}", workers=2)
    backend = MockBackend({"generation": "h100", "mesh": [1]})
    reg = DeviceRegister(backend, S.Config(node_name="node-u"),
                         endpoint=f"unix:{sock}",
                         usage_source=monitor_usage_source(
                             f"127.0.0.1:{port}"))
    reg.start()
    try:
        want = sampler.get("u5_podU")
        deadline = time.monotonic() + 30
        while True:
            acct = s.ledger.get("u5")
            if acct is not None and acct.chip_seconds == want.chip_seconds:
                break
            assert time.monotonic() < deadline, acct
            reg.push_update(backend.inventory())
            time.sleep(0.05)
        assert acct.node == "node-u" and acct.name == "podU"
        assert acct.hbm_byte_seconds == want.hbm_byte_seconds == \
            3.0 * 10 * MIB
    finally:
        reg.stop()
        grpc_server.stop(grace=1).wait()
        rpc.stop()


# -- NodeTPUInfo between the packages --------------------------------------------


class RpcRegion(FakeRegion):
    def __init__(self, uuid, limit_mib, used_mib, pids):
        super().__init__(chips=1, used=used_mib * MIB, switch=1, oversub=1)
        self._uuid, self._limit, self._pids = uuid, limit_mib * MIB, pids
        self.priority = 1

    def uuid(self, dev):
        return self._uuid

    def limit(self, _dev):
        return self._limit

    def sm_limit(self, _dev):
        return 30

    def proc_pids(self):
        return list(self._pids)


def rpc_loop():
    loop = FakeLoop()
    loop.containers["uid9_podZ"] = FakeState(
        RpcRegion("GPU-7", 1000, 100, [11]), active=True, key="uid9_podZ")
    loop.containers["uid8_podY"] = FakeState(
        RpcRegion("GPU-6", 2000, 0, []), active=False, key="uid8_podY")
    return loop


def serve_rpc(pkg: str, loop, sampler):
    if pkg == "port":
        from k8s_vgpu_scheduler_tpu_torch.monitor.noderpc import \
            NodeTPUInfoServer
    else:
        from k8s_vgpu_scheduler_tpu.monitor.noderpc import NodeTPUInfoServer
    server = NodeTPUInfoServer(loop, "node-test", sampler=sampler)
    return server, server.serve(0, "127.0.0.1")


def client(pkg: str, port: int):
    import grpc

    if pkg == "port":
        from k8s_vgpu_scheduler_tpu_torch.api import noderpc_pb2 as pb
        from k8s_vgpu_scheduler_tpu_torch.monitor.noderpc import node_tpu_stub
    else:
        from k8s_vgpu_scheduler_tpu.api import noderpc_pb2 as pb
        from k8s_vgpu_scheduler_tpu.monitor.noderpc import node_tpu_stub
    channel = grpc.insecure_channel(f"127.0.0.1:{port}")
    return pb, node_tpu_stub(channel), channel


@pytest.mark.parametrize("server_pkg,client_pkg", [
    ("port", "port"), ("port", "jax"), ("jax", "port")])
def test_node_tpu_info_between_the_packages(server_pkg, client_pkg):
    from google.protobuf import json_format

    loop = rpc_loop()
    clock = SimClock()
    sampler = side("port").acc.UsageSampler(loop, clock=clock)
    sampler.sample()
    clock.advance(2.0)
    sampler.sample()
    server, port = serve_rpc(server_pkg, loop, sampler)
    pb, stub, channel = client(client_pkg, port)
    try:
        full = stub(pb.GetNodeTPURequest(), timeout=10)
        assert full.nodeid == "node-test"
        by = {u.ctrkey: u.info for u in full.usages}
        assert set(by) == {"uid9_podZ", "uid8_podY"}
        z = by["uid9_podZ"]
        assert (list(z.uuids), list(z.limit), list(z.sm_limit),
                list(z.used), z.priority, z.utilization_switch,
                z.oversubscribe, [p.pid for p in z.procs]) == (
            ["GPU-7"], [1000 * MIB], [30], [100 * MIB], 1, 1, 1, [11])
        counters = {c.ctrkey: c for c in full.usage.counters}
        assert full.usage.nodeid == "node-test"
        assert counters["uid9_podZ"].chip_seconds == 2.0
        assert counters["uid8_podY"].chip_seconds == 0.0
        only = stub(pb.GetNodeTPURequest(usage_only=True), timeout=10)
        assert not only.usages
        assert json_format.MessageToDict(only.usage) == \
            json_format.MessageToDict(full.usage)
        one = stub(pb.GetNodeTPURequest(ctrkey="uid8_podY"), timeout=10)
        assert [u.ctrkey for u in one.usages] == ["uid8_podY"]
        assert not stub(pb.GetNodeTPURequest(ctrkey="nope"),
                        timeout=10).usages
    finally:
        channel.close()
        server.stop()


def test_node_tpu_info_replies_match_the_jax_server_byte_for_byte():
    loop = rpc_loop()
    clock = SimClock()
    sampler = side("port").acc.UsageSampler(loop, clock=clock)
    sampler.sample()
    clock.advance(2.0)
    sampler.sample()
    replies = {}
    for pkg in ("port", "jax"):
        server, port = serve_rpc(pkg, loop, sampler)
        pb, stub, channel = client("jax", port)
        try:
            replies[pkg] = [stub(pb.GetNodeTPURequest(**req), timeout=10)
                            .SerializeToString(deterministic=True)
                            for req in ({}, {"usage_only": True},
                                        {"ctrkey": "uid9_podZ"})]
        finally:
            channel.close()
            server.stop()
    assert replies["port"] == replies["jax"]


@pytest.mark.parametrize("pkg", SIDES)
def test_a_failed_bind_raises(pkg):
    """A failed bind raises on both servers: grpc raises RuntimeError
    itself, or (older grpc) reports port 0, which the server turns into
    OSError.  The address is one no interface of this host holds
    (TEST-NET-1): the bind fails locally, nothing is sent."""
    if pkg == "port":
        from k8s_vgpu_scheduler_tpu_torch.monitor.noderpc import \
            NodeTPUInfoServer
    else:
        from k8s_vgpu_scheduler_tpu.monitor.noderpc import NodeTPUInfoServer
    server = NodeTPUInfoServer(FakeLoop(), "n")
    try:
        with pytest.raises((OSError, RuntimeError), match="bind"):
            server.serve(0, "192.0.2.1")
    finally:
        server.stop()


# -- score_by_actual on the serial Filter ----------------------------------------


def fleet_with_measurements(S, score_by_actual):
    kube = S.FakeKube()
    for n in ("node-a", "node-b"):
        kube.add_node({"metadata": {"name": n, "annotations": {}}})
    s = S.Scheduler(kube, S.Config(score_by_actual=score_by_actual),
                    clock=SimClock())
    register_node(S, s, "node-a")
    register_node(S, s, "node-b")
    kube.watch_pods(s.on_pod_event)
    s.ledger.record("node-a", [counter_row("u0_loud", chips=4, active=True,
                                           chip_seconds=100.0)])
    s.ledger.record("node-b", [counter_row("u0b_quiet", chips=1,
                                           active=False)])
    return kube, s


def test_score_by_actual_prefers_the_measured_idle_node(S):
    kube, s = fleet_with_measurements(S, True)
    try:
        pod = card_pod(S, "p1", "u1")
        kube.create_pod(pod)
        assert s.filter(pod, ["node-a", "node-b"]).node == "node-b"
    finally:
        close(s)


def test_score_by_actual_off_by_default_no_ledger_influence(S):
    kube1, s1 = fleet_with_measurements(S, False)
    kube2, s2 = fleet_with_measurements(S, False)
    s2.ledger = S.acc.UsageLedger()
    try:
        pod = card_pod(S, "p1", "u1")
        kube1.create_pod(pod)
        kube2.create_pod(pod)
        assert s1.filter(pod, ["node-a", "node-b"]).node == \
            s2.filter(pod, ["node-a", "node-b"]).node == "node-a"
    finally:
        close(s1)
        close(s2)


def test_unmonitored_node_gets_no_bonus(S):
    clock = SimClock()
    led = S.acc.UsageLedger(clock=clock)
    assert led.node_busy_chips("never-reported") is None
    assert S.eff.actual_idle_bonus(led, "never-reported", 8) == 0.0
    led.record("n1", [counter_row("u1_p", chips=2, active=True)])
    assert led.node_busy_chips("n1") == 2
    assert S.eff.actual_idle_bonus(led, "n1", 4) == 0.5
    clock.advance(120.0)
    assert led.node_busy_chips("n1") is None
    assert S.eff.actual_idle_bonus(led, "n1", 4) == 0.0


def test_score_by_actual_choices_are_the_jax_choices():
    """Five pods in turn on three measured nodes, the bonus on: every
    choice the JAX serial Filter makes."""
    got = {}
    for name in SIDES:
        S = side(name)
        kube = S.FakeKube()
        for n in ("n0", "n1", "n2"):
            kube.add_node({"metadata": {"name": n, "annotations": {}}})
        s = S.Scheduler(kube, S.Config(score_by_actual=True),
                        clock=SimClock())
        kube.watch_pods(s.on_pod_event)
        for n in ("n0", "n1", "n2"):
            register_node(S, s, n)
        s.ledger.record("n0", [counter_row("a_x", chips=3, active=True)])
        s.ledger.record("n1", [counter_row("b_y", chips=1, active=True)])
        picks = []
        try:
            for i in range(5):
                pod = card_pod(S, f"p{i}", f"u{i}", mem="6000")
                kube.create_pod(pod)
                picks.append(s.filter(pod, ["n0", "n1", "n2"]).node)
        finally:
            close(s)
        got[name] = picks
    assert got["port"] == got["jax"]
    assert len(set(got["port"])) > 1


# -- the rescuer flags, never evicts -------------------------------------------


def idle_env(S):
    kube = S.FakeKube()
    kube.add_node({"metadata": {"name": "node-a", "annotations": {}}})
    clock = SimClock()
    s = S.Scheduler(kube, S.Config(idle_grant_grace_s=60.0,
                                   efficiency_window_s=120.0), clock=clock)
    register_node(S, s, "node-a")
    return s, clock


def test_idle_oversubscribed_grant_flagged_once_not_evicted(S):
    s, clock = idle_env(S)
    try:
        s.pods.add_pod(grant(S, "u1", "squat", "node-a", chips=2))
        for _ in range(2):
            s.ledger.record("node-a", [counter_row(
                "u1_squat", chips=2, active=False, oversub=True)])
            clock.advance(120.0)
        s.ledger.record("node-a", [counter_row(
            "u1_squat", chips=2, active=False, oversub=True)])
        flags = [a for a in s.rescuer.sweep() if a["kind"] == "idle-grant"]
        assert [f["pod"] for f in flags] == ["squat"]
        assert s.pods.get("u1") is not None
        assert not [a for a in s.rescuer.sweep()
                    if a["kind"] == "idle-grant"]
        s.ledger.record("node-a", [counter_row(
            "u1_squat", chips=2, active=True, chip_seconds=5.0,
            oversub=True)])
        s.rescuer.sweep()
        assert "u1" not in s.rescuer.idle_flagged
        clock.advance(120.0)
        s.ledger.record("node-a", [counter_row(
            "u1_squat", chips=2, active=False, chip_seconds=5.0,
            oversub=True)])
        assert [a["kind"] for a in s.rescuer.sweep()] == ["idle-grant"]
    finally:
        close(s)


def test_idle_but_not_oversubscribed_is_metric_only(S):
    s, clock = idle_env(S)
    try:
        s.pods.add_pod(grant(S, "u1", "quiet", "node-a"))
        s.ledger.record("node-a", [counter_row("u1_quiet", active=False)])
        clock.advance(120.0)
        s.ledger.record("node-a", [counter_row("u1_quiet", active=False)])
        assert not [a for a in s.rescuer.sweep()
                    if a["kind"] == "idle-grant"]
        assert [p.name for p in s.grant_efficiency().idle] == ["quiet"]
    finally:
        close(s)


# -- showback, the report and /usagez ---------------------------------------------


def scheduler_with_usage(S):
    kube = S.FakeKube()
    kube.add_node({"metadata": {"name": "node-a", "annotations": {}}})
    clock = SimClock()
    s = S.Scheduler(kube, S.Config(efficiency_window_s=100.0), clock=clock)
    register_node(S, s, "node-a")
    s.pods.add_pod(grant(S, "u1", "train", "node-a", chips=2, namespace="ml"))
    s.pods.add_pod(grant(S, "u2", "squat", "node-a", namespace="web"))
    s.pods.add_pod(grant(S, "u4", "dark", "node-a", chips=3,
                         namespace="dark"))
    for i in range(11):
        s.ledger.record("node-a", [
            counter_row("u1_train", chips=2, active=True,
                        chip_seconds=float(20 * i)),
            counter_row("u2_squat", active=False),
            counter_row("u3_ghost", active=True, chip_seconds=float(i))])
        clock.advance(10.0)
    return s


def test_export_usage_namespaced_rows(S):
    s = scheduler_with_usage(S)
    try:
        export = s.export_usage()
        narrow = s.export_usage(window_s=30.0)
    finally:
        close(s)
    ns = {r["namespace"]: r for r in export["namespaces"]}
    assert ns["ml"]["chip_seconds"] > 0 and ns["ml"]["efficiency"] > 0.9
    assert ns["web"]["chip_seconds"] == 0.0 and ns["web"]["efficiency"] == 0
    assert ns["(unresolved)"]["pods"] == 1
    assert ns["dark"]["granted_chip_seconds"] == 3 * 100.0
    assert ns["dark"]["efficiency"] == 0.0
    assert export["fleet"]["unmeasured_granted_chip_seconds"] == 300.0
    pods = {r["pod"]: r for r in export["pods"]}
    assert pods["train"]["live"] and pods["train"]["namespace"] == "ml"
    assert pods["dark"]["efficiency"] is None and not pods["ghost"]["live"]
    narrow_ml = {r["namespace"]: r for r in narrow["namespaces"]}["ml"]
    assert 0 < narrow_ml["chip_seconds"] < ns["ml"]["chip_seconds"]


def exports():
    out = {}
    for name in SIDES:
        S = side(name)
        s = scheduler_with_usage(S)
        try:
            out[name] = [s.export_usage(), s.export_usage(window_s=30.0)]
        finally:
            close(s)
    return out


def test_the_showback_is_the_jax_showback():
    got = exports()
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("pods", [False, True])
def test_the_report_formats_are_the_jax_formats(pods):
    from k8s_vgpu_scheduler_tpu.cmd import vtpu_report as jrep
    from k8s_vgpu_scheduler_tpu_torch.cmd import vgpu_report as trep

    export = exports()["port"][0]
    assert trep.format_report(export, pods=pods) == \
        jrep.format_report(export, pods=pods)
    assert "ml" in trep.format_report(export, pods=pods)
    cols = (trep.POD_COLUMNS, trep.NAMESPACE_COLUMNS)[not pods]
    rows = export["pods" if pods else "namespaces"]
    text = trep.to_csv(rows, cols)
    assert text == jrep.to_csv(rows, cols)
    assert text.strip().splitlines()[0] == ",".join(cols)
    assert len(text.strip().splitlines()) == 1 + len(rows)
    # The degraded sections, as the JAX report renders them.
    degraded = dict(export, audit=None, slo=None)
    assert trep.format_report(degraded) == jrep.format_report(degraded)
    assert "+ audit: -" in trep.format_report(degraded)


def test_usagez_endpoint_and_the_report_command(capsys):
    from k8s_vgpu_scheduler_tpu_torch.cmd import vgpu_report
    from k8s_vgpu_scheduler_tpu_torch.scheduler.routes import ExtenderServer

    S = side("port")
    s = scheduler_with_usage(S)
    server = ExtenderServer(s, s.cfg, host="127.0.0.1", port=0)
    server.start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        with urllib.request.urlopen(f"{base}/usagez", timeout=10) as r:
            export = json.load(r)
        assert {row["namespace"] for row in export["namespaces"]} >= \
            {"ml", "web"}
        with urllib.request.urlopen(f"{base}/usagez?window=30",
                                    timeout=10) as r:
            assert json.load(r)["window_s"] == 30.0
        assert vgpu_report.main(["--cluster", base, "--json", "--pods"]) == 0
        doc = json.loads(capsys.readouterr().out)
        assert doc["pods"] == export["pods"]
        assert doc["audit"] is None and doc["slo"] is None
        assert "queues" not in doc
        # The capacity section since the extender serves /capacityz: an
        # ungoverned fleet's demand by namespace.
        assert doc["capacity"]["method"] == "analytic"
        shown = {r["queue"] for r in doc["capacity"]["queues"]}
        assert shown and shown == {r["queue"] for r in
                                   s.export_capacity()["queues"]}
        assert shown <= {row["namespace"] for row in export["namespaces"]}
        assert vgpu_report.main(["--cluster", base, "--csv"]) == 0
        assert capsys.readouterr().out.startswith("namespace,pods,")
        assert vgpu_report.main(["--cluster", base]) == 0
        text = capsys.readouterr().out
        assert "fleet efficiency" in text and "+ slo: -" in text
        assert "+ capacity (analytic" in text
    finally:
        server.stop()


def test_the_report_explain_names_the_provenance_slice(capsys):
    from k8s_vgpu_scheduler_tpu_torch.cmd import vgpu_report

    assert vgpu_report.main(["--cluster", "http://127.0.0.1:1",
                             "--explain", "default/p"]) == 2
    assert "A.5" in capsys.readouterr().err
    assert vgpu_report.main(["--cluster", "http://127.0.0.1:1"]) == 2


# -- the collectors' accounting families -----------------------------------------


def test_cluster_collector_emits_accounting_families():
    from k8s_vgpu_scheduler_tpu_torch.util.exposition import render

    S = side("port")
    clock = SimClock()
    s = S.Scheduler(S.FakeKube(), S.Config(efficiency_window_s=100.0,
                                           idle_grant_grace_s=60.0),
                    clock=clock)
    register_node(S, s, "node-a")
    s.pods.add_pod(grant(S, "u1", "train", "node-a", namespace="ml"))
    s.pods.add_pod(grant(S, "u2", "squat", "node-a", namespace="web"))
    for i in range(8):
        s.ledger.record("node-a", [
            counter_row("u1_train", active=True, chip_seconds=float(10 * i)),
            counter_row("u2_squat", active=False)])
        clock.advance(10.0)
    lines = render(S.smetrics.ClusterCollector(s).collect()).splitlines()
    assert ('vtpu_usage_chip_seconds_total{podname="train",'
            'podnamespace="ml"} 70.0') in lines
    assert any(x.startswith('vtpu_usage_hbm_byte_seconds_total{podname='
                            '"train"') for x in lines)
    assert ('vtpu_grant_efficiency_ratio{podname="squat",'
            'podnamespace="web"} 0.0') in lines
    assert "vtpu_idle_grants 1.0" in lines


def test_node_collector_emits_sampler_counters():
    from k8s_vgpu_scheduler_tpu_torch.util.exposition import render

    S = side("port")
    clock, loop = SimClock(), FakeLoop()
    loop.containers["u1_podA"] = FakeState(FakeRegion(chips=2, used=10 * MIB),
                                           active=True, key="u1_podA")
    sampler = S.acc.UsageSampler(loop, clock=clock)
    sampler.sample()
    clock.advance(5.0)
    sampler.sample()
    text = render(S.nmetrics.NodeCollector(loop, None, "node-a",
                                           sampler=sampler).collect())
    assert 'vtpu_usage_chip_seconds_total{container="u1_podA"} 10.0' in \
        text.splitlines()
    for name in ("vtpu_usage_hbm_byte_seconds_total{container=\"u1_podA\"}",
                 "vtpu_usage_throttled_seconds_total",
                 "vtpu_usage_oversub_spill_seconds_total"):
        assert name in text
