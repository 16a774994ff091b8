"""``chip_smoke.py``'s helpers on the CPU.

The reading of the card's used memory (``smi_card_mib``): NVML's v2
``used`` (nvidia-smi's ``memory.used``, the reserve apart), read by a
child without the preloaded interposer, the least over a window; a window
whose highest reading stands above both of its ends is kept as one of the
card's transients, a ramp is not.  The reading runs over the mock NVML
(``csrc/vgpu/mock_nvml.cc``), whose v1 ``used`` is the reserve and whose
v2 ``used`` is 0, so the v1 struct would read 480 here.

The observability legs: ``node_reading`` (leg (a)'s scrape-and-compare)
over fake regions, and ``ledger_vs_monitor`` (leg (b)), each passing on
agreement and failing on any one disagreement; then both legs rehearsed
whole, ``NodeView`` over a real monitor loop and two workload children,
``FleetView`` with ``vgpu-monitor`` as a process and the control-plane
child on the mock NVML."""

import json
import subprocess
import threading
import types

import pytest

import chip_smoke
from k8s_vgpu_scheduler_tpu.health.faults import SimClock
from k8s_vgpu_scheduler_tpu_torch.accounting import UsageSampler
from k8s_vgpu_scheduler_tpu_torch.api import noderpc_pb2
from k8s_vgpu_scheduler_tpu_torch.cmd.vgpu_smi import parse_prom
from k8s_vgpu_scheduler_tpu_torch.monitor.metrics import NodeCollector
from k8s_vgpu_scheduler_tpu_torch.monitor.noderpc import NodeTPUInfoServer
from k8s_vgpu_scheduler_tpu_torch.ops import _kernels
from k8s_vgpu_scheduler_tpu_torch.tpulib import MockBackend
from k8s_vgpu_scheduler_tpu_torch.util import trace
from k8s_vgpu_scheduler_tpu_torch.util.exposition import render


@pytest.fixture
def transients(monkeypatch):
    monkeypatch.setattr(chip_smoke, "CARD_TRANSIENTS", [])
    return chip_smoke.CARD_TRANSIENTS


def test_the_card_reading_is_nvml_v2_used_over_the_mock(
        tmp_path, monkeypatch, transients):
    lib = _kernels.build_mock_nvml()
    fixture = tmp_path / "node.json"
    fixture.write_text(json.dumps({"generation": "h100", "mesh": [1],
                                   "hbm_mib": 81079, "reserved_mib": 480}))
    monkeypatch.setenv("MOCK_NVML_JSON", str(fixture))
    monkeypatch.setenv("LD_LIBRARY_PATH", str(lib.parent))
    monkeypatch.setenv("LD_PRELOAD", "/nonexistent/libvgpu_cuda.so")
    assert chip_smoke.smi_card_mib() == 0
    assert transients == []


@pytest.mark.parametrize("printed, least, kept", [
    ("4844 5363 4844 4844", 4844, True),     # a rise that fell back
    ("4844 5363 5363 4844", 4844, False),    # cut by the window's start
    ("630 4600 630 4600", 630, False),       # a pod taking memory
    ("4844 4844 4844 4844", 4844, False),
])
def test_the_window_keeps_its_least_and_its_transients(
        monkeypatch, transients, printed, least, kept):
    seen = {}

    def run(argv, **kw):
        seen.update(argv=argv, env=kw["env"])
        return subprocess.CompletedProcess(argv, 0, printed + "\n", "")

    monkeypatch.setenv("LD_PRELOAD", "/nonexistent/libvgpu_cuda.so")
    monkeypatch.setattr(chip_smoke.subprocess, "run", run)
    assert chip_smoke.smi_card_mib() == least
    assert [t[1:] for t in transients] == (
        [(least, int(printed.split()[1]))] if kept else [])
    assert seen["argv"][1:3] == ["-I", "-S"]
    assert "LD_PRELOAD" not in seen["env"]


# -- the observability legs' comparisons ------------------------------------------

MIB = 1 << 20
CARD = "GPU-0a1b2c3d-4e5f-6071-8293-a4b5c6d7e8f9"


class FakeRegion:
    """A pod's region as the node's surfaces read it."""

    def __init__(self, limit_mib, sm, used, pids, switch=0, oversub=0):
        self.num_devices, self.priority = 1, 0
        self._limit, self._sm, self._used = limit_mib * MIB, sm, used
        self._pids, self.utilization_switch = pids, switch
        self.oversubscribe = oversub

    def uuid(self, _dev):
        return CARD

    def limit(self, _dev):
        return self._limit

    def sm_limit(self, _dev):
        return self._sm

    def used(self, _dev):
        return self._used

    def proc_pids(self):
        return list(self._pids)


def node_surfaces(monkeypatch):
    """phase_device_plugin's leg (a) over fake S and T: the exporter's
    text parsed, the GetNodeTPU reply, the regions read at once and the
    sampler's rows, after three region-scan ticks."""
    monkeypatch.setattr(trace, "_GLOBAL", trace.Tracer())
    loop = types.SimpleNamespace(lock=threading.RLock(), containers={})
    regions = {"uidDS_serve": FakeRegion(24000, 50, 3 * 1000 * MIB, [41]),
               "uidDT_train": FakeRegion(40000, 50, 9 * 1000 * MIB, [42],
                                         switch=1)}
    for key, r in regions.items():
        loop.containers[key] = types.SimpleNamespace(region=r, active=True,
                                                     key=key)
    clock = SimClock()
    sampler = UsageSampler(loop, clock=clock)
    for _ in range(3):
        with trace.tracer().span("region-scan"):
            sampler.sample()
        clock.advance(0.5)
    fixture = {"generation": "h100", "mesh": [1], "hbm_mib": 81079,
               "chips": [{"coords": [0], "uuid": CARD}]}
    text = render(NodeCollector(loop, MockBackend(fixture), "h100-node",
                                sampler=sampler).collect())
    reply = NodeTPUInfoServer(loop, "h100-node", sampler=sampler) \
        .get_node_tpu(noderpc_pb2.GetNodeTPURequest(), None)
    direct = {k: chip_smoke.region_reading(r) for k, r in regions.items()}
    rows = {row["ctrkey"]: row for row in sampler.snapshot()}
    return parse_prom(text), chip_smoke.rpc_usages(reply), direct, rows


def test_the_node_reading_holds_the_surfaces_to_the_regions(monkeypatch):
    metrics, rpc, direct, rows = node_surfaces(monkeypatch)
    out = chip_smoke.node_reading(metrics, rpc, direct, rows, 3,
                                  {CARD: 81079}, "h100-node")
    assert out["uidDT_train"]["switch"] == 1
    assert out["uidDS_serve"]["switch"] == 0
    assert out["uidDT_train"]["exporter_used"] == \
        out["uidDT_train"]["rpc_used"] == 9 * 1000 * MIB
    assert out["uidDT_train"]["chip_seconds"] == 1.0
    assert out["uidDT_train"]["throttled_seconds"] == 1.0


@pytest.mark.parametrize("what", [
    "limit", "sm_limit", "procs", "oversubscribe", "switch", "used",
    "scans", "advertised", "row", "rpc"])
def test_the_node_reading_fails_on_any_disagreement(monkeypatch, what):
    metrics, rpc, direct, rows = node_surfaces(monkeypatch)
    scans, advertised = 3, {CARD: 81079}
    t = "uidDT_train"
    if what == "used":
        direct[t]["used"] = int(direct[t]["used"] * 1.02)
    elif what == "scans":
        scans = 4
    elif what == "advertised":
        advertised = {CARD: 81559}
    elif what == "row":
        rows[t] = dict(rows[t], chip_seconds=rows[t]["chip_seconds"] + 0.5)
    elif what == "rpc":
        rpc[t] = dict(rpc[t], limit=rpc[t]["limit"] + MIB)
    else:
        direct[t][what] += 1
    with pytest.raises(chip_smoke.Fail):
        chip_smoke.node_reading(metrics, rpc, direct, rows, scans,
                                advertised, "h100-node")


def ledger_surfaces(v_chip=12.5, v_hbm=3.5e12):
    """phase_preempt's leg (b): the monitor's counters and the extender's
    ledger, fed the same rows over the register-stream decode."""
    from k8s_vgpu_scheduler_tpu_torch.accounting.ledger import decode_usage
    from k8s_vgpu_scheduler_tpu_torch.deviceplugin.register import \
        usage_to_proto
    from k8s_vgpu_scheduler_tpu_torch.k8s import FakeKube
    from k8s_vgpu_scheduler_tpu_torch.monitor.noderpc import usage_report
    from k8s_vgpu_scheduler_tpu_torch.scheduler import Scheduler
    from k8s_vgpu_scheduler_tpu_torch.scheduler.metrics import \
        ClusterCollector
    from k8s_vgpu_scheduler_tpu_torch.scheduler.pods import PodInfo
    from k8s_vgpu_scheduler_tpu_torch.util.config import Config
    from k8s_vgpu_scheduler_tpu_torch.util.types import ContainerDevice

    def row(key, chip, hbm):
        return {"ctrkey": key, "chips": 1, "active": False,
                "oversubscribe": False, "chip_seconds": chip,
                "hbm_byte_seconds": hbm, "throttled_seconds": 0.0,
                "oversub_spill_seconds": 0.0, "window_s": 30.0}

    rows = [row("uidPV_trainer", v_chip, v_hbm),
            row("uidPH_serve-hp", 7.25, 1.25e12),
            row("uidPV2_trainer-2", 9.0, 2.5e12)]
    mon = "".join(
        f'vtpu_usage_{f}_total{{container="{r["ctrkey"]}"}} {r[f]!r}\n'
        for r in rows for f in ("chip_seconds", "hbm_byte_seconds"))
    s = Scheduler(FakeKube(), Config(), clock=SimClock())
    s.pods.add_pod(PodInfo(uid="uidPV2", name="trainer-2",
                           namespace="default", node="n", devices=[[
                               ContainerDevice(CARD, "NVIDIA-h100", 40000,
                                               0)]]))
    wire = decode_usage(usage_to_proto(rows))
    assert wire == decode_usage(usage_report("n", rows).counters)
    s.ledger.record("n", wire)
    ext = render(ClusterCollector(s).collect())
    pods = {"uidPV_trainer": ("(unresolved)", "trainer"),
            "uidPH_serve-hp": ("(unresolved)", "serve-hp"),
            "uidPV2_trainer-2": ("default", "trainer-2")}
    return parse_prom(ext), parse_prom(mon), pods


def test_the_ledger_holds_the_monitors_counters():
    ext, mon, pods = ledger_surfaces()
    out = chip_smoke.ledger_vs_monitor(ext, mon, pods)
    assert out["uidPV_trainer"] == {"chip_seconds": 12.5,
                                    "hbm_byte_seconds": 3.5e12}
    assert out["uidPV2_trainer-2"]["chip_seconds"] == 9.0


@pytest.mark.parametrize("case", ["off", "zero", "missing"])
def test_the_ledger_comparison_fails_on_a_gap(case):
    ext, mon, pods = ledger_surfaces()
    if case == "off":
        key = "uidPV_trainer"
        mon["vtpu_usage_chip_seconds_total"] = [
            (labels, v * (1 + 1e-8) if labels["container"] == key else v)
            for labels, v in mon["vtpu_usage_chip_seconds_total"]]
    elif case == "zero":
        ext, mon, pods = ledger_surfaces(v_chip=0.0)
    else:
        pods = dict(pods, uidPX_ghost=("(unresolved)", "ghost"))
    with pytest.raises(chip_smoke.Fail):
        chip_smoke.ledger_vs_monitor(ext, mon, pods)


def test_metric_refuses_two_samples_of_one_selection():
    metrics = parse_prom('m{a="1",b="x"} 1\nm{a="1",b="y"} 2\n')
    assert chip_smoke.metric(metrics, "m", b="y") == 2.0
    assert chip_smoke.metric(metrics, "m", a="2") is None
    with pytest.raises(chip_smoke.Fail):
        chip_smoke.metric(metrics, "m", a="1")


@pytest.mark.parametrize("v2_idle_s", [3.0, 0.0],
                         ids=["as_on_the_card", "launching_its_whole_life"])
def test_the_fleet_leg_runs_on_the_mock_nvml(tmp_path, v2_idle_s):
    """phase_preempt's leg (b) on the CPU: vgpu-monitor as a process over
    the containers dir (FleetView), the control plane child reading its
    NodeTPUInfo through --usage-from, V, H and V' placed as the phase
    places them, each a workload child that launches while the monitor
    ticks; then FleetView.read holds the ledger to the monitor's
    counters, and the extender's exporter, /usagez, /debug/tracez,
    vgpu-report and vgpu-smi top to them and to the calls made.  V' idles
    after launching, as on the card (where it writes its checkpoint for
    most of its life), and its efficiency is then in (0, 1], as
    phase_preempt checks; or it launches for its whole life, and then it
    may read above 1, by no more than efficiency_skew_bound (ROADMAP
    C.9)."""
    import os
    import time

    from tests.test_torch_monitor import PORT, Workload

    nvml = _kernels.build_mock_nvml()
    vgpu = _kernels.build_vgpu()
    fixture = tmp_path / "nvml.json"
    fixture.write_text(json.dumps({"generation": "h100", "mesh": [1],
                                   "hbm_mib": 81079}))
    root = tmp_path / "containers"
    root.mkdir()
    env = {k: v for k, v in os.environ.items()
           if k not in ("VTPU_MOCK_JSON", "MOCK_NVML_NOT_SUPPORTED")}
    env.update(LD_LIBRARY_PATH=str(nvml.parent), MOCK_NVML_JSON=str(fixture))
    fleet = chip_smoke.FleetView(root, vgpu, env)
    plane = None
    try:
        plane = chip_smoke.PlaneChild({**env, "PLUGIN_DIR": str(tmp_path),
                                       "USAGE_FROM": fleet.grpc})
        node, specs = chip_smoke.PLUGIN_NODE, chip_smoke.PREEMPT_PODS
        pods, runs = {}, {}

        def admit(key):
            name, uid, mib, prio, anns = specs[key]
            return chip_smoke.admit_pod(plane.base, plane, chip_smoke.user_pod(
                name, uid, mib, prio, annotations=anns))

        def run(key, idle_s=1.0):
            """The pod launches for 1.5 s, then sits ``idle_s`` (V' writes
            its checkpoint on the card for most of its life, so the grant
            it held reads well under fully used)."""
            plane.call("allocate")
            name, uid = specs[key][:2]
            pods[key] = dict(key=f"{uid}_{name}", pod=plane.get_pod(name))
            t0 = time.monotonic()
            w = Workload(PORT, {"port": str(vgpu)}, root, pods[key]["key"])
            while time.monotonic() - t0 < 1.5:
                w.dispatch()
                time.sleep(0.05)
            time.sleep(idle_s)
            w.stop()
            runs[key] = {"life_s": time.monotonic() - t0}

        created, out = admit("V")
        chip_smoke.place_pod(plane.base, created, node, out)
        run("V")
        created, out = admit("H")
        nofit, _ = chip_smoke.filter_pod(plane.base, created, node)
        plane.call("delete", name=specs["V"][0])
        chip_smoke.place_pod(plane.base, plane.get_pod(specs["H"][0]), node,
                             out)
        run("H")
        plane.call("delete", name=specs["H"][0])
        created, out = admit("V2")
        chip_smoke.place_pod(plane.base, created, node, out)
        run("V2", idle_s=v2_idle_s)
        got = fleet.read(plane, pods, runs, nofit)
        plane.call("end")
    finally:
        if plane is not None:
            plane.close()
        fleet.stop()
    assert set(got["ledger"]) == {"V", "H", "V2"}
    assert got["trace"] == ["webhook", "filter", "decision-write", "bind",
                            "allocate"]
    assert got["phase_counts"]["filter"] == 4
    bound = (chip_smoke.efficiency_skew_bound(got["v2_covered_s"])
             if v2_idle_s == 0 else 1)
    assert 0 < got["v2_efficiency"] <= bound
    assert fleet.proc.returncode == 0
    # The capacity simulator's legs: /fleetz holds V' alone, the replay of
    # the card's remaining MiB fits and a MiB more pends, and the scale
    # leg replayed the 968 pods with the 16 squatters idle.
    assert got["fleetz"]["granted_mib"] == specs["V2"][2]
    assert got["simulate_live"]["card_mib"] == [specs["V2"][2], 81079]
    scaled = got["simulate_scale"]
    assert (scaled["cards"], scaled["placed"] + scaled["pending"],
            scaled["idle_grants"], scaled["exit_code"]) == (1024, 968, 16, 1)
    assert fleet.sim.returncode == 1


def test_the_node_leg_reads_live_regions(tmp_path, monkeypatch):
    """phase_device_plugin's leg (a) on the CPU: NodeView over a real
    monitor loop ticking in its thread, two workload children's regions
    (T's switch on), three readings, vgpu-smi under T's grant env alone
    and over the containers dir, and the debug server's checks."""
    import os

    from k8s_vgpu_scheduler_tpu_torch.cmd import monitor
    from k8s_vgpu_scheduler_tpu_torch.monitor import FeedbackLoop, \
        RegionReader
    from tests.test_torch_monitor import PORT, UUIDS, Workload

    vgpu = _kernels.build_vgpu()
    fixture = tmp_path / "mock.json"
    fixture.write_text(json.dumps({"generation": "h100", "mesh": [1],
                                   "hbm_mib": 81079, "chips": [{
                                       "coords": [0], "uuid": UUIDS[0]}]}))
    monkeypatch.setenv("VTPU_MOCK_JSON", str(fixture))
    root = tmp_path / "containers"
    libs = {"port": str(vgpu)}
    s = Workload(PORT, libs, root, "uidDS_serve", [UUIDS[0]], 0)
    t = Workload(PORT, libs, root, "uidDT_train", [UUIDS[0]], 1, sm=50)
    reader = RegionReader(str(vgpu))
    loop = FeedbackLoop(str(root), reader=reader)
    sampler = monitor.UsageSampler(loop)
    view = chip_smoke.NodeView(
        loop, sampler, reader, root, "h100-node",
        {"PATH": os.environ["PATH"],
         "CUDA_DEVICE_MEMORY_SHARED_CACHE": str(t.path)}, vgpu)
    stop = threading.Event()
    ticker = threading.Thread(
        target=monitor.run, daemon=True, name="vgpu-monitor-ticker",
        args=(loop, sampler, 0.2, stop), kwargs=dict(on_tick=view.on_tick))
    ticker.start()
    keys = (t.key, s.key)
    try:
        first = view.read("before_prefill", keys)
        s.dispatch()
        for _ in range(100):
            if loop.containers[t.key].region.utilization_switch:
                break
            s.dispatch()
            stop.wait(0.05)
        on = view.read("switch_on", keys)
        view.smi(t.key, keys)
        got = view.debug_checks()
    finally:
        stop.set()
        ticker.join()
        view.stop()
        loop.close()
        s.stop()
        t.stop()
    assert first["pods"][t.key]["switch"] == 0
    assert on["pods"][t.key]["switch"] == 1
    assert on["pods"][s.key]["switch"] == 0
    assert got["smi"]["device"]["memory_total_mib"] == 1000
    assert got["smi"]["device"]["core_limit_pct"] == 50
    assert got["smi"]["listed"] == sorted(keys)
    assert got["advertised"] == {UUIDS[0]: 81079}
    assert first["families"] >= 15 and first["scrape_bytes"] > 0


def test_region_scan_cost_reads_the_ticks(monkeypatch):
    """phase_coresidency's reading of the monitor's ticks: the process's
    region-scan histogram as the ticks left it, beside the cost of the
    span alone, measured in a tracer of its own."""
    from k8s_vgpu_scheduler_tpu_torch.util import trace

    monkeypatch.setattr(trace, "_GLOBAL", trace.Tracer())
    with pytest.raises(chip_smoke.Fail):
        chip_smoke.region_scan_cost(n=10)
    for _ in range(3):
        with trace.tracer().span("region-scan"):
            pass
    got = chip_smoke.region_scan_cost(n=100)
    assert got["ticks"] == 3 and got["span_s"] > 0
    assert got["span_share_of_interval"] == (
        got["span_s"] / chip_smoke.MONITOR_INTERVAL_S)
    assert trace.tracer().histogram_snapshot()[("region-scan", "")][1] == 3


# The capacity simulator's legs of FleetView: their checks alone, passing
# on agreement and failing on any one disagreement.
LIVE_CARD = {"uuid": "GPU-card-0", "hbm_mib": 81079}


def live_fleet(mib=40000):
    """A /fleetz of the card alone with one grant of ``mib``, and that
    pod as the apiserver holds it."""
    from k8s_vgpu_scheduler_tpu_torch.util import codec
    from k8s_vgpu_scheduler_tpu_torch.util.types import ContainerDevice

    export = {"nodes": [{"name": chip_smoke.PLUGIN_NODE, "generation": "h100",
                         "mesh": [1], "wraparound": [False],
                         "chips": [{"id": LIVE_CARD["uuid"], "type": "NVIDIA-h100",
                                    "count": 10, "devmem": 81079,
                                    "health": True, "coords": [0],
                                    "cores": 100}]}],
              "pods": [{"uid": "uidPV2", "name": "trainer-2",
                        "namespace": "default", "node": chip_smoke.PLUGIN_NODE,
                        "priority": 1,
                        "devices": [[{"uuid": LIVE_CARD["uuid"],
                                      "type": "NVIDIA-h100",
                                      "usedmem": mib, "usedcores": 0}]]}],
              "config": {"node_scheduler_policy": "spread",
                         "topology_policy": "best-effort"}}
    anns = {"vtpu.dev/assigned-ids": codec.encode_pod_devices(
        [[ContainerDevice(LIVE_CARD["uuid"], "NVIDIA-h100", 40000, 0)]])}
    return export, {"uidPV2": {"metadata": {"annotations": anns}}}


def test_fleetz_checks_hold_the_export_to_the_card_and_the_grants():
    export, held = live_fleet()
    assert chip_smoke.fleetz_checks(export, LIVE_CARD, held)["granted_mib"] == 40000


@pytest.mark.parametrize("fault", ["mib", "extra_node", "mesh", "no_pod",
                                   "devmem"])
def test_fleetz_checks_fail_on_any_disagreement(fault):
    export, held = live_fleet(40001 if fault == "mib" else 40000)
    node = export["nodes"][0]
    if fault == "extra_node":
        export["nodes"].append(dict(node, name="mock-node"))
    elif fault == "mesh":
        node["mesh"] = [8]
    elif fault == "no_pod":
        export["pods"] = []
    elif fault == "devmem":
        node["chips"][0]["devmem"] = 81080
    with pytest.raises(chip_smoke.Fail):
        chip_smoke.fleetz_checks(export, LIVE_CARD, held)


def _replays(export, fit_mib, over_mib):
    from k8s_vgpu_scheduler_tpu_torch.cmd import simulate

    return [simulate.run_simulation({"pods": [
        {"name": name, "gpu": 1, "gpumem": mib}]}, fleet_export=export)
        for name, mib in (("fit", fit_mib), ("over", over_mib))]


def test_the_live_replays_fit_the_remaining_mib_and_refuse_one_more():
    export, _ = live_fleet()
    fit, over = _replays(export, 41079, 41080)
    got = chip_smoke.simulate_live_checks(fit, over, LIVE_CARD, 40000, 1)
    assert got["card_mib"] == [40000, 81079]
    # A replay on another grant than the extender's is caught.
    with pytest.raises(chip_smoke.Fail):
        chip_smoke.simulate_live_checks(fit, over, LIVE_CARD, 39999, 1)
    fit, over = _replays(export, 41078, 41079)
    with pytest.raises(chip_smoke.Fail):
        chip_smoke.simulate_live_checks(fit, over, LIVE_CARD, 40000, 1)


SCALE = {"pods": [{"name": "train", "count": 3, "gpu": 4, "gpumem": 40000,
                   "duty": 0.9},
                  {"name": "squatter", "count": 2, "gpu": 1,
                   "gpumem": 10000, "duty": 0.0}],
         "accounting": {"runtime_s": 300, "tick_s": 5, "idle_grace_s": 120}}


@pytest.mark.parametrize("fault", [None, "overbooked", "lost_pod",
                                   "idle", "metering"])
def test_the_scale_checks_fail_on_any_disagreement(fault):
    import copy

    from k8s_vgpu_scheduler_tpu_torch.cmd import simulate

    r = simulate.run_simulation(copy.deepcopy(SCALE), nodes=2, chips=4,
                                hbm=81079, mesh=(4,), policy="binpack")
    if fault is None:
        got = chip_smoke.simulate_scale_checks(r, SCALE)
        assert (got["placed"], got["idle_grants"]) == (5, 2)
        return
    if fault == "overbooked":
        next(iter(r["chips"].values()))["mem_mib"][0] = 81080
    elif fault == "lost_pod":
        r["placed"].pop()
    elif fault == "idle":
        r["accounting"]["idle_grants"].pop()
    elif fault == "metering":
        r["accounting"]["max_error_pct"] = 5.5
    with pytest.raises(chip_smoke.Fail):
        chip_smoke.simulate_scale_checks(r, SCALE)
