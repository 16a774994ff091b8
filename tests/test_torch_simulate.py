"""The port's capacity simulator (``cmd/simulate.py``, ``vgpu-simulate``),
``Scheduler.export_fleet`` and ``GET /fleetz`` against the JAX package's,
on the CPU.

Both simulators run the same workloads on the same fleets, and their
results are compared whole: the placements (node, cards, MiB, cores),
each card's usage, ``hbm_allocated_fraction``, each pending pod's
reason, the accounting rows (metered and simulated GPU-seconds, errors,
idle grants, efficiencies), the chaos outcome and the serving A/B.

The JAX side runs its serial decision: its ``run_simulation`` builds
``Config(node_scheduler_policy=..., topology_policy=...)``, whose
``optimistic_commit`` defaults to True, and that path picks among nodes
within 1% of the best score by Python's salted ``hash()``.  The fixture
``serial`` rebinds the name ``Config`` in the JAX module's namespace to
``functools.partial(Config, optimistic_commit=False)`` for the test; the
JAX package is not changed.  Both sides place on the same mesh: a 2-D
mesh gives a card the same coordinates in both (the JAX simulator always
gives two); the port's 1-D default is checked on its own.

The name map (the port's name, then the JAX package's):

- workload keys: ``gpu``/``tpu``, ``gpumem``/``tpumem``,
  ``gpumem-percentage``/``tpumem-percentage``, ``gpucores``/``tpucores``
  (and so the pods' ``nvidia.com/*``/``google.com/*`` limits);
  ``priority`` keeps its key;
- card ids: ``sim-node-<n>-gpu-<i>``/``sim-node-<n>-chip-<i>``, and a
  card's type ``NVIDIA-<generation>``/``TPU-<generation>``;
- Filter's messages: "no node fits GPU request"/"no node fits TPU
  request", "no GPU inventory registered"/"no TPU inventory registered".

Every other key and value is the JAX simulator's (``chips``,
``hbm_mib`` and ``hbm_allocated_fraction`` among them: an H100's memory
is HBM too).

A ``gang`` entry is placed by both gang managers, and a ``queueing``
section replayed by both capacity queues, with equal answers.

The stated departure, pinned below with both answers: a workload with a
``fragmentation``, ``elastic``, ``capacity``, ``audit``, ``slo`` or ``ha``
section, which the JAX simulator replays, is refused by name (ROADMAP
A.5) and ``vgpu-simulate`` exits 2.
"""

import copy
import functools
import json
import re
import urllib.error
import urllib.request
from pathlib import Path

import pytest

import k8s_vgpu_scheduler_tpu.cmd.simulate as jsim
from k8s_vgpu_scheduler_tpu.scheduler.routes import \
    ExtenderServer as JServer
from k8s_vgpu_scheduler_tpu.util.config import Config as JConfig
from k8s_vgpu_scheduler_tpu_torch.cmd import simulate as tsim
from k8s_vgpu_scheduler_tpu_torch.scheduler.core import NO_FIT
from k8s_vgpu_scheduler_tpu_torch.scheduler.routes import \
    ExtenderServer as TServer
from tests.test_torch_scheduler import Side, fabric, fixture, limits, pod
from tests.test_torch_shim import libs  # noqa: F401 — a fixture

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"
KEYS = {"gpu": "tpu", "gpumem": "tpumem",
        "gpumem-percentage": "tpumem-percentage", "gpucores": "tpucores"}
A5_SECTIONS = ("queueing", "fragmentation", "elastic", "capacity", "audit",
               "slo", "ha")


class _OrderedScheduler(jsim.Scheduler):
    """The JAX scheduler with its snapshot in its registry's order: the
    JAX snapshot is rebuilt by iterating a set of node names (Python's
    salted string hash), so among nodes of equal score its gang placement
    changes from run to run (tests/test_torch_gang.py's
    ``ordered_snapshot``)."""

    def snapshot(self):
        snap = super().snapshot()
        return {n: snap[n] for n in self.nodes.list_nodes() if n in snap}


@pytest.fixture
def serial(monkeypatch):
    monkeypatch.setattr(jsim, "Config",
                        functools.partial(JConfig, optimistic_commit=False))
    monkeypatch.setattr(jsim, "Scheduler", _OrderedScheduler)


def jax_workload(workload: dict) -> dict:
    """The port's workload in the JAX simulator's names."""
    out = copy.deepcopy(workload)
    out["pods"] = [{KEYS.get(k, k): v for k, v in p.items()}
                   for p in out.get("pods", [])]
    if out.get("queueing"):
        out["queueing"]["arrivals"] = [
            {KEYS.get(k, k): v for k, v in a.items()}
            for a in out["queueing"].get("arrivals", [])]
    for ev in (out.get("chaos") or {}).get("events", []):
        if ev.get("chip"):
            ev["chip"] = ev["chip"].replace("-gpu-", "-chip-")
    return out


def as_port(obj):
    """The JAX simulator's result under the name map."""
    if isinstance(obj, dict):
        return {as_port(k): as_port(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [as_port(v) for v in obj]
    if isinstance(obj, str):
        obj = re.sub(r"-chip-(\d)", r"-gpu-\1", obj)
        obj = re.sub(r"\bTPU-", "NVIDIA-", obj)
        return (obj.replace("TPU request", "GPU request")
                .replace("no TPU inventory", "no GPU inventory"))
    return obj


def both(workload: dict, **kw):
    """(the port's result, the JAX simulator's under the name map)."""
    kw.setdefault("generation", "h100")
    port = tsim.run_simulation(copy.deepcopy(workload), **kw)
    ref = jsim.run_simulation(jax_workload(workload), **kw)
    return port, as_port(json.loads(json.dumps(ref)))


def assert_never_overbooked(r):
    for key, c in r["chips"].items():
        used, total = c["mem_mib"]
        assert used <= total, f"{key} over-booked: {used}>{total}"
        assert c["cores_pct"] <= 100, key


# tests/test_simulate.py's WORKLOAD without its ring gang.
WORKLOAD = {"pods": [
    {"name": "train", "count": 1, "gpu": 4, "gpumem": 8000,
     "gpucores": 100},
    {"name": "serve", "count": 10, "gpu": 1, "gpumem": 3000,
     "gpucores": 30},
]}


# -- (a) tests/test_simulate.py's cases, without a gang -----------------------

@pytest.mark.parametrize("policy", ["spread", "binpack"])
def test_capacity_invariant_and_usage_equal_the_jax_simulator(serial,
                                                              policy):
    port, ref = both(WORKLOAD, nodes=4, chips=8, hbm=16384, mesh=(4, 2),
                     policy=policy)
    assert port == ref
    assert_never_overbooked(port)
    assert port["fits"] and len(port["placed"]) == 11
    want = (32000 + 30000) / 524288
    assert abs(port["hbm_allocated_fraction"] - want) < 0.01


def test_the_port_workload_example_equals_the_jax_simulator(serial):
    """examples/vgpu-workload-sim.json: workload-sim.json's pods without
    its gang, with an accounting section, as its comment runs it."""
    wl = json.loads((EXAMPLES / "vgpu-workload-sim.json").read_text())
    port, ref = both(wl, nodes=4, chips=8, hbm=81079, mesh=(4, 2),
                     policy="binpack")
    assert port == ref
    assert port["fits"] and port["accounting"]["metering_ok"]


def _cli(main, tmp_path, capsys, workload, *args):
    wl = tmp_path / "wl.json"
    wl.write_text(json.dumps(workload))
    rc = main(["--workload", str(wl), *args])
    return rc, capsys.readouterr().out


def test_cli_exit_codes_and_json_equal_the_jax_cli(serial, tmp_path,
                                                   capsys):
    fleet = ("--nodes", "1", "--chips", "8", "--hbm", "16384", "--mesh",
             "4x2", "--generation", "h100")
    for workload, rc_want in (
            ({"pods": [{"name": "big", "gpu": 9, "gpumem": 16384}]}, 1),
            ({"pods": [{"name": "ok", "gpu": 1, "gpumem": 1000}]}, 0)):
        rc, out = _cli(tsim.main, tmp_path, capsys, workload, *fleet,
                       "--json")
        jrc, jout = _cli(jsim.main, tmp_path, capsys,
                         jax_workload(workload), *fleet, "--json")
        assert (rc, json.loads(out)) == (jrc, as_port(json.loads(jout)))
        assert rc == rc_want
    big = json.loads(_cli(tsim.main, tmp_path, capsys, {"pods": [
        {"name": "big", "gpu": 9, "gpumem": 16384}]}, *fleet, "--json")[1])
    assert big["pending"] == [{"pod": "big-0", "reason": NO_FIT}]
    rc, out = _cli(tsim.main, tmp_path, capsys, {"pods": [
        {"name": "ok", "gpu": 1, "gpumem": 1000}]}, *fleet)
    assert rc == 0 and "workload fits" in out
    assert tsim.main(["--workload", str(tmp_path / "absent.json")]) == 2
    assert tsim.main(["--workload", str(tmp_path / "wl.json"), "--mesh",
                      "weird"]) == 2


def test_cli_defaults_name_the_h100(tmp_path, capsys):
    """--chips 8 --hbm 81079 --mesh 8 --generation h100: one node of
    eight H100s as the node agent advertises them (a 1-D NVLink line)."""
    rc, out = _cli(tsim.main, tmp_path, capsys, {"pods": [
        {"name": "whole", "count": 8, "gpu": 1, "gpumem": 81079}]},
        "--json")
    r = json.loads(out)
    assert rc == 0 and r["fleet"] == {
        "nodes": 1, "chips_per_node": 8, "hbm_mib": 81079, "mesh": [8],
        "policy": "spread"}
    assert sorted(r["chips"]) == [f"sim-node-0/sim-node-0-gpu-{i}"
                                  for i in range(8)]
    assert r["hbm_allocated_fraction"] == 1.0


def test_percentage_requests_equal_the_jax_simulator(serial):
    port, ref = both({"pods": [{"name": "half", "count": 2, "gpu": 1,
                                "gpumem-percentage": 50}]},
                     nodes=1, chips=1, hbm=16384, mesh=(1, 1))
    assert port == ref
    assert port["fits"]
    assert port["hbm_allocated_fraction"] == pytest.approx(1.0, abs=0.01)


def _fetch(base: str, path: str = "/fleetz"):
    try:
        with urllib.request.urlopen(base + path, timeout=15) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _served(side: Side, server) -> dict:
    srv = server(side.s, side.s.cfg, host="127.0.0.1", port=0)
    srv.start()
    try:
        code, export = _fetch(f"http://127.0.0.1:{srv.port}")
    finally:
        srv.stop()
    assert code == 200
    return export


def test_from_cluster_plans_against_live_state_as_jax_does(serial):
    """Each package's extender over real HTTP: the same registration (a
    node of two H100s on a (2, 1) fabric) and the same live grant of
    10000 MiB give the same ``/fleetz``; each simulator rebuilt from its
    own snapshot answers for the remaining capacity, the same way."""
    fleet = {"node-a": fabric("node-a", [2, 1])}
    cfg = dict(node_scheduler_policy="binpack",
               topology_policy="restricted")
    exports = {}
    for port, server in ((True, TServer), (False, JServer)):
        side = Side(port, fleet=fleet, **cfg)
        side.create(pod("live", limits(mem=10000)))
        assert side.filter("live")["node"] == "node-a"
        exports[port] = _served(side, server)
    export = exports[True]
    assert export == exports[False]
    assert len(export["nodes"]) == 1 and len(export["pods"]) == 1
    assert export["nodes"][0]["mesh"] == [2, 1]
    assert export["nodes"][0]["chips"][0]["cores"] == 100
    assert export["config"] == {"node_scheduler_policy": "binpack",
                                "topology_policy": "restricted"}
    # Remaining: 71079 MiB on the granted card, 81079 on the other.
    for mib, fits in ((71079, True), (71080, False)):
        wl = {"pods": [{"name": "a", "gpu": 1, "gpumem": 81079},
                       {"name": "b", "gpu": 1, "gpumem": mib}]}
        got = tsim.run_simulation(copy.deepcopy(wl), fleet_export=export)
        ref = jsim.run_simulation(jax_workload(wl),
                                  fleet_export=exports[False])
        assert got == as_port(ref)
        assert got["fits"] is fits, got["pending"]
        assert got["fleet"] == {"nodes": 1,
                                "source": "live /fleetz snapshot",
                                "existing_pods": 1, "policy": "binpack"}


ACCOUNTING = {
    "pods": [
        {"name": "train", "count": 2, "gpu": 2, "gpumem": 4000,
         "gpucores": 50, "duty": 0.9},
        {"name": "bursty", "count": 1, "gpu": 1, "gpumem": 2000,
         "duty": 0.33},
        {"name": "squatter", "count": 1, "gpu": 4, "gpumem": 8000,
         "gpucores": 20, "duty": 0.0, "oversubscribe": True},
    ],
    "accounting": {"runtime_s": 300, "tick_s": 5, "idle_grace_s": 120},
}


def test_accounting_rows_equal_the_jax_simulator(serial):
    port, ref = both(ACCOUNTING, nodes=2, chips=8, hbm=16384, mesh=(4, 2))
    assert port == ref
    acct = port["accounting"]
    assert acct["metering_ok"] and acct["max_error_pct"] <= 5.0
    by_pod = {p["pod"]: p for p in acct["pods"]}
    assert by_pod["train-0"]["simulated_chip_seconds"] == 540.0
    assert abs(by_pod["train-0"]["metered_chip_seconds"] - 540.0) <= 27.0
    assert by_pod["squatter-0"]["metered_chip_seconds"] == 0.0
    assert acct["idle_grants"] == ["squatter-0"]
    assert acct["efficiency"]["squatter-0"] == 0.0
    assert acct["efficiency"]["train-0"] >= 0.85
    assert 0.0 < acct["fleet_efficiency"] < 1.0
    # Replays bit-identically (virtual clock, no real time anywhere).
    assert tsim.run_simulation(copy.deepcopy(ACCOUNTING), nodes=2, chips=8,
                               hbm=16384, mesh=(4, 2))["accounting"] == acct


def test_accounting_feeds_the_report_pipeline_as_jax_does(serial):
    """The replay's metering goes into the scheduler's ledger as the
    register stream's reports do, so vgpu-report's rows take it as
    vtpu-report's take the JAX one."""
    from k8s_vgpu_scheduler_tpu.cmd import vtpu_report as jreport
    from k8s_vgpu_scheduler_tpu_torch.cmd import vgpu_report as treport

    wl = {"pods": [{"name": "t", "count": 1, "gpu": 1, "gpumem": 1000,
                    "duty": 0.5}],
          "accounting": {"runtime_s": 100, "tick_s": 5}}
    port, ref = both(wl, nodes=1, chips=2, hbm=16384, mesh=(2, 1))
    assert port == ref
    acct = port["accounting"]
    assert acct["metering_ok"]
    rows = [{"namespace": "sim", "pods": 1,
             "chip_seconds": acct["pods"][0]["metered_chip_seconds"],
             "hbm_byte_seconds": 0.0, "granted_chip_seconds": 100.0,
             "efficiency": acct["efficiency"]["t-0"], "idle_grants": 0}]
    text = treport.to_csv(rows, treport.NAMESPACE_COLUMNS)
    assert text == jreport.to_csv(rows, jreport.NAMESPACE_COLUMNS)
    assert text.splitlines()[0] == ",".join(treport.NAMESPACE_COLUMNS)
    assert "sim" in text


SERVING = {"serving": {}}


def test_serving_ab_verdict_equals_the_jax_simulator(serial, libs):
    """The flat-vs-tiered QoS A/B (``libs`` builds both packages' native
    libraries once, for tests/test_torch_simlab.py too): the same phases,
    waits, weights and verdict, to the microsecond."""
    port, ref = both(SERVING, mesh=(1, 1))
    assert port == ref
    r = port["serving"]
    v = r["verdict"]
    assert v["bursty_p99_improved"], r["phase_compare"]
    assert v["overload_mean_improved"], r["phase_compare"]
    assert v["duty_shifted"] and v["duty_returned"], \
        r["tiered"]["duty_weights"]
    assert v["best_effort_goodput_ok"], r["best_effort_goodput_ratio"]
    assert v["no_violations"], r["violations"]
    assert v["ok"] and port["fits"]
    assert r["flat"]["phases"][0]["critical"]["wait_p99_us"] > 0
    assert r["tiered"]["reweights"] > 0


def test_serving_replay_is_deterministic_and_the_example_runs_as_is(
        serial, libs, tmp_path, capsys):
    """Bit-identical twice; and examples/workload-serving.json, which has
    no resource key, through both CLIs as it is."""
    a = tsim.run_simulation(SERVING, mesh=(1, 1))
    b = tsim.run_simulation(SERVING, mesh=(1, 1))
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
    example = str(EXAMPLES / "workload-serving.json")
    rc = tsim.main(["--workload", example, "--json"])
    port = json.loads(capsys.readouterr().out)
    jrc = jsim.main(["--workload", example, "--json", "--hbm", "81079",
                     "--mesh", "8"])
    ref = json.loads(capsys.readouterr().out)
    assert (rc, port) == (jrc, as_port(ref)) and rc == 0
    assert port["serving"]["verdict"]["ok"]
    assert tsim.main(["--workload", example]) == 0
    assert "verdict: OK" in capsys.readouterr().out


# -- (b) random workloads ------------------------------------------------------

def test_random_workloads_equal_the_jax_simulator_and_never_overbook(
        serial):
    """Property: whatever the mix, both simulators give the same result,
    and the replay never over-books a card."""
    from hypothesis import given, settings, strategies as st

    pod_st = st.fixed_dictionaries({
        "count": st.integers(1, 4),
        "gpu": st.integers(1, 9),
        "gpumem": st.sampled_from([1000, 3000, 8000, 16384, 20000]),
        "gpucores": st.sampled_from([0, 30, 50, 100]),
    })

    @settings(max_examples=40, deadline=None)
    @given(st.lists(pod_st, min_size=1, max_size=5),
           st.sampled_from(["spread", "binpack"]))
    def run(pods, policy):
        pods = [dict(p, name=f"p{i}") for i, p in enumerate(pods)]
        port, ref = both({"pods": pods}, nodes=2, chips=4, hbm=16384,
                         mesh=(2, 2), policy=policy)
        assert port == ref
        assert_never_overbooked(port)
        assert len(port["placed"]) + len(port["pending"]) == \
            sum(p["count"] for p in pods)

    run()


# -- (c) tests/test_chaos.py's simulator scenarios ----------------------------

NODE_KILL = {
    "pods": [{"name": "train", "count": 6, "gpu": 1, "gpumem": 6000}],
    "chaos": {"seed": 11,
              "events": [{"at_s": 5.0, "kind": "partition-node",
                          "node": "sim-node-0"}]},
}


def test_node_kill_rescues_and_replaces_as_jax_does(serial):
    port, ref = both(NODE_KILL, nodes=3, chips=2, hbm=16384, mesh=(2, 1))
    assert port == ref
    assert port["fits"]
    chaos = port["chaos"]
    killed = {p["pod"] for p in port["placed"] if p["node"] == "sim-node-0"}
    assert killed and set(chaos["rescued"]) == killed
    replaced = {r["pod"]: r["node"] for r in chaos["replaced"]}
    assert set(replaced) == killed
    assert all(n != "sim-node-0" for n in replaced.values())
    assert chaos["still_pending"] == []
    assert chaos["lease_states"]["sim-node-0"] == "DEAD"
    assert chaos["overbooked_chips"] == []
    assert tsim.run_simulation(copy.deepcopy(NODE_KILL), nodes=3, chips=2,
                               hbm=16384, mesh=(2, 1)) == port


@pytest.mark.parametrize("seed", [23, 24])
def test_random_fault_schedule_equals_the_jax_one(serial, seed):
    wl = {"pods": [{"name": "w", "count": 8, "gpu": 1, "gpumem": 4000}],
          "chaos": {"seed": seed, "random_events": 12, "horizon_s": 90.0}}
    port, ref = both(wl, nodes=4, chips=2, hbm=16384, mesh=(2, 1))
    assert port == ref
    chaos = port["chaos"]
    assert chaos["overbooked_chips"] == []
    assert len(chaos["injected"]) == 12


def test_a_flapping_card_is_quarantined_as_in_jax(serial):
    """A card flaps past the threshold: the quarantine strips it, its pod
    is rescued and re-placed, on both (a chip id under the name map)."""
    wl = {"pods": [{"name": "w", "count": 4, "gpu": 1, "gpumem": 4000}],
          "chaos": {"seed": 3, "settle_s": 10,
                    "events": [{"at_s": 2.0, "kind": "flap-chip",
                                "node": "sim-node-0",
                                "chip": "sim-node-0-gpu-0", "count": 4}]}}
    port, ref = both(wl, nodes=2, chips=2, hbm=16384, mesh=(2, 1))
    assert port == ref
    assert port["chaos"]["quarantined"] == {"sim-node-0":
                                            ["sim-node-0-gpu-0"]}
    assert port["chaos"]["overbooked_chips"] == []


def test_chaos_cli_flags_equal_the_jax_cli(serial, tmp_path, capsys):
    args = ("--nodes", "3", "--chips", "2", "--hbm", "16384", "--mesh",
            "2x1", "--generation", "h100", "--chaos-seed", "7",
            "--chaos-random-events", "5", "--json")
    wl = {"pods": [{"name": "w", "count": 5, "gpu": 1, "gpumem": 4000}]}
    rc, out = _cli(tsim.main, tmp_path, capsys, wl, *args)
    jrc, jout = _cli(jsim.main, tmp_path, capsys, jax_workload(wl), *args)
    port = json.loads(out)
    assert (rc, port) == (jrc, as_port(json.loads(jout)))
    assert port["chaos"]["seed"] == 7 and len(port["chaos"]["injected"]) == 5
    rc, out = _cli(tsim.main, tmp_path, capsys, wl, *args[:-1])
    assert "chaos (seed 7): 5 fault(s) injected" in out


# -- (d) the full width -------------------------------------------------------

FLEET = json.loads((EXAMPLES / "vgpu-simulate-fleet.json").read_text())
SQUATTERS = [f"squatter-{i}" for i in range(16)]


def test_the_1024_card_fleet_equals_the_jax_simulator(serial):
    """examples/vgpu-simulate-fleet.json on 128 nodes of eight H100s at
    81,079 MiB under binpack: 776 placed, 192 pending, metered exactly,
    the 16 squatters idle — on both."""
    port, ref = both(FLEET, nodes=128, chips=8, hbm=81079, mesh=(8, 1),
                     policy="binpack")
    assert port == ref
    assert_never_overbooked(port)
    assert (len(port["placed"]), len(port["pending"])) == (776, 192)
    assert {p["reason"] for p in port["pending"]} == {NO_FIT}
    acct = port["accounting"]
    assert acct["metering_ok"] and acct["max_error_pct"] == 0.0
    assert acct["idle_grants"] == sorted(SQUATTERS)


def test_a_16_node_cut_of_the_fleet_under_spread(serial):
    """The same mix on 16 nodes under spread, both sides on (8, 1); and the
    port's own 1-D fabric (8,) gives it the same answer."""
    port, ref = both(FLEET, nodes=16, chips=8, hbm=81079, mesh=(8, 1),
                     policy="spread")
    assert port == ref
    assert_never_overbooked(port)
    line = tsim.run_simulation(copy.deepcopy(FLEET), nodes=16, chips=8,
                               hbm=81079, mesh=(8,), policy="spread")
    assert {k: v for k, v in line.items() if k != "fleet"} == \
        {k: v for k, v in port.items() if k != "fleet"}
    assert line["fleet"]["mesh"] == [8]


def test_the_port_fleet_on_its_own_line_fabric():
    """The port's default fabric, (8,): the cards' coordinates are (i,),
    and 4-card trainers land on contiguous arcs of the line."""
    r = tsim.run_simulation(
        {"pods": [{"name": "train", "count": 4, "gpu": 4, "gpumem": 40000,
                   "gpucores": 100}]},
        nodes=2, chips=8, hbm=81079, mesh=(8,), policy="binpack")
    assert r["fits"]
    for p in r["placed"]:
        idx = sorted(int(c["uuid"].rsplit("-", 1)[1]) for c in p["chips"])
        assert idx == list(range(idx[0], idx[0] + 4)), idx
    assert tsim.card_coords(5, (8,)) == (5,)
    assert [tsim.card_coords(i, (4, 2)) for i in (0, 3, 4, 7)] == \
        [(0, 0), (3, 0), (0, 1), (3, 1)]


# -- (e) export_fleet and GET /fleetz -----------------------------------------

EXPORT_FLEET = {"ring": fabric("ring", [8], wrap=[True]),
                "grid": fabric("grid", [4, 2]),
                "pcie": fabric("pcie", [4], missing=range(4)),
                "bare": dict(fabric("bare", [2], missing=range(2)),
                             mesh=[]),
                "mixed": fixture("mixed", ["h100", "a100"])}


def _export_side(port: bool) -> Side:
    side = Side(port, fleet=EXPORT_FLEET)
    for name, nums, mem, nodes in (("r2", 2, 20000, ["ring"]),
                                   ("g1", 1, 30000, ["grid"]),
                                   ("p1", 1, 10000, ["pcie"]),
                                   ("b1", 1, 5000, ["bare"]),
                                   ("m1", 1, 1000, ["mixed"])):
        side.create(pod(name, limits(nums=nums, mem=mem, cores=25)))
        assert side.filter(name, nodes)["node"] == nodes[0]
    return side


def test_export_fleet_equals_the_jax_export():
    """The same registrations (a ring, a grid, a node without a fabric, a
    node that sent no topology, a mixed node) and grants: the same
    export; a node without a fabric goes out as ``mesh (n,)`` with no
    card coordinates, one without a topology as None."""
    port, ref = (_export_side(p).s.export_fleet() for p in (True, False))
    assert port == ref
    by_name = {n["name"]: n for n in port["nodes"]}
    assert by_name["pcie"]["mesh"] == [4]
    assert all(c["coords"] == [] for c in by_name["pcie"]["chips"])
    assert by_name["bare"]["mesh"] is None
    assert by_name["bare"]["generation"] is None
    assert sorted(p["name"] for p in port["pods"]) == \
        ["b1", "g1", "m1", "p1", "r2"]


def test_fleetz_equals_the_jax_endpoint_and_replays():
    """Over HTTP, each package's ``/fleetz``; and each simulator rebuilt
    from it holds the same usage, the nodes without a fabric or a
    topology included."""
    exports = {p: _served(_export_side(p), TServer if p else JServer)
               for p in (True, False)}
    assert exports[True] == exports[False]
    empty = {"pods": []}
    got = tsim.run_simulation(empty, fleet_export=exports[True])
    ref = jsim.run_simulation(empty, fleet_export=exports[False])
    assert got == as_port(ref)
    assert sum(c["mem_mib"][0] for k, c in got["chips"].items()
               if k.startswith("ring/")) == 40000


def test_fleetz_answers_500_when_the_export_fails(monkeypatch):
    side = _export_side(True)

    def broken():
        raise RuntimeError("registry gone")

    monkeypatch.setattr(side.s, "export_fleet", broken)
    srv = TServer(side.s, side.s.cfg, host="127.0.0.1", port=0)
    srv.start()
    try:
        code, body = _fetch(f"http://127.0.0.1:{srv.port}")
    finally:
        srv.stop()
    assert (code, body) == (500, {"error": "RuntimeError: registry gone"})


def test_an_unreachable_cluster_exits_2(tmp_path, capsys):
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    wl = tmp_path / "wl.json"
    wl.write_text(json.dumps({"pods": []}))
    assert tsim.main(["--workload", str(wl), "--from-cluster",
                      f"127.0.0.1:{port}"]) == 2
    assert "vgpu-simulate:" in capsys.readouterr().err


# -- (f) the stated departures ------------------------------------------------

@pytest.mark.parametrize("section", A5_SECTIONS)
def test_a5_sections_are_refused_by_name(serial, monkeypatch, tmp_path,
                                         capsys, section):
    """The JAX simulator replays the section (its phase function, here a
    stand-in returning a passing verdict, answers under the section's
    key); the port refuses it by name and ``vgpu-simulate`` exits 2."""
    workload = json.loads((EXAMPLES / f"workload-{section}.json")
                          .read_text())
    if section == "queueing":
        # No longer refused: the port replays the JAX example (its keys
        # under the name map) as the JAX simulator does, and the command
        # exits 0 on its passing verdict.
        back = {v: k for k, v in KEYS.items()}
        workload["queueing"]["arrivals"] = [
            {back.get(k, k): v for k, v in a.items()}
            for a in workload["queueing"]["arrivals"]]
        port, ref = both(workload, nodes=2, chips=4, hbm=16384,
                         mesh=(4, 1))
        assert port == ref and port["queueing"]["verdict"]["ok"]
        assert port["queueing"]["fair"]["backfilled"] > 0
        wl = tmp_path / "wl.json"
        wl.write_text(json.dumps(workload))
        assert tsim.main(["--workload", str(wl), "--nodes", "2", "--chips",
                          "4", "--hbm", "16384", "--mesh", "4x1",
                          "--generation", "h100"]) == 0
        assert "verdict: PASS" in capsys.readouterr().out
        return
    seen = []

    def phase(spec, **kw):
        seen.append(spec)
        return {"verdict": {"ok": True}}

    monkeypatch.setattr(jsim, f"run_{section}_phase", phase)
    ref = jsim.run_simulation(copy.deepcopy(workload), nodes=2, chips=4,
                              hbm=16384, mesh=(2, 2))
    assert seen == [workload[section]] and ref[section] == \
        {"verdict": {"ok": True}} and ref["fits"]
    with pytest.raises(tsim.SectionRefused, match=f"'{section}'.*A.5"):
        tsim.run_simulation(copy.deepcopy(workload), nodes=2, chips=4,
                            hbm=16384, mesh=(2, 2))
    wl = tmp_path / "wl.json"
    wl.write_text(json.dumps(workload))
    rc = tsim.main(["--workload", str(wl)])
    err = capsys.readouterr().err
    assert rc == 2
    assert f"'{section}' section" in err and "ROADMAP A.5" in err, err


@pytest.mark.parametrize("workload,runs", [
    ({"ha": {}, "pods": [{"name": "a", "gpu": 1}]}, False),
    ({"queueing": None, "pods": [{"name": "a", "gpu": 1}]}, False),
    ({"capacity": {}, "pods": []}, True),
], ids=["empty_ha", "null_queueing", "empty_capacity"])
def test_a_section_is_refused_where_the_jax_simulator_runs_it(
        serial, monkeypatch, workload, runs):
    """Refused exactly where the JAX simulator would replay the section:
    an empty ``ha`` or ``queueing`` is none there (the plain placement
    runs), an empty ``capacity`` is one."""
    section = next(k for k in workload if k != "pods")
    monkeypatch.setattr(jsim, f"run_{section}_phase",
                        lambda spec, **kw: {"verdict": {"ok": True}})
    ref = jsim.run_simulation(jax_workload(workload), nodes=1, chips=2,
                              hbm=16384, mesh=(2, 1))
    assert (section in ref) is runs
    if runs:
        with pytest.raises(tsim.SectionRefused):
            tsim.run_simulation(workload, nodes=1, chips=2, hbm=16384,
                                mesh=(2, 1))
    else:
        port = tsim.run_simulation(workload, nodes=1, chips=2, hbm=16384,
                                   mesh=(2, 1))
        assert port == as_port(ref)


def test_the_ring_gang_pends_with_the_ports_refusal(serial):
    """examples/workload-sim.json under binpack: both gang managers place
    the two ring members atomically on whole nodes, and every other pod
    as the JAX simulator places it (no ring member pends any more)."""
    wl = json.loads((EXAMPLES / "workload-sim.json").read_text())
    port_wl = copy.deepcopy(wl)
    back = {v: k for k, v in KEYS.items()}
    port_wl["pods"] = [{back.get(k, k): v for k, v in p.items()}
                       for p in wl["pods"]]
    port, ref = both(port_wl, nodes=4, chips=8, hbm=16384, mesh=(4, 2),
                     policy="binpack")
    assert port == ref
    assert port["fits"] and port["pending"] == []
    ring = [p for p in port["placed"] if p["pod"].startswith("ring-")]
    assert len({p["node"] for p in ring}) == 2
    assert all(len(p["chips"]) == 8 for p in ring)


# -- (g) gangs and the queueing section ---------------------------------------

GANG_WORKLOAD = {"pods": WORKLOAD["pods"] + [
    {"name": "ring", "count": 2, "gpu": 8, "gpumem": 16384,
     "gang": "ring"}]}


def test_policy_decides_gang_fit(serial):
    """tests/test_simulate.py's case on both simulators: under spread the
    fractional pods fragment the fleet and the full-node gang cannot be
    placed atomically; under binpack everything fits, the members on two
    whole nodes."""
    spread, ref = both(GANG_WORKLOAD, nodes=4, chips=8, hbm=16384,
                       mesh=(4, 2), policy="spread")
    assert spread == ref
    assert not spread["fits"]
    assert {p["pod"] for p in spread["pending"]} == {"ring-0", "ring-1"}
    assert all("atomic placement" in p["reason"]
               for p in spread["pending"])
    packed, ref = both(GANG_WORKLOAD, nodes=4, chips=8, hbm=16384,
                       mesh=(4, 2), policy="binpack")
    assert packed == ref
    assert packed["fits"]
    ring = [p for p in packed["placed"] if p["pod"].startswith("ring-")]
    assert len({p["node"] for p in ring}) == 2
    assert all(len(p["chips"]) == 8 for p in ring)


QUEUEING = {"queueing": {
    "queues": [
        {"name": "tenant-a", "namespaces": ["tenant-a"], "cohort": "main",
         "weight": 3, "quota": {"chips": 6}, "borrow_limit_chips": 2},
        {"name": "tenant-b", "namespaces": ["tenant-b"], "cohort": "main",
         "weight": 1, "quota": {"chips": 2}, "borrow_limit_chips": 6},
    ],
    "arrivals": [
        {"name": "a", "namespace": "tenant-a", "gpu": 2, "gpumem": 16384,
         "count": 4, "at_s": 0, "runtime_s": 999},
        {"name": "b", "namespace": "tenant-b", "gpu": 2, "gpumem": 16384,
         "count": 1, "at_s": 60, "runtime_s": 999},
    ],
    "horizon_s": 240, "tick_s": 5, "measure_from_s": 100,
    "checkpoint_delay_s": 10, "weight_tolerance_pct": 10,
}}


def test_queueing_ab_fairness_and_invariants(serial):
    """tests/test_simulate.py's contended two-tenant replay on both
    simulators: the same shares, reclaims and verdict; admitted
    GPU-seconds converge to the weights, utilization holds FIFO's,
    reclaim touches only borrowed grants, nothing is booked twice."""
    port, ref = both(QUEUEING, nodes=2, chips=4, hbm=16384, mesh=(4, 1))
    assert port == ref
    r = port["queueing"]
    v = r["verdict"]
    assert v["converged"], r["shares"]
    assert v["utilization_ok"] and v["reclaim_only_borrowed"]
    assert v["no_overbooking"] and v["ok"]
    assert r["fair"]["reclaims"]
    for plan in r["fair"]["reclaims"]:
        for victim in plan["victims"]:
            assert victim["donor_borrowed"] >= victim["chips"]
    assert tsim.format_report(port).splitlines()[-1] == "  verdict: PASS"


def test_queueing_replay_is_deterministic(serial):
    a = tsim.run_simulation(copy.deepcopy(QUEUEING), nodes=2, chips=4,
                            hbm=16384, mesh=(4, 1))
    b = tsim.run_simulation(copy.deepcopy(QUEUEING), nodes=2, chips=4,
                            hbm=16384, mesh=(4, 1))
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def test_queueing_report_lines_equal_the_jax_simulators(serial):
    port, ref = both(QUEUEING, nodes=2, chips=4, hbm=16384, mesh=(4, 1))
    jref = jsim.run_simulation(jax_workload(QUEUEING), nodes=2, chips=4,
                               hbm=16384, mesh=(4, 1), generation="h100")
    assert tsim.format_report(port) == jsim.format_report(jref)
