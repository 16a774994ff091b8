"""The port's fleet health (``health/``: leases, card quarantine, the
rescuer, the fault injector) against the JAX package's, on the CPU.

Three levels, each compared by equality:

- the lease tracker and the quarantine alone, on one clock: every read
  and every transition a script of writes produces;
- both schedulers on the same fleet (tests/test_torch_scheduler.py's
  ``Side``: the JAX side's serial path, the port's resource names, each
  node's ``TopologyDesc`` as registered; the slice-neighbour case also on
  a grid and a ring), through tests/test_health.py's and tests/test_chaos.py's
  scenarios: each ``Rescuer.sweep()``'s actions, field by field, the
  rescue queue, the registry, the pods' annotations, the quarantine and
  the leases;
- seeded ``FaultInjector`` scripts, each side's own injector with the same
  seed on its own scheduler: the plan, the log of faults, every sweep's
  actions and the state they leave.

The JAX cases on the optimistic snapshot's revisions (a quarantine flip
moves the node's inventory rev; a keepalive does not) and its
concurrency case (Filters racing a node's death and the rescuer) run on
both packages' default, optimistic path, the first two compared by
their answers, the third each with its own invariant.

Left out, and why: the device
cache's (held in tests/test_torch_deviceplugin.py), the metrics
collector's (the port's metrics slice, ROADMAP A.5), the simulator's
chaos runs (held against the JAX simulator in
tests/test_torch_simulate.py, on the port's ``cmd/simulate.py``) and the
checkpointed trajectories (tests/test_torch_checkpoint.py holds the
port's).
"""

import dataclasses
import json
import types

import pytest

from k8s_vgpu_scheduler_tpu import health as jhealth
from k8s_vgpu_scheduler_tpu_torch import health as thealth
from tests.test_torch_preempt import PreemptSide
from tests.test_torch_scheduler import (Clock, as_port, fabric, fixture,
                                        limits, pod)


# -- the lease tracker alone ---------------------------------------------------
def lease_run(mod, script, **cfg):
    clock = Clock()
    lt = mod.LeaseTracker(mod.LeaseConfig(**cfg), clock=clock)
    out = []
    for op, *args in script:
        if op == "advance":
            clock.advance(*args)
            continue
        got = getattr(lt, op)(*args)
        if op == "sweep":
            got = [(n, a.name, b.name) for n, a, b in got]
        elif op == "states":
            got = {n: s.name for n, s in got.items()}
        elif op == "state_of":
            got = got and got.name
        out.append([op, got])
    return out


LEASE_SCRIPTS = {
    "edges_once": ({"ttl_s": 10.0, "grace_beats": 1}, [
        ("beat", "n"), ("sweep",), ("advance", 11.0), ("sweep",),
        ("sweep",), ("advance", 15.0), ("sweep",), ("beat", "n"),
        ("sweep",), ("states",)]),
    "ages_errors_and_forget": ({}, [
        ("beat", "a", {"c0": 2}), ("advance", 3.0),
        ("beat", "a", {"c0": 3, "c1": 1}), ("beat", "b"), ("advance", 20.0),
        ("age_of", "a"), ("errors_of", "a"), ("errors_of", "ghost"),
        ("alive_map", ["a", "b", "ghost"]), ("state_of", "a"),
        ("reject_reason", "a"), ("sweep",), ("forget", "a"),
        ("state_of", "a"), ("states",), ("sweep",), ("advance", 40.0),
        ("sweep",), ("alive_map", ["a", "b"])]),
    "dead_then_back": ({"ttl_s": 15.0, "grace_beats": 2}, [
        ("beat", "n"), ("beat", "m"), ("advance", 46.0), ("sweep",),
        ("beat", "m"), ("sweep",), ("states",), ("advance", 14.0),
        ("reject_reason", "n"), ("reject_reason", "m")]),
}


@pytest.mark.parametrize("name", sorted(LEASE_SCRIPTS))
def test_lease_tracker_equals_the_jax_one(name):
    cfg, script = LEASE_SCRIPTS[name]
    assert lease_run(thealth, script, **cfg) == \
        lease_run(jhealth, script, **cfg)


# -- the quarantine alone ------------------------------------------------------
def quarantine_run(mod, script, **cfg):
    clock, changed = Clock(), []
    q = mod.ChipQuarantine(mod.QuarantineConfig(**cfg), clock=clock,
                           on_change=changed.append)
    out = []
    for op, *args in script:
        if op == "advance":
            clock.advance(*args)
            continue
        got = getattr(q, op)(*args)
        if isinstance(got, (set, dict)):
            got = json.loads(json.dumps(got, default=sorted,
                                        sort_keys=True))
        out.append([op, got, list(changed), q.count(),
                    q.quarantines_total])
    return out


HEALTHY2 = {"c0": True, "c1": True}
QUARANTINE_SCRIPTS = {
    "flaps_then_probation": ({"flap_threshold": 3, "flap_window_s": 60.0,
                              "probation_s": 30.0}, [
        ("observe_node", "n", HEALTHY2), ("advance", 1.0),
        ("observe_node", "n", {"c0": False, "c1": True}), ("advance", 1.0),
        ("observe_node", "n", HEALTHY2), ("advance", 1.0),
        ("observe_node", "n", {"c0": False, "c1": True}),
        ("is_quarantined", "n", "c0"), ("quarantined_on", "n"),
        ("observe_node", "n", HEALTHY2), ("advance", 20.0), ("sweep",),
        ("observe_node", "n", HEALTHY2), ("advance", 11.0), ("sweep",),
        ("active",), ("quarantined_on", "n")]),
    "flips_outside_the_window_do_not_count": ({"flap_threshold": 3,
                                               "flap_window_s": 10.0}, [
        ("observe", "n", "c", True), ("advance", 6.0),
        ("observe", "n", "c", False), ("advance", 6.0),
        ("observe", "n", "c", True), ("advance", 6.0),
        ("observe", "n", "c", False), ("is_quarantined", "n", "c"),
        ("advance", 1.0), ("observe", "n", "c", True),
        ("is_quarantined", "n", "c")]),
    "unhealthy_in_probation_restarts_the_clock": ({"probation_s": 30.0}, [
        ("quarantine", "n", "c", "test"), ("quarantine", "n", "c", "again"),
        ("advance", 25.0), ("observe", "n", "c", False), ("advance", 10.0),
        ("sweep",), ("observe", "n", "c", True), ("advance", 31.0),
        ("sweep",), ("release", "n", "c")]),
    "an_unhealthy_card_is_never_released": ({"probation_s": 30.0}, [
        ("quarantine", "n", "c", "test"), ("observe", "n", "c", False),
        ("advance", 31.0), ("sweep",), ("advance", 100.0), ("sweep",),
        ("observe", "n", "c", True), ("sweep",), ("advance", 30.0),
        ("sweep",)]),
    "errors_quarantine_without_a_flip": ({"error_threshold": 5,
                                          "flap_window_s": 60.0}, [
        ("observe_errors", "n", "c", 2), ("advance", 10.0),
        ("observe_errors", "n", "c", 0), ("observe_errors", "n", "c", 2),
        ("advance", 61.0), ("observe_errors", "n", "c", 2),
        ("observe_errors", "n", "c", 3), ("quarantined_on", "n"),
        ("release", "n", "c"), ("release", "n", "c"), ("active",)]),
    "keepalives_and_renamed_cards": ({}, [
        ("observe_node", "n", HEALTHY2), ("observe_node", "n", HEALTHY2),
        ("observe_node", "n", {"c0": True, "c2": True}),
        ("observe_node", "n", {"c0": True, "c2": False}),
        ("observe_node", "n", {"c0": True, "c2": True}),
        ("observe_node", "n", {"c0": True, "c2": False}),
        ("quarantined_on", "n"), ("quarantined_on", "other")]),
}


@pytest.mark.parametrize("name", sorted(QUARANTINE_SCRIPTS))
def test_quarantine_equals_the_jax_one(name):
    cfg, script = QUARANTINE_SCRIPTS[name]
    assert quarantine_run(thealth, script, **cfg) == \
        quarantine_run(jhealth, script, **cfg)


# -- both schedulers, and their rescuers ---------------------------------------
class HealthSide(PreemptSide):
    """The parity Side with the fleet-health ops."""

    def anns(self, name):
        """The pod's annotations, the bind time (a clock's) as "<int>"."""
        out = super().anns(name)
        bound = out.get("vtpu.dev/bind-time")
        if bound is not None:
            assert bound.isdigit(), out
            out["vtpu.dev/bind-time"] = "<int>"
        return out

    def card(self, node, i):
        return self.fixtures[node]["chips"][i]["uuid"]

    def sweep(self):
        return self.s.rescuer.sweep()

    def pending(self):
        return sorted((i.uid, i.namespace, i.name, i.node, i.reason,
                       i.asked_at is not None)
                      for i in self.s.rescuer.pending().values())

    def rescued(self):
        return self.s.rescuer.rescued_total

    def leases(self):
        return {n: s.name for n, s in self.s.leases.states().items()}

    def qactive(self):
        return {n: sorted(c) for n, c in self.s.quarantine.active().items()}

    def quarantine(self, node, i, reason="test"):
        return self.s.quarantine.quarantine(node, self.card(node, i), reason)

    def registered(self):
        return {n: [d.id for d in info.devices]
                for n, info in sorted(self.s.nodes.list_nodes().items())}

    def tick(self, seconds, *quiet):
        """Time passes in 5 s steps, every node but ``quiet`` beating."""
        for _ in range(int(seconds // 5)):
            self.clock.advance(5.0)
            for node in self.fleet:
                if node not in quiet:
                    self.beat(node)

    def drop_card(self, node, i):
        """The node re-registers without card ``i``."""
        del self.fixtures[node]["chips"][i]
        self.beat(node)

    def rm_node(self, node):
        """The node's register stream closed."""
        self.s.nodes.rm_node(node)

    def resync(self):
        self.s.resync_from_apiserver()

    def restart_bare(self):
        """A restarted scheduler before any agent has connected."""
        self.kube.unwatch_pods(self.s.on_pod_event)
        cls = type(self.s)
        self.s = cls(self.kube, self.cfg, clock=self.clock)
        self.kube.watch_pods(self.s.on_pod_event)
        self.s.resync_from_apiserver()

    def inject(self, seed, events, settle_s=60.0):
        """A seeded fault plan over the fleet, played with a rescue sweep
        after every fault and beat."""
        mod = thealth if self.port else jhealth
        inj = mod.FaultInjector(self.s, self.clock, seed=seed)
        inj.attach()
        plan = inj.random_plan(events)
        actions = inj.run_plan(plan, sweep=self.s.rescuer.sweep,
                               settle_s=settle_s)
        return dict(plan=[dataclasses.asdict(e) for e in plan],
                    actions=actions, log=inj.log)

    def partition(self, node, heal_after):
        """tests/test_chaos.py's partition: the agent goes quiet for
        ``heal_after`` seconds of beating fleet, a sweep, then heals."""
        mod = thealth if self.port else jhealth
        inj = mod.FaultInjector(self.s, self.clock, seed=1)
        inj.attach()
        inj.partition_node(node)
        inj.tick(heal_after)
        out = [self.s.rescuer.sweep(), self.leases()]
        inj.heal_node(node)
        return out + [self.s.rescuer.sweep(), self.leases(), inj.log]

    def all_anns(self):
        from tests.test_torch_scheduler import decision
        return {p["metadata"]["name"]: decision(p)
                for p in self.kube.list_pods()}


def health_run(fleet, cfg, script, port):
    side = HealthSide(port, fleet, **cfg)
    out = []
    for op, *args in script:
        got = getattr(side, op)(*args)
        if got is not None:
            out.append([op, *args[:1], got])
    return json.loads(json.dumps(out))


def nodes(n, cards):
    return {f"node-{i}": fixture(f"node-{i}", ["h100"] * cards)
            for i in range(n)}


F = "filter"
P = pod("p1", limits(mem=4000))
QCFG = {"quarantine_flap_threshold": 3, "quarantine_flap_window_s": 60.0,
        "quarantine_probation_s": 30.0}
SCENARIOS = {
    "suspect_node_keeps_its_grant_and_takes_no_new_one": (nodes(2, 4), {}, [
        ("create", P), (F, "p1"), ("tick", 20.0, "node-0"), ("sweep",),
        ("pods",), ("create", pod("p2", limits(mem=4000))), (F, "p2"),
        ("create", pod("p3", limits(mem=99999))), (F, "p3", ["node-0"]),
        ("leases",)]),
    "dead_node_pods_are_rescued_and_replace_elsewhere": (nodes(2, 4), {}, [
        ("create", P), (F, "p1"), ("tick", 60.0, "node-0"), ("sweep",),
        ("pods",), ("rescued",), ("anns", "p1"), ("registered",),
        (F, "p1"), ("usage",), ("sweep",)]),
    "dead_lease_forgotten_after_retention": (nodes(2, 4),
                                             {"lease_retention_s": 300.0}, [
        ("create", P), (F, "p1"), ("advance", 60.0), ("sweep",),
        ("leases",), ("advance", 301.0), ("sweep",), ("leases",),
        ("pods",)]),
    "lease_recovery_restores_placements": (nodes(2, 4), {}, [
        ("advance", 60.0), ("sweep",), ("registered",), ("beat", "node-0"),
        ("leases",), ("create", P), (F, "p1", ["node-0"]), ("sweep",)]),
    "flapping_card_is_quarantined_until_probation": (nodes(1, 2), QCFG, [
        ("advance", 1.0), ("health", "node-0", 0, False), ("advance", 1.0),
        ("health", "node-0", 0, True), ("advance", 1.0),
        ("health", "node-0", 0, False), ("qactive",), ("usage",),
        ("health", "node-0", 0, True), ("tick", 20.0), ("sweep",),
        ("usage",), ("advance", 31.0), ("beat", "node-0"), ("sweep",),
        ("usage",), ("qactive",)]),
    "filter_never_places_on_a_quarantined_card": (nodes(1, 2), {}, [
        ("quarantine", "node-0", 0),
        ("create", pod("p0", limits(mem=40000))),
        ("create", pod("p1", limits(mem=40000))),
        ("create", pod("p2", limits(mem=9000))),
        (F, "p0"), (F, "p1"), (F, "p2"), ("usage",)]),
    "running_victim_gets_a_checkpoint_request_first": (
        nodes(2, 1), {"rescue_checkpoint_grace_s": 120.0}, [
            ("create", P), (F, "p1"), ("bind", "p1", "node-0"),
            ("quarantine", "node-0", 0), ("sweep",), ("anns", "p1"),
            ("pending",), ("pods",), ("delete", "p1"), ("sweep",),
            ("pods",), ("rescued",), ("pending",)]),
    "wedged_victim_is_rescinded_after_grace": (
        nodes(2, 1), {"rescue_checkpoint_grace_s": 60.0}, [
            ("create", P), (F, "p1"), ("bind", "p1", "node-0"),
            ("quarantine", "node-0", 0), ("sweep",), ("tick", 55.0),
            ("sweep",), ("tick", 10.0), ("sweep",), ("pods",),
            ("anns", "p1")]),
    "an_unbound_grant_on_a_quarantined_card_is_rescinded_at_once": (
        nodes(2, 1), {}, [
            ("create", P), (F, "p1"), ("quarantine", "node-0", 0),
            ("sweep",), ("anns", "p1"), (F, "p1")]),
    "resync_keeps_the_rescue_checkpoint_request": (nodes(2, 1), {
        "enable_preemption": True}, [
            ("create", P), (F, "p1"), ("bind", "p1", "node-0"),
            ("quarantine", "node-0", 0), ("sweep",), ("resync",),
            ("anns", "p1"), ("restart",), ("anns", "p1"), ("ledger",)]),
    "multi_card_grant_quarantines_its_other_cards": (nodes(1, 4), {}, [
        ("create", pod("g1", limits(nums=2, mem=2000))), (F, "g1"),
        ("quarantine", "node-0", 0), ("sweep",), ("qactive",), ("pods",),
        ("usage",)]),
    "slice_neighbours_on_a_grid_are_quarantined": (
        {"node-0": fabric("node-0", [2, 2])}, {}, [
            ("create", pod("g1", limits(nums=2, mem=2000),
                           anns={"vtpu.dev/topology-policy": "guaranteed"})),
            (F, "g1"), ("quarantine", "node-0", 1), ("sweep",),
            ("qactive",), ("pods",), ("usage",),
            ("create", pod("g2", limits(nums=2, mem=2000),
                           anns={"vtpu.dev/topology-policy": "guaranteed"})),
            (F, "g2")]),
    "slice_neighbours_on_a_ring_are_quarantined": (
        {"node-0": fabric("node-0", [8], wrap=[True]),
         "node-1": fabric("node-1", [8], wrap=[True])}, {}, [
            ("create", pod("g1", limits(nums=3, mem=2000, cores=100))),
            ("create", pod("g2", limits(nums=3, mem=2000, cores=100))),
            (F, "g1", ["node-0"]), (F, "g2", ["node-0"]),
            ("quarantine", "node-0", 4), ("sweep",), ("qactive",),
            ("pods",), (F, "g2"), ("usage",)]),
    "resync_routes_dead_node_grants_to_the_rescuer": (nodes(2, 4), {}, [
        ("create", P), (F, "p1"), ("rm_node", "node-0"),
        ("tick", 60.0, "node-0"), ("resync",), ("pods",), ("pending",),
        ("sweep",), ("anns", "p1"), ("rescued",)]),
    "boot_resync_without_leases_keeps_grants": (nodes(2, 4), {}, [
        ("create", P), (F, "p1"), ("restart_bare",), ("pods",),
        ("sweep",), ("pods",)]),
    "card_absent_from_reregistration_is_rescued": (nodes(1, 2), {}, [
        ("create", P), (F, "p1"), ("drop_card", "node-0", 0), ("usage",),
        ("sweep",), ("pods",), ("rescued",), ("anns", "p1")]),
    "partition_healed_before_death_changes_nothing": (nodes(2, 2), {}, [
        ("create", P), (F, "p1"), ("partition", "node-0", 20.0),
        ("pods",), ("rescued",)]),
    "dead_then_healed_node_reregisters_and_serves": (nodes(2, 2), {}, [
        ("partition", "node-1", 60.0), ("registered",), ("create", P),
        (F, "p1", ["node-1"]), ("sweep",)]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_the_port_rescues_as_the_jax_scheduler(name):
    fleet, cfg, script = SCENARIOS[name]
    want = as_port(health_run(fleet, cfg, script, port=False))
    got = health_run(fleet, cfg, script, port=True)
    assert got == want


def test_the_scenarios_reach_every_sweep_action():
    kinds, vias = set(), set()
    for fleet, cfg, script in SCENARIOS.values():
        for op, *_, rec in health_run(fleet, cfg, script, port=True):
            if op == "sweep":
                for action in rec:
                    kinds.add(action["kind"])
                    vias.add(action.get("via"))
    assert kinds >= {"lease", "lease-forgotten", "quarantine",
                     "quarantine-release", "checkpoint-requested",
                     "rescued"}, kinds
    assert vias >= {"rescind", "pod-gone"}, vias


# -- seeded fault scripts ------------------------------------------------------
FAULT_FLEET = nodes(3, 2)


def placed_fleet():
    """Five pods on three nodes of two cards, bound."""
    out = []
    for i in range(5):
        out += [("create", pod(f"w{i}", limits(mem=30000, cores=20))),
                (F, f"w{i}")]
    return out


@pytest.mark.parametrize("seed", [1, 7, 11, 23, 42])
def test_seeded_fault_scripts_replay_as_in_jax(seed):
    script = [*placed_fleet(), ("inject", seed, 8), ("pods",),
              ("pending",), ("leases",), ("qactive",), ("registered",),
              ("all_anns",), ("usage",), ("rescued",)]
    want = as_port(health_run(FAULT_FLEET, QCFG, script, port=False))
    got = health_run(FAULT_FLEET, QCFG, script, port=True)
    assert got == want
    [inject] = [rec[2] for rec in got if rec[0] == "inject"]
    assert len(inject["plan"]) == 8 and inject["log"]


def test_the_seeded_plans_differ_by_seed_and_repeat_by_seed():
    plans = {}
    for seed in (7, 7, 8):
        script = [("inject", seed, 10, 0.0)]
        [rec] = health_run(FAULT_FLEET, {}, script, port=True)
        plans.setdefault(seed, []).append(rec[2]["plan"])
    assert plans[7][0] == plans[7][1] != plans[8][0]


def test_a_rescued_member_leaves_its_gang():
    """A gang member whose card vanished from its node's re-registration
    is rescued (its decision rescinded) and leaves its group without a
    tombstone, on both packages: the sweep's actions, the group registry
    (its placement and rank freed, the peer's kept) and the grants are
    equal; the member's next Filter joins the group again and is placed
    alone, with the freed rank."""
    from k8s_vgpu_scheduler_tpu_torch.util import types as t
    from tests.test_torch_gang import (NODES, TDevice, TNode, TTopo,
                                       JDevice, JNode, JTopo, gang_pod,
                                       run_both)

    def script(side):
        pods = [gang_pod(f"w{i}", f"gu{i}", group="ring", total=2)
                for i in range(2)]
        for p in pods:
            side.kube.create_pod(p)
        for p in pods + pods:
            side.filter(p)
        node = side.s.pods.get("gu0").node
        Dev, Node, Topo = ((TDevice, TNode, TTopo) if side.port
                           else (JDevice, JNode, JTopo))
        devs = [Dev(id=f"{node}-gpu-{i}", count=10, devmem=16384,
                    type="NVIDIA-h100", health=True, coords=(i, 0))
                for i in range(1, 4)]
        side.s.nodes.add_node(node, Node(name=node, devices=devs,
                                         topology=Topo(generation="h100",
                                                       mesh=(4, 1))))
        rec = {"node": node, "placed": side.state("w0", "w1"),
               "sweep": side.s.rescuer.sweep()}
        rec["after"] = side.state()
        rec["retry"] = side.filter(side.kube.get_pod("default", "w0"),
                                   [n for n in NODES if n != node])
        return {**rec, **side.state("w0", "w1")}

    rec, _ = run_both(script)
    rescued = [a for a in rec["sweep"] if a["kind"] == "rescued"]
    assert [a["uid"] for a in rescued] == ["gu0"]
    [gang] = rec["after"]["gangs"].values()
    assert gang["members"] == ["gu1"] and list(gang["ranks"]) == ["gu1"]
    assert "gu0" not in rec["after"]["grants"]
    assert rec["retry"]["node"] not in (None, rec["node"])
    ranks = {a[t.GANG_RANK_ANNOTATION] for a in rec["anns"].values()}
    assert ranks == {"0", "1"}


# -- the optimistic snapshot's revisions (tests/test_health.py) -----------------
def optimistic_env(side, n_nodes=2, chips=4):
    """tests/test_health.py's ``make_env``: the fleet registered through
    the register stream (so the leases track it) on a SimClock, the watch
    wired, the default (optimistic) Filter."""
    from tests.test_torch_concurrency import PKGS

    pkg = PKGS[side]
    clock = (thealth if side == "port" else jhealth).faults.SimClock()
    kube = pkg.FakeKube()
    s = pkg.Scheduler(kube, pkg.Config(), clock=clock)
    names = [f"node-{i}" for i in range(n_nodes)]

    def info(n):
        return pkg.NodeInfo(name=n, devices=[
            pkg.DeviceInfo(id=f"{n}-chip-{i}", count=10, devmem=16384,
                           type=pkg.ctype, health=True, coords=(i, 0))
            for i in range(chips)],
            topology=pkg.TopologyDesc(generation=pkg.gen, mesh=(chips, 1)))

    for n in names:
        kube.add_node({"metadata": {"name": n, "annotations": {}}})
        s.observe_registration(n, info(n))
    kube.watch_pods(s.on_pod_event)
    return types.SimpleNamespace(pkg=pkg, kube=kube, s=s, names=names,
                                 clock=clock, info=info)


def quarantine_flip(side):
    env = optimistic_env(side, n_nodes=1, chips=1)
    try:
        node = env.names[0]
        key_before = env.s.snapshot()[node].key
        env.s.quarantine.quarantine(node, f"{node}-chip-0", "test")
        p = env.pkg.pod("p", "u", mem="1000")
        env.kube.create_pod(p)
        r = env.s.filter(p, env.names)
        return dict(rev_step=env.s.nodes.rev_of(node) - key_before[1],
                    key_moved=env.s.snapshot()[node].key != key_before,
                    node=r.node, error=r.error.replace("TPU", "GPU"))
    finally:
        env.s.close()


def test_quarantine_flip_invalidates_optimistic_snapshot():
    """A quarantine after a snapshot bumps the node's inventory rev
    (``NodeManager.touch``): the stale snapshot's key no longer matches,
    and a Filter finds no card at all."""
    got = {side: quarantine_flip(side) for side in ("port", "jax")}
    assert got["port"] == got["jax"] == dict(
        rev_step=1, key_moved=True, node=None,
        error="no node fits GPU request")


def keepalives(side):
    env = optimistic_env(side, n_nodes=1)
    try:
        node = env.names[0]
        env.s.snapshot()
        rev = env.s.nodes.rev_of(node)
        for _ in range(5):
            env.clock.advance(5.0)
            env.s.observe_registration(node, env.info(node))
        return dict(rev_moved=env.s.nodes.rev_of(node) - rev,
                    lease=env.s.leases.state_of(node).name)
    finally:
        env.s.close()


def test_unchanged_reregistration_does_not_bump_rev():
    """Keepalives (the same inventory) leave the snapshot valid."""
    got = {side: keepalives(side) for side in ("port", "jax")}
    assert got["port"] == got["jax"] == dict(rev_moved=0, lease="HEALTHY")


@pytest.mark.parametrize("side", ["port", "jax"])
def test_concurrent_filters_during_node_death_never_overbook(side):
    """Four submitters race a node whose agent goes silent while the
    rescuer sweeps: no card passes its totals at any step, the silent node
    ends dead, and every surviving grant is on a live node."""
    import threading
    import time

    from tests.test_torch_concurrency import overbooked

    env = optimistic_env(side, n_nodes=4, chips=4)
    s, names = env.s, env.names
    errors = []
    barrier = threading.Barrier(5)
    deadline = time.monotonic() + 60.0

    def submitter(t):
        barrier.wait()
        for i in range(20):
            p = env.pkg.pod(f"t{t}p{i}", f"t{t}u{i}",
                            mem=("4000", "8000", "2000")[i % 3])
            try:
                env.kube.create_pod(p)
                s.filter(p, names)
                assert not overbooked(s)
            except Exception as e:  # noqa: BLE001 — raised on the main thread
                errors.append(e)
                return

    def chaos():
        barrier.wait()
        try:
            for _ in range(15):
                env.clock.advance(5.0)
                for n in names[1:]:
                    s.observe_registration(n, env.info(n))
                s.rescuer.sweep()
                assert not overbooked(s)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=submitter, args=(t,))
               for t in range(4)] + [threading.Thread(target=chaos)]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=max(0.0, deadline - time.monotonic()))
            assert not th.is_alive()
        assert not errors, errors[0]
        assert s.leases.state_of(names[0]).name == "DEAD"
        assert all(info.node != names[0] for info in s.pods.list_pods())
        assert not overbooked(s)
    finally:
        s.close()


# -- active replicas: the rescuer's ownership gate --------------------------------

def handoff_rescue(pkg):
    """A node's lease dies while both replicas track it: the owner rescues
    the pod once, the other hands the lease off; then the owner dies, the
    survivor adopts the node and rescues nothing again.  What each sweep
    did, the rescue count and the pod's decision at the end."""
    from tests.test_torch_shard import kill_and_settle, make_fleet

    kube, reps, names, clock = make_fleet(pkg, n_rep=2, n_nodes=4)
    a, b = reps
    try:
        node = next(n for n in names if a.shards.reject_reason(n) is None)
        pod = pkg.pod("victim", "victim-u", mem="2000")
        kube.create_pod(pod)
        assert a.filter(pod, [node]).node == node
        a.leases.beat(node)
        b.leases.beat(node)
        clock.advance(a.leases.cfg.dead_after_s + 1.0)
        sweeps = []
        for s in (a, b, a, b):
            sweeps.append((s.shards.replica, sorted(
                x["kind"] for x in s.rescuer.sweep()
                if x.get("node") == node or x.get("uid") == "victim-u")))
        kill_and_settle(reps, clock, a)
        assert b.shards.owns(node) and b.shards.placeable(node)
        sweeps.append((b.shards.replica, sorted(
            x["kind"] for x in b.rescuer.sweep()
            if x.get("node") == node or x.get("uid") == "victim-u")))
        anns = kube.get_pod("default", "victim")["metadata"]["annotations"]
        return dict(sweeps=sweeps,
                    rescued=sum(k.count("rescued") for _, k in sweeps),
                    assigned=anns.get("vtpu.dev/assigned-node", ""),
                    tracked=[s.pods.get("victim-u") is not None
                             for s in (a, b)])
    finally:
        for s in reps:
            s.close()


def test_a_shard_handoff_never_rescues_twice():
    """The rescuer's ownership gate under active replicas (``shard/``),
    on both packages: one rescue in all, by the owner, none by the
    non-owner before or after it adopts the node."""
    from tests.test_torch_shard import PKGS, SIDES

    got = {side: handoff_rescue(PKGS[side]) for side in SIDES}
    assert got["port"] == got["jax"], got
    assert got["port"]["rescued"] == 1
    assert got["port"]["sweeps"][1][1] == ["lease-handoff"]
    assert got["port"]["assigned"] == "" and got["port"]["tracked"] == [
        False, False]
