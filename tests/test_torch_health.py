"""The port's fleet health (``health/``: leases, card quarantine, the
rescuer, the fault injector) against the JAX package's, on the CPU.

Three levels, each compared by equality:

- the lease tracker and the quarantine alone, on one clock: every read
  and every transition a script of writes produces;
- both schedulers on the same fleet (tests/test_torch_scheduler.py's
  ``Side``: the JAX side's serial path, the port's resource names, no
  ``TopologyDesc``), through tests/test_health.py's and tests/test_chaos.py's
  scenarios: each ``Rescuer.sweep()``'s actions, field by field, the
  rescue queue, the registry, the pods' annotations, the quarantine and
  the leases;
- seeded ``FaultInjector`` scripts, each side's own injector with the same
  seed on its own scheduler: the plan, the log of faults, every sweep's
  actions and the state they leave.

Left out, and why: the JAX cases on the optimistic snapshot's revisions
(the port decides serially on usage it builds afresh), the concurrency
case of tests/test_health.py (the JAX optimistic path's), the device
cache's (held in tests/test_torch_deviceplugin.py), the metrics
collector's (the port's metrics slice, ROADMAP A.5), the simulator's
chaos runs (``vtpu-simulate`` has no port yet, A.4) and the checkpointed
trajectories (tests/test_torch_checkpoint.py holds the port's).
"""

import dataclasses
import json

import pytest

from k8s_vgpu_scheduler_tpu import health as jhealth
from k8s_vgpu_scheduler_tpu_torch import health as thealth
from tests.test_torch_preempt import PreemptSide
from tests.test_torch_scheduler import Clock, as_port, fixture, limits, pod


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
