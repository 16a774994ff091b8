"""The port's active-active replicas (``shard/``: the shard map, the fenced
CAS commit, replica-kill rebalancing) against the JAX package's, on the
CPU.

Every case of ``tests/test_shard.py`` runs here on both packages
(``SIDES``), with the same seeded fleet (``node-<i>``, four 16384 MiB
cards each), the same replica names (``r<i>``) and the same ``SimClock``
tick sequence, and the two must agree exactly on what each case reads:
each node's owner, the epochs, the decision annotations (the card type
read under the name map), the CAS tokens and counters, the adopted sets
and the replayed grants, the leaders of each role, the five shard
families' samples inert and active, and the apiserver operations of a
steady tick.  Each case also holds the JAX case's own assertions on both
sides.

Parity needs the serial decision on both sides (``optimistic_commit=
False``: the optimistic path picks among near-equal nodes by a digest that
is Python's salted ``hash()`` in the JAX package) and the JAX snapshot in
registry order (it is rebuilt by iterating a set of names; ROADMAP
Traps).  The ownership digest is blake2b in both packages, so the
partition is the same in every process.  ``tests/test_torch_
concurrency.py`` runs its stress and churn again with the fence on.
"""

import functools
import json

import pytest

from tests.test_torch_concurrency import package as base_package

SIDES = ("port", "jax")
TTL = 10.0          # the replica lease's ttl (grace_beats 1: dead after 2 TTL)
STALE = 5.0
GRACE = 6.0


def package(name: str):
    """The concurrency suite's package (scheduler, fake apiserver, pods,
    node registration) with the shard layer's names of one side."""
    ns = base_package(name)
    if name == "port":
        from k8s_vgpu_scheduler_tpu_torch.cmd import simulate
        from k8s_vgpu_scheduler_tpu_torch.health.faults import SimClock
        from k8s_vgpu_scheduler_tpu_torch.health.lease import LeaseState
        from k8s_vgpu_scheduler_tpu_torch.k8s.client import Conflict
        from k8s_vgpu_scheduler_tpu_torch.scheduler.metrics import \
            ClusterCollector
        from k8s_vgpu_scheduler_tpu_torch.shard import commit, shardmap
        from k8s_vgpu_scheduler_tpu_torch.util.types import \
            ASSIGNED_NODE_ANNOTATION
        scheduler = ns.Scheduler
    else:
        from k8s_vgpu_scheduler_tpu.cmd import simulate
        from k8s_vgpu_scheduler_tpu.health.faults import SimClock
        from k8s_vgpu_scheduler_tpu.health.lease import LeaseState
        from k8s_vgpu_scheduler_tpu.k8s.client import Conflict
        from k8s_vgpu_scheduler_tpu.scheduler.metrics import \
            ClusterCollector
        from k8s_vgpu_scheduler_tpu.shard import commit, shardmap
        from k8s_vgpu_scheduler_tpu.util.types import \
            ASSIGNED_NODE_ANNOTATION
        scheduler = ordered(ns.Scheduler)
    ns.__dict__.update(
        SimClock=SimClock, LeaseState=LeaseState, Conflict=Conflict,
        ClusterCollector=ClusterCollector, simulate=simulate,
        ShardMap=shardmap.ShardMap, ShardConfig=shardmap.ShardConfig,
        SHARD_MAP_ANNOTATION=shardmap.SHARD_MAP_ANNOTATION,
        COORD_OBJECT=shardmap.COORD_OBJECT,
        REPLICA_BEAT_PREFIX=shardmap.REPLICA_BEAT_PREFIX,
        SHARD_EPOCH_ANNOTATION=commit.SHARD_EPOCH_ANNOTATION,
        SHARD_OWNER_ANNOTATION=commit.SHARD_OWNER_ANNOTATION,
        ASSIGNED_NODE_ANNOTATION=ASSIGNED_NODE_ANNOTATION,
        Sched=scheduler)
    return ns


def ordered(cls):
    """The JAX scheduler with both its snapshot reads in registry order."""

    class Ordered(cls):
        def _ordered(self, snap):
            return {n: snap[n] for n in self.nodes.list_nodes() if n in snap}

        def snapshot(self):
            return self._ordered(super().snapshot())

        def snapshot_for_batch(self):
            snap, changed = super().snapshot_for_batch()
            return self._ordered(snap), changed

    return Ordered


PKGS = {name: package(name) for name in SIDES}


def both(case, *args):
    """``case`` on each package: {side: what it read}."""
    return {side: case(PKGS[side], *args) for side in SIDES}


def agree(case, *args):
    got = both(case, *args)
    assert got["port"] == got["jax"], got
    return got["port"]


def shard_cfg(pkg, i, **kw):
    kw.setdefault("shard_replica", f"r{i}")
    kw.setdefault("shard_ttl_s", TTL)
    kw.setdefault("shard_grace_beats", 1)
    kw.setdefault("shard_stale_ttl_s", STALE)
    kw.setdefault("shard_adoption_grace_s", GRACE)
    kw.setdefault("optimistic_commit", False)
    return pkg.Config(**kw)


def make_fleet(pkg, n_rep=2, n_nodes=4, chips=4, watch=True, kube=None,
               **cfg_kw):
    """N replica schedulers over one fake apiserver, converged on a shard
    map: (kube, replicas, node names, clock)."""
    kube = kube or pkg.FakeKube()
    clock = pkg.SimClock()
    reps = [pkg.Sched(kube, shard_cfg(pkg, i, **cfg_kw), clock=clock)
            for i in range(n_rep)]
    names = [f"node-{i}" for i in range(n_nodes)]
    for n in names:
        kube.add_node({"metadata": {"name": n, "annotations": {}}})
        for s in reps:
            pkg.register_node(s, n, chips=chips)
    if watch:
        for s in reps:
            kube.watch_pods(s.on_pod_event)
    converge(reps, clock, names)
    return kube, reps, names, clock


def converge(reps, clock, names, rounds=20):
    """Tick every replica until the epoch is shared and every node is
    placeable by its owner (the boot adoptions served their grace)."""
    for _ in range(rounds):
        for s in reps:
            s.shards.tick()
        if all(s.shards.active for s in reps) and len(
                {s.shards.epoch() for s in reps}) == 1:
            m = reps[0].shards.map
            if set(m.replicas) == {s.shards.replica for s in reps} and all(
                    owner_of(reps, n).shards.reject_reason(n) is None
                    for n in names):
                return
        clock.advance(1.0)
    raise AssertionError(
        f"shard map never converged: "
        f"{[(s.shards.replica, s.shards.epoch()) for s in reps]}")


def owner_of(reps, node):
    m = next(s for s in reps if s.shards.active).shards.map
    owner = m.owner_of(node)
    return next(s for s in reps if s.shards.replica == owner)


def close_all(reps):
    for s in reps:
        s.close()


def owners(reps, names) -> dict:
    return {n: owner_of(reps, n).shards.replica for n in names}


def decision(pkg, kube, name) -> dict:
    """A pod's decision annotations, the card type under the name map."""
    anns = kube.get_pod("default", name)["metadata"]["annotations"]
    keep = (pkg.ASSIGNED_NODE_ANNOTATION, pkg.SHARD_OWNER_ANNOTATION,
            pkg.SHARD_EPOCH_ANNOTATION, "vtpu.dev/assigned-ids")
    return {k: anns[k].replace(pkg.ctype, "CARD") for k in keep
            if k in anns}


def gpu(text):
    """A Filter message under the name map (the JAX package says TPU)."""
    return text and text.replace("TPU request", "GPU request").replace(
        "no TPU inventory", "no GPU inventory")


def kill_and_settle(reps, clock, victim):
    """Tick the survivors until the victim has left their map and no
    adoption is pending."""
    alive = [s for s in reps if s is not victim]
    for _ in range(60):
        for s in alive:
            s.shards.tick()
        if all(victim.shards.replica not in
               (s2.shards.map.replicas if s2.shards.map else ())
               for s2 in alive) and all(
                not s.shards.rebalancer.pending_nodes() for s in alive):
            break
        clock.advance(2.0)
    return alive


# -- FakeKube's pod CAS -----------------------------------------------------------

def cas_stale(pkg):
    kube = pkg.FakeKube()
    pod = kube.create_pod(pkg.pod("p", "u"))
    rv = pod["metadata"]["resourceVersion"]
    kube.patch_pod_annotations("default", "p", {"x": "peer"})
    with pytest.raises(pkg.Conflict):
        kube.patch_pod_annotations("default", "p", {"x": "loser"},
                                   resource_version=rv)
    return kube.get_pod("default", "p")["metadata"]["annotations"]["x"]


def test_stale_resource_version_is_conflict_not_last_writer_wins():
    assert agree(cas_stale) == "peer"


def cas_match(pkg):
    kube = pkg.FakeKube()
    kube.create_pod(pkg.pod("p", "u"))
    rv = kube.get_pod("default", "p")["metadata"]["resourceVersion"]
    out = kube.patch_pod_annotations("default", "p", {"x": "winner"},
                                     resource_version=rv)
    return out["metadata"]["annotations"]["x"], \
        out["metadata"]["resourceVersion"] != rv


def test_matching_resource_version_applies():
    assert agree(cas_match) == ("winner", True)


def cas_plain(pkg):
    kube = pkg.FakeKube()
    kube.create_pod(pkg.pod("p", "u"))
    kube.patch_pod_annotations("default", "p", {"x": "a"})
    kube.patch_pod_annotations("default", "p", {"x": "b"})
    return kube.get_pod("default", "p")["metadata"]["annotations"]["x"]


def test_no_resource_version_keeps_plain_merge_semantics():
    assert agree(cas_plain) == "b"


def node_conflict(pkg):
    kube = pkg.FakeKube()
    kube.create_node({"metadata": {"name": "coord"}})
    with pytest.raises(pkg.Conflict):
        kube.create_node({"metadata": {"name": "coord"}})
    return True


def test_create_node_conflicts_on_existing():
    assert agree(node_conflict)


# -- rendezvous ownership ---------------------------------------------------------

NODES = [f"node-{i}" for i in range(64)]


def map_owners(pkg, replicas, epoch=1):
    m = pkg.ShardMap(epoch, replicas)
    return [m.owner_of(n) for n in NODES]


def test_deterministic_across_instances():
    got = agree(map_owners, ("r0", "r1", "r2"))
    assert got == map_owners(PKGS["port"], ("r0", "r1", "r2"))


def test_every_replica_owns_something():
    assert set(agree(map_owners, ("r0", "r1", "r2", "r3"))) == \
        {"r0", "r1", "r2", "r3"}


def test_removing_a_replica_moves_only_its_nodes():
    before = agree(map_owners, ("r0", "r1", "r2"))
    after = agree(map_owners, ("r0", "r2"), 2)
    for b, a in zip(before, after):
        assert a == b if b != "r1" else a in ("r0", "r2")


def singletons(pkg):
    m = pkg.ShardMap(3, ("r0", "r1", "r2"))
    return {role: m.singleton_owner(role)
            for role in ("quota-admission", "defrag", "elastic")}


def test_singleton_owner_is_one_live_replica():
    assert set(agree(singletons).values()) <= {"r0", "r1", "r2"}


def codec(pkg):
    m = pkg.ShardMap(7, ("a", "b"))
    assert pkg.ShardMap.decode(m.encode()) == m
    return (m.encode(), pkg.ShardMap.decode(""),
            pkg.ShardMap.decode("not json"))


def test_codec_roundtrip():
    assert agree(codec) == ('{"epoch": 7, "replicas": ["a", "b"]}', None,
                            None)


def short_grace(pkg):
    with pytest.raises(ValueError, match="adoption_grace_s"):
        pkg.ShardConfig(replica="r0", stale_ttl_s=10.0,
                        adoption_grace_s=5.0)
    # Inert, the check does not apply.
    pkg.ShardConfig(stale_ttl_s=10.0, adoption_grace_s=5.0)
    return True


def test_adoption_grace_must_cover_stale_ttl():
    assert agree(short_grace)


# -- two replicas, one map ---------------------------------------------------------

def converged(pkg):
    kube, reps, names, clock = make_fleet(pkg)
    try:
        assert reps[0].shards.epoch() == reps[1].shards.epoch()
        gates = {n: [s.shards.reject_reason(n) is None for s in reps]
                 for n in names}
        for n, g in gates.items():
            assert g.count(True) == 1, (n, g)
        return dict(owners=owners(reps, names),
                    epochs=[s.shards.epoch() for s in reps],
                    replicas=list(reps[0].shards.map.replicas),
                    gates=gates, now=clock())
    finally:
        close_all(reps)


def test_replicas_converge_and_partition_is_disjoint():
    got = agree(converged)
    assert got["replicas"] == ["r0", "r1"]


def stamped(pkg):
    kube, reps, names, clock = make_fleet(pkg)
    try:
        out = []
        for i in range(8):
            pod = pkg.pod(f"p{i}", f"u{i}", mem="2000")
            kube.create_pod(pod)
            placed = None
            for s in reps:
                r = s.filter(pod, names)
                if r.node:
                    placed = (s, r.node)
                    break
            assert placed is not None
            s, node = placed
            assert s.shards.map.owner_of(node) == s.shards.replica
            d = decision(pkg, kube, f"p{i}")
            assert d[pkg.SHARD_OWNER_ANNOTATION] == s.shards.replica
            assert d[pkg.SHARD_EPOCH_ANNOTATION] == str(s.shards.epoch())
            out.append(d)
        return out
    finally:
        close_all(reps)


def test_decisions_stay_on_owned_shards_and_are_stamped():
    assert len(agree(stamped)) == 8


def racing_loser(pkg):
    kube, reps, names, clock = make_fleet(pkg)
    a, b = reps
    try:
        kube.create_pod(pkg.pod("race", "race-u", mem="2000"))
        stale = kube.get_pod("default", "race")
        r_b = b.filter(kube.get_pod("default", "race"), names)
        assert r_b.node, (r_b.error, r_b.failed)
        r_a = a.filter(stale, names)
        assert r_a.node is None and "shard-cas" in r_a.error
        tokens = dict(a.shards.cas_failures)
        assert tokens.get("rv-conflict", 0) \
            + tokens.get("already-decided", 0) == 1
        d = decision(pkg, kube, "race")
        assert d[pkg.ASSIGNED_NODE_ANNOTATION] == r_b.node
        assert d[pkg.SHARD_OWNER_ANNOTATION] == b.shards.replica
        held = a.pods.get("race-u")
        assert held is None or held.node == r_b.node
        return dict(winner=r_b.node, error=r_a.error, tokens=tokens,
                    decision=d, dwf=dict(a.decision_write_failures),
                    loser_holds=held.node if held else None)
    finally:
        close_all(reps)


def test_pod_cas_rejects_the_racing_loser():
    got = agree(racing_loser)
    assert got["dwf"] == {"shard-cas": 1}


def no_steal(pkg):
    kube, reps, names, clock = make_fleet(pkg)
    a, b = reps
    try:
        kube.create_pod(pkg.pod("steal", "steal-u", mem="2000"))
        r_b = b.filter(kube.get_pod("default", "steal"), names)
        assert r_b.node
        fresh = kube.get_pod("default", "steal")
        r_a = a.filter(fresh, names)
        assert r_a.node is None
        assert a.shards.cas_failures.get("already-decided") == 1
        d = decision(pkg, kube, "steal")
        assert d[pkg.ASSIGNED_NODE_ANNOTATION] == r_b.node
        assert d[pkg.SHARD_OWNER_ANNOTATION] == b.shards.replica
        # B deciding its own pod again stays legitimate.
        r_b2 = b.filter(kube.get_pod("default", "steal"), names)
        assert r_b2.node
        return dict(first=r_b.node, again=r_b2.node, error=r_a.error,
                    tokens=dict(a.shards.cas_failures), decision=d)
    finally:
        close_all(reps)


def test_peer_cannot_steal_a_decided_pod_even_with_fresh_rv():
    agree(no_steal)


def stale_map(pkg):
    kube, reps, names, clock = make_fleet(pkg)
    a = reps[0]
    try:
        mine = next(n for n in names if a.shards.reject_reason(n) is None)
        clock.advance(STALE + 1.0)
        pod = pkg.pod("stale", "stale-u", mem="2000")
        kube.create_pod(pod)
        r = a.filter(pod, [mine])
        assert r.node is None and "stale-map" in r.error
        assert a.shards.cas_failures.get("stale-map") == 1
        assert a.pods.get("stale-u") is None
        return dict(node=mine, error=r.error,
                    tokens=dict(a.shards.cas_failures),
                    dwf=dict(a.decision_write_failures),
                    decision=decision(pkg, kube, "stale"))
    finally:
        close_all(reps)


def test_stale_map_commit_fails_closed():
    got = agree(stale_map)
    assert got["error"].startswith("shard-fence: stale-map")
    assert got["dwf"] == {"shard-fence": 1} and got["decision"] == {}


def lost_ownership(pkg):
    kube, reps, names, clock = make_fleet(pkg)
    a, b = reps
    try:
        mine = next(n for n in names if a.shards.reject_reason(n) is None)
        usurped = pkg.ShardMap(epoch=a.shards.epoch() + 1,
                               replicas=(b.shards.replica,))
        real_fence = a.shards.commit_fence

        def racing_fence(node):
            a.shards._map = usurped
            a.shards._map_read_at = clock()
            return real_fence(node)

        a.shards.commit_fence = racing_fence
        pod = pkg.pod("fenced", "fenced-u", mem="2000")
        kube.create_pod(pod)
        r = a.filter(pod, [mine])
        assert r.node is None and "lost-ownership" in r.error
        assert a.shards.cas_failures.get("lost-ownership") == 1
        assert a.pods.get("fenced-u") is None
        d = decision(pkg, kube, "fenced")
        assert not d.get(pkg.ASSIGNED_NODE_ANNOTATION)
        return dict(node=mine, error=r.error,
                    tokens=dict(a.shards.cas_failures), decision=d)
    finally:
        close_all(reps)


def test_epoch_fence_rejects_lost_ownership():
    agree(lost_ownership)


def blind(pkg):
    kube = pkg.FakeKube()
    clock = pkg.SimClock()
    s = pkg.Sched(kube, shard_cfg(pkg, 0), clock=clock)
    try:
        kube.add_node({"metadata": {"name": "node-0", "annotations": {}}})
        pkg.register_node(s, "node-0")
        kube.watch_pods(s.on_pod_event)
        assert s.shards.enabled and not s.shards.active
        pod = pkg.pod("blind", "blind-u", mem="2000")
        kube.create_pod(pod)
        r = s.filter(pod, ["node-0"])
        assert r.node is None
        assert "shard-no-map" in r.failed["node-0"]
        out = dict(failed=dict(r.failed), owns=s.shards.owns("node-0"),
                   leads=s.shards.leads("quota-admission"),
                   placeable=s.shards.placeable("node-0"),
                   fence=s.shards.commit_fence("node-0"))
        assert out["fence"][0] == "no-map"
        assert not (out["owns"] or out["leads"] or out["placeable"])
        # The batched front door fails closed the same way.
        batched = s.filter_many([(pod, ["node-0"])])
        assert batched[0].node is None
        out["batched"] = (gpu(batched[0].error),
                          dict(batched[0].failed or {}))
        # The first tick unblocks placement.
        s.shards.tick()
        assert s.shards.active
        out["placed"] = s.filter(pod, ["node-0"]).node
        assert out["placed"] == "node-0"
        return out
    finally:
        s.close()


def test_enabled_without_map_rejects_everything():
    agree(blind)


# -- replica kill, epoch bump, adoption ---------------------------------------------

def survivors_adopt(pkg):
    kube, reps, names, clock = make_fleet(pkg, n_rep=3, n_nodes=6)
    try:
        victim = reps[1]
        orphans = [n for n in names
                   if victim.shards.reject_reason(n) is None]
        assert orphans, "the victim must own something"
        alive = kill_and_settle(reps, clock, victim)
        m = alive[0].shards.map
        assert victim.shards.replica not in m.replicas
        for n in names:
            assert owner_of(alive, n).shards.reject_reason(n) is None
        adopted = sum(s.shards.rebalancer.adopted_total for s in alive)
        assert adopted >= len(orphans)
        return dict(orphans=orphans, owners=owners(alive, names),
                    epoch=[s.shards.epoch() for s in alive],
                    adopted=[s.shards.rebalancer.adopted_total
                             for s in alive],
                    latency=[s.shards.rebalancer.last_adoption_latency_s
                             for s in alive],
                    rebalances=[s.shards.rebalances_total for s in alive],
                    now=clock())
    finally:
        close_all(reps)


def test_survivors_adopt_all_orphans():
    agree(survivors_adopt)


def orphaned_gauge(pkg):
    kube, reps, names, clock = make_fleet(pkg, n_rep=3, n_nodes=6)
    try:
        victim, observer = reps[2], reps[0]
        orphans = [n for n in names
                   if victim.shards.reject_reason(n) is None]
        assert orphans
        dead_after = observer.shards.leases.cfg.dead_after_s
        observer.shards.leases.beat(victim.shards.replica,
                                    now=clock() - dead_after - 1.0)
        window = sorted(observer.shards.orphaned_nodes())
        assert window == sorted(orphans)
        alive = kill_and_settle(reps, clock, victim)
        for s in alive:
            assert s.shards.orphaned_nodes() == []
        return dict(window=window, after=[s.shards.orphaned_nodes()
                                          for s in alive])
    finally:
        close_all(reps)


def test_orphaned_gauge_flags_the_window():
    agree(orphaned_gauge)


HA_SPEC = {"replicas": 3, "seed": 11, "kill_after": 4,
           "storm": {"name": "t", "tpu": 1, "tpumem": 16384, "count": 14},
           "storm_interval_s": 1, "settle_s": 120}


def ha_runs(pkg, monkeypatch):
    spec = json.loads(json.dumps(HA_SPEC))
    if pkg.name == "port":
        spec["storm"] = {"name": "t", "gpu": 1, "gpumem": 16384,
                         "count": 14}
    monkeypatch.setattr(pkg.simulate, "Config", functools.partial(
        pkg.Config, optimistic_commit=False))
    monkeypatch.setattr(pkg.simulate, "Scheduler", pkg.Sched)
    runs = [pkg.simulate.run_ha_phase(
        json.loads(json.dumps(spec)), nodes=4, chips=4, hbm=16384,
        mesh=(4, 1), generation="v5e" if pkg.name == "jax" else "h100",
        policy="spread") for _ in range(2)]
    assert runs[0]["verdict"]["ok"], runs[0]["verdict"]
    assert json.dumps(runs[0], sort_keys=True) \
        == json.dumps(runs[1], sort_keys=True)
    return runs[0]


def test_seeded_kill_adoption_is_deterministic(monkeypatch):
    got = {side: ha_runs(PKGS[side], monkeypatch) for side in SIDES}
    assert got["port"] == got["jax"]
    assert got["port"]["pending_during_window"] > 0


def beats_gced(pkg):
    kube, reps, names, clock = make_fleet(pkg, n_rep=2)
    a, b = reps
    try:
        beat_a = pkg.REPLICA_BEAT_PREFIX + a.shards.replica
        beat_b = pkg.REPLICA_BEAT_PREFIX + b.shards.replica
        before = sorted(kube.get_node(pkg.COORD_OBJECT)["metadata"]
                        ["annotations"])
        assert beat_b in before
        kill_and_settle(reps, clock, b)
        after = kube.get_node(pkg.COORD_OBJECT)["metadata"]["annotations"]
        assert beat_b not in after and beat_a in after
        assert b.shards.replica not in a.shards.map.replicas
        assert a.shards.leases.state_of(b.shards.replica) is None
        return dict(before=before, after=sorted(after),
                    map=after[pkg.SHARD_MAP_ANNOTATION])
    finally:
        close_all(reps)


def test_dead_replica_beat_annotation_is_gced():
    agree(beats_gced)


def wal_replay(pkg):
    kube, reps, names, clock = make_fleet(pkg, n_rep=2, n_nodes=4,
                                          watch=False)
    a, b = reps
    try:
        a_node = next(n for n in names if a.shards.reject_reason(n) is None)
        pod = pkg.pod("wal", "wal-u", mem="2000")
        kube.create_pod(pod)
        assert a.filter(pod, [a_node]).node == a_node
        assert b.pods.get("wal-u") is None
        alive = kill_and_settle(reps, clock, a)
        assert alive == [b]
        got = b.pods.get("wal-u")
        assert got is not None and got.node == a_node
        return dict(node=a_node, replayed=b.shards.rebalancer
                    .wal_replayed_total,
                    skipped=b.shards.rebalancer.wal_skipped_total,
                    grant=[[(d.uuid, d.usedmem, d.usedcores) for d in c]
                           for c in got.devices])
    finally:
        close_all(reps)


def test_adoption_replays_decision_wal_without_watch():
    assert agree(wal_replay)["replayed"] == 1


# -- the loops that run on one replica ----------------------------------------------

QA = {"name": "qa", "namespaces": ["team-a"], "weight": 1,
      "quota": {"chips": 4}}


def quota_one_leader(pkg):
    kube, reps, names, clock = make_fleet(
        pkg, n_rep=3, quota_queues=(QA,), queue_reclaim_grace_s=0.0)
    try:
        leaders = [s for s in reps if s.shards.leads("quota-admission")]
        assert len(leaders) == 1
        pod = pkg.pod("held", "held-u", mem="2000")
        pod["metadata"]["namespace"] = "team-a"
        kube.create_pod(pod)
        for s in reps:
            r = s.filter(pod, names)
            assert r.node is None and "queue" in r.error
        acted = [s for s in reps if s.admission.tick()]
        assert acted == leaders
        return [s.shards.replica for s in leaders]
    finally:
        close_all(reps)


def test_quota_admission_runs_on_exactly_one_replica():
    agree(quota_one_leader)


def quota_moves(pkg):
    kube, reps, names, clock = make_fleet(
        pkg, n_rep=2, quota_queues=(QA,), queue_reclaim_grace_s=0.0)
    try:
        leader = next(s for s in reps if s.shards.leads("quota-admission"))
        alive = kill_and_settle(reps, clock, leader)
        assert all(s.shards.leads("quota-admission") for s in alive)
        return leader.shards.replica, [s.shards.replica for s in alive]
    finally:
        close_all(reps)


def test_quota_leadership_moves_with_the_epoch():
    agree(quota_moves)


def defrag_gated(pkg):
    kube, reps, names, clock = make_fleet(pkg, n_rep=2)
    try:
        followers = [s for s in reps if not s.shards.leads("defrag")]
        assert len(followers) == 1
        assert followers[0].defrag.tick() == []
        return followers[0].shards.replica
    finally:
        close_all(reps)


def test_defrag_tick_is_leader_gated():
    agree(defrag_gated)


def no_double_evict(pkg):
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
        a_actions = a.rescuer.sweep()
        b_actions = b.rescuer.sweep()

        def kinds(actions):
            return [x["kind"] for x in actions if x.get("node") == node
                    or x.get("uid") == "victim-u"]

        assert "lease" in kinds(a_actions)
        assert kinds(b_actions) == ["lease-handoff"]
        assert b.rescuer.pending() == {}
        return kinds(a_actions), kinds(b_actions), \
            sorted(a.rescuer.pending())
    finally:
        close_all(reps)


def test_rescuer_never_double_evicts_across_a_handoff():
    agree(no_double_evict)


# -- one replica: the layer is inert --------------------------------------------------

def single(pkg, kube=None):
    kube = kube or pkg.FakeKube()
    s = pkg.Sched(kube, pkg.Config(optimistic_commit=False))
    names = ["node-0", "node-1"]
    for n in names:
        kube.add_node({"metadata": {"name": n, "annotations": {}}})
        pkg.register_node(s, n)
    kube.watch_pods(s.on_pod_event)
    return kube, s, names


def inert(pkg):
    kube, s, names = single(pkg)
    try:
        assert not s.shards.active

        def boom(*_a, **_k):  # pragma: no cover - the assert is the test
            raise AssertionError("shard layer consulted while inert")

        s.shards.reject_reason = boom
        s.shards.commit_fence = boom
        s.shards.placeable = boom
        placed = []
        for i in range(4):
            pod = pkg.pod(f"p{i}", f"u{i}", mem="2000")
            kube.create_pod(pod)
            placed.append(s.filter(pod, names).node)
        results = s.filter_many([
            (kube.create_pod(pkg.pod(f"b{i}", f"bu{i}", mem="500")), names)
            for i in range(4)])
        placed += [r.node for r in results]
        assert all(placed)
        assert s._decisions.writes > 0     # the batcher, not the CAS
        decisions = {}
        for p in kube.list_pods():
            anns = p["metadata"]["annotations"]
            assert pkg.SHARD_EPOCH_ANNOTATION not in anns
            assert pkg.SHARD_OWNER_ANNOTATION not in anns
            decisions[p["metadata"]["name"]] = decision(
                pkg, kube, p["metadata"]["name"])
        return dict(placed=placed, decisions=decisions,
                    writes=s._decisions.writes)
    finally:
        s.close()


def test_inert_layer_is_never_consulted():
    agree(inert)


def inert_tick(pkg):
    kube, s, names = single(pkg)
    try:
        return (s.shards.tick(), s.shards.owns("node-0"),
                s.shards.leads("quota-admission"),
                s.shards.reject_reason("node-0"),
                s.shards.commit_fence("node-0"),
                s.shards.candidate_gate())
    finally:
        s.close()


def test_inert_tick_is_a_noop():
    assert agree(inert_tick) == ([], True, True, None, (None, 0), None)


SHARD_FAMILIES = ("vtpu_shard_epoch", "vtpu_shards_owned",
                  "vtpu_shards_orphaned", "vtpu_shard_rebalances",
                  "vtpu_commit_cas_failures")


def shard_samples(pkg, s) -> dict:
    out = {}
    for fam in pkg.ClusterCollector(s).collect():
        if fam.name in SHARD_FAMILIES:
            out[fam.name] = sorted((smp[0], tuple(sorted(smp[1].items())),
                                    smp[2]) for smp in fam.samples)
    return out


def families_inert_and_active(pkg):
    kube, s, names = single(pkg)
    try:
        inert_fams = shard_samples(pkg, s)
    finally:
        s.close()
    kube2, reps, names2, clock = make_fleet(pkg, n_rep=2)
    try:
        # One failed fence, to fill the token family.
        clock.advance(STALE + 1.0)
        a = reps[0]
        mine = next(n for n in names2 if a.shards.reject_reason(n) is None)
        pod = pkg.pod("stale", "stale-u", mem="2000")
        kube2.create_pod(pod)
        assert a.filter(pod, [mine]).node is None
        active = [shard_samples(pkg, r) for r in reps]
    finally:
        close_all(reps)
    return inert_fams, active


def test_shard_metrics_emitted_inert_and_active():
    inert_fams, active = agree(families_inert_and_active)
    assert inert_fams["vtpu_shard_epoch"] == [("vtpu_shard_epoch", (), 0.0)]
    assert inert_fams["vtpu_shards_owned"] == [("vtpu_shards_owned", (),
                                                2.0)]
    assert inert_fams["vtpu_shards_orphaned"][0][2] == 0
    assert inert_fams["vtpu_commit_cas_failures"] == []
    epoch = active[0]["vtpu_shard_epoch"][0][2]
    assert epoch > 0
    owned = [a["vtpu_shards_owned"][0][2] for a in active]
    assert all(0 < o < 4 for o in owned) and sum(owned) == 4
    assert active[0]["vtpu_commit_cas_failures"] == [
        ("vtpu_commit_cas_failures_total", (("reason", "stale-map"),), 1.0)]


# -- the steady tick is O(replicas) ------------------------------------------------------

def counting_kube(pkg):
    class CountingKube(pkg.FakeKube):
        def __init__(self):
            super().__init__()
            self.pod_lists = 0
            self.node_patches = 0

        def list_pods(self, namespace=None, node_name=None):
            self.pod_lists += 1
            return super().list_pods(namespace, node_name)

        def patch_node_annotations(self, name, annotations,
                                   resource_version=None):
            self.node_patches += 1
            return super().patch_node_annotations(
                name, annotations, resource_version)

    return CountingKube()


def steady_tick(pkg):
    kube = counting_kube(pkg)
    clock = pkg.SimClock()
    reps = [pkg.Sched(kube, shard_cfg(pkg, i), clock=clock)
            for i in range(2)]
    try:
        names = [f"node-{i}" for i in range(16)]
        for n in names:
            kube.add_node({"metadata": {"name": n, "annotations": {}}})
            for s in reps:
                pkg.register_node(s, n, chips=2)
        converge(reps, clock, names)
        boot = (kube.pod_lists, kube.node_patches)
        kube.pod_lists = kube.node_patches = 0
        walks_before = [s.shards.tick_fleet_walks for s in reps]
        ticks = 10
        for _ in range(ticks):
            for s in reps:
                s.shards.tick()
            clock.advance(1.0)
        assert kube.pod_lists == 0
        assert kube.node_patches == ticks * len(reps)
        assert [s.shards.tick_fleet_walks for s in reps] == walks_before
        return dict(boot=boot, steady=(kube.pod_lists, kube.node_patches),
                    walks=walks_before)
    finally:
        close_all(reps)


def test_steady_tick_is_o_replicas():
    agree(steady_tick)


def replay_skips(pkg):
    kube, reps, names, clock = make_fleet(pkg, n_rep=2, n_nodes=6)
    victim, survivor = reps[1], reps[0]
    try:
        victim_nodes = [n for n in names
                        if victim.shards.reject_reason(n) is None]
        assert victim_nodes
        items = [(kube.create_pod(pkg.pod(f"v{i}", f"vu{i}", mem="500")),
                  [node]) for i, node in enumerate(victim_nodes)]
        results = victim.filter_many(items)
        assert all(r.node for r in results), \
            [r.error for r in results if not r.node]
        for i in range(len(victim_nodes)):
            assert survivor.pods.get(f"vu{i}") is not None
        for _ in range(60):
            survivor.shards.tick()
            if not survivor.shards.rebalancer.pending_nodes() \
                    and survivor.shards.map is not None \
                    and victim.shards.replica \
                    not in survivor.shards.map.replicas:
                break
            clock.advance(2.0)
        reb = survivor.shards.rebalancer
        assert reb.adopted_total >= len(victim_nodes)
        assert reb.wal_skipped_total >= len(victim_nodes)
        assert reb.wal_replayed_total == 0
        return dict(nodes=victim_nodes, adopted=reb.adopted_total,
                    skipped=reb.wal_skipped_total,
                    decisions=[decision(pkg, kube, f"v{i}")
                               for i in range(len(victim_nodes))])
    finally:
        close_all(reps)


def test_adoption_replay_skips_informer_tracked_pods():
    agree(replay_skips)


# -- the port's own: the shard package's imports --------------------------------------

def test_the_shard_package_imports_neither_torch_nor_numpy():
    """``shard/`` is on the extender's import chain, which the solve
    workers re-import: neither torch nor numpy may load with it."""
    import subprocess
    import sys

    code = ("import sys; import k8s_vgpu_scheduler_tpu_torch.shard; "
            "import k8s_vgpu_scheduler_tpu_torch.scheduler.core; "
            "print(sorted(m for m in ('torch', 'numpy', 'jax') "
            "if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"


def test_the_ownership_digest_is_the_jax_packages():
    """blake2b of ``node\\0replica``: the partition is the same in both
    packages and in every process (not Python's salted hash)."""
    import hashlib

    from k8s_vgpu_scheduler_tpu.shard.shardmap import _digest as jdigest
    from k8s_vgpu_scheduler_tpu_torch.shard.shardmap import _digest

    for key in ("node-0\x00r0", "role:defrag\x00replica-2", ""):
        want = int.from_bytes(hashlib.blake2b(
            key.encode(), digest_size=8).digest(), "big")
        assert _digest(key) == jdigest(key) == want


def test_a_cas_failure_is_a_tracer_event():
    """The JAX commit's provenance record, ``commit-cas-failed`` with its
    token and epoch, is an event in the port's tracer."""
    from k8s_vgpu_scheduler_tpu_torch.util import trace

    pkg = PKGS["port"]
    kube, reps, names, clock = make_fleet(pkg)
    try:
        a = reps[0]
        mine = next(n for n in names if a.shards.reject_reason(n) is None)
        clock.advance(STALE + 1.0)
        pod = pkg.pod("ev", "ev-u", mem="2000")
        kube.create_pod(pod)
        assert a.filter(pod, [mine]).node is None
        events = [e["attributes"] for e in trace.tracer().events("ev-u")
                  if e["event"] == "commit-cas-failed"]
        assert [(ev["token"], ev["node"], ev["epoch"]) for ev in events] \
            == [("stale-map", mine, a.shards.epoch())]
    finally:
        close_all(reps)


def bulk_fence(pkg):
    """``cas_commit_many`` on a cycle's decisions: each entry fenced and
    stamped as on the single path, one bulk call, per-entry CAS."""
    kube, reps, names, clock = make_fleet(pkg, n_rep=2, n_nodes=6)
    a, b = reps
    try:
        mine = [n for n in names if a.shards.reject_reason(n) is None]
        items = [(kube.create_pod(pkg.pod(f"m{i}", f"mu{i}", mem="500")),
                  [mine[i % len(mine)]]) for i in range(4)]
        # One pod a peer decided after the cycle's view of it was taken:
        # its CAS (on that view's resourceVersion) fails closed alone.
        r_b = b.filter(items[1][0], names)
        assert r_b.node
        results = a.filter_many(items)
        return dict(nodes=[r.node for r in results],
                    errors=[gpu(r.error) for r in results],
                    tokens=dict(a.shards.cas_failures),
                    dwf=dict(a.decision_write_failures),
                    decisions=[decision(pkg, kube, f"m{i}")
                               for i in range(4)])
    finally:
        close_all(reps)


def test_the_bulk_commit_is_fenced_entry_by_entry():
    got = agree(bulk_fence)
    assert got["nodes"][1] is None and all(
        got["nodes"][i] for i in (0, 2, 3))
    assert got["tokens"] == {"rv-conflict": 1}
    assert got["dwf"] == {"shard-cas": 1}


def test_the_ports_flags_build_the_shard_config():
    """The seven ``--shard-*`` flags parse as the JAX entry point's and
    give the config the JAX main builds; the defaults are the JAX ones
    (the layer inert)."""
    from k8s_vgpu_scheduler_tpu.cmd import scheduler as jcmd
    from k8s_vgpu_scheduler_tpu_torch.cmd.scheduler import (build_config,
                                                            parse_args)

    fields = ("shard_replica", "shard_ttl", "shard_grace_beats",
              "shard_tick", "shard_stale_ttl", "shard_adoption_grace",
              "shard_coord_object")
    for argv in ([], ["--shard-replica", "sched-1", "--shard-ttl", "3",
                      "--shard-grace-beats", "1", "--shard-tick", "0.5",
                      "--shard-stale-ttl", "2", "--shard-adoption-grace",
                      "2.5", "--shard-coord-object", "coord-x"]):
        mine, ref = parse_args(argv), jcmd.parse_args(argv)
        assert {f: getattr(mine, f) for f in fields} == \
            {f: getattr(ref, f) for f in fields}
        cfg = build_config(mine)
        assert (cfg.shard_replica, cfg.shard_ttl_s, cfg.shard_grace_beats,
                cfg.shard_tick_s, cfg.shard_stale_ttl_s,
                cfg.shard_adoption_grace_s, cfg.shard_coord_object) == \
            tuple(getattr(ref, f) for f in fields)
    default = PKGS["port"].Config()
    ref = PKGS["jax"].Config()
    assert [getattr(default, f) for f in (
        "shard_replica", "shard_ttl_s", "shard_grace_beats",
        "shard_tick_s", "shard_stale_ttl_s", "shard_adoption_grace_s",
        "shard_coord_object")] == [getattr(ref, f) for f in (
            "shard_replica", "shard_ttl_s", "shard_grace_beats",
            "shard_tick_s", "shard_stale_ttl_s", "shard_adoption_grace_s",
            "shard_coord_object")] == ["", 15.0, 2, 3.0, 10.0, 12.0,
                                       "vtpu-shard-coordination"]


def test_the_entry_point_joins_the_map_before_it_serves(monkeypatch):
    """``vgpu-scheduler --shard-replica``: the first coordination tick
    runs before the register service starts, then the tick thread at
    ``--shard-tick``."""
    from k8s_vgpu_scheduler_tpu_torch.cmd import scheduler as cmd

    order, built = [], []

    class Stop(Exception):
        pass

    real_init = cmd.Scheduler.__init__

    def init(self, *a, **kw):
        real_init(self, *a, **kw)
        built.append(self)
        self.shards.tick = lambda: order.append("tick") or []
        self.shards.start = lambda interval: order.append(
            ("start", interval))

    def register(*a, **kw):
        order.append("register")
        raise Stop

    monkeypatch.setattr(cmd.Scheduler, "__init__", init)
    monkeypatch.setattr(cmd, "start_register_service", register)
    try:
        with pytest.raises(Stop):
            cmd.main(["--fake-kube", "--shard-replica", "sched-0",
                      "--shard-tick", "0.5", "--no-watch", "--no-rescue",
                      "--capacity-interval", "0"])
    finally:
        for s in built:
            s.close()
    assert order == ["tick", ("start", 0.5), "register"]
    assert built[0].cfg.shard_replica == "sched-0"
