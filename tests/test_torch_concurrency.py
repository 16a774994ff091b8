"""The port's optimistic Filter (``scheduler/core.py``: revisions, the
snapshot cache, the optimistic commit, the fit cache, the worker pool) and
its decision writer (``util/decisionwriter.py``) against the JAX
package's, on the CPU: ``tests/test_scheduler_concurrency.py``'s cases,
each run on both packages (``SIDES``), the batched-cycle ones with them:
the interleaved add against the batch group commit, the stress and the
churn again with every Filter through the batch gate (``STRESS_SIDES``,
the JAX suite's ``VTPU_TEST_FILTER_BATCH`` rerun), and
``DecisionBatcher.write_many`` with the bulk epilogue's rollback
(tests/test_torch_batch.py holds the rest of the batch engine).

- The stress and the churn are run on each package with its own
  invariant: through any interleaving no card's slots, MiB or cores pass
  its totals, and every thread ends within its limit.
- The protocol cases (the forced conflict, the exhausted retries, the
  interleaved watch add, the incremental publish, the fit cache) force
  the same race on both and compare what comes out: the placement, the
  conflicts counted, the usage the next reader sees, the rebuild and
  write-through counts.
- ``CowUsage``, the type prefilter and ``DecisionBatcher``'s four cases
  are compared by their answers.
- The serial and optimistic paths place alike in each package.

Three stated departures, each pinned with both answers:

- the near-best scatter.  Both packages pick among the candidates within
  1% of the best score by a digest of (pod, node); the JAX package's is
  Python's ``hash((uid, node))``, salted per process, so its pick changes
  with ``PYTHONHASHSEED``; the port's is ``zlib.crc32`` of
  ``uid + "\\0" + node``, the same in every process.  On seeded near-tie
  fleets the port's pick lies in the JAX package's near-best set.
- the fit cache's key.  The JAX fingerprint leaves a pod's
  ``vtpu.dev/mesh`` out, so a mesh pod's cached rejection is served to a
  plain pod of the same request on the same node generation; the port's
  key holds the mesh, and the plain pod places.
- the snapshot refresh's reads.  The JAX refresh reads a node's pod rev
  and then its grants in a second acquire, so an informer event between
  the two lands in a map keyed before it and its write-through counts it
  twice; the port reads both in one acquire.
"""

import os
import random
import subprocess
import sys
import threading
import time
import types
import zlib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
CHIP_MIB = 16384
CHIPS_PER_NODE = 4
SLOTS_PER_CHIP = 10
CORES_PER_CHIP = 100
#: Seconds each stress case may take, its threads' joins included.
STRESS_LIMIT_S = 120.0


def package(name: str):
    """One package's scheduler, score module, registries and the test's
    helpers for it (resource names, card type, pods, node registration)."""
    if name == "port":
        from k8s_vgpu_scheduler_tpu_torch.k8s import FakeKube
        from k8s_vgpu_scheduler_tpu_torch.scheduler import Scheduler
        from k8s_vgpu_scheduler_tpu_torch.scheduler import score
        from k8s_vgpu_scheduler_tpu_torch.scheduler.nodes import (
            DeviceInfo, NodeInfo)
        from k8s_vgpu_scheduler_tpu_torch.scheduler.pods import PodInfo
        from k8s_vgpu_scheduler_tpu_torch.tpulib import TopologyDesc
        from k8s_vgpu_scheduler_tpu_torch.util import nodelock
        from k8s_vgpu_scheduler_tpu_torch.util.config import Config
        from k8s_vgpu_scheduler_tpu_torch.util.decisionwriter import \
            DecisionBatcher
        from k8s_vgpu_scheduler_tpu_torch.util.types import (
            ContainerDevice, ContainerDeviceRequest)
        res, ctype, gen = "nvidia.com/gpu", "NVIDIA-h100", "h100"
        use_type = "nvidia.com/use-gputype"
    else:
        from k8s_vgpu_scheduler_tpu.k8s import FakeKube
        from k8s_vgpu_scheduler_tpu.scheduler import Scheduler
        from k8s_vgpu_scheduler_tpu.scheduler import score
        from k8s_vgpu_scheduler_tpu.scheduler.nodes import (DeviceInfo,
                                                            NodeInfo)
        from k8s_vgpu_scheduler_tpu.scheduler.pods import PodInfo
        from k8s_vgpu_scheduler_tpu.tpulib import TopologyDesc
        from k8s_vgpu_scheduler_tpu.util import nodelock
        from k8s_vgpu_scheduler_tpu.util.config import Config
        from k8s_vgpu_scheduler_tpu.util.decisionwriter import \
            DecisionBatcher
        from k8s_vgpu_scheduler_tpu.util.types import (
            ContainerDevice, ContainerDeviceRequest)
        res, ctype, gen = "google.com/tpu", "TPU-v5e", "v5e"
        use_type = "vtpu.dev/use-tputype"
    ns = types.SimpleNamespace(**locals())
    ns.name = name

    def register_node(s, node, chips=CHIPS_PER_NODE, devmem=CHIP_MIB,
                      mesh=(4, 1)):
        s.nodes.add_node(node, NodeInfo(name=node, devices=[
            DeviceInfo(id=f"{node}-chip-{i}", count=SLOTS_PER_CHIP,
                       devmem=devmem, type=ctype, health=True,
                       coords=(i % mesh[0], i // mesh[0]))
            for i in range(chips)],
            topology=TopologyDesc(generation=gen, mesh=mesh)))

    def pod(pname, uid, mem="3000", nums="1", anns=None):
        return {"metadata": {"name": pname, "namespace": "default",
                             "uid": uid, "annotations": dict(anns or {})},
                "spec": {"containers": [{"name": "main", "resources": {
                    "limits": {res: nums, f"{res}mem": mem}}}]}}

    ns.register_node, ns.pod = register_node, pod
    return ns


SIDES = ("port", "jax")
PKGS = {name: package(name) for name in SIDES}


@pytest.fixture
def built():
    """Every scheduler a case builds, closed at its end (the evaluation
    pool's threads must not outlive the case)."""
    made = []
    yield made
    for s in made:
        s.close()


def make_env(pkg, built, n_nodes=8, **cfg):
    kube = pkg.FakeKube()
    s = pkg.Scheduler(kube, pkg.Config(**cfg))
    built.append(s)
    names = [f"node-{i}" for i in range(n_nodes)]
    for n in names:
        kube.add_node({"metadata": {"name": n, "annotations": {}}})
        pkg.register_node(s, n)
    kube.watch_pods(s.on_pod_event)
    return kube, s, names


def overbooked(s) -> list:
    """Every card whose summed grants pass its slots, MiB or cores."""
    granted = {}
    for info in s.pods.list_pods():
        for container in info.devices:
            for dev in container:
                g = granted.setdefault(dev.uuid, [0, 0, 0])
                g[0] += 1
                g[1] += dev.usedmem
                g[2] += dev.usedcores
    return sorted(chip for chip, (slots, mem, cores) in granted.items()
                  if slots > SLOTS_PER_CHIP or mem > CHIP_MIB
                  or cores > CORES_PER_CHIP)


def used_mem(s) -> int:
    return sum(u.used_mem for usage in s.inspect_all_nodes_usage().values()
               for u in usage.values())


def join_all(threads, deadline):
    for th in threads:
        th.join(timeout=max(0.0, deadline - time.monotonic()))
        assert not th.is_alive(), "a worker wedged (conflict livelock?)"


# -- the stress -----------------------------------------------------------------
#: The stress and churn cases run on each package as they are, again with
#: every Filter through the batch gate (``filter_batch``: the JAX suite's
#: VTPU_TEST_FILTER_BATCH rerun), and again with the shard layer on as one
#: replica that owns the whole fleet (``fenced``: the JAX suite's
#: VTPU_TEST_SHARD_FENCE rerun), so that every decision passes the epoch
#: fence and commits as a compare-and-swap on the pod's resourceVersion
#: under the same racing load.  Its stale TTL outlasts the case: nothing
#: here bumps an epoch (tests/test_torch_shard.py races those).
STRESS_SIDES = (*SIDES, *(f"{side}-{mode}" for mode in ("batched", "fenced")
                          for side in SIDES))


def stress_env(side, built, **cfg):
    name, _, mode = side.partition("-")
    pkg = PKGS[name]
    if mode == "batched":
        cfg["filter_batch"] = True
    if mode == "fenced":
        cfg.update(shard_replica="stress-replica", shard_stale_ttl_s=3600.0,
                   shard_adoption_grace_s=3600.0)
    kube, s, names = make_env(pkg, built, **cfg)
    if mode == "fenced":
        s.shards.tick()
        assert s.shards.active, "the shard map must converge first"
    return pkg, kube, s, names


@pytest.mark.parametrize("side", STRESS_SIDES)
def test_racing_filters_binds_and_deletes_never_overbook(side, built):
    """8 threads x Filter/Bind/delete over 8 nodes, the invariant checked
    at every step of every thread and at the end, within its limit."""
    pkg, kube, s, names = stress_env(side, built)
    n_threads, ops = 8, 30
    errors = []
    barrier = threading.Barrier(n_threads)
    deadline = time.monotonic() + STRESS_LIMIT_S

    def worker(t):
        barrier.wait()
        placed = []
        try:
            for i in range(ops):
                name, uid = f"t{t}p{i}", f"t{t}u{i}"
                p = pkg.pod(name, uid, mem=("4000", "8000", "2000")[i % 3])
                kube.create_pod(p)
                r = s.filter(p, names)
                if r.node is not None:
                    placed.append((name, uid, r.node))
                    if i % 3 == 0 and s.bind("default", name, uid,
                                             r.node) is None:
                        pkg.nodelock.release_node(kube, r.node)
                else:
                    assert r.error or r.failed
                if i % 4 == 3 and placed:
                    kube.delete_pod("default", placed.pop(0)[0])
                assert not overbooked(s)
        except Exception as e:  # noqa: BLE001 — raised on the main thread
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(n_threads)]
    for th in threads:
        th.start()
    join_all(threads, deadline)
    assert not errors, errors[0]
    assert not overbooked(s)
    if side.endswith("-batched"):
        assert s.batch.stats.pods >= 1
        assert s.export_perf()["queue"]["pending_depth"] == 0
    fenced_checks(side, kube, s)


def fenced_checks(side, kube, s) -> None:
    """With the fence on: the fence itself never refused (the map stayed
    fresh and owned), and every standing decision was stamped by the
    replica at its epoch."""
    if not side.endswith("-fenced"):
        return
    assert not {"no-map", "stale-map", "lost-ownership", "adopting"} \
        & set(s.shards.cas_failures), s.shards.cas_failures
    decided = [p["metadata"]["annotations"] for p in kube.list_pods()
               if p["metadata"]["annotations"].get("vtpu.dev/assigned-node")]
    assert decided
    assert all(a.get("vtpu.dev/shard-owner") == "stress-replica"
               and a.get("vtpu.dev/shard-epoch") == "1" for a in decided)


@pytest.mark.parametrize("side", STRESS_SIDES)
def test_conflict_retry_converges_under_node_churn(side, built):
    """Filters racing re-registrations (every validation sees a moving
    inventory rev) still place and never overbook."""
    pkg, kube, s, names = stress_env(side, built, n_nodes=4)
    stop = threading.Event()
    deadline = time.monotonic() + STRESS_LIMIT_S

    def churn():
        i = 0
        while not stop.is_set():
            pkg.register_node(s, names[i % len(names)])
            i += 1

    churner = threading.Thread(target=churn, daemon=True)
    churner.start()
    try:
        for i in range(40):
            p = pkg.pod(f"c{i}", f"cu{i}", mem="1000")
            kube.create_pod(p)
            r = s.filter(p, names)
            assert r.node is not None, r.error
            assert time.monotonic() < deadline
    finally:
        stop.set()
        churner.join(timeout=10)
    assert not overbooked(s)
    fenced_checks(side, kube, s)


# -- the protocol -----------------------------------------------------------------
def rival(pkg, s, uid, node, mem=1000, chip=0):
    s.pods.add_pod(pkg.PodInfo(
        uid=uid, name=uid, namespace="default", node=node,
        devices=[[pkg.ContainerDevice(uuid=f"{node}-chip-{chip}",
                                      type=pkg.ctype, usedmem=mem,
                                      usedcores=0)]]))


def lost_race(side, built):
    pkg = PKGS[side]
    kube, s, names = make_env(pkg, built, n_nodes=2)
    real_eval = s._evaluate_candidates
    fired = []

    def racing_eval(uid, requests, anns, node_names, snap):
        best, failed = real_eval(uid, requests, anns, node_names, snap)
        if best is not None and not fired:
            fired.append(best[1])
            rival(pkg, s, "rival", best[1])
        return best, failed

    s._evaluate_candidates = racing_eval
    p = pkg.pod("p", "u", mem="2000")
    kube.create_pod(p)
    r = s.filter(p, names)
    return dict(placed=r.node is not None, conflicts=s.commit_conflicts,
                on_raced=r.node == fired[0],
                grants=sorted(u for u in ("u", "rival")
                              if s.pods.get(u) is not None),
                used=used_mem(s), overbooked=overbooked(s))


def test_lost_revision_race_retries_and_places(built):
    """A rival grant lands on the winner between snapshot and commit: the
    conflict is counted, the pod refits and places, both grants stand and
    the next reader sees both."""
    got = {side: lost_race(side, built) for side in SIDES}
    assert got["port"] == got["jax"] == dict(
        placed=True, conflicts=1, on_raced=True, grants=["rival", "u"],
        used=3000, overbooked=[])


def exhausted(side, built):
    pkg = PKGS[side]
    kube, s, names = make_env(pkg, built, n_nodes=2, commit_retries=1)
    real_snapshot = s.snapshot
    bumps = [0]

    def racing_snapshot():
        snap = real_snapshot()
        if bumps[0] < 4:
            bumps[0] += 1
            for n in names:
                pkg.register_node(s, n)
        return snap

    s.snapshot = racing_snapshot
    s._refit_live_locked = lambda *a, **kw: None
    p = pkg.pod("p", "u", mem="2000")
    kube.create_pod(p)
    r = s.filter(p, names)
    return dict(placed=r.node is not None, conflicts=s.commit_conflicts,
                bumps=bumps[0], overbooked=overbooked(s))


def test_exhausted_retries_fall_back_to_locked_decide(built):
    """A conflict storm past ``commit_retries`` with no refit decides on
    the serial path, and still places."""
    got = {side: exhausted(side, built) for side in SIDES}
    assert got["port"] == got["jax"]
    assert got["port"]["placed"] and got["port"]["conflicts"] >= 2
    assert not got["port"]["overbooked"]


@pytest.mark.parametrize("side", SIDES)
def test_metrics_scrape_never_blocks_on_commit_lock(side, built):
    pkg = PKGS[side]
    kube, s, names = make_env(pkg, built, n_nodes=2)
    p = pkg.pod("p", "u", mem="2000")
    kube.create_pod(p)
    assert s.filter(p, names).node is not None
    got = {}
    with s._commit_lock:
        t = threading.Thread(
            target=lambda: got.update(s.inspect_all_nodes_usage()))
        t.start()
        t.join(timeout=5)
        assert not t.is_alive(), "the scrape blocked on the commit lock"
    assert sum(u.used_mem for usage in got.values()
               for u in usage.values()) == 2000


def interleaved(side, built):
    pkg = PKGS[side]
    kube, s, names = make_env(pkg, built, n_nodes=1)
    real_add = s.pods.add_pod
    fired = []

    def interleaved_add(info):
        if not fired and info.uid == "u":
            fired.append(info.node)
            rival(pkg, s, "watch-rival", info.node)
        return real_add(info)

    s.pods.add_pod = interleaved_add
    p = pkg.pod("p", "u", mem="2000")
    kube.create_pod(p)
    r = s.filter(p, names)
    return dict(placed=r.node is not None, conflicts=s.commit_conflicts,
                used=used_mem(s), overbooked=overbooked(s))


def test_interleaved_watch_add_forces_refit(built):
    """An informer add between the rev check and the commit's insert
    breaks the rev chain: a conflict, undone and refitted on the live
    view, and the published snapshot shows the interleaver."""
    got = {side: interleaved(side, built) for side in SIDES}
    assert got["port"] == got["jax"] == dict(
        placed=True, conflicts=1, used=3000, overbooked=[])


def interleaved_group(side, built):
    pkg = PKGS[side]
    kube, s, names = make_env(pkg, built, n_nodes=1, filter_batch=True)
    real_group = s.pods.add_pods_group
    fired = []

    def group(infos, node, expected_rev):
        if not fired:
            fired.append(node)
            rival(pkg, s, "watch-rival", node)
        return real_group(infos, node, expected_rev)

    s.pods.add_pods_group = group
    p = pkg.pod("p", "u", mem="2000")
    kube.create_pod(p)
    r = s.filter_many([(p, names)])[0]
    return dict(placed=r.node is not None, fired=len(fired),
                fallbacks=s.batch.stats.fallback_reason_counts(),
                conflicts=s.commit_conflicts, used=used_mem(s),
                overbooked=overbooked(s))


def test_interleaved_watch_add_conflicts_batch_group_commit(built):
    """The batched twin: the group commit checks the node's rev inside
    the registry lock, so an informer add between the cycle's snapshot and
    its insert refuses the whole group (nothing added), the pod places
    through the cycle's per-pod fallback, and both grants show."""
    got = {side: interleaved_group(side, built) for side in SIDES}
    assert got["port"] == got["jax"] == dict(
        placed=True, fired=1, fallbacks={"commit-conflict": 1},
        conflicts=1, used=3000, overbooked=[])


def incremental(side, built, monkeypatch):
    pkg = PKGS[side]
    kube, s, names = make_env(pkg, built, n_nodes=2)
    s.snapshot()
    before = (s.usage_rebuilds, s.usage_writethroughs)
    calls = [0]
    real_build = pkg.score.build_usage

    def counting_build(info, pods):
        calls[0] += 1
        return real_build(info, pods)

    monkeypatch.setattr(pkg.score, "build_usage", counting_build)
    for i in range(6):
        p = pkg.pod(f"p{i}", f"u{i}", mem="1000")
        kube.create_pod(p)
        assert s.filter(p, names).node is not None
    monkeypatch.setattr(pkg.score, "build_usage", real_build)
    return dict(builds=calls[0], used=used_mem(s),
                rebuilds=s.usage_rebuilds - before[0],
                writethroughs=s.usage_writethroughs - before[1])


def test_commit_publishes_snapshot_incrementally(built, monkeypatch):
    """A committed grant is published copy-on-write: the steady decision
    path rebuilds no node, and the informer's echo of the decision write
    does not invalidate the entry."""
    got = {side: incremental(side, built, monkeypatch) for side in SIDES}
    assert got["port"] == got["jax"]
    assert got["port"]["builds"] == 0 and got["port"]["used"] == 6000
    assert got["port"]["rebuilds"] == 0


def snapshot_race(side, built, when, event):
    """An informer event on ``node-0`` lands while a snapshot refresh
    rebuilds the node: just ``before`` or just ``after`` the refresh reads
    the node's grants (the port's ``node_view``, the JAX package's
    ``pods_on_node``; the JAX refresh read the pod rev already).  The
    event runs on its own thread, as the informer does: its registry
    change is made at that moment, its write-through waits for the
    refresh's cache lock.  Whether the snapshot after it shows each card's
    usage as the registry builds it, and keys it on the live revs."""
    pkg = PKGS[side]
    kube, s, names = make_env(pkg, built, n_nodes=1)
    node = names[0]
    s.snapshot()
    rival(pkg, s, "q", node)
    rival(pkg, s, "p", node)
    added = pkg.PodInfo(
        uid="r", name="r", namespace="default", node=node,
        devices=[[pkg.ContainerDevice(uuid=f"{node}-chip-0", type=pkg.ctype,
                                      usedmem=1000, usedcores=0)]])

    def informer():
        if event == "delete":
            s._del_pod_wt("p")
        else:
            rev = s.pods.upsert(added)
            if rev is not None:
                s._write_through(node, added.devices, rev, 1)

    def landed():
        return (s.pods.get("p") is None if event == "delete"
                else s.pods.get("r") is not None)

    attr = "node_view" if side == "port" else "pods_on_node"
    real_read = getattr(s.pods, attr)
    threads = []

    def fire():
        th = threading.Thread(target=informer, daemon=True)
        threads.append(th)
        th.start()
        deadline = time.monotonic() + 10.0
        while not landed():
            assert time.monotonic() < deadline, "the informer never landed"
            time.sleep(0.001)

    def racing_read(name):
        if name != node or threads:
            return real_read(name)
        if when == "before":
            fire()
            return real_read(name)
        got = real_read(name)
        fire()
        return got

    setattr(s.pods, attr, racing_read)
    s.snapshot()
    join_all(threads, time.monotonic() + 10.0)
    setattr(s.pods, attr, real_read)
    entry = s.snapshot()[node]
    truth = pkg.score.build_usage(s.nodes.get_node(node),
                                  s.pods.pods_on_node(node))

    def cards(usage):
        return {cid: (u.used_slots, u.used_mem, u.used_cores)
                for cid, u in usage.items()}

    live = (s.pods.rev_of(node), s.nodes.rev_of(node))
    return dict(fired=len(threads), live_key=entry.key == live,
                usage=cards(entry.usage), truth=cards(truth))


@pytest.mark.parametrize("event", ["delete", "add"])
def test_informer_event_during_refresh_is_counted_once(built, event):
    """A stated departure.  The port's refresh reads a node's pod rev and
    its grants in one acquire, so the map it caches is exactly that rev's,
    and the event's write-through, which moves the map by one rev, counts
    the event once wherever it lands.  The JAX refresh reads the rev, then
    the grants: an event between the two is in a map keyed before it, and
    its write-through counts it a second time (a delete takes the card's
    other grant off, an add books itself twice), served under the live
    key until the node changes again.  After the read, both are right."""
    got = {(side, when): snapshot_race(side, built, when, event)
           for side in SIDES for when in ("before", "after")}
    for (side, when), g in got.items():
        assert g["fired"] == 1 and g["live_key"], (side, when)
        right = g["usage"] == g["truth"]
        assert right == (side == "port" or when == "after"), (side, when, g)
    chip = "node-0-chip-0"
    want = {"delete": 1000, "add": 3000}[event]
    assert got["port", "before"]["usage"][chip][1] == want
    assert got["jax", "before"]["usage"][chip][1] == {
        "delete": 0, "add": 4000}[event]


def fit_cache(side, built):
    pkg = PKGS[side]
    kube, s, names = make_env(pkg, built, n_nodes=1)
    out = []
    for i in range(CHIPS_PER_NODE + 1):
        p = pkg.pod(f"p{i}", f"u{i}", mem=str(CHIP_MIB))
        kube.create_pod(p)
        r = s.filter(p, names)
        out.append([r.node, {n: why.split(":")[0]
                             for n, why in r.failed.items()}])
    return dict(out=out, overbooked=overbooked(s))


def test_fit_cache_invalidated_by_any_grant(built):
    """Whole-card pods on one node: four place, the fifth (the same
    request, a fit-cache key seen four times) sees the grants and fits
    nowhere."""
    got = {side: fit_cache(side, built) for side in SIDES}
    assert got["port"] == got["jax"]
    assert [n for n, _ in got["port"]["out"]] == ["node-0"] * 4 + [None]


def mesh_then_plain(side, built):
    pkg = PKGS[side]
    kube, s, names = make_env(pkg, built, n_nodes=1)
    pkg.register_node(s, names[0], mesh=(2, 2))
    out = []
    for name, anns in (("m", {"vtpu.dev/mesh": "3"}), ("plain", {})):
        p = pkg.pod(name, f"u-{name}", mem="1000", nums="3", anns=anns)
        kube.create_pod(p)
        r = s.filter(p, names)
        out.append([r.node, sorted(why.split(":")[0]
                                   for why in r.failed.values())])
    return out


def test_the_fit_cache_keys_the_declared_mesh(built):
    """The stated departure: a 3-card mesh pod on a (2, 2) fabric is
    refused (no box realizes a line of three); the next pod asks the same
    three cards without a mesh.  The JAX fit cache serves it the mesh pod's
    rejection; the port fits it."""
    got = {side: mesh_then_plain(side, built) for side in SIDES}
    assert got["jax"][0][0] is None and got["port"][0] == got["jax"][0]
    assert got["jax"][1] == got["jax"][0]            # the cached rejection
    assert got["port"][1] == ["node-0", []]          # fitted afresh


# -- CowUsage and the type prefilter ------------------------------------------------
def base_usage(pkg):
    return {f"c{i}": pkg.score.DeviceUsage(
        id=f"c{i}", type=pkg.ctype, health=True, coords=(i, 0),
        total_slots=10, used_slots=0, total_mem=CHIP_MIB, used_mem=0,
        total_cores=100, used_cores=0) for i in range(4)}


@pytest.mark.parametrize("side", SIDES)
def test_cow_mutation_stays_in_overlay(side):
    pkg = PKGS[side]
    base = base_usage(pkg)
    cow = pkg.score.CowUsage(base)
    cow.own("c0").used_mem = 5000
    assert base["c0"].used_mem == 0 and cow["c0"].used_mem == 5000
    merged = {u.id: u for u in cow.values()}
    assert merged["c0"].used_mem == 5000 and merged["c1"] is base["c1"]


@pytest.mark.parametrize("side", SIDES)
def test_cow_layering_composes(side):
    pkg = PKGS[side]
    base = base_usage(pkg)
    trial = pkg.score.CowUsage(base)
    trial.own("c0").used_mem = 1000
    probe = pkg.score.CowUsage(trial)
    probe.own("c0").used_mem += 500
    probe.own("c1").used_mem = 7
    assert [base["c0"].used_mem, trial["c0"].used_mem,
            probe["c0"].used_mem, trial["c1"].used_mem,
            probe["c1"].used_mem] == [0, 1000, 1500, 0, 7]


@pytest.mark.parametrize("side", SIDES)
def test_fit_container_clones_only_granted_chips(side):
    pkg = PKGS[side]
    base = base_usage(pkg)
    cow = pkg.score.CowUsage(base)
    got = pkg.score.fit_container(
        pkg.ContainerDeviceRequest(nums=1, memreq=1000, coresreq=10),
        cow, None, {})
    assert got is not None and len(got) == 1
    assert len(cow._own) == 1
    assert all(u.used_mem == 0 for u in base.values())


@pytest.mark.parametrize("side", SIDES)
def test_multi_container_sees_earlier_grants(side):
    pkg = PKGS[side]
    cow = pkg.score.CowUsage(base_usage(pkg))
    reqs = [pkg.ContainerDeviceRequest(nums=4, memreq=CHIP_MIB - 1000),
            pkg.ContainerDeviceRequest(nums=1, memreq=2000)]
    assert pkg.score.fit_pod(reqs, cow, None, {}) is None


def test_whitelist_miss_rejects_without_fit(built):
    got = {}
    for side in SIDES:
        pkg = PKGS[side]
        kube, s, names = make_env(pkg, built, n_nodes=2)
        p = pkg.pod("p", "u", mem="1000", anns={pkg.use_type: "v6"})
        kube.create_pod(p)
        r = s.filter(p, names)
        got[side] = [r.node, sorted(why.split(":")[0]
                                    for why in r.failed.values())]
    assert got["port"] == got["jax"] == [None, ["type-mismatch"] * 2]


@pytest.mark.parametrize("side", SIDES)
def test_prefilter_matches_chip_rule(side):
    pkg = PKGS[side]
    usage = {"c0": base_usage(pkg)["c0"]}
    word = pkg.gen
    aff = pkg.score.parse_affinity({pkg.use_type: word})
    assert pkg.score.type_excluded(aff, usage) is None
    aff = pkg.score.parse_affinity({pkg.use_type: "v4"})
    assert pkg.score.type_excluded(aff, usage) is not None


# -- DecisionBatcher ------------------------------------------------------------------
@pytest.mark.parametrize("side", SIDES)
def test_single_writer_writes_alone(side):
    pkg = PKGS[side]
    kube = pkg.FakeKube()
    kube.create_pod(pkg.pod("p", "u"))
    b = pkg.DecisionBatcher(kube)
    assert b.write("default", "p", {"k": "v"}) == 1
    assert kube.get_pod("default", "p")["metadata"]["annotations"]["k"] \
        == "v"
    assert (b.batches, b.writes) == (1, 1)


def concurrent_writers(pkg):
    class SlowKube(pkg.FakeKube):
        def patch_pod_annotations_many(self, patches):
            time.sleep(0.01)  # holds the leader while followers pile up
            return super().patch_pod_annotations_many(patches)

    kube = SlowKube()
    n = 12
    for i in range(n):
        kube.create_pod(pkg.pod(f"p{i}", f"u{i}"))
    b = pkg.DecisionBatcher(kube)
    sizes, lock = [], threading.Lock()

    def write(i):
        got = b.write("default", f"p{i}", {"k": str(i)})
        with lock:
            sizes.append(got)

    threads = [threading.Thread(target=write, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    values = [kube.get_pod("default", f"p{i}")["metadata"]["annotations"][
        "k"] for i in range(n)]
    return dict(n=len(sizes), writes=b.writes, grouped=b.batches < n,
                largest_over_1=max(sizes) > 1, values=values)


def test_concurrent_writers_share_batches():
    got = {side: concurrent_writers(PKGS[side]) for side in SIDES}
    assert got["port"] == got["jax"] == dict(
        n=12, writes=12, grouped=True, largest_over_1=True,
        values=[str(i) for i in range(12)])


def one_bad(pkg):
    class FlakyKube(pkg.FakeKube):
        def patch_pod_annotations(self, ns, name, anns, **kw):
            if name == "bad":
                raise RuntimeError("apiserver said no")
            return super().patch_pod_annotations(ns, name, anns, **kw)

    kube = FlakyKube()
    kube.create_pod(pkg.pod("good", "g"))
    kube.create_pod(pkg.pod("bad", "b"))
    b = pkg.DecisionBatcher(kube)
    results = {}

    def write(name):
        try:
            results[name] = b.write("default", name, {"k": "v"})
        except RuntimeError as e:
            results[name] = e

    threads = [threading.Thread(target=write, args=(n,))
               for n in ("good", "bad")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    return {n: type(r).__name__ for n, r in sorted(results.items())}


def test_one_failure_does_not_poison_the_batch():
    got = {side: one_bad(PKGS[side]) for side in SIDES}
    assert got["port"] == got["jax"] == {"bad": "RuntimeError",
                                         "good": "int"}


def leader_death(pkg):
    entered = threading.Event()

    class DyingKube(pkg.FakeKube):
        def patch_pod_annotations_many(self, patches):
            entered.set()
            time.sleep(0.05)  # lets a follower pile onto the queue
            raise KeyboardInterrupt

    b = pkg.DecisionBatcher(DyingKube())
    outcomes = {}

    def writer(name, wait_for_leader):
        if wait_for_leader:
            entered.wait(5)
        try:
            b.write("default", name, {"k": "v"})
            outcomes[name] = None
        except BaseException as e:  # noqa: BLE001 — the point
            outcomes[name] = type(e).__name__

    threads = [threading.Thread(target=writer, args=("a", False)),
               threading.Thread(target=writer, args=("b", True))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive(), "a writer wedged on a dead leader"
    return dict(a=outcomes["a"] is not None, b=outcomes["b"] is not None,
                leader_active=b._leader_active)


def test_leader_death_releases_inflight_followers():
    got = {side: leader_death(PKGS[side]) for side in SIDES}
    assert got["port"] == got["jax"] == dict(a=True, b=True,
                                             leader_active=False)


def bulk_writes(pkg, mode):
    """``DecisionBatcher.write_many`` on a cycle's three patches: the
    outcomes an entry, the counters and the sizer's next size."""

    class Kube(pkg.FakeKube):
        def patch_pod_annotations(self, ns, name, anns, **kw):
            if name == "bad":
                raise RuntimeError("apiserver said no")
            return super().patch_pod_annotations(ns, name, anns, **kw)

        def patch_pod_annotations_many(self, patches):
            if mode == "transport":
                raise ConnectionError("apiserver gone")
            if mode == "short":
                return [None]
            return super().patch_pod_annotations_many(patches)

    kube = Kube()
    for name in ("a", "bad", "c"):
        kube.create_pod(pkg.pod(name, f"u{name}"))
    b = pkg.DecisionBatcher(kube)
    out = b.write_many([("default", n, {"k": n}) for n in ("a", "bad", "c")])
    return dict(
        outcomes=[None if e is None else type(e).__name__ for e in out],
        written=[kube.get_pod("default", n)["metadata"]["annotations"].get(
            "k") for n in ("a", "bad", "c")],
        batches=b.batches, writes=b.writes, size=b.sizer.size())


@pytest.mark.parametrize("mode", ["entries", "transport", "short"])
def test_write_many_gives_one_outcome_an_entry(mode):
    """A cycle's bulk write: a failed entry never fails another; a
    transport failure, or an override that returns a short list, fails
    every entry; each call is one batch of three writes either way."""
    got = {side: bulk_writes(PKGS[side], mode) for side in SIDES}
    assert got["port"] == got["jax"]
    want = {"entries": [None, "RuntimeError", None],
            "transport": ["ConnectionError"] * 3,
            "short": ["RuntimeError"] * 3}[mode]
    assert got["port"]["outcomes"] == want
    assert (got["port"]["batches"], got["port"]["writes"]) == (1, 3)
    if mode == "entries":
        assert got["port"]["written"] == ["a", None, "c"]


def bulk_rollback(pkg, built):
    class Kube(pkg.FakeKube):
        def patch_pod_annotations(self, ns, name, anns, **kw):
            if name == "p1" and "vtpu.dev/assigned-node" in anns:
                raise RuntimeError("apiserver said no")
            return super().patch_pod_annotations(ns, name, anns, **kw)

    kube = Kube()
    s = pkg.Scheduler(kube, pkg.Config(filter_batch=True))
    built.append(s)
    names = ["node-a", "node-b"]
    for n in names:
        pkg.register_node(s, n)
    kube.watch_pods(s.on_pod_event)
    items = []
    for i in range(3):
        p = pkg.pod(f"p{i}", f"u{i}", mem="1000")
        kube.create_pod(p)
        items.append((p, names))
    rs = s.filter_many(items)
    return dict(nodes=[r.node is not None for r in rs],
                errors=[r.error.split(":")[0] for r in rs],
                grants=[s.pods.get(f"u{i}") is not None for i in range(3)],
                failures=dict(s.decision_write_failures),
                writes=s.decision_writes_total, cycles=s.batch.stats.cycles)


def test_a_failed_bulk_write_rolls_back_only_its_own_grant(built):
    got = {side: bulk_rollback(PKGS[side], built) for side in SIDES}
    assert got["port"] == got["jax"] == dict(
        nodes=[True, False, True],
        errors=["", "writing decision failed", ""],
        grants=[True, False, True], failures={"transport": 1}, writes=3,
        cycles=1)


def rollback(pkg, built):
    class PatchlessKube(pkg.FakeKube):
        def patch_pod_annotations(self, ns, name, anns, **kw):
            raise RuntimeError("apiserver down")

    kube = PatchlessKube()
    s = pkg.Scheduler(kube, pkg.Config())
    built.append(s)
    pkg.register_node(s, "node-a")
    p = pkg.pod("p", "u")
    kube.create_pod(p)
    r = s.filter(p, ["node-a"])
    return dict(error=r.error.split(":")[0], grant=s.pods.get("u"),
                failures=dict(s.decision_write_failures),
                writes=s.decision_writes_total)


def test_failed_decision_write_still_rolls_back_grant(built):
    got = {side: rollback(PKGS[side], built) for side in SIDES}
    assert got["port"] == got["jax"] == dict(
        error="writing decision failed", grant=None,
        failures={"transport": 1}, writes=1)


# -- serial and optimistic ----------------------------------------------------------------
def fill(side, built, optimistic):
    pkg = PKGS[side]
    kube, s, names = make_env(pkg, built, n_nodes=2,
                              optimistic_commit=optimistic)
    out = []
    for i in range(2 * CHIPS_PER_NODE + 1):
        p = pkg.pod(f"p{i}", f"u{i}", mem=str(CHIP_MIB))
        kube.create_pod(p)
        out.append(s.filter(p, names).node is not None)
    return dict(placed=out, overbooked=overbooked(s))


@pytest.mark.parametrize("optimistic", [True, False])
def test_same_placements_either_mode(optimistic, built):
    """Both decide paths enforce the same fit: eight whole cards place,
    the ninth does not, on each package."""
    want = dict(placed=[True] * 8 + [False], overbooked=[])
    for side in SIDES:
        assert fill(side, built, optimistic) == want


def distinct_scores(side, built, optimistic, policy):
    """Pods of different sizes on a fleet pre-loaded so that the nodes'
    scores stay more than 1% apart (node k holds 6000 MiB on each of its
    first k cards; the pods add 4500 MiB in all): no near-ties, so the
    optimistic pick is the serial one."""
    pkg = PKGS[side]
    kube, s, names = make_env(pkg, built, n_nodes=4,
                              node_scheduler_policy=policy,
                              optimistic_commit=optimistic)
    for k, n in enumerate(names):
        for c in range(k):
            rival(pkg, s, f"pre-{n}-{c}", n, mem=6000, chip=c)
    out = []
    for i, mem in enumerate(("1000", "500", "1500", "700", "800")):
        p = pkg.pod(f"p{i}", f"u{i}", mem=mem)
        kube.create_pod(p)
        r = s.filter(p, names)
        out.append([r.node, s.pods.get(f"u{i}").devices[0][0].uuid
                    if r.node else None])
    return out


@pytest.mark.parametrize("policy", ["spread", "binpack"])
def test_optimistic_equals_serial_without_near_ties(policy, built):
    """Each package's optimistic path against its own serial path, and the
    two packages against each other, where no two scores are within 1%."""
    got = {(side, opt): distinct_scores(side, built, opt, policy)
           for side in SIDES for opt in (True, False)}
    assert len({repr(v) for v in got.values()}) == 1, got


# -- the near-best scatter -------------------------------------------------------------------
def near_best_set(pkg, s, p, names):
    """The candidates within 1% of the best score on the package's own
    snapshot and fit (the JAX rule, read off its score module)."""
    snap = s.snapshot()
    requests = None
    if pkg.name == "jax":
        from k8s_vgpu_scheduler_tpu.util.resources import container_requests
    else:
        from k8s_vgpu_scheduler_tpu_torch.util.resources import \
            container_requests
    requests = container_requests(p, s.cfg)
    scores = {}
    for n in names:
        cow = pkg.score.CowUsage(snap[n].usage)
        if pkg.score.fit_pod(requests, cow, snap[n].info.topology, {},
                             s.cfg.topology_policy) is not None:
            scores[n] = pkg.score.node_score(cow,
                                             s.cfg.node_scheduler_policy)
    s_max = max(scores.values())
    eps = 0.01 * max(1.0, abs(s_max))
    return {n for n, v in scores.items() if v >= s_max - eps}


@pytest.mark.parametrize("policy", ["spread", "binpack"])
def test_the_port_pick_lies_in_the_jax_near_best_set(policy, built):
    """Seeded near-tie fleets (equal nodes, a few small grants each): for
    every pod, the port's optimistic pick is one of the JAX package's
    near-best candidates on the same state, and is the candidate with the
    least ``zlib.crc32(uid + "\\0" + node)`` among them."""
    from k8s_vgpu_scheduler_tpu_torch.scheduler.core import Scheduler

    for seed in range(12):
        rng = random.Random(seed)
        sides = {side: make_env(PKGS[side], built, n_nodes=6,
                                node_scheduler_policy=policy)
                 for side in SIDES}
        loads = [[rng.choice((0, 0, 100, 200)) for _ in range(2)]
                 for _ in range(6)]
        for side, (kube, s, names) in sides.items():
            for k, n in enumerate(names):
                for c, mem in enumerate(loads[k]):
                    if mem:
                        rival(PKGS[side], s, f"pre-{n}-{c}", n, mem=mem)
        for i in range(4):
            mem = str(rng.choice((1000, 1500, 2000)))
            uid = f"s{seed}u{i}"
            jkube, js, jnames = sides["jax"]
            jp = PKGS["jax"].pod(f"p{i}", uid, mem=mem)
            near = near_best_set(PKGS["jax"], js, jp, jnames)
            tkube, ts_, tnames = sides["port"]
            tp = PKGS["port"].pod(f"p{i}", uid, mem=mem)
            tkube.create_pod(tp)
            r = ts_.filter(tp, tnames)
            assert r.node in near, (seed, i, r.node, near)
            assert r.node == min(near, key=lambda n: zlib.crc32(
                f"{uid}\0{n}".encode()))
            assert Scheduler.near_best_key(uid, r.node) == \
                zlib.crc32(f"{uid}\0{r.node}".encode())
            # The JAX side takes the port's pick, so both states move on
            # alike.
            js.pods.add_pod(PKGS["jax"].PodInfo(
                uid=uid, name=f"p{i}", namespace="default", node=r.node,
                devices=[[PKGS["jax"].ContainerDevice(
                    uuid=d.uuid, type=PKGS["jax"].ctype,
                    usedmem=d.usedmem, usedcores=d.usedcores)
                    for d in ctr] for ctr in ts_.pods.get(uid).devices]))


PICKS = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from tests.test_torch_concurrency import PKGS, make_env
out, built = {}, []
for side in ("port", "jax"):
    pkg = PKGS[side]
    kube, s, names = make_env(pkg, built, n_nodes=8,
                              node_scheduler_policy="binpack")
    picks = []
    for i in range(8):
        p = pkg.pod(f"p{i}", f"u{i}", mem="1000")
        kube.create_pod(p)
        picks.append(s.filter(p, names).node)
        s.pods.del_pod(f"u{i}")   # every pod sees the same empty fleet
    out[side] = picks
for s in built:
    s.close()
print(json.dumps(out))
"""


def test_the_port_pick_is_the_same_in_every_process():
    """Eight equal empty nodes under binpack (every node ties): the same
    pods Filtered in processes with PYTHONHASHSEED 1 and 2.  The port
    picks the same nodes in both; the JAX package's picks, keyed on the
    salted ``hash()``, differ."""
    import json

    got = []
    for seed in ("1", "2"):
        env = dict(os.environ, PYTHONHASHSEED=seed, JAX_PLATFORMS="cpu")
        res = subprocess.run([sys.executable, "-c", PICKS, str(ROOT)],
                             env=env, capture_output=True, text=True,
                             timeout=120, cwd=ROOT)
        assert res.returncode == 0, res.stderr[-2000:]
        got.append(json.loads(res.stdout.strip().splitlines()[-1]))
    assert got[0]["port"] == got[1]["port"]
    assert got[0]["port"] == [min((f"node-{k}" for k in range(8)),
                                  key=lambda n: zlib.crc32(
                                      f"u{i}\0{n}".encode()))
                              for i in range(8)]
    assert got[0]["jax"] != got[1]["jax"]
