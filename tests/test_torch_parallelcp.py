"""The port's multicore control plane (``parallelcp/``: the shared-memory
columnar segments and the solve worker processes) against the JAX
package's, on the CPU: ``tests/test_parallelcp.py``'s cases, each run on
both packages (``SIDES``), and the port's pooled answers held to the JAX
in-process answers on the same seeded fleets.

- the store and view round-trip every column bit for bit, views are
  read-only, and the generation counter fences every remap;
- a worker asked about a stale generation refuses, and the pool respawns
  it;
- a parent resize (a fleet rebuild, a new generation) is absorbed within
  one evaluation;
- the pool's row-sharded evaluation equals the in-process
  ``eval_class_full`` bit for bit, and any pool failure falls back to the
  in-process pass, so decisions are the same at every worker count,
  through crashes too.

Every case that starts a pool closes it and its store in teardown (the
``pools`` fixture), finds no segment of its own left in ``/dev/shm``, and
ends within ``POOL_LIMIT_S``; at most two workers a case (six xdist
workers may each run one).  The port's segments are named ``vgpu<pid>x<n>``
where the JAX package's are ``vtpu<pid>x<n>``.
"""

import copy
import logging
import os
import random
import time

import numpy as np
import pytest

from tests.test_torch_batch import (  # noqa: F401 (built: a fixture)
    S, SIDES, build_fleet, built, grants, random_anns, random_fleet,
    random_pod_stream, random_request)

#: Seconds a pool case may take, its workers' start (spawn) included.
POOL_LIMIT_S = 90.0
#: The per-attempt collection deadline the cases give their pools (the
#: pool's own default is 30 s).
EVAL_TIMEOUT_S = 20.0


def parallelcp(side):
    if side == "port":
        from k8s_vgpu_scheduler_tpu_torch import parallelcp as mod
    else:
        from k8s_vgpu_scheduler_tpu import parallelcp as mod
    return mod


@pytest.fixture
def pools():
    """Stores and pools a case makes: closed at its end, their segments
    checked gone, the case held to POOL_LIMIT_S."""
    made = []
    t0 = time.monotonic()
    yield made
    prefixes = []
    for obj in reversed(made):
        if hasattr(obj, "header_name"):
            prefixes.append(obj.prefix)
        obj.close()
    left = [f for f in os.listdir("/dev/shm")
            if any(f.startswith(p + "-") for p in prefixes)]
    assert not left, f"segments left behind: {left}"
    assert time.monotonic() - t0 < POOL_LIMIT_S


def shared_fleet(side, pools, rng, n_nodes):
    sd = S[side]
    store = parallelcp(side).SharedColumnStore()
    pools.append(store)
    fleet = sd.batch.ColumnarFleet(store=store)
    fleet.refresh(random_fleet(rng, sd, n_nodes=n_nodes))
    return store, fleet


def pool_of(side, pools, store, n=2):
    pool = parallelcp(side).SolveWorkerPool(store, n)
    pool.EVAL_TIMEOUT_S = EVAL_TIMEOUT_S
    pools.append(pool)
    return pool


def make_ce(side, rng, multi=False):
    sd = S[side]
    req = random_request(rng, sd, multi=multi)
    affinity = sd.pkg.score.parse_affinity(random_anns(rng, sd))
    return sd.batch._ClassEval(req, affinity, binpack=False)


def reference(side, fleet, ce):
    """The in-process evaluation of a fresh copy of ``ce``."""
    sd = S[side]
    ref = sd.batch._ClassEval(ce.req, ce.affinity, ce.binpack)
    sd.batch.eval_class_full(fleet, ref)
    return ref


class TestSharedColumns:
    @pytest.mark.parametrize("side", SIDES)
    def test_store_view_roundtrip_readonly_and_live(self, side, pools):
        mod = parallelcp(side)
        store = mod.SharedColumnStore()
        pools.append(store)
        arrs = store.alloc(3, 2)
        arrs["used_mem"][:] = [[1, 2], [3, 4], [5, 6]]
        arrs["base"][:] = [0.5, 1.5, 2.5]
        arrs["alive"][:] = [True, False, True]
        view = mod.SharedColumnView(store.header_name)
        try:
            got = view.ensure(store.generation)
            for name in ("used_mem", "base", "alive"):
                np.testing.assert_array_equal(got[name], arrs[name])
            assert not got["used_mem"].flags.writeable
            # The same segment: a parent cell write shows without a remap.
            arrs["used_mem"][0, 0] = 42
            assert got["used_mem"][0, 0] == 42
        finally:
            view.close()

    @pytest.mark.parametrize("side", SIDES)
    def test_generation_fence_on_resize(self, side, pools):
        mod = parallelcp(side)
        store = mod.SharedColumnStore()
        pools.append(store)
        store.alloc(2, 2)
        view = mod.SharedColumnView(store.header_name)
        try:
            view.ensure(store.generation)
            old = store.generation
            store.alloc(5, 3)
            with pytest.raises(mod.StaleGeneration):
                view.ensure(old)
            with pytest.raises(mod.StaleGeneration):
                view.ensure(store.generation + 1)
            assert view.ensure(store.generation)["used_mem"].shape == (5, 3)
            assert (view.n, view.c) == (5, 3)
        finally:
            view.close()

    @pytest.mark.parametrize("side", SIDES)
    def test_fleet_alloc_through_store_bumps_generation(self, side, pools):
        store, fleet = shared_fleet(side, pools, random.Random(2), 4)
        g1 = store.generation
        assert g1 >= 1
        assert fleet.used_mem is store.arrays["used_mem"]
        fleet.set_gates([True] * fleet.N, [0.0] * fleet.N)
        np.testing.assert_array_equal(store.arrays["alive"],
                                      np.ones(fleet.N, bool))
        np.testing.assert_array_equal(store.arrays["base"],
                                      np.asarray(fleet.base))
        fleet.refresh(random_fleet(random.Random(3), S[side], n_nodes=7))
        assert store.generation == g1 + 1
        assert store.arrays["used_mem"].shape[0] == 7

    def test_the_layouts_and_names_are_the_jax_ones_but_the_prefix(self,
                                                                   pools):
        """The same columns at the same offsets; the port's segments and
        header magic name the port."""
        port, jax = parallelcp("port"), parallelcp("jax")
        assert port.shmem.COLUMN_SPECS == jax.shmem.COLUMN_SPECS
        assert port.shmem._layout(7, 3) == jax.shmem._layout(7, 3)
        a, b = port.SharedColumnStore(), jax.SharedColumnStore()
        pools.extend([a, b])
        assert a.prefix.startswith(f"vgpu{os.getpid()}x")
        assert b.prefix.startswith(f"vtpu{os.getpid()}x")
        assert port.shmem.HEADER_MAGIC == b"VGPUCOL1"
        assert sorted(f for f in os.listdir("/dev/shm")
                      if f.startswith(a.prefix + "-")) == [a.header_name]


class TestSolveWorkerPool:
    @pytest.mark.parametrize("side", SIDES)
    @pytest.mark.parametrize("seed", range(3))
    def test_pool_eval_bit_identical_to_in_process(self, seed, side,
                                                   pools):
        rng = random.Random(100 + seed)
        store, fleet = shared_fleet(side, pools, rng, 10)
        pool = pool_of(side, pools, store)
        for trial in range(6):
            ce = make_ce(side, rng, multi=rng.random() < 0.3)
            ref = reference(side, fleet, ce)
            assert pool.eval_class(fleet, ce), (seed, trial)
            assert (ce.score, ce.chip, ce.mem, ce.allowed) == \
                (ref.score, ref.chip, ref.mem, ref.allowed)
        assert (pool.evals_offloaded, pool.restarts_total) == (6, 0)

    @pytest.mark.parametrize("seed", range(2))
    def test_the_port_pool_equals_the_jax_in_process_pass(self, seed,
                                                          pools):
        """The port's pooled evaluation of a seeded fleet equals the JAX
        package's in-process evaluation of the same fleet, bit for
        bit."""
        got = {}
        for side in SIDES:
            rng = random.Random(150 + seed)
            if side == "port":
                store, fleet = shared_fleet(side, pools, rng, 12)
                pool = pool_of(side, pools, store)
            else:
                fleet = S[side].batch.ColumnarFleet()
                fleet.refresh(random_fleet(rng, S[side], n_nodes=12))
            out = []
            for _ in range(5):
                ce = make_ce(side, rng, multi=rng.random() < 0.3)
                if side == "port":
                    assert pool.eval_class(fleet, ce)
                else:
                    S[side].batch.eval_class_full(fleet, ce)
                out.append((ce.score, ce.chip if ce.nums <= 1 else None,
                            ce.mem if ce.nums <= 1 else None))
            got[side] = out
        assert got["port"] == got["jax"]

    @pytest.mark.parametrize("side", SIDES)
    def test_small_fleet_stays_in_process(self, side, pools):
        rng = random.Random(9)
        store, fleet = shared_fleet(side, pools, rng, 3)
        pool = pool_of(side, pools, store)
        assert not pool.eval_class(fleet, make_ce(side, rng))
        assert pool.alive_count() == 0

    @pytest.mark.parametrize("side", SIDES)
    def test_stale_generation_refused_then_respawned(self, side, pools):
        rng = random.Random(21)
        store, fleet = shared_fleet(side, pools, rng, 10)
        pool = pool_of(side, pools, store)
        assert pool.eval_class(fleet, make_ce(side, rng))
        before = pool.restarts_total
        assert not pool.eval_class(fleet, make_ce(side, rng),
                                   gen=store.generation + 7)
        assert pool.restarts_total > before
        assert pool.eval_fallbacks == 1
        ce = make_ce(side, rng)
        ref = reference(side, fleet, ce)
        assert pool.eval_class(fleet, ce)
        assert ce.score == ref.score

    @pytest.mark.parametrize("side", SIDES)
    def test_crashed_worker_respawns_and_serves(self, side, pools):
        rng = random.Random(31)
        store, fleet = shared_fleet(side, pools, rng, 10)
        pool = pool_of(side, pools, store)
        assert pool.eval_class(fleet, make_ce(side, rng))
        pool._procs[0].kill()
        pool._procs[0].join(timeout=5.0)
        ce = make_ce(side, rng)
        ref = reference(side, fleet, ce)
        assert pool.eval_class(fleet, ce)
        assert ce.score == ref.score
        assert pool.restarts_total >= 1
        assert pool.alive_count() == 2

    @pytest.mark.parametrize("side", SIDES)
    def test_parent_resize_remaps_workers_within_one_cycle(self, side,
                                                           pools):
        rng = random.Random(41)
        store, fleet = shared_fleet(side, pools, rng, 9)
        pool = pool_of(side, pools, store)
        assert pool.eval_class(fleet, make_ce(side, rng))
        g1 = store.generation
        assert all(p[2] == g1 for p in pool.ping())
        fleet.refresh(random_fleet(random.Random(42), S[side], n_nodes=14))
        g2 = store.generation
        assert g2 == g1 + 1
        before = pool.restarts_total
        ce = make_ce(side, rng)
        ref = reference(side, fleet, ce)
        assert pool.eval_class(fleet, ce)
        assert ce.score == ref.score
        assert pool.restarts_total == before
        assert all(p[2] == g2 for p in pool.ping())

    @pytest.mark.parametrize("side", SIDES)
    def test_perfz_export_shape(self, side, pools):
        rng = random.Random(51)
        store, fleet = shared_fleet(side, pools, rng, 10)
        pool = pool_of(side, pools, store)
        assert pool.eval_class(fleet, make_ce(side, rng))
        doc = pool.export()
        assert (doc["configured"], doc["workers"],
                doc["evals_offloaded"]) == (2, 2, 1)
        assert len(doc["per_worker"]) == 2
        assert doc["per_worker"][0]["evals"] >= 1
        assert doc["per_worker"][0]["p99_ms"] >= 0.0


class TestSchedulerEndToEnd:
    """``solve_workers`` through the whole batched Filter: the decisions
    (node, cards, MiB, cores) equal those of ``solve_workers`` 0."""

    def _run(self, side, built, workers, n_nodes=12, n_pods=40, seed=77):
        logging.disable(logging.CRITICAL)
        try:
            kube, s, names = build_fleet(side, built, n_nodes=n_nodes,
                                         filter_batch=True,
                                         solve_workers=workers)
            pods = random_pod_stream(random.Random(seed), side, n_pods,
                                     multi_ok=True)
            for p in pods:
                kube.create_pod(copy.deepcopy(p))
            t0 = time.monotonic()
            results = s.filter_many([(copy.deepcopy(p), names)
                                     for p in pods])
            assert time.monotonic() - t0 < POOL_LIMIT_S
            out = [(r.node, grants(s, f"u{i}") if r.node else None)
                   for i, r in enumerate(results)]
            offloaded = s.batch.fleet.class_evals_offloaded
            perf = s.export_perf()["solve_workers"]
            s.close()
            return out, offloaded, perf
        finally:
            logging.disable(logging.NOTSET)

    @pytest.mark.parametrize("side", SIDES)
    def test_decisions_identical_at_every_worker_count(self, side, built):
        base, off0, perf0 = self._run(side, built, 0)
        pooled, off2, perf2 = self._run(side, built, 2)
        assert pooled == base
        assert off0 == 0 and perf0["configured"] == 0
        assert off2 > 0, "the pool never engaged"
        assert perf2["configured"] == 2
        assert perf2["evals_offloaded"] == off2

    def test_the_port_pooled_decisions_equal_the_jax_ones(self, built):
        port, off, _perf = self._run("port", built, 2)
        jax, _off, _perf = self._run("jax", built, 0)
        assert off > 0
        assert port == jax

    @pytest.mark.parametrize("side", SIDES)
    def test_scheduler_close_drains_pool(self, side, built):
        mod = parallelcp(side)
        logging.disable(logging.CRITICAL)
        try:
            pkg = S[side].pkg
            s = pkg.Scheduler(pkg.FakeKube(),
                              pkg.Config(filter_batch=True, solve_workers=2))
            pool = s.batch.pool
            assert pool is not None
            store = s.batch.fleet.store
            s.close()
            assert s.batch.pool is None
            assert pool.alive_count() == 0
            with pytest.raises(FileNotFoundError):
                mod.SharedColumnView(store.header_name)
            assert not [f for f in os.listdir("/dev/shm")
                        if f.startswith(store.prefix + "-")]
        finally:
            logging.disable(logging.NOTSET)
