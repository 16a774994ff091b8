"""The port's batched scheduling cycles (``scheduler/batch.py``: the
columnar fleet, the class evaluator, the joint solver, the batch gate and
the per-node group commit; ``Scheduler.filter_many``) against the JAX
package's, on the CPU: ``tests/test_scheduler_batch.py``'s five classes,
each case on both packages (``SIDES``), and the port held to the JAX
answer on the same seeded inputs.

- Columnar parity: the vector pass against ``score.fit_pod`` rule for
  rule, the scalar row pass against the vector pass bit for bit, and the
  port's columns against the JAX columns bit for bit; the port's vector
  pass (numpy, ``parallelcp/vector.py``) against its numpy-free scalar
  pass.
- Rejection-reason parity: ``node_reject_reason`` against
  ``score._reject_summary``, and the port's strings against the JAX ones.
- Decision parity: batched ``fifo`` equals the serial path grant for
  grant; batched ``fifo`` and ``regret`` decisions equal the JAX ones
  (the JAX batch snapshot read in registry order, as
  ``tests/test_torch_gang.py``'s ``ordered_snapshot`` orders
  ``snapshot()``); the regret-beats-argmax fixture.
- Churn parity: the cached class columns equal a cold rebuild after any
  interleaving of completions, inventory flips and commits, with each
  changed row counted on the path it took.
- The batch protocol: the lost group commit's fallback, the lease gate,
  the gate's aggregation, the per-pod shapes, the slice stage, the
  fallback reasons and their family, a mesh on a fleet without a fabric,
  the fair-share order, the held and alien pods.

The class fingerprint leaves the declared ``vtpu.dev/mesh`` out in both
packages, while the port's per-pod fit cache keys it (a stated departure
of the per-pod path, tests/test_torch_concurrency.py).  A one-card pod's
fit ignores its mesh on every path, and a multi-card mesh pod goes to the
slice stage, so the batched answer equals the per-pod one in each package:
``test_a_one_card_mesh_pod_gets_the_per_pod_answer`` shows both answers.

The name map: ``NVIDIA-h100``/``NVIDIA-a100`` for ``TPU-v5e``/``TPU-v4``,
``nvidia.com/use-gputype``/``nouse-gputype`` for ``vtpu.dev/use-tputype``/
``nouse-tputype``, ``nvidia.com/gpu*`` for ``google.com/tpu*``.
"""

import copy
import itertools
import random
import threading
import time
import types

import pytest

from tests.test_torch_concurrency import PKGS, SIDES, overbooked

NEG_INF = float("-inf")


def side_of(name: str):
    """One package's modules and names for this test."""
    pkg = PKGS[name]
    if name == "port":
        from k8s_vgpu_scheduler_tpu_torch.scheduler import batch
        from k8s_vgpu_scheduler_tpu_torch.scheduler import metrics
        from k8s_vgpu_scheduler_tpu_torch.scheduler.core import SnapEntry
        from k8s_vgpu_scheduler_tpu_torch.util import resources
        types_ = ("NVIDIA-h100", "NVIDIA-a100")
        use, nouse = "nvidia.com/use-gputype", "nvidia.com/nouse-gputype"
        tokens = ("h100", "a100")
    else:
        from k8s_vgpu_scheduler_tpu.scheduler import batch
        from k8s_vgpu_scheduler_tpu.scheduler import metrics
        from k8s_vgpu_scheduler_tpu.scheduler.core import SnapEntry
        from k8s_vgpu_scheduler_tpu.util import resources
        types_ = ("TPU-v5e", "TPU-v4")
        use, nouse = "vtpu.dev/use-tputype", "vtpu.dev/nouse-tputype"
        tokens = ("v5e", "v4")
    return types.SimpleNamespace(
        pkg=pkg, name=name, batch=batch, metrics=metrics,
        SnapEntry=SnapEntry, resources=resources, types=types_, use=use,
        nouse=nouse, tokens=tokens, res=pkg.res)


S = {name: side_of(name) for name in SIDES}


@pytest.fixture
def built():
    """Every scheduler a case builds, closed at its end."""
    made = []
    yield made
    for s in made:
        s.close()


# -- seeded inputs ------------------------------------------------------------------

def random_fleet(rng, side, n_nodes=None):
    """A seeded snapshot: nodes with random card counts and sizes and
    random usage.  The draws do not depend on the side, so both packages
    get the same fleet in their own names."""
    snap = {}
    pkg = side.pkg
    for n in range(n_nodes or rng.randint(2, 8)):
        name = f"node-{n}"
        chips = rng.randint(1, 6)
        devmem = rng.choice([8000, 16384, 24000])
        ctype = side.types[rng.randrange(2)]
        usage = {}
        devices = []
        for c in range(chips):
            cid = f"{name}-chip-{c}"
            devices.append(pkg.DeviceInfo(
                id=cid, count=10, devmem=devmem, type=ctype,
                health=True, coords=(c, 0)))
            used_slots = rng.randint(0, 9)
            usage[cid] = pkg.score.DeviceUsage(
                id=cid, type=ctype, health=rng.random() > 0.1,
                coords=(c, 0), total_slots=10, used_slots=used_slots,
                total_mem=devmem,
                used_mem=rng.randint(0, devmem) if used_slots else 0,
                total_cores=100,
                used_cores=rng.choice([0, 15, 30, 60]) if used_slots
                else 0)
        info = pkg.NodeInfo(name=name, devices=devices, topology=None)
        snap[name] = side.SnapEntry((1, 1), info, usage)
    return snap


def random_request(rng, side, multi=False):
    nums = rng.randint(2, 4) if multi else 1
    if rng.random() < 0.3:
        memreq, pct = 0, rng.choice([10, 25, 50, 100])
    else:
        memreq, pct = rng.choice([500, 2000, 8000, 16384]), 0
    cores = rng.choice([0, 15, 30, 100])
    return side.pkg.ContainerDeviceRequest(
        nums=nums, type="X", memreq=memreq, mem_percentage_req=pct,
        coresreq=cores)


def random_anns(rng, side):
    r = rng.random()
    if r < 0.2:
        return {side.use: side.tokens[0]}
    if r < 0.3:
        return {side.nouse: side.tokens[1]}
    return {}


def fleet_of(side, snap):
    fleet = side.batch.ColumnarFleet()
    fleet.refresh(snap)
    return fleet


# -- columnar parity ------------------------------------------------------------------

class TestColumnarParity:
    """The vector pass against score.fit_pod, rule for rule."""

    @pytest.mark.parametrize("side", SIDES)
    @pytest.mark.parametrize("seed", range(8))
    def test_fit_and_chip_choice_match_fit_pod(self, seed, side):
        sd = S[side]
        score = sd.pkg.score
        rng = random.Random(seed)
        snap = random_fleet(rng, sd)
        fleet = fleet_of(sd, snap)
        for trial in range(12):
            req = random_request(rng, sd, multi=rng.random() < 0.3)
            anns = random_anns(rng, sd)
            ce = sd.batch._ClassEval(req, score.parse_affinity(anns),
                                     binpack=False)
            sd.batch.eval_class_full(fleet, ce)
            for row, name in enumerate(fleet.names):
                cow = score.CowUsage(snap[name].usage)
                placement = score.fit_pod([req], cow, None, anns,
                                          "best-effort")
                assert (ce.score[row] != NEG_INF) == \
                    (placement is not None), (seed, trial, name)
                if placement is None:
                    continue
                chips, mems = sd.batch.choose_chips(fleet, ce, row)
                assert [fleet.chip_ids[row][c] for c in chips] == \
                    [d.uuid for d in placement[0]]
                assert mems == [d.usedmem for d in placement[0]]
                assert abs(ce.score[row]
                           - score.node_score(cow, "spread")) < 1e-9

    @pytest.mark.parametrize("side", SIDES)
    @pytest.mark.parametrize("seed", range(4))
    def test_scalar_row_eval_matches_vector_eval_bitwise(self, seed, side):
        """The solver patches rows one at a time between whole-fleet
        passes: the two agree bit for bit, or a tie-break would depend on
        which path last scored a node."""
        sd = S[side]
        rng = random.Random(100 + seed)
        fleet = fleet_of(sd, random_fleet(rng, sd))
        for _ in range(8):
            req = random_request(rng, sd, multi=rng.random() < 0.3)
            ce = sd.batch._ClassEval(
                req, sd.pkg.score.parse_affinity(random_anns(rng, sd)),
                binpack=rng.random() < 0.5)
            sd.batch.eval_class_full(fleet, ce)
            vec = (list(ce.score), list(ce.chip), list(ce.mem))
            for row in range(fleet.N):
                sd.batch.eval_class_row(fleet, ce, row)
                assert ce.score[row] == vec[0][row], row
                if req.nums <= 1 and vec[0][row] != NEG_INF:
                    assert (ce.chip[row], ce.mem[row]) == \
                        (vec[1][row], vec[2][row])

    @pytest.mark.parametrize("seed", range(6))
    def test_the_port_columns_equal_the_jax_columns(self, seed):
        """The same seeded fleet and requests in each package's names:
        every row's score, card and MiB equal bit for bit, under both node
        policies."""
        got = {}
        for side in SIDES:
            sd = S[side]
            rng = random.Random(200 + seed)
            fleet = fleet_of(sd, random_fleet(rng, sd))
            rows = []
            for _ in range(10):
                req = random_request(rng, sd, multi=rng.random() < 0.3)
                ce = sd.batch._ClassEval(
                    req, sd.pkg.score.parse_affinity(random_anns(rng, sd)),
                    binpack=rng.random() < 0.5)
                sd.batch.eval_class_full(fleet, ce)
                rows.append((ce.score, ce.chip if req.nums <= 1 else None,
                             ce.mem if req.nums <= 1 else None))
            got[side] = (fleet.names, rows)
        assert got["port"] == got["jax"]

    @pytest.mark.parametrize("seed", range(4))
    def test_the_numpy_free_pass_gives_the_same_bits(self, seed):
        """The port's fleet without numpy columns (the extender's image
        installs no numpy) evaluates every row in scalar Python: the same
        scores, cards and MiB as its vectorized pass."""
        sd = S["port"]
        rng = random.Random(300 + seed)
        snap = random_fleet(rng, sd)
        vec = fleet_of(sd, snap)
        bare = sd.batch.ColumnarFleet()
        bare.vec = None
        bare._alloc(0, 1)
        bare.refresh(snap)
        assert vec.columns and not bare.columns
        for _ in range(10):
            req = random_request(rng, sd, multi=rng.random() < 0.3)
            aff = sd.pkg.score.parse_affinity(random_anns(rng, sd))
            binpack = rng.random() < 0.5
            a = sd.batch._ClassEval(req, aff, binpack)
            b = sd.batch._ClassEval(req, aff, binpack)
            sd.batch.eval_class_full(vec, a)
            sd.batch.eval_class_full(bare, b)
            assert a.score == b.score
            for row in range(vec.N):
                if a.score[row] != NEG_INF and req.nums <= 1:
                    assert (a.chip[row], a.mem[row]) == \
                        (b.chip[row], b.mem[row])


# -- rejection reasons ------------------------------------------------------------------

RULE_CASES = [
    ("unhealthy", dict(health=False), dict(), "none"),
    ("type-mismatch", dict(), dict(), "use-other"),
    ("slots-exhausted", dict(used_slots=10), dict(), "none"),
    ("cores-exhausted", dict(used_slots=1, used_cores=100), dict(), "none"),
    ("exclusive-chip-busy", dict(used_slots=1, used_cores=15),
     dict(coresreq=100), "none"),
    ("insufficient-cores", dict(used_slots=1, used_cores=30),
     dict(coresreq=80), "none"),
    ("insufficient-hbm", dict(used_slots=1, used_mem=15000),
     dict(memreq=8000), "none"),
    ("too-few-chips", dict(), dict(nums=2), "none"),
]


class TestRejectionReasonParity:
    """The columnar rejection reasons are the scalar path's strings."""

    @pytest.mark.parametrize("side", SIDES)
    @pytest.mark.parametrize("seed", range(8))
    def test_reason_strings_match_scalar_summary(self, seed, side):
        sd = S[side]
        score = sd.pkg.score
        rng = random.Random(9000 + seed)
        snap = random_fleet(rng, sd)
        fleet = fleet_of(sd, snap)
        rejections = 0
        for _ in range(16):
            req = random_request(rng, sd, multi=rng.random() < 0.3)
            anns = random_anns(rng, sd)
            affinity = score.parse_affinity(anns)
            for row, name in enumerate(fleet.names):
                usage = snap[name].usage
                if score.fit_pod([req], score.CowUsage(usage), None, anns,
                                 "best-effort") is not None:
                    continue
                rejections += 1
                assert sd.batch.node_reject_reason(
                    fleet, req, affinity, row) == \
                    score._reject_summary(req, usage, affinity)
        assert rejections > 0

    @pytest.mark.parametrize("seed", range(4))
    def test_the_port_reasons_equal_the_jax_reasons(self, seed):
        got = {}
        for side in SIDES:
            sd = S[side]
            rng = random.Random(9100 + seed)
            fleet = fleet_of(sd, random_fleet(rng, sd))
            out = []
            for _ in range(12):
                req = random_request(rng, sd, multi=rng.random() < 0.3)
                aff = sd.pkg.score.parse_affinity(random_anns(rng, sd))
                out.append([sd.batch.node_reject_reason(fleet, req, aff, r)
                            for r in range(fleet.N)])
            got[side] = out
        assert got["port"] == got["jax"]

    @pytest.mark.parametrize("side", SIDES)
    @pytest.mark.parametrize("token,chip,reqkw,anns", RULE_CASES,
                             ids=[c[0] for c in RULE_CASES])
    def test_each_scalar_rule_has_a_columnar_twin(self, token, chip, reqkw,
                                                  anns, side):
        sd = S[side]
        score = sd.pkg.score
        ctype = sd.types[0]
        usage = {"n0-chip-0": score.DeviceUsage(
            id="n0-chip-0", type=ctype, coords=(0, 0),
            health=chip.get("health", True), total_slots=10,
            used_slots=chip.get("used_slots", 0), total_mem=16384,
            used_mem=chip.get("used_mem", 0), total_cores=100,
            used_cores=chip.get("used_cores", 0))}
        info = sd.pkg.NodeInfo(name="n0", devices=[sd.pkg.DeviceInfo(
            id="n0-chip-0", count=10, devmem=16384, type=ctype,
            health=chip.get("health", True), coords=(0, 0))],
            topology=None)
        fleet = fleet_of(sd, {"n0": sd.SnapEntry((1, 1), info, usage)})
        req = sd.pkg.ContainerDeviceRequest(
            nums=reqkw.get("nums", 1), type="X",
            memreq=reqkw.get("memreq", 500), mem_percentage_req=0,
            coresreq=reqkw.get("coresreq", 0))
        a = {sd.use: sd.tokens[1]} if anns == "use-other" else {}
        affinity = score.parse_affinity(a)
        assert score.fit_pod([req], score.CowUsage(usage), None, a,
                             "best-effort") is None
        got = sd.batch.node_reject_reason(fleet, req, affinity, 0)
        assert got == score._reject_summary(req, usage, affinity)
        assert got.split(":", 1)[0] == token


# -- decisions ------------------------------------------------------------------------

def ordered_batch_snapshot(s):
    """The JAX batch engine's snapshot read in registry order (its
    snapshot dict follows a set of node names); the port's is in
    registry order already."""
    real = s.snapshot_for_batch

    def ordered():
        snap, changed = real()
        return ({n: snap[n] for n in s.nodes.list_nodes() if n in snap},
                changed)

    s.snapshot_for_batch = ordered


def build_fleet(side, built, n_nodes=4, chips=4, devmem=16384,
                topology=True, **cfg):
    sd = S[side]
    pkg = sd.pkg
    kube = pkg.FakeKube()
    s = pkg.Scheduler(kube, pkg.Config(**cfg))
    built.append(s)
    if side == "jax":
        ordered_batch_snapshot(s)
    names = [f"node-{i}" for i in range(n_nodes)]
    for n in names:
        kube.add_node({"metadata": {"name": n, "annotations": {}}})
        if topology:
            pkg.register_node(s, n, chips=chips, devmem=devmem)
        else:
            s.nodes.add_node(n, pkg.NodeInfo(name=n, devices=[
                pkg.DeviceInfo(id=f"{n}-chip-{i}", count=10, devmem=devmem,
                               type=sd.types[0], health=True, coords=(i, 0))
                for i in range(chips)], topology=None))
    kube.watch_pods(s.on_pod_event)
    return kube, s, names


def random_pod_stream(rng, side, n, multi_ok=False):
    res = S[side].res
    pods = []
    for i in range(n):
        limits = {res: str(rng.randint(2, 3)) if multi_ok
                  and rng.random() < 0.25 else "1"}
        if rng.random() < 0.3:
            limits[f"{res}mem-percentage"] = str(rng.choice([10, 25, 50]))
        else:
            limits[f"{res}mem"] = str(rng.choice([500, 2000, 4000, 8000]))
        if rng.random() < 0.5:
            limits[f"{res}cores"] = str(rng.choice([0, 15, 100]))
        pods.append({
            "metadata": {"name": f"p{i}", "namespace": "default",
                         "uid": f"u{i}",
                         "annotations": random_anns(rng, S[side])},
            "spec": {"containers": [
                {"name": "main", "resources": {"limits": limits}}]}})
    return pods


def grants(s, uid):
    """A pod's grant with the card types left out (the names differ)."""
    info = s.pods.get(uid)
    return [[(d.uuid, d.usedmem, d.usedcores) for d in c]
            for c in info.devices]


def batched_run(side, built, seed, solver, n_pods=40, multi_ok=True):
    rng = random.Random(1000 + seed)
    kube, s, names = build_fleet(
        side, built, n_nodes=rng.randint(2, 6), chips=rng.randint(2, 5),
        topology=False, filter_batch=True, batch_solver=solver)
    pods = random_pod_stream(rng, side, n_pods, multi_ok=multi_ok)
    items = []
    for pod in pods:
        kube.create_pod(copy.deepcopy(pod))
        items.append((copy.deepcopy(pod), names))
    results = s.filter_many(items)
    return s, names, pods, results


class TestDecisionParity:
    @pytest.mark.parametrize("side", SIDES)
    @pytest.mark.parametrize("seed", range(6))
    def test_batched_fifo_equals_serial_decisions(self, seed, side, built):
        """Batched fifo cycles against the serial path on the same fleet
        and pods in the same order: the same node, cards, MiB and cores
        for every placed pod."""
        rng = random.Random(1000 + seed)
        n_nodes, chips = rng.randint(2, 6), rng.randint(2, 5)
        kube_s, serial, names = build_fleet(
            side, built, n_nodes=n_nodes, chips=chips, topology=False,
            optimistic_commit=False)
        kube_b, batched, _ = build_fleet(
            side, built, n_nodes=n_nodes, chips=chips, topology=False,
            filter_batch=True, batch_solver="fifo")
        pods = random_pod_stream(rng, side, 40, multi_ok=True)
        items = []
        for pod in pods:
            kube_s.create_pod(copy.deepcopy(pod))
            kube_b.create_pod(copy.deepcopy(pod))
            items.append((copy.deepcopy(pod), names))
        rs = [serial.filter(copy.deepcopy(p), names) for p in pods]
        rb = batched.filter_many(items)
        for i, (a, b) in enumerate(zip(rs, rb)):
            assert a.node == b.node, (seed, i, a.node, b.node, b.error)
            if a.node is not None:
                assert grants(serial, f"u{i}") == grants(batched, f"u{i}")

    @pytest.mark.parametrize("solver", ["fifo", "regret"])
    @pytest.mark.parametrize("seed", range(6))
    def test_batched_decisions_equal_the_jax_ones(self, seed, solver,
                                                  built):
        """The same seeded fleet and pod stream through each package's
        filter_many: the same node and grant for every pod, under both
        solvers."""
        got = {}
        for side in SIDES:
            s, _names, pods, results = batched_run(side, built, seed, solver)
            got[side] = [(r.node, grants(s, f"u{i}") if r.node else None)
                         for i, r in enumerate(results)]
            assert s.batch.stats.cycles >= 1
            assert not overbooked(s)
        assert got["port"] == got["jax"]

    @pytest.mark.parametrize("side", SIDES)
    def test_regret_mode_places_everything_serial_places(self, side, built):
        rng = random.Random(7)
        kube_s, serial, names = build_fleet(side, built, n_nodes=6,
                                            topology=False,
                                            optimistic_commit=False)
        kube_b, batched, _ = build_fleet(side, built, n_nodes=6,
                                         topology=False, filter_batch=True,
                                         batch_solver="regret")
        pods = random_pod_stream(rng, side, 30)
        items = []
        for pod in pods:
            kube_s.create_pod(copy.deepcopy(pod))
            kube_b.create_pod(copy.deepcopy(pod))
            items.append((copy.deepcopy(pod), names))
        placed_serial = sum(1 for p in pods
                            if serial.filter(copy.deepcopy(p), names).node)
        placed = sum(1 for r in batched.filter_many(items) if r.node)
        assert placed >= placed_serial
        assert not overbooked(batched)

    @pytest.mark.parametrize("side", SIDES)
    def test_regret_beats_sequential_argmax_under_contention(self, side,
                                                             built):
        """A flexible pod yields the contended node to a pod that fits
        nowhere else: sequential argmax strands the picky pod, regret
        places both."""
        sd = S[side]
        pkg = sd.pkg

        def run(solver):
            kube = pkg.FakeKube()
            s = pkg.Scheduler(kube, pkg.Config(filter_batch=True,
                                               batch_solver=solver))
            built.append(s)
            for name, mib in (("node-big", 12000), ("node-small", 4000)):
                s.nodes.add_node(name, pkg.NodeInfo(name=name, devices=[
                    pkg.DeviceInfo(id=f"{name}-card", count=10, devmem=mib,
                                   type=sd.types[0], health=True,
                                   coords=(0, 0))], topology=None))
            kube.watch_pods(s.on_pod_event)
            names = ["node-big", "node-small"]
            flex = pkg.pod("flex", "flex", mem="3500")
            picky = pkg.pod("picky", "picky", mem="9000")
            for p in (flex, picky):
                kube.create_pod(p)
            return [r.node for r in s.filter_many([(flex, names),
                                                   (picky, names)])]

        assert run("fifo") == ["node-big", None]
        assert run("regret") == ["node-small", "node-big"]

    def test_a_one_card_mesh_pod_gets_the_per_pod_answer(self, built):
        """The class fingerprint leaves the mesh out; a one-card pod's fit
        ignores it on every path.  A one-card pod declaring a mesh after a
        plain pod of the same request (same class) places as it does
        through the per-pod path, in each package, and the port's answer
        is the JAX one."""
        got = {}
        for side in SIDES:
            pkg = S[side].pkg
            answers = {}
            for mode in ("batched", "per-pod"):
                cfg = ({"filter_batch": True} if mode == "batched"
                       else {"optimistic_commit": False})
                kube, s, names = build_fleet(side, built, n_nodes=2, **cfg)
                plain = pkg.pod("plain", "up", mem="2000")
                mesh = pkg.pod("mesh", "um", mem="2000",
                               anns={"vtpu.dev/mesh": "1"})
                for p in (plain, mesh):
                    kube.create_pod(p)
                if mode == "batched":
                    rs = s.filter_many([(plain, names), (mesh, names)])
                    assert s.batch.stats.fallbacks == 0
                else:
                    rs = [s.filter(plain, names), s.filter(mesh, names)]
                answers[mode] = [(r.node, grants(s, u) if r.node else None)
                                 for r, u in zip(rs, ("up", "um"))]
            assert answers["batched"] == answers["per-pod"]
            assert all(n for n, _g in answers["batched"])
            got[side] = answers["batched"]
        assert got["port"] == got["jax"]


# -- churn ----------------------------------------------------------------------------

class Churn:
    def __init__(self, side, built, n_nodes=10, chips=4):
        self.sd = S[side]
        self.kube, self.s, self.names = build_fleet(
            side, built, n_nodes=n_nodes, chips=chips, filter_batch=True)
        self.placed = []
        self.seq = itertools.count()

    def place(self, n):
        pkg = self.sd.pkg
        items = []
        for _ in range(n):
            i = next(self.seq)
            pod = pkg.pod(f"c{i}", f"cu{i}", mem="500")
            self.kube.create_pod(pod)
            items.append((pod, self.names))
        for (pod, _o), r in zip(items, self.s.filter_many(items)):
            assert r.node, r.error
            self.placed.append((pod["metadata"]["name"], r.node))

    def sync(self):
        """A cycle's start: drain the deltas, snapshot, refresh, gate.
        Returns (snapshot, rows reloaded, rows patched)."""
        fleet = self.s.batch.fleet
        deltas = self.s.batch._drain_deltas()
        snap = self.s.snapshot()
        r0, p0 = fleet.rows_reloaded_total, fleet.rows_patched_total
        fleet.refresh(snap, deltas)
        self.s.batch._gate_rows()
        return (snap, fleet.rows_reloaded_total - r0,
                fleet.rows_patched_total - p0)

    def req(self):
        return self.sd.pkg.ContainerDeviceRequest(
            nums=1, type="X", memreq=500, mem_percentage_req=0, coresreq=0)

    def cold_parity(self, snap):
        """The cached columns against a cold fleet built from the same
        snapshot, bit for bit."""
        sd, s = self.sd, self.s
        fleet = s.batch.fleet
        req = self.req()
        affinity = sd.pkg.score.parse_affinity({})
        fp = sd.batch.class_fingerprint([req], {}, s.cfg.topology_policy)
        ce = fleet.class_eval(fp, req, affinity, binpack=False)
        cold = fleet_of(sd, snap)
        assert cold.names == fleet.names
        cold.alive = list(fleet.alive)
        cold.bonus = list(fleet.bonus)
        cold_ce = sd.batch._ClassEval(req, affinity, binpack=False)
        sd.batch.eval_class_full(cold, cold_ce)
        for row in range(fleet.N):
            assert ce.score[row] == cold_ce.score[row], row
            if ce.score[row] != NEG_INF:
                assert (ce.chip[row], ce.mem[row]) == \
                    (cold_ce.chip[row], cold_ce.mem[row])
        return [ce.score, ce.chip]

    def flip(self, node, unhealthy):
        pkg = self.sd.pkg
        self.s.nodes.add_node(node, pkg.NodeInfo(name=node, devices=[
            pkg.DeviceInfo(id=f"{node}-chip-{i}", count=10, devmem=16384,
                           type=self.sd.types[0],
                           health=not (unhealthy and i == 0),
                           coords=(i % 4, i // 4))
            for i in range(4)], topology=None))


class TestChurnParity:
    @pytest.mark.parametrize("side", SIDES)
    @pytest.mark.parametrize("seed", range(4))
    def test_interleaved_churn_matches_cold_rebuild(self, seed, side,
                                                    built):
        rng = random.Random(4000 + seed)
        env = Churn(side, built)
        flipped = {n: False for n in env.names}
        env.place(8)
        snap, _r, _p = env.sync()
        env.cold_parity(snap)
        for rnd in range(8):
            action = rng.choice(["complete", "flip", "commit", "mixed"])
            completions, flips = set(), set()
            if action in ("complete", "mixed") and env.placed:
                for _ in range(min(3, len(env.placed))):
                    name, node = env.placed.pop(
                        rng.randrange(len(env.placed)))
                    env.kube.delete_pod("default", name)
                    completions.add(node)
            if action in ("flip", "mixed"):
                node = rng.choice(env.names)
                flipped[node] = not flipped[node]
                env.flip(node, flipped[node])
                flips.add(node)
            if action == "commit":
                env.place(4)
            snap, reloaded, patched = env.sync()
            assert reloaded == len(flips), (rnd, action)
            assert patched == len(completions - flips), (rnd, action)
            env.cold_parity(snap)

    @pytest.mark.parametrize("seed", range(2))
    def test_the_port_churn_equals_the_jax_churn(self, seed, built):
        """The same churn script on both packages: the same counters
        after every round and the same cached columns."""
        got = {}
        for side in SIDES:
            rng = random.Random(4100 + seed)
            env = Churn(side, built)
            env.place(8)
            trail = []
            for _ in range(6):
                action = rng.choice(["complete", "flip", "commit"])
                if action == "complete" and env.placed:
                    name, _node = env.placed.pop(
                        rng.randrange(len(env.placed)))
                    env.kube.delete_pod("default", name)
                elif action == "flip":
                    env.flip(rng.choice(env.names), rng.random() < 0.5)
                else:
                    env.place(3)
                snap, reloaded, patched = env.sync()
                trail.append((action, reloaded, patched,
                              env.cold_parity(snap),
                              sorted(env.placed)))
            got[side] = trail
        assert got["port"] == got["jax"]

    @pytest.mark.parametrize("side", SIDES)
    def test_evict_readd_mid_cache_keeps_dirty_sets_correct(self, side,
                                                            built):
        """A node removed and added back while cached classes hold dirty
        rows: each rebuild drops the class cache whole (rows move), and
        the columns equal a cold rebuild after both moves."""
        env = Churn(side, built, n_nodes=6)
        s, fleet = env.s, env.s.batch.fleet
        env.place(12)
        snap, _r, _p = env.sync()
        env.cold_parity(snap)
        assert fleet._class_cache
        stale = dict(fleet._class_cache)
        for _ in range(3):
            name, _node = env.placed.pop()
            env.kube.delete_pod("default", name)
        env.sync()
        assert any(ce.pending for ce in fleet._class_cache.values())
        info = s.nodes.get_node(env.names[0])
        s.nodes.rm_node(env.names[0])
        rebuilds = fleet.rebuilds
        snap, _r, _p = env.sync()
        assert fleet.rebuilds == rebuilds + 1
        assert env.names[0] not in fleet.row_of
        assert not fleet._class_cache
        env.cold_parity(snap)
        survivors = [i for i, (_n, node) in enumerate(env.placed)
                     if node != env.names[0]]
        for i in sorted(survivors[:2], reverse=True):
            name, _node = env.placed.pop(i)
            env.kube.delete_pod("default", name)
        env.sync()
        assert any(ce.pending for ce in fleet._class_cache.values())
        s.nodes.add_node(env.names[0], info)
        snap, _r, _p = env.sync()
        assert fleet.rebuilds == rebuilds + 2
        assert env.names[0] in fleet.row_of
        assert not fleet._class_cache
        env.cold_parity(snap)
        for fp, ce in fleet._class_cache.items():
            assert stale.get(fp) is not ce

    @pytest.mark.parametrize("side", SIDES)
    def test_commit_round_adopts_without_reload(self, side, built):
        """A cycle's own grants force no reload at the next refresh (the
        group commit published what the columns hold)."""
        env = Churn(side, built, n_nodes=4)
        env.place(6)
        _snap, reloaded, patched = env.sync()
        assert (reloaded, patched) == (0, 0)

    @pytest.mark.parametrize("side", SIDES)
    def test_completion_write_through_counts_and_parity(self, side, built):
        """Deletes patch rows in place: no reload, no usage rebuild, and
        the patched columns equal a cold rebuild."""
        env = Churn(side, built, n_nodes=6)
        env.place(12)
        env.sync()
        rebuilds = env.s.usage_rebuilds
        nodes = set()
        for _ in range(6):
            name, node = env.placed.pop()
            env.kube.delete_pod("default", name)
            nodes.add(node)
        snap, reloaded, patched = env.sync()
        assert (reloaded, patched) == (0, len(nodes))
        assert env.s.usage_rebuilds == rebuilds
        env.cold_parity(snap)

    @pytest.mark.parametrize("side", SIDES)
    def test_a_delta_queue_past_its_cap_is_poisoned(self, side, built):
        """Past DELTA_CAP a node's queue is one None: the next refresh
        reloads the row instead of patching it, and the queue stays
        O(1)."""
        env = Churn(side, built, n_nodes=2)
        engine = env.s.batch
        cap = engine.DELTA_CAP
        for i in range(cap + 5):
            engine.note_delta("node-0", [], -1, (i + 1, 1))
        assert engine._pending_deltas["node-0"] == [None]
        engine.note_delta("node-0", [], -1, (999, 1))
        assert engine._pending_deltas["node-0"] == [None]
        engine.note_delta("node-1", [], -1, (2, 1))
        assert len(engine._pending_deltas["node-1"]) == 1


# -- the protocol -------------------------------------------------------------------------

class TestBatchProtocol:
    @pytest.mark.parametrize("side", SIDES)
    def test_lost_group_commit_falls_back_and_places(self, side, built,
                                                     monkeypatch):
        """A node whose revision moves between the cycle's snapshot and
        its group commit conflicts: the group is decided by the per-pod
        path, nothing is overbooked, and the columns' phantom grants are
        rolled back."""
        sd = S[side]
        pkg = sd.pkg
        kube, s, names = build_fleet(side, built, n_nodes=2,
                                     filter_batch=True)
        real_solve = sd.batch.solve
        fired = []

        def racing_solve(fleet, cohorts, n_jobs, solver, **kw):
            # (The JAX cycle also passes its provenance audit.)
            plan = real_solve(fleet, cohorts, n_jobs, solver, **kw)
            if not fired and any(plan):
                node = fleet.names[next(p[0] for p in plan if p)]
                fired.append(node)
                s.pods.add_pod(pkg.PodInfo(
                    uid="rival", name="rival", namespace="default",
                    node=node, devices=[[pkg.ContainerDevice(
                        uuid=f"{node}-chip-0", type=sd.types[0],
                        usedmem=1000, usedcores=0)]]))
            return plan

        monkeypatch.setattr(sd.batch, "solve", racing_solve)
        items = []
        for i in range(4):
            p = pkg.pod(f"p{i}", f"u{i}", mem="2000")
            kube.create_pod(p)
            items.append((p, names))
        results = s.filter_many(items)
        assert all(r.node for r in results)
        assert s.commit_conflicts >= 1 and s.batch.stats.conflicts >= 1
        assert s.batch.stats.fallback_reason_counts()["commit-conflict"] \
            >= 1
        assert not overbooked(s)
        total = sum(u.used_mem for usage in
                    s.inspect_all_nodes_usage().values()
                    for u in usage.values())
        assert total == 4 * 2000 + 1000

    @pytest.mark.parametrize("side", SIDES)
    def test_suspect_node_takes_no_batched_placements(self, side, built):
        pkg = S[side].pkg
        kube, s, names = build_fleet(side, built, n_nodes=2,
                                     filter_batch=True, lease_ttl_s=0.001,
                                     lease_grace_beats=0)
        s.leases.beat(names[0])
        time.sleep(0.01)
        p = pkg.pod("p", "u", mem="1000")
        kube.create_pod(p)
        r, = s.filter_many([(p, names)])
        assert r.node == names[1]
        if side == "port":
            # The JAX cycle records these only as provenance.
            job = s._route_batch(p, names)
            assert s.batch.batch_no_fit_reasons(job)[names[0]] == \
                s.leases.reject_reason(names[0])

    @pytest.mark.parametrize("side", SIDES)
    def test_gate_aggregates_concurrent_filters(self, side, built):
        """Concurrent Filters through the gate share cycles and all
        place."""
        pkg = S[side].pkg
        kube, s, names = build_fleet(side, built, n_nodes=4,
                                     filter_batch=True, batch_tick_ms=20)
        n = 12
        pods = [pkg.pod(f"p{i}", f"u{i}", mem="1000") for i in range(n)]
        for p in pods:
            kube.create_pod(p)
        results = [None] * n
        barrier = threading.Barrier(n)

        def submit(i):
            barrier.wait()
            results[i] = s.filter(pods[i], names)

        threads = [threading.Thread(target=submit, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive(), "filter wedged in the batch gate"
        assert all(r is not None and r.node for r in results)
        assert s.batch.stats.pods == n
        assert s.batch.stats.cycles < n
        assert not overbooked(s)
        assert s.export_perf()["queue"]["pending_depth"] == 0

    @pytest.mark.parametrize("side", SIDES)
    def test_non_batchable_shapes_use_per_pod_path(self, side, built):
        pkg = S[side].pkg
        res = S[side].res
        kube, s, names = build_fleet(side, built, n_nodes=2,
                                     filter_batch=True)
        gang = pkg.pod("g0", "g0u", mem="1000", anns={
            "vtpu.dev/pod-group": "team", "vtpu.dev/pod-group-total": "1"})
        kube.create_pod(gang)
        assert s.filter(gang, names).node is not None
        assert s.batch.stats.pods == 0
        multi = {"metadata": {"name": "mc", "namespace": "default",
                              "uid": "mcu", "annotations": {}},
                 "spec": {"containers": [
                     {"name": c, "resources": {"limits": {
                         res: "1", f"{res}mem": "1000"}}}
                     for c in ("a", "b")]}}
        kube.create_pod(multi)
        assert s.filter(multi, names).node is not None
        assert s.batch.stats.pods == 0
        assert len(s.pods.get("mcu").devices) == 2

    @pytest.mark.parametrize("side", SIDES)
    def test_multichip_on_topology_fleet_uses_slice_engine(self, side,
                                                           built):
        pkg = S[side].pkg
        kube, s, names = build_fleet(side, built, n_nodes=2,
                                     filter_batch=True)
        p = pkg.pod("p", "u", mem="1000", nums="2")
        kube.create_pod(p)
        r, = s.filter_many([(p, names)])
        assert r.node is not None
        assert (s.batch.stats.fallbacks, s.batch.stats.pods) == (0, 1)
        info = s.nodes.get_node(r.node)
        coords = sorted(dev.coords for dev in info.devices
                        for d in s.pods.get("u").devices[0]
                        if dev.id == d.uuid)
        assert coords == [(0, 0), (1, 0)]

    @pytest.mark.parametrize("side", SIDES)
    def test_slice_jobs_group_commit_with_vector_jobs(self, side, built):
        pkg = S[side].pkg
        kube, s, names = build_fleet(side, built, n_nodes=2,
                                     filter_batch=True)
        sl = pkg.pod("sl", "usl", mem="1000", nums="2")
        sg = pkg.pod("sg", "usg", mem="1000")
        for p in (sl, sg):
            kube.create_pod(p)
        rs = s.filter_many([(sl, names), (sg, names)])
        assert all(r.node for r in rs)
        assert s.batch.stats.fallbacks == 0
        assert s.batch.stats.fallback_reason_counts() == {}
        assert not overbooked(s)

    @pytest.mark.parametrize("side", SIDES)
    def test_fallback_reasons_counted_and_exported(self, side, built):
        sd = S[side]
        pkg = sd.pkg
        kube, s, names = build_fleet(side, built, n_nodes=1,
                                     filter_batch=True)
        many = pkg.pod("big", "ub", mem="1000", nums="64")
        fat = pkg.pod("fat", "uf", mem="999999")
        for p in (many, fat):
            kube.create_pod(p)
        rs = s.filter_many([(many, names), (fat, names)])
        assert all(r.node is None for r in rs)
        assert s.batch.stats.fallback_reason_counts() == {
            "slice-no-fit": 1, "no-fit": 1}
        text = metrics_text(side, s)
        assert 'vtpu_filter_batch_fallbacks_total{reason="slice-no-fit"} ' \
            '1.0' in text
        if side == "port":
            job = s._route_batch(fat, names)
            assert s.batch.batch_no_fit_reasons(job) == {
                names[0]: rs[1].failed[names[0]]}

    @pytest.mark.parametrize("side", SIDES)
    def test_mesh_on_topologyless_fleet_rejects_not_scatters(self, side,
                                                             built):
        sd = S[side]
        pkg = sd.pkg
        kube = pkg.FakeKube()
        s = pkg.Scheduler(kube, pkg.Config(filter_batch=True))
        built.append(s)
        kube.add_node({"metadata": {"name": "n0", "annotations": {}}})
        s.nodes.add_node("n0", pkg.NodeInfo(name="n0", devices=[
            pkg.DeviceInfo(id=f"n0-chip-{i}", count=10, devmem=16384,
                           type=sd.types[0], health=True, coords=())
            for i in range(4)], topology=None))
        kube.watch_pods(s.on_pod_event)
        p = pkg.pod("m", "um", mem="1000", nums="2",
                    anns={"vtpu.dev/mesh": "1x2"})
        kube.create_pod(p)
        r, = s.filter_many([(p, ["n0"])])
        assert r.node is None
        assert "topology-unverifiable" in (r.error or "") + \
            " ".join(r.failed.values())

    @pytest.mark.parametrize("side", SIDES)
    def test_fair_share_release_order_respected_in_drain(self, side,
                                                         built):
        """Governed pods of one drain are ranked in the admission loop's
        release order, not their arrival order."""
        sd = S[side]
        pkg = sd.pkg
        quota = ({"name": "q", "namespaces": ["default"], "weight": 1,
                  "quota": {"chips": 100}},)
        kube, s, names = build_fleet(side, built, n_nodes=1,
                                     filter_batch=True, quota_queues=quota)
        p0 = pkg.pod("p0", "u0", mem="1000")
        p1 = pkg.pod("p1", "u1", mem="1000")
        for p in (p0, p1):
            kube.create_pod(p)
            assert s.quota.gate(p, sd.resources.container_requests(
                p, s.cfg)) is not None
        s.quota.release("u1")
        s.quota.release("u0")
        assert (s.quota.release_seq_of("u1"),
                s.quota.release_seq_of("u0")) == (1, 2)
        jobs = [s._route_batch(p, names) for p in (p0, p1)]
        assert all(isinstance(j, sd.batch.BatchJob) for j in jobs)
        ranks = s.batch.fair_share_ranks(jobs)
        assert ranks == [1, 0]

    @pytest.mark.parametrize("side", SIDES)
    def test_batch_metrics_exported(self, side, built):
        pkg = S[side].pkg
        kube, s, names = build_fleet(side, built, n_nodes=2,
                                     filter_batch=True)
        p = pkg.pod("p", "u", mem="1000")
        kube.create_pod(p)
        assert s.filter_many([(p, names)])[0].node
        text = metrics_text(side, s)
        assert 'vtpu_filter_batch_size_bucket{le="1.0"} 1.0' in text
        assert "vtpu_filter_batch_cycle_seconds_sum" in text

    @pytest.mark.parametrize("side", SIDES)
    def test_filter_many_mirrors_filter_for_held_and_alien_pods(self, side,
                                                                built):
        pkg = S[side].pkg
        quota = ({"name": "q", "namespaces": ["default"], "weight": 1,
                  "quota": {"chips": 1}},)
        kube, s, names = build_fleet(side, built, n_nodes=1,
                                     filter_batch=True, quota_queues=quota)
        held = pkg.pod("held", "heldu", mem="1000")
        alien = {"metadata": {"name": "alien", "namespace": "default",
                              "uid": "alienu", "annotations": {}},
                 "spec": {"containers": [{"name": "c", "resources": {}}]}}
        kube.create_pod(held)
        r_held, r_alien = s.filter_many([(held, names), (alien, names)])
        assert r_held.node is None and "queue" in r_held.error
        assert r_alien.node is None and not r_alien.error

    @pytest.mark.parametrize("side", SIDES)
    def test_the_serial_path_never_batches(self, side, built):
        """With optimistic_commit off, filter_many decides every pod
        through the per-pod serial path: no cycle runs."""
        pkg = S[side].pkg
        kube, s, names = build_fleet(side, built, n_nodes=2,
                                     optimistic_commit=False,
                                     filter_batch=True)
        items = []
        for i in range(4):
            p = pkg.pod(f"p{i}", f"u{i}", mem="1000")
            kube.create_pod(p)
            items.append((p, names))
        assert all(r.node for r in s.filter_many(items))
        assert s.batch.stats.cycles == 0

    @pytest.mark.parametrize("side", SIDES)
    def test_the_leader_death_resolves_every_follower(self, side, built,
                                                      monkeypatch):
        """A cycle that raises in the gate's leader resolves its own and
        its followers' Filters with an error, and the gate leads again."""
        pkg = S[side].pkg
        kube, s, names = build_fleet(side, built, n_nodes=2,
                                     filter_batch=True, batch_tick_ms=30)
        pods = [pkg.pod(f"p{i}", f"u{i}", mem="1000") for i in range(4)]
        for p in pods:
            kube.create_pod(p)
        real = s.batch.decide_many
        calls = []

        def dying(jobs):
            calls.append(len(jobs))
            if len(calls) == 1:
                raise KeyboardInterrupt
            return real(jobs)

        monkeypatch.setattr(s.batch, "decide_many", dying)
        out = {}
        barrier = threading.Barrier(len(pods))

        def submit(i):
            barrier.wait()
            try:
                out[i] = s.filter(pods[i], names)
            except BaseException as e:  # noqa: BLE001 — the point
                out[i] = e

        threads = [threading.Thread(target=submit, args=(i,))
                   for i in range(len(pods))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive(), "a follower wedged on a dead leader"
        assert any(isinstance(v, BaseException) for v in out.values())
        assert s.batch._leader_active is False
        assert s.filter(pods[0], names).node is not None


def metrics_text(side, s) -> str:
    if side == "port":
        from k8s_vgpu_scheduler_tpu_torch.util import exposition
        return exposition.render(S[side].metrics.ClusterCollector(s)
                                 .collect())
    from tests.test_torch_metrics import jax_text
    return jax_text(S[side].metrics.ClusterCollector(s))
