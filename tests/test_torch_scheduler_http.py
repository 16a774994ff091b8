"""The port's webhook, HTTP routes and register stream against the JAX
package's, and the whole handshake of the port on the CPU.

- The webhook's JSONPatch for each case of the JAX package's webhook tests
  equals the JAX webhook's under the name table (``TPU_TASK_PRIORITY`` is
  the port's ``CUDA_TASK_PRIORITY``); the JAX webhook is given the port's
  resource names and scheduler name.
- ``/filter`` (both forms), ``/bind``, ``/webhook`` and ``/healthz`` over
  real HTTP on 127.0.0.1 answer with the JAX ExtenderServer's JSON, each
  server over a scheduler of its own package on the same fleet
  (``tests/test_torch_scheduler.py``'s Side).
- A ``vtpu.dev/mesh`` pod's admission, directly and over HTTP against
  each scheduler's registered fabrics, is refused (422) or admitted as
  the JAX webhook does it, with its message; an elastic mesh range is
  refused by name (ROADMAP A.5).
- The register stream runs over gRPC on a unix socket, from the port's
  DeviceRegister to the port's scheduler.
- The whole port on the mock NVML: ``chip_smoke.py``'s node-agent child,
  as the card runs it, with the mock as ``libnvidia-ml.so.1``: webhook,
  Filter, Bind and Allocate, bind phase ``success``, the lock released,
  no annotation written by the caller, and no torch.
"""

import base64
import copy
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

import chip_smoke
from k8s_vgpu_scheduler_tpu.scheduler import routes as jroutes
from k8s_vgpu_scheduler_tpu.scheduler import webhook as jwebhook
from k8s_vgpu_scheduler_tpu.util.config import Config as JConfig
from k8s_vgpu_scheduler_tpu.util.config import ResourceNames as JNames
from k8s_vgpu_scheduler_tpu_torch.cmd.scheduler import (
    build_config, parse_args, start_register_service)
from k8s_vgpu_scheduler_tpu_torch.deviceplugin import DeviceRegister
from k8s_vgpu_scheduler_tpu_torch.k8s import FakeKube
from k8s_vgpu_scheduler_tpu_torch.ops import _kernels
from k8s_vgpu_scheduler_tpu_torch.scheduler import Scheduler
from k8s_vgpu_scheduler_tpu_torch.scheduler import routes as troutes
from k8s_vgpu_scheduler_tpu_torch.scheduler import webhook as twebhook
from k8s_vgpu_scheduler_tpu_torch.tpulib import MockBackend
from k8s_vgpu_scheduler_tpu_torch.util import types as t
from k8s_vgpu_scheduler_tpu_torch.util.config import Config as TConfig
from tests.test_torch_scheduler import (FLEET, PORT_NAMES, TOPO_FLEET,
                                        Side, limits, pod)

ROOT = Path(__file__).resolve().parent.parent
JCFG = JConfig(resources=JNames(**PORT_NAMES), scheduler_name="vgpu-scheduler",
               optimistic_commit=False)
TCFG = TConfig(optimistic_commit=False)
TRACE = "ab" * 16


def as_port(patches: list) -> list:
    return json.loads(json.dumps(patches).replace("TPU_TASK_PRIORITY",
                                                  "CUDA_TASK_PRIORITY"))


def as_jax(obj):
    """A pod or review as the JAX webhook reads it, under the name table."""
    return json.loads(json.dumps(obj).replace("CUDA_TASK_PRIORITY",
                                              "TPU_TASK_PRIORITY"))


def with_env(p: dict, i: int, env: list) -> dict:
    p["spec"]["containers"][i]["env"] = env
    return p


WEBHOOK_CASES = {
    "priority_into_empty_env": pod("a", limits(mem=1000, prio=0)),
    "priority_beside_existing_env": with_env(
        pod("a", limits(mem=1000, prio=0)), 0, [{"name": "X", "value": "1"}]),
    "priority_already_set": with_env(
        pod("a", limits(mem=1000, prio=1)), 0,
        [{"name": "CUDA_TASK_PRIORITY", "value": "1"}]),
    "low_priority_gets_podinfo": pod("a", limits(mem=1000, prio=1),
                                     limits(prio=2)),
    "podinfo_beside_volumes_and_mounts": {
        **pod("a", limits(mem=1000, prio=3)),
        "spec": {"volumes": [{"name": "data", "emptyDir": {}}],
                 "containers": [{
                     "name": "c0", "env": [{"name": "X", "value": "1"}],
                     "volumeMounts": [{"name": "data", "mountPath": "/d"}],
                     "resources": {"limits": limits(mem=1000, prio=3)}}]}},
    "privileged": {**pod("a", limits(mem=1000, prio=1)),
                   "spec": {"containers": [{
                       "name": "c0", "securityContext": {"privileged": True},
                       "resources": {"limits": limits(mem=1000, prio=1)}}]}},
    "scheduler_name_already_set": {
        **pod("a", limits(mem=1000)),
        "spec": {"schedulerName": "vgpu-scheduler", "containers": [
            {"name": "c0", "resources": {"limits": limits(mem=1000)}}]}},
    "trace_id_into_no_annotations": {
        "metadata": {"name": "a", "namespace": "default", "uid": "u"},
        "spec": {"containers": [{"name": "c0", "resources": {
            "limits": limits(mem=1000)}}]}},
    "trace_id_kept": pod("a", limits(mem=1000),
                         anns={"vtpu.dev/trace-id": TRACE}),
    "non_gpu_pod": pod("a", None, {"cpu": "1", "nvidia.com/priority": "1"}),
    "bad_quantity": pod("a", limits(mem="lots", prio=1)),
    "qos_class": pod("a", limits(mem=1000),
                     anns={t.QOS_ANNOTATION: "latency-critical"}),
}


@pytest.mark.parametrize("name", sorted(WEBHOOK_CASES))
def test_webhook_patch_matches_jax(name):
    p = WEBHOOK_CASES[name]
    jinfo, tinfo = {}, {}
    want = jwebhook.mutate_pod(as_jax(p), JCFG, trace_id=TRACE, info=jinfo)
    got = twebhook.mutate_pod(copy.deepcopy(p), TCFG, trace_id=TRACE,
                              info=tinfo)
    assert got == as_port(want)
    assert tinfo.get("wants_gpu") == jinfo.get("wants_tpu")


def review(p: dict, uid: str = "r1") -> dict:
    return {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
            "request": {"uid": uid, "operation": "CREATE",
                        "namespace": "default", "object": p}}


def decoded(reply: dict) -> dict:
    """An AdmissionReview reply with its patch decoded and the issued
    trace id named (a fresh one each time)."""
    out = copy.deepcopy(reply)
    resp = out["response"]
    if "patch" in resp:
        ops = json.loads(base64.b64decode(resp["patch"]))
        for op in ops:
            if op["path"] == "/metadata/annotations/vtpu.dev~1trace-id":
                op["value"] = "<issued>"
            elif op["path"] == "/metadata/annotations" and \
                    "vtpu.dev/trace-id" in op["value"]:
                op["value"]["vtpu.dev/trace-id"] = "<issued>"
        resp["patch"] = ops
    return out


@pytest.mark.parametrize("name", sorted(WEBHOOK_CASES) + ["bad_qos",
                                                          "update"])
def test_admission_review_matches_jax(name):
    if name == "bad_qos":
        body = review(pod("a", limits(mem=1000),
                          anns={t.QOS_ANNOTATION: "gold"}))
    elif name == "update":
        body = review(pod("a", limits(mem=1000, prio=1)))
        body["request"]["operation"] = "UPDATE"
    else:
        body = review(WEBHOOK_CASES[name])
    want = jwebhook.handle_admission_review(as_jax(body), JCFG)
    got = twebhook.handle_admission_review(copy.deepcopy(body), TCFG)
    want = decoded(want)
    if "patch" in want["response"]:
        want["response"]["patch"] = as_port(want["response"]["patch"])
    assert decoded(got) == want


MESH_CASES = {
    "fits_a_ring": ("4", 4), "fits_the_grid": ("2x4", 8),
    "fits_no_fabric": ("2x2x2", 8), "bad_shape": ("2x", 2),
    "volume_mismatch": ("2x2", 2), "no_cards": ("2", 0),
    "too_many_axes": ("1x1x1x1x2", 2), "one_card": ("1", 1),
    "bad_quantity": ("2", "lots"),
}


def mesh_pod(value, nums):
    if nums == "lots":
        spec = limits(nums=2, mem="lots")
    else:
        spec = limits(nums=nums, mem=1000) if nums else {"cpu": "1"}
    return pod("m", spec, anns={t.MESH_ANNOTATION: value})


@pytest.mark.parametrize("fleet", ["fabrics", "lines", "none"])
@pytest.mark.parametrize("name", sorted(MESH_CASES))
def test_mesh_admission_matches_jax(name, fleet):
    """validate_pod_mesh and the AdmissionReview of a mesh pod, against
    the fabrics each package's scheduler registered (TOPO_FLEET, or
    FLEET's lines of 8), or none (the fleet check is skipped)."""
    if fleet == "none":
        topos = {False: None, True: None}
    else:
        topos = {port: Side(port, fleet=TOPO_FLEET if fleet == "fabrics"
                            else FLEET).s.known_topologies
                 for port in (False, True)}
    p = mesh_pod(*MESH_CASES[name])
    want = jwebhook.validate_pod_mesh(as_jax(p), JCFG, topos[False])
    got = twebhook.validate_pod_mesh(copy.deepcopy(p), TCFG, topos[True])
    assert got == (want and want.replace("TPU", "GPU"))
    jr = decoded(jwebhook.handle_admission_review(as_jax(review(p)), JCFG,
                                                  topos[False]))
    tr = decoded(twebhook.handle_admission_review(review(p), TCFG,
                                                  topos[True]))
    if "patch" in jr["response"]:
        jr["response"]["patch"] = as_port(jr["response"]["patch"])
    assert tr == json.loads(json.dumps(jr).replace("no TPU", "no GPU"))
    assert tr["response"]["allowed"] == (got is None)


@pytest.mark.parametrize("anns", [
    {"vtpu.dev/mesh-min": "2x2", "vtpu.dev/mesh-max": "2x4",
     t.MESH_ANNOTATION: "2x4"},
    {"vtpu.dev/mesh-max": "2x4"}], ids=["range", "max_only"])
def test_an_elastic_mesh_range_is_refused_by_name(anns):
    """A malformed elastic range (here on a pod of no gang, and a bound
    without its pair) is a 422 with the JAX webhook's message, which
    names the range's annotations (until the port's resize controller
    came, the port refused every range by name; tests/test_torch_elastic.py
    holds each of the JAX webhook's range cases)."""
    p = pod("e", limits(nums=8, mem=1000), anns=anns)
    topos = {port: Side(port, fleet=TOPO_FLEET).s.known_topologies
             for port in (False, True)}
    jr = decoded(jwebhook.handle_admission_review(as_jax(review(p)), JCFG,
                                                  topos[False]))
    tr = decoded(twebhook.handle_admission_review(review(p), TCFG,
                                                  topos[True]))
    assert tr == json.loads(json.dumps(jr).replace("TPU", "GPU"))
    resp = tr["response"]
    assert not resp["allowed"] and resp["status"]["code"] == 422
    assert "vtpu.dev/mesh-m" in resp["status"]["message"]


def test_the_extender_checks_a_mesh_against_its_fleet(servers):
    """Over HTTP each extender validates against its own scheduler's
    registered fabrics (FLEET: lines of 8): a 2x4 mesh fits none."""
    def call(side, base):
        return [post(base, "/webhook", review(mesh_pod(v, n)))
                for v, n in (("2x4", 8), ("8", 8), ("4", 4))]
    want, got = both(servers, call)
    assert [r[1]["response"]["allowed"] for r in got] == [False, True, True]
    assert got[0][1]["response"]["status"]["message"] == \
        want[0][1]["response"]["status"]["message"]
    assert "fits no node topology in the fleet (meshes: 8)" in \
        got[0][1]["response"]["status"]["message"]


def post(base: str, path: str, body=None):
    return chip_smoke.http(f"{base}{path}", body, timeout=30)


@pytest.fixture
def servers():
    """An ExtenderServer of each package on 127.0.0.1, over a scheduler of
    its own on the same fleet."""
    sides = {port: Side(port) for port in (False, True)}
    out = {}
    for port, side in sides.items():
        mod, cfg = (troutes, TCFG) if port else (jroutes, JCFG)
        server = mod.ExtenderServer(side.s, cfg, host="127.0.0.1", port=0)
        server.start()
        out[port] = (side, server, f"http://127.0.0.1:{server.port}")
    yield out
    for _, server, _ in out.values():
        server.stop()


def both(servers, call):
    """``call(side, base)`` on the JAX and the port's server."""
    return [call(*servers[port][::2]) for port in (False, True)]


def test_routes_answer_as_the_jax_extender(servers):
    nodes_form = {"items": [{"metadata": {"name": n}} for n in
                            ("h100-0", "mixed", "ghost")]}
    pods = [pod("a", limits(mem=30000, cores=40)),
            pod("b", limits(nums=8, mem=81000)),
            pod("c", limits(nums=9, mem=1000)),
            pod("cpu", None),
            pod("d", limits(mem=1000),
                anns={t.GPU_USE_TYPE_ANNOTATION: "a100"})]
    replies = []
    for p in pods:
        def create(side, base, p=p):
            side.create(p)
        both(servers, create)
    for i, p in enumerate(pods):
        body = {"Pod": None, "NodeNames": ["h100-0", "h100-1", "ghost"]} \
            if i % 2 == 0 else {"Pod": None, "Nodes": nodes_form}

        def call(side, base, name=p["metadata"]["name"], body=body):
            body = dict(body, Pod=side.kube.get_pod("default", name))
            return post(base, "/filter", body)
        want, got = both(servers, call)
        replies.append(got)
        assert got[0] == 200 and "TPU" not in json.dumps(got)
        assert list(got) == json.loads(
            json.dumps(want).replace("TPU", "GPU"))
    assert replies[0][1]["NodeNames"] == ["h100-0"]
    assert replies[3][1] == {"NodeNames": ["h100-0", "mixed", "ghost"],
                             "FailedNodes": {}, "Error": "",
                             "Nodes": {"apiVersion": "v1",
                                       "kind": "NodeList",
                                       "items": nodes_form["items"]}}

    def bind(side, base):
        first = post(base, "/bind", {"PodName": "a",
                                     "PodNamespace": "default",
                                     "PodUID": "uid-a", "Node": "h100-0"})
        locked = t.NODE_LOCK_ANNOTATION in side.kube.get_node(
            "h100-0")["metadata"]["annotations"]
        side.release("h100-0")
        ghost = post(base, "/bind", {"PodName": "ghost",
                                     "PodNamespace": "default",
                                     "PodUID": "g", "Node": "h100-0"})
        return first, locked, ghost, side.kube.get_pod(
            "default", "a")["metadata"]["annotations"][
                t.BIND_PHASE_ANNOTATION]
    want, got = both(servers, bind)
    assert got == want
    assert got[0] == (200, {"Error": ""}) and got[1]
    assert got[2][1]["Error"]

    def misc(side, base):
        return [post(base, "/healthz"), post(base, "/nothing", {}),
                post(base, "/webhook", review(pod("w", limits(prio=1))))]
    want, got = both(servers, misc)
    assert got[:2] == want[:2] == [(200, {"ok": True}),
                                   (404, '{"error": "not found"}')]
    assert decoded(got[2][1]) == json.loads(json.dumps(decoded(
        want[2][1])).replace("TPU_TASK_PRIORITY", "CUDA_TASK_PRIORITY"))


def test_a_bad_body_is_a_400(servers):
    import urllib.request

    base = servers[True][2]
    req = urllib.request.Request(f"{base}/filter", data=b"{not json",
                                 headers={"Content-Type":
                                          "application/json"})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 400


def test_register_stream_over_grpc_on_a_unix_socket(tmp_path):
    """The port's DeviceRegister streams its cards to the port's scheduler
    over gRPC on a unix socket; a health flip goes down the same stream;
    the stream's end drops the node and keeps its lease."""
    fx = copy.deepcopy(FLEET["mixed"])
    backend = MockBackend(fx)
    s = Scheduler(FakeKube(), TConfig())
    sock = f"unix:{tmp_path / 'sched.sock'}"
    server = start_register_service(s, sock, workers=4)
    reg = DeviceRegister(backend, TConfig(node_name="mixed"), endpoint=sock)
    try:
        reg.start()
        deadline = time.monotonic() + 30
        while s.nodes.get_node("mixed") is None:
            assert time.monotonic() < deadline, "never registered"
            time.sleep(0.02)
        devs = s.nodes.get_node("mixed").devices
        assert [(d.id, d.devmem, d.count, d.type, d.health) for d in devs] \
            == [(c["uuid"], c["hbm_mib"], 10, c["type"], True)
                for c in fx["chips"]]
        fx["chips"][2]["healthy"] = False
        reg.push_update(backend.inventory())
        while s.nodes.get_node("mixed").devices[2].health:
            assert time.monotonic() < deadline, "no health flip"
            time.sleep(0.02)
    finally:
        reg.stop()
        reg._thread.join(timeout=30)
        server.stop(grace=1).wait()
    assert not reg._thread.is_alive()
    assert s.nodes.get_node("mixed") is None
    assert s.leases.state_of("mixed") is not None


def test_scheduler_flags_build_the_config():
    cfg = build_config(parse_args([
        "--scheduler-name", "x", "--default-mem", "5", "--default-cores",
        "7", "--resource-name", "a/gpu", "--resource-mem", "a/mem",
        "--resource-mem-percentage", "a/pct", "--resource-cores", "a/c",
        "--resource-priority", "a/p", "--node-scheduler-policy", "binpack",
        "--lease-ttl", "3", "--lease-grace-beats", "4",
        "--topology-policy", "guaranteed"]))
    assert (cfg.scheduler_name, cfg.default_mem, cfg.default_cores,
            cfg.node_scheduler_policy, cfg.lease_ttl_s,
            cfg.lease_grace_beats, cfg.topology_policy) == (
                "x", 5, 7, "binpack", 3.0, 4, "guaranteed")
    assert (cfg.resources.count, cfg.resources.memory,
            cfg.resources.memory_percentage, cfg.resources.cores,
            cfg.resources.priority) == ("a/gpu", "a/mem", "a/pct", "a/c",
                                        "a/p")
    assert build_config(parse_args([])) == TConfig()


BATCH_ARGVS = {
    "defaults": [],
    "batched": ["--filter-batch", "--batch-tick-ms", "7.5", "--batch-max",
                "64", "--batch-solver", "fifo", "--solve-workers", "3"],
    "settings": ["--gil-switch-interval", "0.02", "--gc-threshold0",
                 "5000", "--trace-capacity", "128"],
    "interpreter": ["--gil-switch-interval", "0", "--gc-threshold0", "0"],
}
BATCH_FLAGS = ("filter_batch", "batch_tick_ms", "batch_max", "batch_solver",
               "solve_workers", "gil_switch_interval", "gc_threshold0",
               "trace_capacity")


@pytest.mark.parametrize("name", sorted(BATCH_ARGVS))
def test_the_batch_flags_and_process_settings_parse_as_jax(name):
    """The five batch flags and the three process settings: the port's
    ``parse_args`` reads each argv as the JAX entry point's does, and its
    config carries the batch fields as the JAX main builds them."""
    from k8s_vgpu_scheduler_tpu.cmd import scheduler as jcmd

    argv = BATCH_ARGVS[name]
    mine, ref = parse_args(argv), jcmd.parse_args(argv)
    assert {f: getattr(mine, f) for f in BATCH_FLAGS} == \
        {f: getattr(ref, f) for f in BATCH_FLAGS}
    cfg = build_config(mine)
    assert (cfg.filter_batch, cfg.batch_tick_ms, cfg.batch_max,
            cfg.batch_solver, cfg.solve_workers) == (
        ref.filter_batch, ref.batch_tick_ms, ref.batch_max,
        ref.batch_solver, ref.solve_workers)
    if name == "defaults":
        assert (cfg.filter_batch, cfg.batch_tick_ms, cfg.batch_max,
                cfg.batch_solver, cfg.solve_workers) == \
            (False, 2.0, 256, "regret", 0)
        assert (mine.gil_switch_interval, mine.gc_threshold0,
                mine.trace_capacity) == (0.05, 0, 2048)


SETTINGS_PROBE = """
import gc, json, sys
import {module} as m
from {package}.util import trace

class Stop(Exception):
    pass

def stop(*a, **k):
    raise Stop

m.DryRunKube = stop
try:
    m.main({argv!r} + ["--fake-kube"])
except Stop:
    pass
print(json.dumps([round(sys.getswitchinterval(), 6), gc.get_threshold()[0],
                  trace._GLOBAL._spans.maxlen,
                  trace._GLOBAL._events.maxlen]))
"""


@pytest.mark.parametrize("name", sorted(BATCH_ARGVS))
def test_main_applies_the_process_settings_as_jax(name):
    """Each entry point's ``main`` in a fresh interpreter, stopped where
    it would make its apiserver client: the GIL switch interval, the gen-0
    GC threshold and the tracer's rings are the same after both."""
    got = {}
    for module, package in (
            ("k8s_vgpu_scheduler_tpu_torch.cmd.scheduler",
             "k8s_vgpu_scheduler_tpu_torch"),
            ("k8s_vgpu_scheduler_tpu.cmd.scheduler",
             "k8s_vgpu_scheduler_tpu")):
        code = SETTINGS_PROBE.format(module=module, package=package,
                                     argv=BATCH_ARGVS[name])
        res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                             capture_output=True, text=True, timeout=120,
                             env={**os.environ, "JAX_PLATFORMS": "cpu"})
        assert res.returncode == 0, res.stderr
        got[package] = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["k8s_vgpu_scheduler_tpu_torch"] == \
        got["k8s_vgpu_scheduler_tpu"]
    want = {"defaults": [0.05, 700, 2048, 4096],
            "batched": [0.05, 700, 2048, 4096],
            "settings": [0.02, 5000, 128, 256],
            "interpreter": [0.005, 700, 2048, 4096]}[name]
    assert got["k8s_vgpu_scheduler_tpu_torch"] == want


def test_the_scheduler_binary_serves_and_stops(tmp_path):
    """``vgpu-scheduler --fake-kube``: it lists before it serves, answers
    /healthz and a dry-run /filter, takes a register stream on its unix
    socket, and stops on SIGTERM."""
    import signal

    port = chip_smoke.free_port()
    sock = tmp_path / "s.sock"
    proc = subprocess.Popen(
        [sys.executable, "-m", "k8s_vgpu_scheduler_tpu_torch.cmd.scheduler",
         "--fake-kube", "--http-bind", f"127.0.0.1:{port}", "--grpc-bind",
         f"unix:{sock}"], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    base = f"http://127.0.0.1:{port}"
    reg = None
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                if post(base, "/healthz") == (200, {"ok": True}):
                    break
            except OSError:
                pass
            assert proc.poll() is None and time.monotonic() < deadline
            time.sleep(0.1)
        reg = DeviceRegister(MockBackend(copy.deepcopy(FLEET["h100-0"])),
                             TConfig(node_name="h100-0"),
                             endpoint=f"unix:{sock}")
        reg.start()
        p = pod("dry", limits(mem=1000, cores=10))
        while True:
            code, reply = post(base, "/filter",
                               {"Pod": p, "NodeNames": ["h100-0"]})
            if reply["NodeNames"] == ["h100-0"]:
                break
            assert time.monotonic() < deadline, reply
            time.sleep(0.1)
        assert code == 200 and reply["Error"] == ""
        code, bound = post(base, "/bind", {
            "PodName": "dry", "PodNamespace": "default",
            "PodUID": "dryrun-default-dry", "Node": "h100-0"})
        assert (code, bound) == (200, {"Error": ""})
    finally:
        if reg is not None:
            reg.stop()
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=30)
    assert proc.returncode == 0, out


def test_json_patch_and_downward_api_as_the_apiserver_and_kubelet_do(
        tmp_path):
    p = WEBHOOK_CASES["podinfo_beside_volumes_and_mounts"]
    ops = twebhook.mutate_pod(copy.deepcopy(p), TCFG, trace_id=TRACE)
    got = chip_smoke.apply_json_patch(p, ops)
    ctr = got["spec"]["containers"][0]
    assert [v["name"] for v in got["spec"]["volumes"]] == ["data",
                                                          "vtpu-podinfo"]
    assert [m["mountPath"] for m in ctr["volumeMounts"]] == [
        "/d", "/etc/vtpu-podinfo"]
    assert ctr["env"] == [
        {"name": "X", "value": "1"},
        {"name": "CUDA_TASK_PRIORITY", "value": "3"},
        {"name": "VTPU_PODINFO_ANNOTATIONS",
         "value": "/etc/vtpu-podinfo/annotations"}]
    assert got["spec"]["schedulerName"] == "vgpu-scheduler"
    assert got["metadata"]["annotations"] == {"vtpu.dev/trace-id": TRACE}
    assert p["spec"]["containers"][0]["env"] == [{"name": "X", "value": "1"}]
    text = chip_smoke.podinfo_text({"b": 'say "x"', "a": "1"})
    assert text == 'a="1"\nb="say \\"x\\""\n'
    from k8s_vgpu_scheduler_tpu_torch.shim.preempt import PreemptionWatch

    f = tmp_path / "annotations"
    f.write_text(chip_smoke.podinfo_text(
        {"vtpu.dev/preempt-requested": "uid-hp"}))
    assert PreemptionWatch(str(f)).requester() == "uid-hp"


def test_the_whole_port_places_a_pod_on_the_mock_nvml(tmp_path):
    """chip_smoke.py's node-agent child on the CPU, its NVML the mock:
    the port's scheduler registers the mock's card over its unix socket,
    and each pod, written with resources only, goes through /webhook,
    /filter, /bind and Allocate; each ends ``success`` with the lock
    released and its grant (the card, its MiB, 50 cores) written by
    Filter; torch is never loaded.  The mock MIG node's leg runs there
    too, its checks made in the child."""
    lib = _kernels.build_mock_nvml()
    fixture = tmp_path / "nvml.json"
    fixture.write_text(json.dumps({"generation": "h100", "mesh": [1],
                                   "hbm_mib": 81079}))
    env = {k: v for k, v in os.environ.items()
           if k not in ("VTPU_MOCK_JSON", "MOCK_NVML_NOT_SUPPORTED")}
    # No card: the compaction's trainers are stood in for (the card run
    # drops DEFRAG_TRAINER and checks that real ones ran).
    env.update(LD_LIBRARY_PATH=str(lib.parent), MOCK_NVML_JSON=str(fixture),
               PLUGIN_DIR=str(tmp_path), DEFRAG_TRAINER="standin")
    res = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--enforce-child",
         "node_agent"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120)
    assert res.returncode == 0, res.stderr
    [line] = [x for x in res.stdout.splitlines() if x.startswith("ENFORCE ")]
    na = json.loads(line[len("ENFORCE "):])
    assert not na["torch_loaded"] and na["backend"] == "NvmlBackend"
    [chip] = na["inventory"]
    assert [(d["id"], d["devmem"]) for d in na["registered"]] == [
        (chip["uuid"], 81079)]
    for name, p in na["pods"].items():
        anns = p["pod"]["metadata"]["annotations"]
        assert anns["vtpu.dev/bind-phase"] == "success" and not p["locked"]
        assert set(anns) >= {"vtpu.dev/trace-id", "vtpu.dev/assigned-time",
                             "vtpu.dev/assigned-ids", "vtpu.dev/bind-time"}
        chip_smoke.placed(name, p, chip["uuid"])
        h = p["handshake"]
        assert h["bind"] == {"Error": ""} and h["filter"]["Error"] == ""
        assert all(h[k] > 0 for k in ("webhook_s", "filter_s", "bind_s",
                                      "allocate_s"))
    # The racing pairs on the one card: over HTTP from two threads, then
    # in one batched cycle whose loser went through the per-pod fallback.
    race = na["race"]
    assert race["winner_run"]["kind"] == "standin"
    assert race["refused"]["FailedNodes"][chip_smoke.PLUGIN_NODE] \
        .startswith(chip_smoke.RACE_REASON)
    batched = race["batched"]
    assert batched["reason"].startswith(chip_smoke.RACE_REASON)
    assert batched["fallbacks"] == {"no-fit": 1}
    assert batched["winner_run"]["grant_mib"] == batched["mib"]
    assert {batched["winner"], batched["loser"]} == {
        n for n, _ in chip_smoke.RACE_BATCH_PODS}
    assert "group-commit" in batched["tick_phases_ms"]
    # The replica failover: the gate, the stale-map fence, the adoption at
    # E+1 and B placed after A, stand-in pods (checked in the child).
    ha = na["ha"]
    assert ha["a_run"]["kind"] == ha["b_run"]["kind"] == "standin"
    assert ha["fence"]["error"].startswith("shard-fence: stale-map")
    assert ha["adoption"]["full_reason"].startswith(chip_smoke.RACE_REASON)
    assert [f["what"] for f in ha["filters"]][-1] == "place"
    train = na["pods"]["train"]["pod"]["spec"]
    assert [v["name"] for v in train["volumes"]] == ["vtpu-podinfo"]
    assert "volumes" not in na["pods"]["serve"]["pod"]["spec"]
    # The fabric: one card (the mock refuses P2P without a "fabric" key),
    # kubelet's answers on it, and the HGX node's placements.
    summary = chip_smoke.fabric_summary(na)
    assert summary["p2p"] == {"links": [], "not_supported": [],
                              "kind": "single"}
    assert summary["p2p_self"] == {"not_supported": "nvmlDeviceGetP2PStatus"}
    assert [a["ids"] for a in summary["preferred"]] == [
        [f"{chip['uuid']}-0"], [f"{chip['uuid']}-0", f"{chip['uuid']}-1"],
        [f"{chip['uuid']}-9", f"{chip['uuid']}-0"]]
    hgx = summary["hgx"]
    assert hgx["registered"] == {"generation": "h100", "mesh": [8],
                                 "wraparound": [True]}
    assert hgx["agent_fabric"] == {"kind": "nvlink", "not_supported": []}
    assert [hgx[n]["cards"] for n in ("ring4", "mesh2", "pin", "arc3")] \
        == [[0, 1, 2, 3], [4, 5], [6], None]
    assert hgx["arc3"]["failed"]["hgx-node"].startswith("no-ici-slice:")
    # The compaction (checked in the child): pin migrated, arc3 on the
    # reserved box, the replacement beside it, the gauges back.
    d = hgx["defrag"]
    assert d["trainer"] == "standin" and d["box"] == [4, 5, 6]
    assert d["arc3_cards"] == [4, 5, 6] and d["bystander"] == [7]
    assert d["replacement_cards"] == [7]
    assert d["losses"]["defrag_R"] == (d["losses"]["defrag_V"]
                                       + d["losses"]["defrag_V2"])
    assert len(d["ticks_ms"]) == 2 and d["launches"] == [0, 0, 0]
    # The elastic gang (checked in the child; tests/test_torch_elastic.py
    # holds its chain to the stand-ins' uninterrupted one).
    assert hgx["elastic_s"] > 0
    assert hgx["slice_gauges"]["after"] == hgx["slice_gauges"]["before"]
    assert hgx["bad_mesh"]["status"]["message"] == \
        chip_smoke.BAD_MESH_MESSAGE
    # MIG: the mock's card has MIG off; the mock MIG node serves its
    # instances by flavor, registers its MIG-off card alone, and both
    # refusals of single exit non-zero with their messages.
    mig = chip_smoke.mig_summary(na)
    assert mig["real"]["nvml"] == {"mode": [0, 0], "devices": []}
    assert mig["registered"] == [list(r) for r in chip_smoke.MIG_REGISTERED]
    assert mig["list_and_watch"]["nvidia.com/mig-3g.40gb"][0] == 4
    assert mig["list_and_watch"]["nvidia.com/mig-1g.10gb"][0] == 7
    assert mig["whole_pod_failed"]["mig-node"]
    assert mig["allocate"]["envs"]["CUDA_DEVICE_MEMORY_LIMIT_0"] == str(
        chip_smoke.MIG_3G_MIB)
    assert mig["unknown"]["code"] == "INVALID_ARGUMENT"
    assert {k: v["rc"] != 0 for k, v in mig["refusals"].items()} == {
        "subset": True, "flavors": True}


def test_the_control_plane_child_preempts_and_rescues_on_the_mock_nvml(
        tmp_path):
    """phase_preempt's control plane on the CPU, its NVML the mock, driven
    as the phase drives it: V placed by the webhook, Filter, Bind and
    Allocate; H's Filter finds no node and the scheduler writes the
    request on V; V's pod deleted, H's next Filter places it with host
    swap's env and the startup hook on its PYTHONPATH (V, not
    oversubscribed, has none); V' placed; then the
    two rescue sweeps of ``end``.  torch is never loaded."""
    lib = _kernels.build_mock_nvml()
    fixture = tmp_path / "nvml.json"
    fixture.write_text(json.dumps({"generation": "h100", "mesh": [1],
                                   "hbm_mib": 81079}))
    (tmp_path / "containers").mkdir()
    env = {k: v for k, v in os.environ.items()
           if k not in ("VTPU_MOCK_JSON", "MOCK_NVML_NOT_SUPPORTED")}
    env.update(LD_LIBRARY_PATH=str(lib.parent), MOCK_NVML_JSON=str(fixture),
               PLUGIN_DIR=str(tmp_path))
    plane = chip_smoke.PlaneChild(env)
    node, pods = chip_smoke.PLUGIN_NODE, chip_smoke.PREEMPT_PODS
    try:
        # The node agent filled the shim dir as --install-shim does.
        assert plane.ready["shim_files"] == [
            "ld.so.preload", "libvgpu_cuda.so", "sitecustomize.py"]
        def admit(key):
            name, uid, mib, prio, anns = pods[key]
            return chip_smoke.admit_pod(plane.base, plane, chip_smoke.user_pod(
                name, uid, mib, prio, annotations=anns))

        def allocate(key):
            got = plane.call("allocate")
            pod = plane.get_pod(pods[key][0])
            return pod, chip_smoke.kubelet_env(pod, got["response"],
                                               tmp_path / "volumes")

        created, out = admit("V")
        chip_smoke.place_pod(plane.base, created, node, out)
        v, v_env = allocate("V")
        assert "PYTHONPATH" not in v_env  # not oversubscribed
        h, out = admit("H")
        nofit, _ = chip_smoke.filter_pod(plane.base, h, node)
        assert nofit["NodeNames"] == [] and nofit["FailedNodes"][
            node].startswith("insufficient-hbm")
        requested = plane.call("requested")
        assert [*requested] == ["uidPV"] and requested["uidPV"][0] == "uidPH"
        anns = plane.get_pod("trainer")["metadata"]["annotations"]
        assert anns["vtpu.dev/preempt-requested"] == "uidPH"
        assert plane.call("grants") == [["uidPV", "trainer"]]
        plane.call("delete", name="trainer")
        assert plane.call("grants") == []
        chip_smoke.place_pod(plane.base, plane.get_pod("serve-hp"), node, out)
        h, h_env = allocate("H")
        assert h_env["CUDA_OVERSUBSCRIBE"] == "true"
        assert h_env["CUDA_DEVICE_MEMORY_LIMIT_0"] == "48000"
        assert h_env["PYTHONPATH"] == str(tmp_path / "shim")
        assert (tmp_path / "shim" / "sitecustomize.py").is_file()
        plane.call("delete", name="serve-hp")
        created, out = admit("V2")
        chip_smoke.place_pod(plane.base, created, node, out)
        allocate("V2")
        ended = plane.call("end")
    finally:
        rc = plane.close()
    assert rc == 0
    assert ended["held"] == [["uidPV2", "trainer-2"]]
    assert ended["suspect"]["actions"] == [
        {"kind": "lease", "node": node, "from": "HEALTHY",
         "to": "SUSPECT"}]
    assert ended["suspect"]["left"] == ended["held"]
    assert ended["dead"]["actions"] == [
        {"kind": "lease", "node": node, "from": "SUSPECT", "to": "DEAD"},
        {"kind": "rescued", "pod": "trainer-2", "uid": "uidPV2",
         "reason": "node-dead", "via": "rescind"}]
    assert ended["dead"]["left"] == [] and not ended["registered"]
    assert 15.0 < ended["suspect"]["age_s"] <= 45.0 < ended["dead"]["age_s"]
    anns = ended["annotations"]["trainer-2"]
    assert all(anns[k] == "" for k in (
        "vtpu.dev/assigned-node", "vtpu.dev/assigned-ids",
        "vtpu.dev/devices-to-allocate", "vtpu.dev/bind-phase"))
    assert not ended["torch_loaded"]
