"""The port's tracer and debug endpoints against the JAX package's, on the
CPU: every case of ``tests/test_trace.py`` and ``tests/test_debug_endpoints.py``
run on the port's ``util/trace.py``, ``util/debugz.py``, webhook,
scheduler and extender routes.

Cases that exercise the tracer alone run on both packages with the same
expectations (``PKGS``).  The port's webhook, Filter and Bind run on its
own GPU pods; the JAX shim's ``publish_trace_id`` has no counterpart to
mirror (the port's Allocate drops the id next to the region, pinned in
``tests/test_torch_deviceplugin.py``).  Of the JAX extender's debug and
export endpoints the port serves ``/usagez``, ``/fleetz`` and
``/debug/*``; the rest (``/perfz``, ``/capacityz``, ``/queuez``,
``/auditz``, ``/explainz``, ``/sloz``) wait for ROADMAP A.5 and answer a
JSON 404."""

import json
import urllib.error
import urllib.request

import pytest
from prometheus_client.parser import text_string_to_metric_families

from k8s_vgpu_scheduler_tpu.util import debugz as jdebugz
from k8s_vgpu_scheduler_tpu.util import trace as jtrace
from k8s_vgpu_scheduler_tpu_torch.k8s import FakeKube
from k8s_vgpu_scheduler_tpu_torch.scheduler import Scheduler
from k8s_vgpu_scheduler_tpu_torch.scheduler.core import \
    decode_register_request
from k8s_vgpu_scheduler_tpu_torch.scheduler.metrics import phase_metrics
from k8s_vgpu_scheduler_tpu_torch.scheduler.routes import ExtenderServer
from k8s_vgpu_scheduler_tpu_torch.util import debugz, trace
from k8s_vgpu_scheduler_tpu_torch.util.config import Config
from k8s_vgpu_scheduler_tpu_torch.util.exposition import render

PKGS = {"port": (trace, debugz), "jax": (jtrace, jdebugz)}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def fresh_tracer(monkeypatch, mod):
    t = mod.Tracer(capacity=64, event_capacity=64, service="test")
    monkeypatch.setattr(mod, "_GLOBAL", t)
    return t


@pytest.fixture
def fresh(monkeypatch):
    """The port's process-global tracer swapped for an isolated one."""
    return fresh_tracer(monkeypatch, trace)


# -- the ring ----------------------------------------------------------------


def test_span_ring_evicts_oldest(pkg):
    t = pkg[0].Tracer(capacity=4)
    for i in range(10):
        with t.span("filter", trace_id=f"t{i}"):
            pass
    assert [s.trace_id for s in t.spans()] == ["t6", "t7", "t8", "t9"]


def test_event_ring_evicts_oldest(pkg):
    t = pkg[0].Tracer(event_capacity=3)
    for i in range(5):
        t.event(f"u{i}", "created")
    assert [e["pod_uid"] for e in t.events()] == ["u2", "u3", "u4"]


def test_events_filter_by_pod(pkg):
    t = pkg[0].Tracer()
    t.event("u1", "filter-assigned", trace_id="abc", node="node-a")
    t.event("u2", "filter-rejected")
    [got] = t.events("u1")
    assert (got["event"], got["trace_id"], got["attributes"]["node"]) == (
        "filter-assigned", "abc", "node-a")


def test_events_paginate_after_a_cursor(pkg):
    t = pkg[0].Tracer()
    for i in range(6):
        t.event("u", f"e{i}")
    seqs = [e["seq"] for e in t.events()]
    assert [e["event"] for e in t.events(after_seq=seqs[2], limit=2)] == \
        ["e3", "e4"]
    assert [e["event"] for e in t.events(limit=2)] == ["e4", "e5"]


def test_span_records_exception_and_reraises(pkg):
    t = pkg[0].Tracer()
    with pytest.raises(ValueError):
        with t.span("bind", trace_id="x"):
            raise ValueError("boom")
    (sp,) = t.spans()
    assert "boom" in sp.attrs["error"]


# -- the histograms ------------------------------------------------------------


def test_bucket_emission_is_cumulative_with_inf(pkg):
    h = pkg[0].PhaseHistogram(bounds=(0.01, 0.1, 1.0))
    for v in (0.005, 0.005, 0.05, 5.0):
        h.observe(v)
    buckets, count, sum_s = h.snapshot()
    assert buckets == [("0.01", 2), ("0.1", 3), ("1.0", 3), ("+Inf", 4)]
    assert count == 4 and abs(sum_s - 5.06) < 1e-9


def test_tracer_histograms_keyed_by_phase_and_qos(pkg):
    t = pkg[0].Tracer()
    t.record("filter", "tid", 100.0, 100.5)
    t.record("bind", "tid", 100.0, 100.001)
    t.record("filter", "tid2", 100.0, 100.25, qos="latency-critical")
    snap = t.histogram_snapshot()
    assert set(snap) == {("filter", ""), ("bind", ""),
                         ("filter", "latency-critical")}
    assert snap[("filter", "")][1] == 1
    assert abs(snap[("filter", "")][2] - 0.5) < 1e-9
    assert abs(snap[("filter", "latency-critical")][2] - 0.25) < 1e-9


def test_unknown_qos_values_clamp_to_one_label(pkg):
    t = pkg[0].Tracer()
    for i in range(10):
        t.record("filter", "x", 100.0, 100.1, qos=f"gold-{i}")
    snap = t.histogram_snapshot()
    assert set(snap) == {("filter", "invalid")}
    assert snap[("filter", "invalid")][1] == 10


def test_span_qos_attr_labels_the_histogram(pkg):
    t = pkg[0].Tracer()
    with t.span("filter", trace_id="x", qos="latency-critical"):
        pass
    with t.span("filter", trace_id="y"):
        pass
    snap = t.histogram_snapshot()
    assert snap[("filter", "latency-critical")][1] == 1
    assert snap[("filter", "")][1] == 1


def test_default_buckets_resolve_sub_millisecond(pkg):
    mod = pkg[0]
    assert mod.DEFAULT_BUCKETS == jtrace.DEFAULT_BUCKETS
    assert mod.DEFAULT_BUCKETS == tuple(sorted(mod.DEFAULT_BUCKETS))
    h = mod.PhaseHistogram()
    h.observe(0.00002)
    buckets, count, _ = h.snapshot()
    assert count == 1 and buckets[0] == ("5e-06", 0)
    assert dict(buckets)["2.5e-05"] == 1


def test_same_observations_give_the_jax_snapshots():
    t, j = trace.Tracer(), jtrace.Tracer()
    for tr in (t, j):
        for i, d in enumerate((3e-6, 4e-5, 2e-3, 0.4, 30.0)):
            tr.record("filter", "x", 10.0, 10.0 + d,
                      qos=("", "best-effort", "gold")[i % 3])
        tr.reject("insufficient-hbm", 3)
        tr.reject("lease-suspect")
    assert t.histogram_snapshot() == j.histogram_snapshot()
    assert t.rejection_snapshot() == j.rejection_snapshot()


def test_phase_metrics_render_buckets(fresh):
    fresh.record("filter", "tid", 10.0, 10.0005)
    fresh.record("filter", "tid2", 10.0, 10.0005, qos="latency-critical")
    fresh.reject("insufficient-hbm", 3)
    text = render(phase_metrics())
    for line in ('vtpu_scheduling_phase_latency_seconds_bucket'
                 '{le="0.001",phase="filter",qos=""} 1.0',
                 'vtpu_scheduling_phase_latency_seconds_bucket'
                 '{le="+Inf",phase="filter",qos=""} 1.0',
                 'vtpu_scheduling_phase_latency_seconds_count'
                 '{phase="filter",qos=""} 1.0',
                 'vtpu_scheduling_phase_latency_seconds_count'
                 '{phase="filter",qos="latency-critical"} 1.0',
                 'vtpu_filter_rejections_total{reason="insufficient-hbm"} '
                 '3.0'):
        assert line in text.splitlines()
    assert [f.name for f in text_string_to_metric_families(text)] == [
        "vtpu_scheduling_phase_latency_seconds", "vtpu_filter_rejections"]


def test_finish_observes_the_span_histogram(fresh):
    sp = trace.Span("webhook", "t" * 32)
    fresh.finish(sp)
    assert fresh.histogram_snapshot()[("webhook", "")][1] == 1


# -- OTLP and the renderers ----------------------------------------------------


def test_tracez_json_is_otlp_shaped(monkeypatch, pkg):
    mod = pkg[0]
    t = fresh_tracer(monkeypatch, mod)
    with t.span("filter", trace_id="a" * 32, node="node-a", n=3, ok=True,
                f=0.5):
        pass
    with t.span("bind", trace_id="b" * 32):
        pass
    status, ctype, body = mod.render_tracez({"format": "json"})
    assert status == 200 and ctype == "application/json"
    (rs,) = json.loads(body)["resourceSpans"]
    svc = {a["key"]: a["value"] for a in rs["resource"]["attributes"]}
    assert svc["service.name"]["stringValue"] == "test"
    spans = rs["scopeSpans"][0]["spans"]
    assert {s["name"] for s in spans} == {"filter", "bind"}
    for s in spans:
        assert len(s["traceId"]) == 32 and len(s["spanId"]) == 16
        assert int(s["endTimeUnixNano"]) >= int(s["startTimeUnixNano"])
    (f,) = [s for s in spans if s["name"] == "filter"]
    attrs = {a["key"]: a["value"] for a in f["attributes"]}
    assert attrs == {"node": {"stringValue": "node-a"},
                     "n": {"intValue": "3"}, "ok": {"boolValue": True},
                     "f": {"doubleValue": 0.5}}


def test_tracez_json_filters_by_trace(monkeypatch, pkg):
    mod = pkg[0]
    t = fresh_tracer(monkeypatch, mod)
    for tid in ("a" * 32, "b" * 32):
        with t.span("filter", trace_id=tid):
            pass
    _, _, body = mod.render_tracez({"format": "json", "trace": "a" * 32})
    spans = json.loads(body)["resourceSpans"][0]["scopeSpans"][0]["spans"]
    assert [s["traceId"] for s in spans] == ["a" * 32]


def test_tracez_text_groups_by_trace(monkeypatch, pkg):
    mod = pkg[0]
    t = fresh_tracer(monkeypatch, mod)
    with t.span("filter", trace_id="deadbeef" * 4):
        pass
    status, ctype, body = mod.render_tracez({})
    assert status == 200 and ctype == "text/plain"
    assert "deadbeef" in body and "filter" in body and "ms" in body


def test_debugz_serves_tracez_and_events(monkeypatch, pkg):
    mod, dz = pkg
    t = fresh_tracer(monkeypatch, mod)
    with t.span("filter", trace_id="c" * 32):
        pass
    t.event("uid-1", "filter-assigned", trace_id="c" * 32)
    status, _, body = dz.handle("/debug/tracez", {})
    assert status == 200 and "filter" in body
    status, _, body = dz.handle("/debug/events", {"pod": "uid-1"})
    events = json.loads(body)["events"]
    assert status == 200 and events[0]["pod_uid"] == "uid-1"
    _, _, body = dz.handle("/debug/events", {"pod": "no-such"})
    assert json.loads(body)["events"] == []
    status, _, body = dz.handle("/debug/events", {"limit": "x"})
    assert status == 400 and "error" in json.loads(body)
    assert dz.handle("/debug/nope", {})[0] == 404


def test_debugz_vars_stacks_and_profile(pkg):
    dz = pkg[1]
    status, ctype, body = dz.handle("/debug/vars", {})
    assert status == 200 and ctype == "application/json"
    assert set(json.loads(body)) == {"uptime_s", "rss_mib", "open_fds",
                                     "threads", "gc_counts", "pid"}
    status, _, body = dz.handle("/debug/stacks", {})
    assert status == 200 and "MainThread" in body
    status, _, body = dz.handle("/debug/profile", {"seconds": "0.1"})
    assert status == 200 and body.startswith("wall-clock samples over 0.1s")


def test_debug_server_serves_on_loopback():
    srv = debugz.DebugServer(port=0)
    srv.start()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/debug/vars", timeout=10) as r:
            assert json.loads(r.read())["threads"] >= 1
    finally:
        srv.stop()


# -- the webhook issues the trace id --------------------------------------------


def gpu_pod(name="p1", uid="u1", mem="3000") -> dict:
    return {"metadata": {"name": name, "namespace": "default", "uid": uid,
                         "annotations": {}},
            "spec": {"containers": [{"name": "c", "resources": {"limits": {
                "nvidia.com/gpu": "1", "nvidia.com/gpumem": mem}}}]}}


def test_mutated_gpu_pod_carries_trace_annotation(fresh):
    import base64

    from k8s_vgpu_scheduler_tpu_torch.scheduler.webhook import \
        handle_admission_review

    out = handle_admission_review({"request": {
        "uid": "r1", "operation": "CREATE", "object": gpu_pod()}}, Config())
    patches = json.loads(base64.b64decode(out["response"]["patch"]))
    (tp,) = [p for p in patches if "trace-id" in p["path"]]
    assert tp["path"] == "/metadata/annotations/vtpu.dev~1trace-id"
    assert len(tp["value"]) == 32
    (sp,) = [s for s in fresh.spans() if s.name == "webhook"]
    assert sp.trace_id == tp["value"]
    assert fresh.histogram_snapshot()[("webhook", "")][1] == 1


def test_trace_annotation_created_when_annotations_absent(fresh):
    from k8s_vgpu_scheduler_tpu_torch.scheduler.webhook import mutate_pod

    pod = gpu_pod()
    del pod["metadata"]["annotations"]
    patches = mutate_pod(pod, Config(), trace_id="f" * 32)
    (tp,) = [p for p in patches if p["path"] == "/metadata/annotations"]
    assert tp["value"] == {trace.TRACE_ID_ANNOTATION: "f" * 32}


def test_existing_trace_id_is_kept(fresh):
    from k8s_vgpu_scheduler_tpu_torch.scheduler.webhook import mutate_pod

    pod = gpu_pod()
    pod["metadata"]["annotations"][trace.TRACE_ID_ANNOTATION] = "keep"
    assert not any("trace-id" in p["path"]
                   for p in mutate_pod(pod, Config(), trace_id="g" * 32))


def test_non_gpu_pod_gets_no_trace_id(fresh):
    from k8s_vgpu_scheduler_tpu_torch.scheduler.webhook import mutate_pod

    pod = {"metadata": {"name": "web", "namespace": "d", "uid": "w"},
           "spec": {"containers": [{
               "name": "c", "resources": {"limits": {"cpu": "1"}}}]}}
    assert mutate_pod(pod, Config(), trace_id="h" * 32) == []


# -- the scheduler's spans and rejection counts -------------------------------


def scheduler_with_node(**cfg):
    import types

    from k8s_vgpu_scheduler_tpu_torch.deviceplugin import advertised_devices
    from k8s_vgpu_scheduler_tpu_torch.tpulib import H100_FIXTURE, MockBackend

    kube = FakeKube()
    kube.add_node({"metadata": {"name": "node-a", "annotations": {}}})
    s = Scheduler(kube, Config(**cfg))
    inv = MockBackend(dict(H100_FIXTURE, mesh=[1])).inventory()
    msg = types.SimpleNamespace(node="node-a", devices=[
        types.SimpleNamespace(**d) for d in advertised_devices(inv, Config())],
        topology=types.SimpleNamespace(generation="h100", mesh=[1],
                                       wraparound=[False]))
    s.observe_registration("node-a", decode_register_request(msg))
    return kube, s


def test_filter_bind_and_allocate_share_the_pod_trace_id(fresh):
    from k8s_vgpu_scheduler_tpu_torch.util import types as t

    kube, s = scheduler_with_node()
    kube.watch_pods(s.on_pod_event)
    pod = gpu_pod()
    tid = "e" * 32
    pod["metadata"]["annotations"][trace.TRACE_ID_ANNOTATION] = tid
    kube.create_pod(pod)
    assert s.filter(pod, ["node-a"]).node == "node-a"
    assert s.bind("default", "p1", "u1", "node-a") is None
    kube.patch_pod_annotations("default", "p1", {
        t.BIND_PHASE_ANNOTATION: t.BIND_SUCCESS})
    names = [sp.name for sp in sorted(fresh.spans(tid),
                                      key=lambda x: x.start)]
    assert names == ["filter", "decision-write", "bind", "allocate"]
    kinds = [e["event"] for e in fresh.events("u1")]
    assert {"filter-assigned", "bound", "allocate-success"} <= set(kinds)
    # Once a uid: a replayed success records no second span.
    kube.patch_pod_annotations("default", "p1", {"x": "y"})
    assert [sp.name for sp in fresh.spans(tid)].count("allocate") == 1


def test_stale_allocate_goes_to_the_journal_alone(fresh):
    from k8s_vgpu_scheduler_tpu_torch.util import types as t

    _, s = scheduler_with_node()
    pod = gpu_pod()
    pod["metadata"]["annotations"].update({
        t.BIND_PHASE_ANNOTATION: t.BIND_SUCCESS,
        t.BIND_TIME_ANNOTATION: str(int(1e9))})
    s.on_pod_event("ADDED", pod)
    assert not [sp for sp in fresh.spans() if sp.name == "allocate"]
    [ev] = [e for e in fresh.events("u1") if e["event"] == "allocate-success"]
    assert ev["attributes"]["histogram"] == "dropped-stale"


def test_rejection_reason_reaches_counter_and_failed_nodes(fresh):
    kube, s = scheduler_with_node()
    pod = gpu_pod(mem="99999")
    kube.create_pod(pod)
    r = s.filter(pod, ["node-a", "ghost"])
    assert r.node is None
    assert r.failed["node-a"].split(":")[0] == "insufficient-hbm"
    assert fresh.rejection_snapshot() == {
        "insufficient-hbm": 1, "no GPU inventory registered": 1}


def test_configure_renames_and_resizes(monkeypatch, pkg):
    mod = pkg[0]
    fresh_tracer(monkeypatch, mod)
    t = mod.configure(service="renamed", capacity=2)
    for i in range(5):
        with t.span("x", trace_id=str(i)):
            pass
    assert t.service == "renamed" and len(t.spans()) == 2


# -- the extender's endpoints (tests/test_debug_endpoints.py) --------------------


def _get(base: str, path: str):
    try:
        with urllib.request.urlopen(base + path, timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.fixture(scope="module")
def server():
    kube, s = scheduler_with_node(enable_debug=True)
    srv = ExtenderServer(s, s.cfg, host="127.0.0.1", port=0)
    srv.start()
    try:
        yield f"http://127.0.0.1:{srv.port}", s
    finally:
        srv.stop()


ENDPOINTS = [
    ("usagez", "/usagez", {200}, "/usagez?window=abc"),
    ("usagez-nan", "/usagez?window=60", {200}, "/usagez?window=nan"),
    ("usagez-inf", "/usagez?window=600", {200}, "/usagez?window=inf"),
    ("usagez-neg", "/usagez?window=1", {200}, "/usagez?window=-5"),
    ("debug-events", "/debug/events?limit=4", {200},
     "/debug/events?after_seq=zzz"),
    ("debug-vars", "/debug/vars", {200}, None),
    ("debug-tracez", "/debug/tracez?format=json", {200}, None),
    ("fleetz", "/fleetz", {200}, None),
]


@pytest.mark.parametrize("name,good,statuses,bad", ENDPOINTS,
                         ids=[e[0] for e in ENDPOINTS])
def test_good_request_is_strict_json(server, name, good, statuses, bad):
    base, _ = server
    code, body = _get(base, good)
    assert code in statuses, (good, code, body[:200])
    json.dumps(json.loads(body), allow_nan=False)


@pytest.mark.parametrize("name,good,statuses,bad",
                         [e for e in ENDPOINTS if e[3] is not None],
                         ids=[e[0] for e in ENDPOINTS if e[3] is not None])
def test_bad_params_return_400_json(server, name, good, statuses, bad):
    base, _ = server
    code, body = _get(base, bad)
    assert code == 400, (bad, code, body[:200])
    doc = json.loads(body)
    assert doc.get("error"), doc
    json.dumps(doc, allow_nan=False)


@pytest.mark.parametrize("path", ["/perfz", "/capacityz", "/queuez",
                                  "/auditz", "/explainz?pod=a/b", "/sloz"])
def test_a5_endpoints_answer_a_json_404(server, path):
    base, _ = server
    code, body = _get(base, path)
    assert code == 404 and json.loads(body) == {"error": "not found"}


def test_debug_endpoints_are_off_by_default():
    _, s = scheduler_with_node()
    srv = ExtenderServer(s, s.cfg, host="127.0.0.1", port=0)
    srv.start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        assert _get(base, "/debug/vars")[0] == 404
        assert _get(base, "/usagez")[0] == 200
    finally:
        srv.stop()


def test_usagez_export_error_answers_500(server, monkeypatch):
    base, s = server

    def broken(window=None):
        raise RuntimeError("ledger gone")

    monkeypatch.setattr(s, "export_usage", broken)
    code, body = _get(base, "/usagez")
    assert code == 500
    assert json.loads(body) == {"error": "RuntimeError: ledger gone"}
