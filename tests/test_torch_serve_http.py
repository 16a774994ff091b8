"""The port's HTTP front (``cmd/serve.py``) on the CPU, mirroring
tests/test_serve_http.py: real sockets, concurrent clients through the
engine thread, tokens exactly JAX ``generate()``'s (f32, so no greedy
near-tie can flip between shapes), streaming equal to blocking, status
codes, cancellation, drain, ``/profilez`` through ``torch.profiler``,
and ``/metrics`` text equal, line for line, to the JAX package's
``prometheus_text`` on the same stats.  The serving pod's own entry point
is driven as a process too: a checkpoint restored and quantized, six
requests, SIGTERM, exit 0.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_vgpu_scheduler_tpu.cmd import serve as jserve_cmd
from k8s_vgpu_scheduler_tpu.models import llama as jllama
from k8s_vgpu_scheduler_tpu.models.generate import generate as jgenerate
from k8s_vgpu_scheduler_tpu_torch.cmd import serve as tserve_cmd
from k8s_vgpu_scheduler_tpu_torch.cmd.serve import (
    EngineFrontend, make_handler)
from k8s_vgpu_scheduler_tpu_torch.models import llama as tllama
from k8s_vgpu_scheduler_tpu_torch.models.checkpoint import save_checkpoint
from k8s_vgpu_scheduler_tpu_torch.models.convert import (
    from_flax, quantize_model)
from k8s_vgpu_scheduler_tpu_torch.models.serve import ServingEngine

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
CFG = dict(vocab=64, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
           ffn_hidden=128, dtype="float32")


@pytest.fixture(scope="module")
def tiny_model():
    jcfg = jllama.LlamaConfig(**CFG)
    params = jllama.Llama(jcfg).init(jax.random.PRNGKey(0),
                                     jnp.zeros((1, 8), jnp.int32))
    model = from_flax(jax.tree.map(np.asarray, params),
                      tllama.LlamaConfig(**CFG), device="cpu")
    return jcfg, params, model


def serve(engine):
    frontend = EngineFrontend(engine)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                make_handler(frontend, request_timeout=120))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return frontend, httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def server(tiny_model):
    jcfg, params, model = tiny_model
    frontend, httpd, url = serve(ServingEngine(model, max_slots=2,
                                               max_len=32, horizon=2))
    yield jcfg, params, url
    httpd.shutdown()
    frontend.shutdown()


def post(url, obj, timeout=120):
    req = urllib.request.Request(
        url + "/v1/generate", data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def stream(url, obj, timeout=120):
    """(tokens, finished_by) of a streamed request."""
    req = urllib.request.Request(
        url + "/v1/generate", data=json.dumps(dict(obj, stream=True)).encode(),
        headers={"Content-Type": "application/json"})
    tokens, done = [], None
    with urllib.request.urlopen(req, timeout=timeout) as r:
        assert r.headers["Content-Type"] == "text/event-stream"
        for raw in r:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            evt = json.loads(line[len("data: "):])
            if "token" in evt:
                tokens.append(evt["token"])
            elif evt.get("done"):
                done = evt["finished_by"]
                break
            else:
                raise AssertionError(f"stream error event: {evt}")
    return tokens, done


def jax_tokens(jcfg, params, prompt, n):
    out = jgenerate(jcfg, params, jnp.asarray(prompt, jnp.int32)[None], n)
    return [int(t) for t in np.asarray(out[0, len(prompt):])]


def test_concurrent_clients_token_exact_vs_jax_generate(server):
    jcfg, params, url = server
    rng = np.random.RandomState(2)
    prompts = [[int(x) for x in rng.randint(1, 64, size=n)]
               for n in (4, 9, 6, 11, 5)]
    results = {}

    def client(i):
        results[i] = post(url, {"prompt": prompts[i], "max_new_tokens": 6})

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
        assert not t.is_alive()
    for i, p in enumerate(prompts):
        status, body = results[i]
        assert status == 200
        assert body["tokens"] == jax_tokens(jcfg, params, p, 6)
        assert body["finished_by"] == "length"


def test_health_stats_and_errors(server):
    _, _, url = server
    with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
        assert json.loads(r.read())["ok"] is True
    status, body = post(url, {"prompt": [5, 6, 7], "max_new_tokens": 4})
    assert status == 200 and len(body["tokens"]) == 4
    with urllib.request.urlopen(url + "/statsz", timeout=30) as r:
        st = json.loads(r.read())
    assert st["slots"] == 2 and st["pool_hbm_bytes"] > 0
    assert st["stats"]["completions"] >= 1
    status, body = post(url, {"prompt": [1] * 40, "max_new_tokens": 6})
    assert status == 422 and "exceeds" in body["error"]
    status, body = post(url, {"max_new_tokens": 6})
    assert status == 400
    status, body = post(url, {"prompt": [None], "max_new_tokens": 4})
    assert status in (400, 422) and "error" in body
    try:
        urllib.request.urlopen(url + "/nope", timeout=30)
        raise AssertionError("expected HTTP 404")
    except urllib.error.HTTPError as e:
        assert e.code == 404


def test_streaming_tokens_match_blocking(server):
    jcfg, params, url = server
    prompt, max_new = [2, 9, 4], 6
    status, blocking = post(url, {"prompt": prompt,
                                  "max_new_tokens": max_new})
    assert status == 200
    tokens, done = stream(url, {"prompt": prompt, "max_new_tokens": max_new})
    assert tokens == blocking["tokens"] == jax_tokens(jcfg, params, prompt,
                                                      max_new)
    assert done == blocking["finished_by"]


def test_streaming_bad_prompt_is_422_before_headers(server):
    _, _, url = server
    try:
        stream(url, {"prompt": [1] * 40, "max_new_tokens": 4}, timeout=60)
        raise AssertionError("expected HTTP 422")
    except urllib.error.HTTPError as e:
        assert e.code == 422 and "exceeds" in json.loads(e.read())["error"]


def test_profilez_captures_a_torch_profiler_trace(server, tmp_path,
                                                  monkeypatch):
    _, _, url = server
    monkeypatch.setenv("VTPU_PROFILE_BASE", str(tmp_path))
    monkeypatch.setenv("VTPU_PROFILE_KEEP", "1")
    with urllib.request.urlopen(url + "/profilez?seconds=0.3",
                                timeout=60) as r:
        body = json.loads(r.read())
    # Server-chosen under the base, never caller-controlled.
    assert body["trace_dir"].startswith(str(tmp_path))
    assert body["files"] >= 1
    trace = json.loads((Path(body["trace_dir"]) / "trace.json").read_text())
    assert "traceEvents" in trace
    for bad in ("nope", "-1", "0", "nan", "3600"):
        try:
            urllib.request.urlopen(f"{url}/profilez?seconds={bad}",
                                   timeout=30)
            raise AssertionError(f"expected HTTP 400 for seconds={bad}")
        except urllib.error.HTTPError as e:
            assert e.code == 400
    with urllib.request.urlopen(url + "/profilez?seconds=0.2",
                                timeout=60) as r:
        second = json.loads(r.read())
    assert second["files"] >= 1
    # Retention: only the newest capture is kept.
    assert os.listdir(tmp_path) == [Path(second["trace_dir"]).name]


def test_profilez_refuses_a_second_capture_while_one_runs():
    assert tserve_cmd._PROFILE_LOCK.acquire(blocking=False)
    try:
        code, body = tserve_cmd.profile_capture("/profilez?seconds=1",
                                                torch.device("cpu"))
    finally:
        tserve_cmd._PROFILE_LOCK.release()
    assert code == 409 and "already" in body["error"]


def test_profilez_charges_the_tracer_to_the_grant_first(monkeypatch,
                                                        tmp_path):
    """On the card a capture needs the tracer started, its footprint
    (TRACER_MIB) charged through the interposer first: where the grant
    cannot hold it the reply is 503 and no trace starts (nor a
    directory); a refused charge is asked for again next time."""
    from k8s_vgpu_scheduler_tpu_torch.shim import core

    asked = []
    monkeypatch.setattr(tserve_cmd, "_tracer_started", False)
    monkeypatch.setattr(core, "interposer_charge",
                        lambda dev, n: asked.append((dev, n)) or False)
    monkeypatch.setattr(tserve_cmd, "TRACER_MIB", 300)
    monkeypatch.setenv("VTPU_PROFILE_BASE", str(tmp_path))
    for _ in range(2):
        code, body = tserve_cmd.profile_capture("/profilez?seconds=1",
                                                torch.device("cuda", 0))
        assert code == 503 and "tracer" in body["error"]
    assert asked == [(0, 300 << 20)] * 2
    assert os.listdir(tmp_path) == []
    assert tserve_cmd._PROFILE_LOCK.acquire(blocking=False)
    tserve_cmd._PROFILE_LOCK.release()


def test_timeout_cancels_and_frees_slot(tiny_model):
    _, _, model = tiny_model
    eng = ServingEngine(model, max_slots=1, max_len=64, horizon=1)
    fe = EngineFrontend(eng)
    try:
        with pytest.raises(TimeoutError):
            fe.submit_and_wait([1, 2, 3], 40, timeout=0.05)
        deadline = time.monotonic() + 60
        while (eng.stats["cancelled"] < 1 or eng.active.any()) \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        assert eng.stats["cancelled"] == 1
        assert not eng.active.any()
        c = fe.submit_and_wait([4, 5], 4, timeout=120)
        assert len(c.tokens) == 4
    finally:
        fe.shutdown()


def test_stream_disconnect_frees_slot(tiny_model):
    _, _, model = tiny_model
    eng = ServingEngine(model, max_slots=1, max_len=64, horizon=1)
    fe, httpd, url = serve(eng)
    try:
        req = urllib.request.Request(
            url + "/v1/generate",
            data=json.dumps({"prompt": [3, 1], "max_new_tokens": 50,
                             "stream": True}).encode(),
            headers={"Content-Type": "application/json"})
        r = urllib.request.urlopen(req, timeout=60)
        r.fp.readline()          # first SSE event arrived — mid-stream now
        r.close()                # hang up
        deadline = time.monotonic() + 60
        while (eng.stats["cancelled"] < 1 or eng.active.any()) \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        assert eng.stats["cancelled"] == 1
        assert not eng.active.any()
    finally:
        httpd.shutdown()
        fe.shutdown()


def test_drain_finishes_inflight_and_refuses_new(tiny_model):
    _, _, model = tiny_model
    eng = ServingEngine(model, max_slots=1, max_len=64, horizon=1)
    fe = EngineFrontend(eng)
    try:
        result = {}

        def client():
            result["c"] = fe.submit_and_wait([2, 3], 12, timeout=120)

        t = threading.Thread(target=client)
        t.start()
        deadline = time.monotonic() + 60
        while not eng.active.any() and time.monotonic() < deadline:
            time.sleep(0.02)           # wait until it's genuinely in-flight
        assert fe.drain(timeout=120) is True
        t.join(timeout=60)
        assert not t.is_alive()
        assert len(result["c"].tokens) == 12     # finished, not dropped
        with pytest.raises(RuntimeError, match="draining"):
            fe.submit_and_wait([5], 4, timeout=10)
    finally:
        fe.shutdown()


STATS = [
    {"stats": {"prefills": 3, "decode_steps": 10, "tokens_out": 2.5},
     "utilization": 0.25, "queue_depth": 0, "pool_hbm_bytes": 123456789012,
     "latency": {"ttft_s": {"p50": 0.001, "p95": 1e-07},
                 "per_token_s": {"p50": 0.5, "p95": 1.5}}},
    {"stats": {}, "utilization": 0.0, "queue_depth": 7,
     "pool_hbm_bytes": 65536, "latency": {}},
    {"stats": {"prefills": 10 ** 7, "decode_steps": 1234567,
               "decode_dispatches": 12345678, "tokens_out": float("inf"),
               "completions": float("nan"), "cancelled": 0},
     "utilization": 1.0, "queue_depth": 0, "pool_hbm_bytes": 0,
     "latency": {"ttft_s": {"p50": 1e300, "p95": 123456.7}}},
]


@pytest.mark.parametrize("stats", STATS, ids=["full", "idle", "extremes"])
def test_prometheus_text_equals_jax(stats):
    assert tserve_cmd.prometheus_text(stats).splitlines() == \
        jserve_cmd.prometheus_text(stats).splitlines()


def test_metrics_endpoint_parses_and_agrees_with_statsz(server):
    _, _, url = server
    post(url, {"prompt": [8, 9], "max_new_tokens": 3})
    with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
        assert r.headers["Content-Type"].startswith("text/plain")
        text = r.read().decode()
    with urllib.request.urlopen(url + "/statsz", timeout=30) as r:
        st = json.loads(r.read())
    from k8s_vgpu_scheduler_tpu.cmd.vtpu_smi import parse_prom
    metrics = parse_prom(text)
    assert metrics["vtpu_serve_completions_total"][0][1] >= 1
    assert metrics["vtpu_serve_tokens_out_total"][0][1] >= 3
    assert metrics["vtpu_serve_pool_hbm_bytes"][0][1] == st["pool_hbm_bytes"]
    assert 0.0 <= metrics["vtpu_serve_slot_utilization"][0][1] <= 1.0


def args(*argv):
    return tserve_cmd.parse_args(["--device", "cpu", *argv])


def test_build_engine_restores_and_quantizes_a_checkpoint(tiny_model,
                                                           tmp_path):
    _, params, model = tiny_model
    save_checkpoint(str(tmp_path / "ckpt"), 0, model)
    config = tmp_path / "llama.json"
    config.write_text(json.dumps(CFG))
    eng = tserve_cmd.build_engine(args(
        "--config", str(config), "--checkpoint", str(tmp_path / "ckpt"),
        "--max-slots", "2", "--max-len", "32"))
    for a, b in zip(eng.model.state_dict().values(),
                    model.state_dict().values()):
        assert torch.equal(a, b)
    for quant, bits in (("int8", 8), ("int4", 4)):
        eng = tserve_cmd.build_engine(args(
            "--config", str(config), "--checkpoint", str(tmp_path / "ckpt"),
            "--quant", quant, "--max-slots", "2", "--max-len", "32"))
        want = quantize_model(from_flax(jax.tree.map(np.asarray, params),
                                        tllama.LlamaConfig(**CFG),
                                        device="cpu"), bits, device="cpu")
        assert eng.model.cfg.quant == quant
        for (n, a), b in zip(eng.model.state_dict().items(),
                             want.state_dict().values()):
            assert torch.equal(a, b), n
    eng = tserve_cmd.build_engine(args("--demo", "tiny", "--max-len", "64"))
    assert eng.model.cfg.n_layers == 2 and eng.device.type == "cpu"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_the_pod_serves_a_quantized_checkpoint_and_drains_on_sigterm(
        tiny_model, tmp_path):
    """``python -m ...cmd.serve`` as a pod runs it: restore, quantize to
    int8, serve six concurrent requests (one streamed) with the in-process
    engine's tokens, then SIGTERM: drain and exit 0."""
    _, params, model = tiny_model
    save_checkpoint(str(tmp_path / "ckpt"), 0, model)
    config = tmp_path / "llama.json"
    config.write_text(json.dumps(CFG))
    ref_model = quantize_model(from_flax(jax.tree.map(np.asarray, params),
                                         tllama.LlamaConfig(**CFG),
                                         device="cpu"), 8, device="cpu")
    rng = np.random.RandomState(5)
    prompts = [[int(x) for x in rng.randint(1, 64, size=n)]
               for n in (3, 8, 5, 12, 6, 4)]
    ref = ServingEngine(ref_model, max_slots=4, max_len=32)
    want = []
    for p in prompts:       # one request after another
        ref.submit(p, 8)
        want.append(ref.run()[0].tokens)
    port = free_port()
    url = f"http://127.0.0.1:{port}"
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    proc = subprocess.Popen(
        [sys.executable, "-m", "k8s_vgpu_scheduler_tpu_torch.cmd.serve",
         "--device", "cpu", "--config", str(config), "--checkpoint",
         str(tmp_path / "ckpt"), "--quant", "int8", "--max-slots", "4",
         "--max-len", "32", "--bind", f"127.0.0.1:{port}"],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 120
        while True:
            assert proc.poll() is None, proc.stdout.read()
            assert time.monotonic() < deadline, "the pod never came up"
            try:
                with urllib.request.urlopen(url + "/healthz", timeout=5):
                    break
            except (urllib.error.URLError, ConnectionError):
                time.sleep(0.2)
        got = {}

        def client(i):
            req = {"prompt": prompts[i], "max_new_tokens": 8}
            got[i] = stream(url, req)[0] if i == 0 else post(url, req)[1][
                "tokens"]

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        assert [got[i] for i in range(len(prompts))] == want
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out
        assert "drain complete" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
