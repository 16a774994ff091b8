"""The port's ``parallel/multihost.py`` against the JAX package's, on the
CPU: the gang contract read from the env (``gang_env``, which imports no
jax on either side) equal case for case to JAX's ``TestGangEnv``; the
process group wired from it through ``torch.distributed`` (the backend
the caller names, the coordinator as the TCP rendezvous, the timeout);
and two real processes that form a gloo group from the env alone and
all-reduce, under a join timeout.
"""

import datetime
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from k8s_vgpu_scheduler_tpu.parallel import multihost as jmultihost
from k8s_vgpu_scheduler_tpu_torch.parallel import multihost

ROOT = Path(__file__).resolve().parent.parent
ENV_KEYS = (multihost.ENV_RANK, multihost.ENV_SIZE, multihost.ENV_COORDINATOR)


def set_env(monkeypatch, **kv):
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    for k, v in kv.items():
        monkeypatch.setenv(k, v)


@pytest.mark.parametrize("env", [
    {},
    {"VTPU_GANG_RANK": "3", "VTPU_GANG_SIZE": "32",
     "VTPU_GANG_COORDINATOR": "llama7b-0.llama7b-svc"},
    {"VTPU_GANG_RANK": "0", "VTPU_GANG_SIZE": "2",
     "VTPU_GANG_COORDINATOR": "10.0.0.5:9999"},
    {"VTPU_GANG_RANK": "0", "VTPU_GANG_SIZE": "2"},
    {"VTPU_GANG_RANK": "1", "VTPU_GANG_COORDINATOR": "c:1"},
    {"VTPU_GANG_RANK": "", "VTPU_GANG_SIZE": "2"},
], ids=["not_a_member", "full_contract", "explicit_port",
        "missing_coordinator", "missing_size", "empty_rank"])
def test_gang_env_equals_the_jax_one(monkeypatch, env):
    set_env(monkeypatch, **env)
    try:
        want = ("ok", jmultihost.gang_env())
    except jmultihost.GangEnvError as e:
        want = ("error", str(e))
    try:
        got = ("ok", multihost.gang_env())
    except multihost.GangEnvError as e:
        got = ("error", str(e))
    assert got == want
    assert multihost.DEFAULT_PORT == jmultihost.DEFAULT_PORT == 8476
    assert ENV_KEYS == (jmultihost.ENV_RANK, jmultihost.ENV_SIZE,
                        jmultihost.ENV_COORDINATOR)


def test_not_a_member_forms_no_group(monkeypatch):
    set_env(monkeypatch)
    called = []
    import torch.distributed as dist
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **kw: called.append((a, kw)))
    assert multihost.initialize_from_env("gloo") is False
    assert called == []


def test_initialize_wires_torch_distributed(monkeypatch):
    set_env(monkeypatch, VTPU_GANG_RANK="1", VTPU_GANG_SIZE="4",
            VTPU_GANG_COORDINATOR="coord")
    calls = []
    import torch.distributed as dist
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **kw: calls.append((a, kw)))
    assert multihost.initialize_from_env("nccl", timeout_s=30) is True
    assert calls == [(("nccl",), {
        "init_method": "tcp://coord:8476", "rank": 1, "world_size": 4,
        "timeout": datetime.timedelta(seconds=30)})]
    calls.clear()
    assert multihost.initialize_from_env("gloo") is True
    assert calls[0][0] == ("gloo",) and "timeout" not in calls[0][1]


def test_the_module_imports_torch_only_inside_its_function():
    code = ("import sys\n"
            "from k8s_vgpu_scheduler_tpu_torch.parallel import multihost\n"
            "assert multihost.gang_env() is None\n"
            "assert 'torch' not in sys.modules, 'torch imported'\n")
    env = {k: v for k, v in os.environ.items() if k not in ENV_KEYS}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


MEMBER = """
import json, sys, torch, torch.distributed as dist
from k8s_vgpu_scheduler_tpu_torch.parallel import multihost
assert multihost.initialize_from_env("gloo", timeout_s=60)
rank = dist.get_rank()
x = torch.tensor([float(rank + 1), float(10 * (rank + 1))])
dist.all_reduce(x, op=dist.ReduceOp.SUM)
m = torch.tensor([float(rank)])
dist.all_reduce(m, op=dist.ReduceOp.MAX)
print(json.dumps({"rank": rank, "size": dist.get_world_size(),
                  "sum": x.tolist(), "max": m.item()}))
dist.destroy_process_group()
"""


def test_two_processes_form_a_gloo_group_from_the_env(tmp_path):
    """Two members started with nothing but the gang env (rank, size,
    coordinator on a free local port) form one gloo group and
    all-reduce; a missing peer would end the run at the join timeout."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = []
    for rank in range(2):
        env = {k: v for k, v in os.environ.items() if k not in ENV_KEYS}
        env.update(VTPU_GANG_RANK=str(rank), VTPU_GANG_SIZE="2",
                   VTPU_GANG_COORDINATOR=f"127.0.0.1:{port}",
                   PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", MEMBER], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert sorted(o["rank"] for o in outs) == [0, 1]
    for o in outs:
        assert o["size"] == 2 and o["sum"] == [3.0, 30.0] and o["max"] == 1.0
