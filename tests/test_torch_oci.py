"""The port's OCI runtime wrapper (``oci/``, ``cmd/oci_runtime.py``) against
the JAX package's, argv for argv with tests/test_oci.py.

Every case of tests/test_oci.py runs on both packages (the swappable-exec
pattern of the reference's pkg/oci/runtime_exec_test.go: no process is
exec'd), each on its own bundle and runtime stand-in, on the same host
shim install.  The outcomes must be equal once the JAX package's are
written in the port's terms: the env under tests/test_torch_deviceplugin.py's
table (``TPU_VISIBLE_CHIPS`` is ``NVIDIA_VISIBLE_DEVICES``; the TPU device
indices and physical HBM have no counterpart), the mount destinations
/usr/local/vtpu -> /usr/local/vgpu and /tmp/vtpu -> /tmp/vgpu on the same
host paths, and each side's runtime path as ``<runtime>`` and its
directory as ``<side>``.  One stated difference, Allocate's
(tests/test_torch_deviceplugin.py's ``SHIM_ENV``): where the shim dir is
mounted and the node has no ``ld.so.preload``, the port's bundle also
puts the dir on ``PYTHONPATH``, for the shim's startup hook.

Then what the port adds: a grant's bundle equals the port's Allocate
answer for that grant; the bundle's own ``PYTHONPATH`` keeps its entries
after the shim dir, once however often the bundle is injected; ``delete``
reaches the runtime with a broken grant config.
"""

import json
import os
import stat

import pytest

from k8s_vgpu_scheduler_tpu import oci as joci
from k8s_vgpu_scheduler_tpu.cmd import oci_runtime as jcmd
from k8s_vgpu_scheduler_tpu.oci import runtime as jruntime
from k8s_vgpu_scheduler_tpu_torch import oci as toci
from k8s_vgpu_scheduler_tpu_torch.cmd import oci_runtime as tcmd
from k8s_vgpu_scheduler_tpu_torch.oci import runtime as truntime
from tests.test_torch_deviceplugin import SHIM_ENV, PATHS, \
    Side as PluginSide, as_port_envs

CACHE_HOST = "/tmp/vtpu/containers/x"
SPEC = {"ociVersion": "1.0.2",
        "process": {"env": ["PATH=/usr/bin"], "args": ["sleep", "1"]},
        "mounts": [{"destination": "/proc", "source": "proc",
                    "type": "proc"}]}


class Side:
    """One package's wrapper pieces under ``tmp``: its own runtime
    stand-in and bundles, the host paths shared with the other side."""

    def __init__(self, port: bool, tmp, shared) -> None:
        self.port = port
        self.tmp = tmp / ("port" if port else "jax")
        self.tmp.mkdir()
        self.shared = shared
        self.oci = toci if port else joci
        self.runtime = truntime if port else jruntime
        self.cmd = tcmd if port else jcmd
        self.runc = self.tmp / "runc"
        self.runc.write_text("#!/bin/sh\n")
        self.runc.chmod(self.runc.stat().st_mode | stat.S_IXUSR)

    def modifier(self, shim_host_dir=None):
        """tests/test_oci.py's grant: 3000 MiB on the card chip-a, 30%."""
        if self.port:
            return toci.inject_vgpu(
                {0: 3000}, core_limit=30, visible_devices="chip-a",
                cache_host_dir=CACHE_HOST,
                shim_host_dir=shim_host_dir or "/usr/local/vgpu")
        return joci.inject_vtpu(
            {0: 3000}, core_limit=30, visible_chips="chip-a",
            visible_devices="0", physical_mib={0: 16384},
            cache_host_dir=CACHE_HOST,
            shim_host_dir=shim_host_dir or "/usr/local/vtpu")

    def bundle(self, name="bundle"):
        b = self.tmp / name
        b.mkdir(parents=True)
        (b / "config.json").write_text(json.dumps(SPEC))
        return b

    def wrapper(self, bundle=None, shim_host_dir=None):
        rt = self.oci.SyscallExecRuntime(str(self.runc),
                                         exec_fn=lambda *a: None)
        spec = self.oci.FileSpec(str(bundle / "config.json")) \
            if bundle else None
        return self.oci.ModifyingRuntimeWrapper(
            rt, self.modifier(shim_host_dir), spec=spec)

    def create(self, w, argv) -> str:
        """exec ``argv``; the error it ends in (the stand-in exec returns)."""
        with pytest.raises(self.runtime.RuntimeError_) as e:
            w.exec(argv)
        return str(e.value).replace(str(self.runc), "<runtime>")

    def spec(self, bundle) -> dict:
        return json.loads((bundle / "config.json").read_text())


def shim_install(root, preload=True):
    shim = root / ("shim" if preload else "shim-nopreload")
    shim.mkdir(exist_ok=True)
    if preload:
        (shim / "ld.so.preload").write_text("/usr/local/vgpu/libvgpu_cuda.so\n")
    return str(shim)


# -- the cases of tests/test_oci.py, each a function of a side ---------------------
def rejects_non_executable(s):
    p = s.tmp / "notexec"
    p.write_text("")
    with pytest.raises(s.runtime.RuntimeError_):
        s.oci.SyscallExecRuntime(str(p))
    return "raised"


def rejects_missing(s):
    with pytest.raises(s.runtime.RuntimeError_):
        s.oci.SyscallExecRuntime("/does/not/exist")
    return "raised"


def argv0_forced_to_runtime_path(s):
    calls = []
    rt = s.oci.SyscallExecRuntime(
        str(s.runc), exec_fn=lambda path, argv, env: calls.append(
            (path, argv)))
    with pytest.raises(s.runtime.RuntimeError_, match="unexpected return"):
        rt.exec(["vtpu-runtime", "create", "--bundle", "/b", "id"])
    return [[str(x).replace(str(s.runc), "<runtime>") for x in (p, *a)]
            for p, a in calls]


def create_injects_env_and_mounts(s):
    b = s.bundle()
    w = s.wrapper(shim_host_dir=shim_install(s.shared))
    return s.create(w, ["rt", "create", "--bundle", str(b), "c1"]), s.spec(b)


def missing_shim_dir_skips_mounts_but_keeps_env(s):
    b = s.bundle()
    w = s.wrapper(shim_host_dir=str(s.shared / "nonexistent"))
    return s.create(w, ["rt", "create", "--bundle", str(b), "c1"]), s.spec(b)


def shim_dir_without_preload_mounts_lib_only(s):
    b = s.bundle()
    w = s.wrapper(shim_host_dir=shim_install(s.shared, preload=False))
    return s.create(w, ["rt", "create", "--bundle", str(b), "c1"]), s.spec(b)


def each_create_uses_its_own_bundle(s):
    b1, b2 = s.bundle("one"), s.bundle("two")
    w = s.wrapper()
    errs = [s.create(w, ["rt", "create", "--bundle", str(b), "c"])
            for b in (b1, b2)]
    return errs, s.spec(b1), s.spec(b2)


def create_without_bundle_uses_pinned_spec(s):
    b = s.bundle()
    w = s.wrapper(b)
    return s.create(w, ["rt", "create", "c1"]), s.spec(b)


def create_without_bundle_or_spec_fails_loud(s):
    w = s.wrapper()
    return s.create(w, ["rt", "create", "c1"])


def non_create_passthrough(s):
    b = s.bundle()
    before = (b / "config.json").read_text()
    w = s.wrapper(b)
    err = s.create(w, ["rt", "delete", "c1"])
    return err, (b / "config.json").read_text() == before


def create_after_global_flags(s):
    b = s.bundle()
    w = s.wrapper(b)
    return s.create(w, ["rt", "--root", "/run/runc", "create", "--bundle",
                        str(b), "c1"]), s.spec(b)


def idempotent_reinjection(s):
    b = s.bundle()
    w = s.wrapper(b, shim_host_dir=shim_install(s.shared))
    errs = [s.create(w, ["rt", "create", "--bundle", str(b), "c1"])
            for _ in range(2)]
    return errs, s.spec(b)


def filespec_modify_without_load_raises(s):
    f = s.oci.FileSpec(str(s.tmp / "config.json"))
    with pytest.raises(ValueError):
        f.modify(lambda x: x)
    return "raised"


def filespec_roundtrip(s):
    p = s.tmp / "config.json"
    p.write_text(json.dumps({"ociVersion": "1.0.2"}))
    f = s.oci.FileSpec(str(p))
    f.load()
    f.modify(lambda spec: {**spec, "hostname": "h"})
    f.flush()
    return json.loads(p.read_text())


def entrypoint_config_to_modifier_to_exec(s, monkeypatch):
    cfg = s.tmp / "oci.json"
    cfg.write_text(json.dumps(
        {"chip_limits_mib": {"0": 2000}, "core_limit": 50,
         "visible_devices": "u1"} if s.port else
        {"chip_limits_mib": {"0": 2000}, "physical_mib": {"0": 16384},
         "core_limit": 50, "visible_chips": "u1", "visible_devices": "0"}))
    b = s.tmp / "b"
    b.mkdir()
    (b / "config.json").write_text(json.dumps(
        {"process": {"env": []}, "mounts": []}))
    monkeypatch.setenv("VTPU_OCI_RUNTIME", str(s.runc))
    monkeypatch.setenv("VTPU_OCI_CONFIG", str(cfg))
    execs = []
    monkeypatch.setattr(os, "execve", lambda p, a, e: execs.append((p, a)))
    with pytest.raises(s.runtime.RuntimeError_):
        s.cmd.main(["vtpu-runc", "create", "--bundle", str(b), "c1"])
    return s.spec(b), [[str(x).replace(str(s.runc), "<runtime>").replace(
        str(s.tmp), "<side>") for x in (p, *a)] for p, a in execs]


def bundle_path_long_flag(s):
    return s.runtime.bundle_spec_path(["rt", "create", "--bundle", "/b", "c"])


def bundle_path_eq_form(s):
    return s.runtime.bundle_spec_path(["rt", "create", "--bundle=/b", "c"])


def bundle_path_absent(s):
    return s.runtime.bundle_spec_path(["rt", "state", "c"])


CASES = [rejects_non_executable, rejects_missing, argv0_forced_to_runtime_path,
         create_injects_env_and_mounts,
         missing_shim_dir_skips_mounts_but_keeps_env,
         shim_dir_without_preload_mounts_lib_only,
         each_create_uses_its_own_bundle,
         create_without_bundle_uses_pinned_spec,
         create_without_bundle_or_spec_fails_loud, non_create_passthrough,
         create_after_global_flags, idempotent_reinjection,
         filespec_modify_without_load_raises, filespec_roundtrip,
         entrypoint_config_to_modifier_to_exec, bundle_path_long_flag,
         bundle_path_eq_form, bundle_path_absent]


def as_port(value):
    """A JAX outcome in the port's terms: every spec's env through the env
    table, its mount destinations through the path table."""
    if isinstance(value, dict) and "process" in value:
        env = []
        for e in value["process"].get("env", []):
            k, v = e.split("=", 1)
            env += [f"{pk}={pv}" for pk, pv in as_port_envs({k: v}).items()]
        return {**value, "process": {**value["process"], "env": env},
                "mounts": [{**m, "destination": PATHS.get(m["destination"],
                                                          m["destination"])}
                           for m in value.get("mounts", [])]}
    if isinstance(value, (list, tuple)):
        return [as_port(v) for v in value]
    return value


@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_each_case_of_the_jax_tests(tmp_path, monkeypatch, case):
    shared = tmp_path / "host"
    shared.mkdir()
    outs = []
    for port in (False, True):
        s = Side(port, tmp_path, shared)
        args = (monkeypatch,) if "monkeypatch" in \
            case.__code__.co_varnames[:case.__code__.co_argcount] else ()
        outs.append(json.loads(json.dumps(case(s, *args))))
    want = as_port(outs[0])
    if case is shim_dir_without_preload_mounts_lib_only:
        want[1]["process"]["env"] += [f"{k}={v}" for k, v in SHIM_ENV.items()]
    assert outs[1] == want


def test_the_injected_bundle_holds_the_grant(tmp_path):
    """tests/test_oci.py's first case, read on the port's side alone."""
    s = Side(True, tmp_path, tmp_path)
    _, spec = create_injects_env_and_mounts(s)
    env = spec["process"]["env"]
    assert env == ["PATH=/usr/bin", "CUDA_DEVICE_MEMORY_LIMIT_0=3000",
                   "CUDA_DEVICE_SM_LIMIT=30", "NVIDIA_VISIBLE_DEVICES=chip-a",
                   "CUDA_DEVICE_MEMORY_SHARED_CACHE=/tmp/vgpu/cudevshr.cache"]
    assert [(m["destination"], m["source"]) for m in spec["mounts"]] == [
        ("/proc", "proc"), ("/usr/local/vgpu", str(tmp_path / "shim")),
        ("/etc/ld.so.preload", str(tmp_path / "shim" / "ld.so.preload")),
        ("/tmp/vgpu", CACHE_HOST)]


# -- the bundle is Allocate's answer ---------------------------------------------------
GRANTS = {
    "one_card": ([(0, 3000, 30)], {}, True),
    "two_cards": ([(0, 24000, 50), (2, 40000, 50)], {}, True),
    "oversubscribed": ([(1, 90000, 50)], {"vtpu.dev/oversubscribe": "true"},
                       True),
    "no_preload": ([(3, 8000, 100)], {}, False),
}


@pytest.mark.parametrize("case", list(GRANTS))
def test_a_grants_bundle_is_its_allocate_answer(tmp_path, case):
    """The same grant through the port's Allocate (a pod bound by the
    scheduler) and through a bundle: equal env, and equal mounts but for
    the OCI format (destination, source, rw/ro options), so the two paths
    cannot drift apart."""
    cards, anns, preload = GRANTS[case]
    shim = tmp_path / "shim"
    shim.mkdir()
    if preload:
        (shim / "ld.so.preload").write_text("/usr/local/vgpu/libvgpu_cuda.so\n")
    side = PluginSide(True, tmp_path)
    side.bind([cards], annotations=anns)
    [(envs, mounts)], err = side.allocate(1)
    assert err is None
    region = dict((c, h) for c, h, _ in mounts)["/tmp/vgpu"]
    modifier = toci.inject_vgpu(
        {i: mem for i, (_, mem, _) in enumerate(cards)},
        core_limit=cards[0][2],
        visible_devices=",".join(side.inv.chips[c].uuid for c, _, _ in cards),
        oversubscribe=bool(anns), shim_host_dir=str(shim),
        cache_host_dir=region)
    spec = modifier({"process": {"env": []}, "mounts": []})
    assert dict(e.split("=", 1) for e in spec["process"]["env"]) == envs
    assert sorted((m["destination"], m["source"], m["options"] == [
        "rbind", "ro"]) for m in spec["mounts"]) == sorted(mounts)
    assert all(m["type"] == "bind" for m in spec["mounts"])


# -- PYTHONPATH ------------------------------------------------------------------------
@pytest.mark.parametrize("preload,oversubscribe,own,want", [
    (True, True, "/app:/app/lib", "/usr/local/vgpu:/app:/app/lib"),
    (False, False, "/app", "/usr/local/vgpu:/app"),
    (True, True, None, "/usr/local/vgpu"),
    (True, True, "/usr/local/vgpu:/app", "/usr/local/vgpu:/app"),
    (True, False, "/app", "/app")],
    ids=["oversubscribed", "no_preload", "no_own", "already_first",
         "interposer_alone"])
def test_the_bundles_pythonpath_follows_the_shim_dir(tmp_path, preload,
                                                     oversubscribe, own,
                                                     want):
    """Where Allocate puts the shim dir on PYTHONPATH (the port's rule:
    the grant oversubscribes, or the node has no ld.so.preload), the
    bundle keeps the image's own entries after it, which kubelet's answer
    cannot; re-injecting the bundle leaves it as once injected."""
    shim = tmp_path / "shim"
    shim.mkdir()
    if preload:
        (shim / "ld.so.preload").write_text("/usr/local/vgpu/libvgpu_cuda.so\n")
    bundle = tmp_path / "bundle"
    bundle.mkdir()
    env = ["PATH=/usr/bin"] + ([f"PYTHONPATH={own}"] if own else [])
    (bundle / "config.json").write_text(json.dumps(
        {"process": {"env": env}, "mounts": []}))
    w = toci.ModifyingRuntimeWrapper(
        toci.SyscallExecRuntime(sys_true(tmp_path), exec_fn=lambda *a: None),
        toci.inject_vgpu({0: 4000}, visible_devices="GPU-a",
                         oversubscribe=oversubscribe,
                         shim_host_dir=str(shim)))
    specs = []
    for _ in range(2):
        with pytest.raises(truntime.RuntimeError_):
            w.exec(["rt", "create", "--bundle", str(bundle), "c1"])
        specs.append(json.loads((bundle / "config.json").read_text()))
    assert specs[0] == specs[1]
    got = [e for e in specs[1]["process"]["env"]
           if e.startswith("PYTHONPATH=")]
    assert got == [f"PYTHONPATH={want}"]


def sys_true(tmp_path) -> str:
    p = tmp_path / "runtime"
    p.write_text("#!/bin/sh\n")
    p.chmod(p.stat().st_mode | stat.S_IXUSR)
    return str(p)


# -- the entry point -------------------------------------------------------------------
@pytest.mark.parametrize("config", ["broken", "missing"])
@pytest.mark.parametrize("command", [["delete", "c1"], ["state", "c1"],
                                     ["--root", "/run/x", "kill", "c1"]])
def test_a_broken_config_leaves_other_commands_to_the_runtime(
        tmp_path, monkeypatch, config, command):
    """The grant is read on create alone: with a broken or missing config,
    delete/state/kill reach the runtime, argv[0] forced to it, and create
    fails before it does."""
    runtime = sys_true(tmp_path)
    cfg = tmp_path / "oci.json"
    if config == "broken":
        cfg.write_text("{not json")
    monkeypatch.setenv("VTPU_OCI_RUNTIME", runtime)
    monkeypatch.setenv("VTPU_OCI_CONFIG", str(cfg))
    execs = []
    monkeypatch.setattr(os, "execve", lambda p, a, e: execs.append((p, a)))
    with pytest.raises(truntime.RuntimeError_, match="unexpected return"):
        tcmd.main(["vgpu-oci-runtime", *command])
    assert execs == [(runtime, [runtime, *command])]
    bundle = tmp_path / "b"
    bundle.mkdir()
    (bundle / "config.json").write_text(json.dumps({"process": {}}))
    with pytest.raises((ValueError, OSError)):
        tcmd.main(["vgpu-oci-runtime", "create", "--bundle", str(bundle),
                   "c1"])
    assert len(execs) == 1


def test_the_config_keys_reach_the_bundle(tmp_path, monkeypatch):
    """Every key of the config: limits, SM limit, UUIDs, oversubscribe,
    the region file's path, the shim install and the region dir."""
    shim = tmp_path / "shim"
    shim.mkdir()
    (shim / "ld.so.preload").write_text("/usr/local/vgpu/libvgpu_cuda.so\n")
    cfg = tmp_path / "oci.json"
    cfg.write_text(json.dumps({
        "chip_limits_mib": {"0": 4000, "1": 2000}, "core_limit": 40,
        "visible_devices": "GPU-a,GPU-b", "oversubscribe": True,
        "cache_path": "/tmp/vgpu/cudevshr.cache",
        "shim_host_dir": str(shim), "cache_host_dir": str(tmp_path / "r")}))
    bundle = tmp_path / "b"
    bundle.mkdir()
    (bundle / "config.json").write_text(json.dumps(
        {"process": {"env": ["PYTHONPATH=/app"]}}))
    monkeypatch.setenv("VTPU_OCI_RUNTIME", sys_true(tmp_path))
    monkeypatch.setenv("VTPU_OCI_CONFIG", str(cfg))
    monkeypatch.setattr(os, "execve", lambda p, a, e: None)
    with pytest.raises(truntime.RuntimeError_):
        tcmd.main(["vgpu-oci-runtime", "create", "--bundle", str(bundle),
                   "c1"])
    spec = json.loads((bundle / "config.json").read_text())
    assert spec["process"]["env"] == [
        "CUDA_DEVICE_MEMORY_LIMIT_0=4000", "CUDA_DEVICE_MEMORY_LIMIT_1=2000",
        "CUDA_DEVICE_SM_LIMIT=40", "NVIDIA_VISIBLE_DEVICES=GPU-a,GPU-b",
        "CUDA_OVERSUBSCRIBE=true",
        "CUDA_DEVICE_MEMORY_SHARED_CACHE=/tmp/vgpu/cudevshr.cache",
        "PYTHONPATH=/usr/local/vgpu:/app"]
    assert [(m["destination"], m["source"], m["options"])
            for m in spec["mounts"]] == [
        ("/usr/local/vgpu", str(shim), ["rbind", "ro"]),
        ("/etc/ld.so.preload", str(shim / "ld.so.preload"), ["rbind", "ro"]),
        ("/tmp/vgpu", str(tmp_path / "r"), ["rbind", "rw"])]
