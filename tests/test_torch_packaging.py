"""The port's packaging: its image (``docker/Dockerfile.torch``), its CI
workflow (``.github/workflows/torch.yml``) and the one build entry both
rely on (``ops/_kernels.build_all``, ``python -m
k8s_vgpu_scheduler_tpu_torch.ops._kernels``).

Neither docker nor helm runs here: the Dockerfile is read as text, stage
by stage, and held to what the image must be (the build stage runs the
build entry and nothing else; the runtime stage carries the package with
its prebuilt ``build/`` and no compiler, torch or jax).  The build entry
is driven with its compiler lookups stubbed out.
"""

import re
import subprocess
import sys
from pathlib import Path

import pytest

from k8s_vgpu_scheduler_tpu_torch.ops import _kernels

yaml = pytest.importorskip("yaml")

ROOT = Path(__file__).resolve().parent.parent
DOCKERFILE = ROOT / "docker" / "Dockerfile.torch"
WORKFLOW = ROOT / ".github" / "workflows" / "torch.yml"
BUILD_MAIN = "python3 -m k8s_vgpu_scheduler_tpu_torch.ops._kernels"


def stages():
    """[(FROM line, [instructions])] of the Dockerfile, continuation lines
    joined and comments dropped."""
    text = re.sub(r"\\\n\s*", " ", DOCKERFILE.read_text())
    out = []
    for line in text.splitlines():
        line = " ".join(line.split())
        if not line or line.startswith("#"):
            continue
        if line.startswith("FROM "):
            out.append((line, []))
        else:
            out[-1][1].append(line)
    return out


def test_the_image_has_a_build_and_a_runtime_stage():
    (build_from, _), (run_from, _) = stages()
    # Ubuntu 22.04's glibc (2.35) is older than the runtime's (Debian 12,
    # 2.36): a 24.04 build calls __isoc23_strtol@GLIBC_2.38.
    assert re.fullmatch(
        r"FROM nvidia/cuda:12\.8\.\d+-devel-ubuntu22\.04 AS build",
        build_from)
    assert run_from == "FROM python:3.12-slim"


def test_the_build_stage_runs_the_kernels_main_and_nothing_else():
    _, build = stages()[0]
    runs = [i[4:] for i in build if i.startswith("RUN ")]
    copies = [i.split()[1:] for i in build if i.startswith("COPY ")]
    assert copies == [["k8s_vgpu_scheduler_tpu_torch",
                       "k8s_vgpu_scheduler_tpu_torch"]]
    # The toolchain, then the build entry on a package without a build/.
    assert runs[0].startswith("apt-get") and "g++" in runs[0]
    assert runs[1] == ("rm -rf k8s_vgpu_scheduler_tpu_torch/build && "
                       + BUILD_MAIN)
    assert len(runs) == 2


def test_the_runtime_stage_can_read_the_charts_quota_yaml():
    """The chart renders the capacity queues as YAML: the runtime stage
    installs PyYAML beside grpcio and protobuf."""
    _, run = stages()[1]
    installs = " ".join(i for i in run if i.startswith("RUN "))
    assert re.search(r"\bgrpcio protobuf pyyaml\b", installs)


def test_the_runtime_stage_carries_the_built_package_and_no_toolchain():
    _, run = stages()[1]
    assert ("COPY --from=build /src/k8s_vgpu_scheduler_tpu_torch "
            "k8s_vgpu_scheduler_tpu_torch") in run
    installs = " ".join(i for i in run if i.startswith("RUN "))
    assert "grpcio" in installs and "protobuf" in installs
    for banned in ("torch", "jax", "g++", "gcc", "nvcc", "cuda", "clang",
                   "build-essential"):
        assert not re.search(rf"\b{re.escape(banned)}\b", installs), banned
    assert "ENV PYTHONPATH=/app" in run
    [entry] = [i for i in run if i.startswith("ENTRYPOINT ")]
    argv = yaml.safe_load(entry[len("ENTRYPOINT "):])
    assert argv[:2] == ["python", "-m"]
    module = ROOT.joinpath(*argv[2].split(".")).with_suffix(".py")
    assert argv[2] == "k8s_vgpu_scheduler_tpu_torch.cmd.scheduler"
    assert module.is_file()


def test_every_copy_source_exists():
    for _, instructions in stages():
        for i in instructions:
            if i.startswith("COPY ") and "--from=" not in i:
                for src in i.split()[1:-1]:
                    assert (ROOT / src).exists(), src


def test_the_chart_runs_the_image_entry_points():
    """Every python -m module the chart starts is a module of the
    package the image carries."""
    text = "".join(p.read_text() for p in
                   (ROOT / "charts" / "vgpu" / "templates").rglob("*.yaml"))
    modules = set(re.findall(r"-\s+(k8s_vgpu_scheduler_tpu_torch[.\w]+)",
                             text))
    assert modules == {"k8s_vgpu_scheduler_tpu_torch.cmd.scheduler",
                       "k8s_vgpu_scheduler_tpu_torch.cmd.device_plugin",
                       "k8s_vgpu_scheduler_tpu_torch.cmd.monitor"}
    for m in modules:
        assert ROOT.joinpath(*m.split(".")).with_suffix(".py").is_file()


def test_the_daemons_import_without_torch_jax_or_numpy():
    """The image installs none of them: each daemon the chart starts, and
    the build entry, import with all three refused."""
    code = (
        "import sys\n"
        "class Refuse:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('torch', 'jax', 'numpy'):\n"
        "            raise ImportError('refused: ' + name)\n"
        "sys.meta_path.insert(0, Refuse())\n"
        "import k8s_vgpu_scheduler_tpu_torch.cmd.scheduler\n"
        "import k8s_vgpu_scheduler_tpu_torch.cmd.device_plugin\n"
        "import k8s_vgpu_scheduler_tpu_torch.cmd.monitor\n"
        "import k8s_vgpu_scheduler_tpu_torch.ops._kernels\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_the_workflow_tests_the_port_and_builds_its_image():
    wf = yaml.safe_load(WORKFLOW.read_text())
    assert set(wf["jobs"]) == {"test", "image"}
    test = [s.get("run", "") for s in wf["jobs"]["test"]["steps"]]
    image = [s.get("run", "") for s in wf["jobs"]["image"]["steps"]]
    [setup] = [s for s in wf["jobs"]["test"]["steps"]
               if s.get("uses", "").startswith("actions/setup-python")]
    assert setup["with"]["python-version"] == "3.12"
    assert any("download.pytorch.org/whl/cpu" in r for r in test)
    main = yaml.safe_load((ROOT / ".github" / "workflows" / "main.yml")
                          .read_text())
    [jax_deps] = [s["run"] for s in main["jobs"]["test"]["steps"]
                  if s.get("name") == "Install deps"]
    assert any(r == jax_deps for r in test)
    [pytest_run] = [r for r in test if "python -m pytest" in r]
    assert "tests/test_torch_*.py" in pytest_run
    assert '-m "not slow"' in pytest_run
    assert any(r.startswith("docker build -f docker/Dockerfile.torch")
               for r in image)


def test_build_all_raises_where_there_is_no_nvcc(monkeypatch):
    monkeypatch.setattr(_kernels.shutil, "which", lambda name: None)
    monkeypatch.setattr(_kernels, "NVCC_FALLBACK",
                        Path("/nonexistent/bin/nvcc"))

    def refuse(*a, **k):
        raise AssertionError("a compiler was started")

    monkeypatch.setattr(_kernels.subprocess, "run", refuse)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.build_all()


def test_build_all_builds_every_library_a_deployment_ships(monkeypatch,
                                                           tmp_path):
    """Each kernel with nvcc for sm_90a, the enforcement library and the
    interposer with g++, all started at once; names by source hash."""
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_kernels, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_kernels, "_gxx", lambda: "g++")
    seen = []

    def run(cmd, **kw):
        seen.append(cmd)
        Path(cmd[-1]).write_bytes(b"built")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(_kernels.subprocess, "run", run)
    built = _kernels.build_all()
    assert set(built) == {"flash_fwd", "flash_bwd", "vgpu", "interposer"}
    assert all(p.parent == tmp_path and p.read_bytes() == b"built"
               for p in built.values())
    tools = sorted(cmd[0] for cmd in seen)
    assert tools == ["g++", "g++", "nvcc", "nvcc"]
    for cmd in seen:
        if cmd[0] == "nvcc":
            assert "arch=compute_90a,code=sm_90a" in cmd
    seen.clear()
    assert _kernels.build_all() == built and not seen  # nothing rebuilt


def test_a_built_library_loads_without_a_compiler(monkeypatch, tmp_path):
    """The image's runtime stage has no compiler: a library whose build
    is there is returned without looking for one."""
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path)
    digest = _kernels.source_digest(_kernels.CSRC / "flash_fwd.cu")
    name = f"libflash_fwd-{digest}.so"
    (tmp_path / name).write_bytes(b"prebuilt")
    srcs = [_kernels.VGPU_DIR / s for s in _kernels.VGPU_SOURCES]
    vgpu = tmp_path / f"libvgpu_torch-{_kernels._digest(srcs)}.so"
    vgpu.write_bytes(b"prebuilt")

    def missing():
        raise RuntimeError("no compiler here")

    monkeypatch.setattr(_kernels, "_nvcc", missing)
    monkeypatch.setattr(_kernels, "_gxx", missing)
    assert _kernels.build("flash_fwd") == tmp_path / name
    assert _kernels.build_vgpu() == vgpu
    with pytest.raises(RuntimeError, match="no compiler here"):
        _kernels.build_interposer()  # not built: it needs g++


def test_the_build_entry_prints_each_library(monkeypatch, tmp_path,
                                            capsys):
    """``python -m ...ops._kernels`` (its ``main``) runs build_all and
    prints a line a library; the build is stubbed here."""
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_kernels, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_kernels, "_gxx", lambda: "g++")

    def run(cmd, **kw):
        Path(cmd[-1]).write_bytes(b"")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(_kernels.subprocess, "run", run)
    _kernels.main()
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(": ")[0] for ln in lines] == [
        "flash_fwd", "flash_bwd", "vgpu", "interposer"]
    assert all(ln.split(": ")[1].startswith(str(tmp_path)) for ln in lines)
    src = Path(_kernels.__file__).read_text()
    assert src.rstrip().endswith('if __name__ == "__main__":\n    main()')
