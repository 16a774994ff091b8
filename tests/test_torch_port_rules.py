"""Rules of the PyTorch/CUDA port that no parity test would catch.

- The port and chip_smoke.py import nothing of JAX, Flax, optax or the
  JAX package (the port keeps its own copies), nor orbax (the checkpoint
  writes with torch.save) or prometheus_client (the HTTP front writes its
  exposition text itself).
- Entry points run on the card unless the caller asks for the CPU: on a
  box without a card they raise instead of quietly using the CPU.
- Importing the kernel binding compiles nothing (the tests import it on
  boxes without nvcc).
- The CUDA entry points and their ctypes signatures agree.
- A kernel's build is named by its source and the headers it includes.
- The CPU path, forward and backward, builds and launches nothing.
- The enforcement layer (``shim/``, ``tpulib/``) imports torch only inside
  functions, and the node monitor (``monitor/``, ``accounting/``,
  ``cmd/monitor.py``) and the node agent (``deviceplugin/``, ``k8s/``,
  ``util/``, ``api/``, ``tpulib/nvml.py``, ``cmd/device_plugin.py``) and
  the scheduler extender (``scheduler/``, ``health/``,
  ``util/resources.py``, ``cmd/scheduler.py``) and the slice engine
  (``topology/``, ``placement/``, ``deviceplugin/allocator.py``) import
  none at all; the node agent's Allocate core, the slice engine and the
  scheduler's core import neither grpc nor protobuf, and the agent raises
  without NVML and without the mock; ``placement/`` imports nothing but
  its mesh module;
  nothing in the port reads
  ``lib/tpu/``, and ``csrc/vgpu/``
  builds with g++ into the port's build directory: the enforcement
  library, the driver-API interposer, its mock driver and its C test
  driver, each named by its sources.
"""

import ast
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import chip_smoke
from k8s_vgpu_scheduler_tpu_torch.cmd import serve as serve_cmd
from k8s_vgpu_scheduler_tpu_torch.device import resolve_device
from k8s_vgpu_scheduler_tpu_torch.entry import entry
from k8s_vgpu_scheduler_tpu_torch.models.checkpoint import restore_checkpoint
from k8s_vgpu_scheduler_tpu_torch.models import convert, workloads
from k8s_vgpu_scheduler_tpu_torch.models.convert import (
    init_weights, quantize_model)
from k8s_vgpu_scheduler_tpu_torch.models.deeplab import DeepLabV3, deeplab_v3
from k8s_vgpu_scheduler_tpu_torch.models.llama import Llama, llama_tiny
from k8s_vgpu_scheduler_tpu_torch.models.lstm import LSTMClassifier
from k8s_vgpu_scheduler_tpu_torch.models.resnet import (
    ResNetConfig, ResNetV2, resnet_v2_50)
from k8s_vgpu_scheduler_tpu_torch.models.vgg import VGG16
from k8s_vgpu_scheduler_tpu_torch.models.train import init_train_state
from k8s_vgpu_scheduler_tpu_torch.ops import _kernels
from k8s_vgpu_scheduler_tpu_torch.ops import flash_attention as tfa

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "k8s_vgpu_scheduler_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "k8s_vgpu_scheduler_tpu")


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_imports_nothing_of_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_imports_no_orbax_or_prometheus_client(path):
    bad = sorted(set(_imported_roots(path)) & {"orbax", "prometheus_client"})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_new_modules_are_under_the_import_rules():
    for rel in ("models/checkpoint.py", "models/quant.py", "cmd/serve.py",
                "shim/preempt.py", "models/layers.py", "models/resnet.py",
                "models/vgg.py", "models/deeplab.py", "models/lstm.py",
                "models/workloads.py", "tpulib/nvml.py",
                "deviceplugin/plugin.py", "deviceplugin/cache.py",
                "deviceplugin/register.py", "cmd/device_plugin.py",
                "k8s/client.py", "k8s/fake.py", "k8s/rest.py",
                "util/types.py", "util/config.py", "util/codec.py",
                "util/nodelock.py", "util/protocol.py",
                "util/enforcement.py", "util/trace.py", "api/kubelet.py",
                "api/service.py", "api/deviceplugin_pb2.py",
                "api/device_register_pb2.py", "util/resources.py",
                "scheduler/__init__.py", "scheduler/core.py",
                "scheduler/nodes.py", "scheduler/pods.py",
                "scheduler/score.py", "scheduler/webhook.py",
                "scheduler/routes.py", "health/__init__.py",
                "health/lease.py", "cmd/scheduler.py",
                "health/quarantine.py", "health/faults.py",
                "health/rescuer.py", "scheduler/preempt.py",
                "shim/startup.py", "topology/__init__.py",
                "topology/torus.py", "placement/__init__.py",
                "placement/mesh.py", "deviceplugin/allocator.py",
                "deviceplugin/partition.py", "oci/__init__.py",
                "oci/spec.py", "oci/runtime.py", "cmd/oci_runtime.py",
                "util/debugz.py", "util/exposition.py",
                "accounting/forecast.py", "accounting/ledger.py",
                "accounting/efficiency.py", "monitor/metrics.py",
                "monitor/noderpc.py", "api/noderpc_pb2.py",
                "scheduler/metrics.py", "cmd/vgpu_smi.py",
                "cmd/vgpu_report.py", "cmd/simulate.py",
                "scheduler/gang.py", "parallel/multihost.py",
                "placement/frag.py", "placement/reserve.py",
                "placement/defrag.py", "elastic/__init__.py",
                "elastic/ranges.py", "elastic/controller.py",
                "accounting/planner.py"):
        assert PORT / rel in SOURCES, rel


def test_the_startup_hook_imports_the_standard_library_alone():
    """The hook runs at the start of every Python process of a pod: it
    imports os and sys at its top, importlib only once the program
    imports the port's shim, and names the port by a string alone;
    importing it as a module installs nothing."""
    path = PORT / "shim" / "startup.py"
    tree = ast.parse(path.read_text())
    top = {alias.name for node in tree.body
           if isinstance(node, ast.Import) for alias in node.names}
    assert top == {"os", "sys"}
    assert not [n for n in tree.body if isinstance(n, ast.ImportFrom)]
    inner = set(_imported_roots(path))
    assert inner <= {"os", "sys", "importlib"}, inner
    code = ("import sys\n"
            "import k8s_vgpu_scheduler_tpu_torch.shim.startup as s\n"
            "assert s.__name__ != 'sitecustomize'\n"
            "assert s.managed()\n"
            "from k8s_vgpu_scheduler_tpu_torch.shim import core\n"
            "assert core._GLOBAL is None and 'torch' not in sys.modules\n"
            "assert s.SHIM_MODULE == core.__name__\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ,
                                  CUDA_DEVICE_MEMORY_SHARED_CACHE="/x/y"),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_the_shim_install_carries_no_copy_of_the_port(tmp_path):
    """install_shim writes the interposer, its ld.so.preload and the
    startup hook, and nothing else: a pod imports its own port."""
    _kernels.install_shim(tmp_path / "shim")
    assert sorted(p.name for p in (tmp_path / "shim").iterdir()) == [
        "ld.so.preload", "libvgpu_cuda.so", "sitecustomize.py"]
    assert (tmp_path / "shim" / "sitecustomize.py").read_bytes() == \
        (PORT / "shim" / "startup.py").read_bytes()


SMALL_RESNET = ResNetConfig(stage_sizes=(1, 1, 1, 1), width=32)


@pytest.mark.parametrize("call", [
    lambda: resolve_device(),
    lambda: Llama(llama_tiny()),
    lambda: init_weights(llama_tiny(), torch.Generator()),
    lambda: entry(),
    lambda: init_train_state(llama_tiny(), torch.Generator()),
    lambda: restore_checkpoint("unused", init_weights(
        llama_tiny(), torch.Generator(), device="cpu")),
    lambda: quantize_model(init_weights(
        llama_tiny(), torch.Generator(), device="cpu"), 8),
    lambda: serve_cmd.build_engine(serve_cmd.parse_args(["--demo", "tiny"])),
    lambda: ResNetV2(resnet_v2_50()),
    lambda: VGG16(),
    lambda: DeepLabV3(deeplab_v3()),
    lambda: LSTMClassifier(),
    lambda: convert.init_resnet(SMALL_RESNET, torch.Generator()),
    lambda: convert.init_vgg(torch.Generator(), size=32),
    lambda: convert.init_deeplab(deeplab_v3(), torch.Generator()),
    lambda: convert.init_lstm(torch.Generator()),
    lambda: convert.resnet_from_flax({}, SMALL_RESNET),
    lambda: convert.vgg_from_flax({}),
    lambda: convert.deeplab_from_flax({}, deeplab_v3()),
    lambda: convert.lstm_from_flax({}),
    lambda: workloads.build("lstm_train_bf16_b10_1024x300",
                            torch.Generator()),
], ids=["resolve_device", "Llama", "init_weights", "entry",
        "init_train_state", "restore_checkpoint", "quantize_model",
        "serve_build_engine", "ResNetV2", "VGG16", "DeepLabV3",
        "LSTMClassifier", "init_resnet", "init_vgg", "init_deeplab",
        "init_lstm", "resnet_from_flax", "vgg_from_flax",
        "deeplab_from_flax", "lstm_from_flax", "workloads_build"])
def test_entry_points_default_to_the_card(call):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


def test_kernel_module_import_runs_no_compiler():
    # A fresh interpreter in which starting any process fails.
    code = (
        "import subprocess\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError('a process was started')\n"
        "subprocess.Popen = refuse\n"
        "import k8s_vgpu_scheduler_tpu_torch.ops._kernels as k\n"
        "import k8s_vgpu_scheduler_tpu_torch.ops.flash_attention\n"
        "import k8s_vgpu_scheduler_tpu_torch.entry\n"
        "import k8s_vgpu_scheduler_tpu_torch.models.train\n"
        "import k8s_vgpu_scheduler_tpu_torch.shim\n"
        "import k8s_vgpu_scheduler_tpu_torch.tpulib\n"
        "import k8s_vgpu_scheduler_tpu_torch.monitor\n"
        "import k8s_vgpu_scheduler_tpu_torch.accounting\n"
        "import k8s_vgpu_scheduler_tpu_torch.cmd.monitor\n"
        "import k8s_vgpu_scheduler_tpu_torch.shim.simlab\n"
        "import k8s_vgpu_scheduler_tpu_torch.shim.preempt\n"
        "import k8s_vgpu_scheduler_tpu_torch.models.checkpoint\n"
        "import k8s_vgpu_scheduler_tpu_torch.models.quant\n"
        "import k8s_vgpu_scheduler_tpu_torch.cmd.serve\n"
        "import k8s_vgpu_scheduler_tpu_torch.models.workloads\n"
        "import k8s_vgpu_scheduler_tpu_torch.deviceplugin\n"
        "import k8s_vgpu_scheduler_tpu_torch.cmd.device_plugin\n"
        "import k8s_vgpu_scheduler_tpu_torch.api.kubelet\n"
        "import k8s_vgpu_scheduler_tpu_torch.api.service\n"
        "import k8s_vgpu_scheduler_tpu_torch.scheduler.routes\n"
        "import k8s_vgpu_scheduler_tpu_torch.cmd.scheduler\n"
        "import k8s_vgpu_scheduler_tpu_torch.scheduler.metrics\n"
        "import k8s_vgpu_scheduler_tpu_torch.monitor.metrics\n"
        "import k8s_vgpu_scheduler_tpu_torch.cmd.vgpu_smi\n"
        "import k8s_vgpu_scheduler_tpu_torch.cmd.vgpu_report\n"
        "assert not k._libs and not k.build_logs\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _assert_signature(source: str, symbol: str, argtypes) -> None:
    src = (_kernels.CSRC / source).read_text()
    m = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', src)
    assert m, f"{symbol} entry point not found"
    params = [p.strip() for p in m.group(1).split(",")]
    assert len(params) == len(argtypes)
    # c_longlong is an alias of c_long on LP64 platforms.
    ctypes_kind = {"c_void_p": "void*", "c_int": "int",
                   "c_longlong": "long long", "c_long": "long long",
                   "c_float": "float"}
    for decl, ctype in zip(params, argtypes):
        want = ctypes_kind[ctype.__name__]
        got = decl.rsplit(" ", 1)[0].replace("const ", "").replace(" *", "*")
        assert got == want, f"{decl!r} bound as {ctype.__name__}"


def test_cuda_signature_matches_ctypes():
    _assert_signature("flash_fwd.cu", "flash_fwd", _kernels.FLASH_FWD_ARGTYPES)


@pytest.mark.parametrize("symbol,argtypes", [
    ("flash_bwd_dq", _kernels.FLASH_BWD_DQ_ARGTYPES),
    ("flash_bwd_dkv", _kernels.FLASH_BWD_DKV_ARGTYPES),
], ids=["flash_bwd_dq", "flash_bwd_dkv"])
def test_backward_signatures_match_ctypes(symbol, argtypes):
    _assert_signature("flash_bwd.cu", symbol, argtypes)


def test_cpu_backward_launches_nothing(monkeypatch):
    def refuse():
        raise AssertionError("the CPU path must not build or launch")

    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        monkeypatch.setattr(tfa._kernels, name, refuse)
    counters = (tfa.flash_attention, tfa.flash_bwd_dq, tfa.flash_bwd_dkv)
    before = [f.launches for f in counters]
    q, k, v = (torch.randn(1, 16, 2, 16, requires_grad=True)
               for _ in range(3))
    tfa.flash_attention(q, k, v).sum().backward()
    assert q.grad is not None and k.grad is not None and v.grad is not None
    assert [f.launches for f in counters] == before
    assert not _kernels._libs


def test_every_cuda_kernel_has_a_profile_family():
    # chip_smoke.py sums device time by kernel name; a kernel its patterns
    # miss would drop silently into the "other" family.
    patterns = chip_smoke.KERNEL_GROUPS["port_kernels"]
    names = [name for src in sorted(_kernels.CSRC.glob("*.cu"))
             for name in re.findall(
                 r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                 r"(\w+)\s*\(", src.read_text())]
    assert len(names) >= 6
    missed = [n for n in names if not any(p in n for p in patterns)]
    assert not missed, f"kernels outside KERNEL_GROUPS: {missed}"
    # One name each: a pattern inside another kernel's name would count
    # that kernel's calls as its own.
    for p in patterns:
        assert [n for n in names if p in n] == [p], p


def test_kernels_build_for_sm90a_into_an_ignored_dir():
    assert "arch=compute_90a,code=sm_90a" in _kernels.ARCH_FLAGS
    ignored = (ROOT / ".gitignore").read_text().split()
    rel = _kernels.BUILD_DIR.relative_to(ROOT).as_posix() + "/"
    assert rel in ignored


def test_build_digest_covers_included_headers(tmp_path):
    # An edited header must not load a library built from the old one.
    (tmp_path / "inner.cuh").write_text("#define A 1\n")
    (tmp_path / "outer.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    (tmp_path / "other.cuh").write_text("#define B 1\n")
    src = tmp_path / "k.cu"
    src.write_text('#include <stdint.h>\n  #include "outer.cuh"\nint x;\n')
    first = _kernels.source_digest(src)
    assert _kernels.source_digest(src) == first
    (tmp_path / "other.cuh").write_text("#define B 2\n")  # not included
    assert _kernels.source_digest(src) == first
    (tmp_path / "inner.cuh").write_text("#define A 2\n")
    second = _kernels.source_digest(src)
    assert second != first
    src.write_text('#include <stdint.h>\n  #include "outer.cuh"\nint y;\n')
    assert _kernels.source_digest(src) not in (first, second)


@pytest.mark.parametrize("source", ["flash_fwd.cu", "flash_bwd.cu"])
def test_kernel_sources_share_the_tensor_core_header(source):
    src = _kernels.CSRC / source
    assert '#include "tensor_core.cuh"' in src.read_text()
    alone = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    assert _kernels.source_digest(src) != alone


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__fd017272_12_flash_bwd_cu_3c15cd2824flash_bwd_dkv_mma_kernelILi128ELi32EEEvPK13__nv_bfloat16S3_S3_S3_PKfS5_PS1_S6_iiNS_7StridesES7_S7_S7_S7_S7_fii' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__fd017272_12_flash_bwd_cu_3c15cd2824flash_bwd_dkv_mma_kernelILi128ELi32EEEvPK13__nv_bfloat16S3_S3_S3_PKfS5_PS1_S6_iiNS_7StridesES7_S7_S7_S7_S7_fii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 242 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__fd017272_12_flash_bwd_cu_3c15cd2819flash_bwd_dq_kernelILi16EEEvPKfS2_S2_S2_S2_S2_Pfii' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__fd017272_12_flash_bwd_cu_3c15cd2819flash_bwd_dq_kernelILi16EEEvPKfS2_S2_S2_S2_S2_Pfii
    8 bytes stack frame, 12 bytes spill stores, 20 bytes spill loads
ptxas info    : Used 42 registers, used 1 barriers, 4096 bytes smem
"""


def test_ptxas_log_reads_registers_and_spills():
    # chip_smoke.py fails a run whose tensor-core kernels spill; the names
    # sit inside the mangled anonymous namespace of their file.
    assert chip_smoke.ptxas_kernels(PTXAS_LOG) == [
        dict(kernel="flash_bwd_dkv_mma_kernel", head_dim=128,
             registers=242, spill_bytes=0),
        dict(kernel="flash_bwd_dq_kernel", head_dim=16, registers=42,
             spill_bytes=32)]


ENFORCEMENT = sorted((PORT / "shim").glob("*.py")) + \
    sorted((PORT / "tpulib").glob("*.py"))
# The node monitor: a daemon that never touches the card.
MONITOR = sorted((PORT / "monitor").glob("*.py")) + \
    sorted((PORT / "accounting").glob("*.py")) + [PORT / "cmd" / "monitor.py"]


def test_serve_command_imports_torch_only_under_its_entry_point():
    """The serving pod brings the card up inside its enforcement env: the
    HTTP front's module imports the stdlib only."""
    path = PORT / "cmd" / "serve.py"
    top = set()
    for node in ast.parse(path.read_text(), str(path)).body:
        if isinstance(node, ast.Import):
            top |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, (ast.ImportFrom)) and node.level == 0:
            top.add(node.module.split(".")[0])
    assert top <= set(sys.stdlib_module_names) | {"__future__"}, sorted(top)
    code = ("import sys\n"
            "import k8s_vgpu_scheduler_tpu_torch.cmd.serve as s\n"
            "s.prometheus_text({'stats': {}, 'utilization': 0, "
            "'queue_depth': 0, 'pool_hbm_bytes': 0})\n"
            "assert 'torch' not in sys.modules, 'torch imported'\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("path", ENFORCEMENT + MONITOR,
                         ids=[str(p.relative_to(ROOT))
                              for p in ENFORCEMENT + MONITOR])
def test_enforcement_imports_torch_only_inside_functions(path):
    top = set()
    for node in ast.parse(path.read_text(), str(path)).body:
        if isinstance(node, ast.Import):
            top |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            top.add(node.module.split(".")[0])
    assert not top & {"torch", "numpy", *FORBIDDEN}, sorted(top)
    if path in MONITOR:  # not even inside a function
        inner = set(_imported_roots(path))
        assert not inner & {"torch", "numpy", *FORBIDDEN}, sorted(inner)


def test_a_solve_worker_imports_no_torch():
    """A solve worker's import chain in a fresh interpreter (``spawn``
    re-imports the parent's ``__main__`` and the worker module, which
    imports the scheduler's batch module and the shared columns): no
    torch and no jax in ``sys.modules``."""
    code = ("import sys\n"
            "import k8s_vgpu_scheduler_tpu_torch.parallelcp.workers\n"
            "from k8s_vgpu_scheduler_tpu_torch.scheduler import batch\n"
            "assert batch.ColumnarFleet().columns\n"
            "assert 'torch' not in sys.modules, 'torch imported'\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_enforcement_import_loads_no_torch():
    code = ("import sys\n"
            "import k8s_vgpu_scheduler_tpu_torch.shim\n"
            "import k8s_vgpu_scheduler_tpu_torch.tpulib\n"
            "import k8s_vgpu_scheduler_tpu_torch.monitor\n"
            "import k8s_vgpu_scheduler_tpu_torch.accounting\n"
            "import k8s_vgpu_scheduler_tpu_torch.cmd.monitor\n"
            "import k8s_vgpu_scheduler_tpu_torch.shim.simlab\n"
            "import tempfile\n"
            "from k8s_vgpu_scheduler_tpu_torch.monitor import FeedbackLoop\n"
            "from k8s_vgpu_scheduler_tpu_torch.accounting import "
            "UsageSampler\n"
            "loop = FeedbackLoop(tempfile.mkdtemp())\n"
            "loop.tick()\n"
            "UsageSampler(loop).sample()\n"
            "assert 'torch' not in sys.modules, 'torch imported'\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


PORT_FILES = sorted(p for p in PORT.rglob("*")
                    if p.is_file() and "build" not in p.parts
                    and "__pycache__" not in p.parts)


# The node agent: a DaemonSet that must hold no context on the cards it
# advertises, so no torch anywhere in it; nor in the scheduler extender,
# a control plane that holds no tensor.
NODE_AGENT = sorted(p for d in ("deviceplugin", "k8s", "util", "api",
                                "scheduler", "health", "topology",
                                "placement", "oci")
                    for p in (PORT / d).glob("*.py")) + [
    PORT / "tpulib" / "nvml.py", PORT / "cmd" / "device_plugin.py",
    PORT / "cmd" / "scheduler.py", PORT / "cmd" / "oci_runtime.py"]


@pytest.mark.parametrize("path", NODE_AGENT,
                         ids=[str(p.relative_to(ROOT)) for p in NODE_AGENT])
def test_node_agent_imports_no_torch(path):
    inner = set(_imported_roots(path))
    assert not inner & {"torch", "numpy", *FORBIDDEN}, sorted(inner)


def test_allocate_core_runs_without_grpc_protobuf_or_torch(tmp_path):
    """The core that turns a pod into per-container env and mounts, with
    grpc and protobuf blocked: the card's machine need not have them."""
    code = (
        "import sys\n"
        "for name in ('grpc', 'google.protobuf', 'torch'):\n"
        "    sys.modules[name] = None  # importing it raises\n"
        "from k8s_vgpu_scheduler_tpu_torch.deviceplugin import (\n"
        "    DeviceCache, GpuDevicePlugin, advertised_devices)\n"
        "from k8s_vgpu_scheduler_tpu_torch.k8s import FakeKube\n"
        "from k8s_vgpu_scheduler_tpu_torch.tpulib import MockBackend, "
        "H100_FIXTURE\n"
        "from k8s_vgpu_scheduler_tpu_torch.util import codec, nodelock\n"
        "from k8s_vgpu_scheduler_tpu_torch.util import types as t\n"
        "from k8s_vgpu_scheduler_tpu_torch.util.config import Config\n"
        "cache = DeviceCache(MockBackend(H100_FIXTURE))\n"
        "cache.poll_once()\n"
        "inv = cache.inventory\n"
        "kube = FakeKube()\n"
        "kube.add_node({'metadata': {'name': 'n', 'annotations': {}}})\n"
        "nodelock.lock_node(kube, 'n')\n"
        "grant = [[t.ContainerDevice(inv.chips[0].uuid, inv.chips[0].type,"
        " 24000, 50)]]\n"
        "kube.create_pod({'metadata': {'name': 'p', 'namespace': 'default',"
        " 'uid': 'u', 'annotations': {t.BIND_TIME_ANNOTATION: '1',"
        " t.BIND_PHASE_ANNOTATION: t.BIND_ALLOCATING,"
        " t.ASSIGNED_NODE_ANNOTATION: 'n',"
        " t.TO_ALLOCATE_ANNOTATION: codec.encode_pod_devices(grant)}},"
        " 'spec': {'nodeName': 'n'}})\n"
        f"cfg = Config(node_name='n', cache_host_dir={str(tmp_path)!r},"
        f" shim_host_dir={str(tmp_path / 'shim')!r})\n"
        "[r] = GpuDevicePlugin(kube, inv, cfg).allocate(1)\n"
        "assert r.envs['CUDA_DEVICE_MEMORY_LIMIT_0'] == '24000', r\n"
        "assert not nodelock.is_locked(kube, 'n')\n"
        "assert advertised_devices(inv, cfg)[0]['devmem'] == 81079\n"
        "assert not {'grpc', 'torch'} & {m.split('.')[0] for m, v in "
        "sys.modules.items() if v is not None}\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_partitions_and_the_oci_wrapper_run_without_grpc_protobuf_or_torch(
        tmp_path):
    """The partition core (enumeration, the whole-card view, passthrough
    Allocate, the single refusals) and the OCI wrapper's injection, with
    grpc and protobuf blocked."""
    code = (
        "import sys\n"
        "for name in ('grpc', 'google.protobuf', 'torch'):\n"
        "    sys.modules[name] = None  # importing it raises\n"
        "from k8s_vgpu_scheduler_tpu_torch.deviceplugin import partition\n"
        "from k8s_vgpu_scheduler_tpu_torch.cmd import oci_runtime\n"
        "from k8s_vgpu_scheduler_tpu_torch.oci import inject_vgpu\n"
        "from k8s_vgpu_scheduler_tpu_torch.tpulib import MockBackend\n"
        "from k8s_vgpu_scheduler_tpu_torch.util.config import Config\n"
        "fx = {'generation': 'h100', 'mesh': [2], 'chips': [\n"
        "    {'coords': [0], 'mig': [{'slices': 3, 'mib': 40448}] * 2},\n"
        "    {'coords': [1]}]}\n"
        "inv = MockBackend(fx).inventory()\n"
        f"cfg = Config(partition_strategy='mixed', cache_host_dir="
        f"{str(tmp_path)!r}, shim_host_dir={str(tmp_path / 'shim')!r})\n"
        "[p] = partition.get_partition_plugins('mixed', inv, cfg,\n"
        f"                                 {str(tmp_path)!r})\n"
        "r = p.allocate(['MIG-h100-mock-0-1'])\n"
        "assert r.envs['CUDA_DEVICE_MEMORY_LIMIT_0'] == '40448', r\n"
        "assert [c.uuid for c in partition.whole_chip_view(inv).chips]"
        " == ['GPU-h100-mock-1']\n"
        "assert partition.single_refusal(inv, Config(\n"
        "    partition_strategy='single'))\n"
        "spec = inject_vgpu({0: 100})({'process': {}})\n"
        "assert spec['process']['env'], spec\n"
        "assert not {'grpc', 'torch'} & {m.split('.')[0] for m, v in "
        "sys.modules.items() if v is not None}\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_scheduler_core_runs_without_grpc_protobuf_or_torch():
    """The extender's core, webhook and HTTP routes, with grpc and
    protobuf blocked: a register message is read by its fields, and a pod
    is mutated, placed and bound over HTTP."""
    code = (
        "import sys, json, types, urllib.request\n"
        "for name in ('grpc', 'google.protobuf', 'torch'):\n"
        "    sys.modules[name] = None  # importing it raises\n"
        "from k8s_vgpu_scheduler_tpu_torch.deviceplugin import "
        "advertised_devices\n"
        "from k8s_vgpu_scheduler_tpu_torch.k8s import FakeKube\n"
        "from k8s_vgpu_scheduler_tpu_torch.scheduler import Scheduler\n"
        "from k8s_vgpu_scheduler_tpu_torch.scheduler.core import "
        "decode_register_request\n"
        "from k8s_vgpu_scheduler_tpu_torch.scheduler.routes import "
        "ExtenderServer\n"
        "from k8s_vgpu_scheduler_tpu_torch.tpulib import MockBackend, "
        "H100_FIXTURE\n"
        "from k8s_vgpu_scheduler_tpu_torch.util.config import Config\n"
        "kube = FakeKube()\n"
        "kube.add_node({'metadata': {'name': 'n', 'annotations': {}}})\n"
        "s = Scheduler(kube, Config())\n"
        "inv = MockBackend(H100_FIXTURE).inventory()\n"
        "msg = types.SimpleNamespace(node='n', devices=[\n"
        "    types.SimpleNamespace(**d) for d in advertised_devices(\n"
        "        inv, Config())], topology=types.SimpleNamespace(\n"
        "    generation='h100', mesh=[8], wraparound=[True]))\n"
        "s.observe_registration('n', decode_register_request(msg))\n"
        "srv = ExtenderServer(s, Config(), host='127.0.0.1', port=0)\n"
        "srv.start()\n"
        "def post(path, body):\n"
        "    req = urllib.request.Request(\n"
        "        f'http://127.0.0.1:{srv.port}{path}',\n"
        "        data=json.dumps(body).encode())\n"
        "    with urllib.request.urlopen(req, timeout=30) as r:\n"
        "        return json.loads(r.read())\n"
        "pod = {'metadata': {'name': 'p', 'namespace': 'default',\n"
        "                    'uid': 'u'}, 'spec': {'containers': [{\n"
        "    'name': 'c', 'resources': {'limits': {\n"
        "        'nvidia.com/gpu': '1', 'nvidia.com/gpumem': '24000'}}}]}}\n"
        "r = post('/webhook', {'request': {'uid': 'r', 'object': pod}})\n"
        "assert r['response']['allowed'] and r['response']['patch'], r\n"
        "kube.create_pod(pod)\n"
        "f = post('/filter', {'Pod': pod, 'NodeNames': ['n']})\n"
        "assert f['NodeNames'] == ['n'] and not f['Error'], f\n"
        "assert post('/bind', {'PodName': 'p', 'PodNamespace': 'default',\n"
        "                      'PodUID': 'u', 'Node': 'n'}) == {'Error': ''}\n"
        "srv.stop()\n"
        "loaded = {m for m, v in sys.modules.items() if v is not None}\n"
        "assert not {m for m in loaded if m.split('.')[0] in\n"
        "            ('grpc', 'torch') or m.startswith('google.protobuf')}\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_gangs_run_without_grpc_protobuf_or_torch():
    """A pod group through the extender's core with grpc, protobuf and
    torch blocked: the barrier, the atomic placement, the ranks; and the
    gang env read by ``parallel/multihost.py``, which imports torch only
    inside ``initialize_from_env``."""
    code = (
        "import sys\n"
        "for name in ('grpc', 'google.protobuf', 'torch'):\n"
        "    sys.modules[name] = None  # importing it raises\n"
        "from k8s_vgpu_scheduler_tpu_torch.k8s import FakeKube\n"
        "from k8s_vgpu_scheduler_tpu_torch.parallel import multihost\n"
        "from k8s_vgpu_scheduler_tpu_torch.scheduler import Scheduler\n"
        "from k8s_vgpu_scheduler_tpu_torch.scheduler.nodes import (\n"
        "    DeviceInfo, NodeInfo)\n"
        "from k8s_vgpu_scheduler_tpu_torch.util.config import Config\n"
        "kube = FakeKube()\n"
        "s = Scheduler(kube, Config())\n"
        "for n in ('a', 'b'):\n"
        "    kube.add_node({'metadata': {'name': n, 'annotations': {}}})\n"
        "    s.nodes.add_node(n, NodeInfo(name=n, devices=[DeviceInfo(\n"
        "        id=f'{n}-0', count=10, devmem=81079, type='NVIDIA-H100',\n"
        "        health=True)]))\n"
        "kube.watch_pods(s.on_pod_event)\n"
        "pods = [{'metadata': {'name': f'ring-{i}', 'namespace': 'default',\n"
        "         'uid': f'u{i}', 'annotations': {\n"
        "             'vtpu.dev/pod-group': 'ring',\n"
        "             'vtpu.dev/pod-group-total': '2'}},\n"
        "         'spec': {'containers': [{'name': 'c', 'resources': {\n"
        "             'limits': {'nvidia.com/gpu': '1',\n"
        "                        'nvidia.com/gpumem': '81079'}}}]}}\n"
        "        for i in range(2)]\n"
        "for p in pods:\n"
        "    kube.create_pod(p)\n"
        "assert 'waiting (1/2)' in s.filter(pods[0], ['a', 'b']).error\n"
        "assert s.filter(pods[1], ['a', 'b']).node\n"
        "assert s.filter(pods[0], ['a', 'b']).node\n"
        "ranks = sorted(kube.get_pod('default', p['metadata']['name'])[\n"
        "    'metadata']['annotations']['vtpu.dev/pod-group-rank']\n"
        "    for p in pods)\n"
        "assert ranks == ['0', '1'], ranks\n"
        "assert multihost.gang_env() is None\n"
        "loaded = {m for m, v in sys.modules.items() if v is not None}\n"
        "assert not {m for m in loaded if m.split('.')[0] in\n"
        "            ('grpc', 'torch') or m.startswith('google.protobuf')}\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("VTPU_GANG_")}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_slice_engine_runs_without_grpc_protobuf_or_torch():
    """The slice engine, mesh placement and the kubelet-path allocator,
    with grpc, protobuf and torch blocked."""
    code = (
        "import sys\n"
        "for name in ('grpc', 'google.protobuf', 'torch', 'numpy'):\n"
        "    sys.modules[name] = None  # importing it raises\n"
        "from k8s_vgpu_scheduler_tpu_torch.deviceplugin.allocator import (\n"
        "    SliceAllocator, unsatisfiable_sizes)\n"
        "from k8s_vgpu_scheduler_tpu_torch.placement import "
        "find_mesh_slice\n"
        "from k8s_vgpu_scheduler_tpu_torch.topology import find_slice\n"
        "from k8s_vgpu_scheduler_tpu_torch.tpulib import MockBackend\n"
        "inv = MockBackend({'mesh': [8], 'wraparound': [True]}).inventory()\n"
        "t = inv.topology\n"
        "assert find_slice(t, [(i,) for i in (6, 7, 0, 3)], 3, "
        "'guaranteed') == [(6,), (7,), (0,)]\n"
        "assert find_mesh_slice(t, [(i,) for i in range(8)], (2,)) == "
        "[(0,), (1,)]\n"
        "ids = [f'{c.uuid}-0' for c in inv.chips]\n"
        "assert len(SliceAllocator(inv, 'guaranteed').preferred(ids, [], "
        "4)) == 4\n"
        "assert unsatisfiable_sizes(inv) == []\n"
        "loaded = {m for m, v in sys.modules.items() if v is not None}\n"
        "assert not {m for m in loaded if m.split('.')[0] in\n"
        "            ('grpc', 'torch') or m.startswith('google.protobuf')}\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_placement_imports_nothing_but_its_mesh_module():
    """The placement package imports its own four modules, as the JAX
    package's placement/__init__ does (since ROADMAP A.5 placement; before
    it, the mesh module alone), and nothing else: the mesh math imports
    none of the others, and none of them reaches torch, grpc, protobuf or
    the scheduler at import (the defragmenter reads the scheduler it is
    given)."""
    tree = ast.parse((PORT / "placement" / "__init__.py").read_text())
    rel = {(n.level, n.module) for n in ast.walk(tree)
           if isinstance(n, ast.ImportFrom)}
    assert rel == {(1, "mesh"), (1, "frag"), (1, "reserve"), (1, "defrag")}
    assert not {"reserve", "defrag", "frag"} & set(_imported_roots(
        PORT / "placement" / "mesh.py"))
    code = (
        "import sys\n"
        "for name in ('grpc', 'google.protobuf', 'torch', 'numpy'):\n"
        "    sys.modules[name] = None  # importing it raises\n"
        "import k8s_vgpu_scheduler_tpu_torch.placement as p\n"
        "assert 'k8s_vgpu_scheduler_tpu_torch.scheduler.core' not in "
        "sys.modules\n"
        "r = p.SliceReservations(ttl_s=5.0)\n"
        "r.reserve('n', {'a', 'b'}, 'k')\n"
        "assert r.total_chips() == 2\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_elastic_resizes_without_grpc_protobuf_or_torch():
    """The resize controller on the extender's core with grpc, protobuf,
    torch and numpy blocked: an elastic gang placed, shrunk through the
    preemption ledger, its resize completed; the quota and defrag hooks
    and the simulator's elastic section imported.  The elastic package
    imports nothing of the scheduler at import (the controller reads the
    scheduler it is given)."""
    code = (
        "import sys\n"
        "for name in ('grpc', 'google.protobuf', 'torch', 'numpy'):\n"
        "    sys.modules[name] = None  # importing it raises\n"
        "import k8s_vgpu_scheduler_tpu_torch.elastic as el\n"
        "assert 'k8s_vgpu_scheduler_tpu_torch.scheduler.core' not in "
        "sys.modules\n"
        "from k8s_vgpu_scheduler_tpu_torch.cmd import simulate\n"
        "from k8s_vgpu_scheduler_tpu_torch.k8s import FakeKube\n"
        "from k8s_vgpu_scheduler_tpu_torch.quota import plan_shrinks\n"
        "from k8s_vgpu_scheduler_tpu_torch.scheduler import Scheduler\n"
        "from k8s_vgpu_scheduler_tpu_torch.scheduler.nodes import (\n"
        "    DeviceInfo, NodeInfo)\n"
        "from k8s_vgpu_scheduler_tpu_torch.tpulib.types import "
        "TopologyDesc\n"
        "from k8s_vgpu_scheduler_tpu_torch.util.config import Config\n"
        "kube = FakeKube()\n"
        "s = Scheduler(kube, Config(enable_elastic=True))\n"
        "kube.add_node({'metadata': {'name': 'n', 'annotations': {}}})\n"
        "s.nodes.add_node('n', NodeInfo(name='n', devices=[DeviceInfo(\n"
        "    id=f'c{i}', count=1, devmem=81079, type='NVIDIA-H100',\n"
        "    health=True, coords=(i,)) for i in range(4)],\n"
        "    topology=TopologyDesc(generation='h100', mesh=(4,))))\n"
        "kube.watch_pods(s.on_pod_event)\n"
        "pods = [{'metadata': {'name': f'e-{i}', 'namespace': 'default',\n"
        "         'uid': f'u{i}', 'annotations': {\n"
        "             'vtpu.dev/pod-group': 'e',\n"
        "             'vtpu.dev/pod-group-total': '2',\n"
        "             'vtpu.dev/mesh': '4', 'vtpu.dev/mesh-min': '2',\n"
        "             'vtpu.dev/mesh-max': '4'}},\n"
        "         'spec': {'containers': [{'name': 'c', 'resources': {\n"
        "             'limits': {'nvidia.com/gpu': '2',\n"
        "                        'nvidia.com/gpumem': '1000'}}}]}}\n"
        "        for i in range(2)]\n"
        "for p in pods:\n"
        "    kube.create_pod(p)\n"
        "s.filter(pods[0], ['n'])\n"
        "assert s.filter(pods[1], ['n']).node\n"
        "assert s.filter(pods[0], ['n']).node\n"
        "act = s.elastic.begin_shrink('default/e', 'rescue:reclaim:x')\n"
        "assert act['to'] == '2', act\n"
        "for p in pods:\n"
        "    kube.delete_pod('default', p['metadata']['name'])\n"
        "assert [a['kind'] for a in s.elastic.tick()] == "
        "['resize-complete']\n"
        "s.close()\n"
        "loaded = {m for m, v in sys.modules.items() if v is not None}\n"
        "assert not {m for m in loaded if m.split('.')[0] in\n"
        "            ('grpc', 'torch', 'numpy')\n"
        "            or m.startswith('google.protobuf')}\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_capacity_planning_runs_without_grpc_protobuf_or_torch():
    """The capacity planner on the extender's core with grpc, protobuf,
    torch and numpy blocked: a held pod's demand sampled, /capacityz's
    document built, and the simulator's capacity section replayed on the
    bursty scenario of examples/vgpu-capacity-scenarios.json."""
    code = (
        "import json, sys\n"
        "for name in ('grpc', 'google.protobuf', 'torch', 'numpy'):\n"
        "    sys.modules[name] = None  # importing it raises\n"
        "from k8s_vgpu_scheduler_tpu_torch.accounting import planner\n"
        "from k8s_vgpu_scheduler_tpu_torch.cmd import simulate\n"
        "from k8s_vgpu_scheduler_tpu_torch.k8s import FakeKube\n"
        "from k8s_vgpu_scheduler_tpu_torch.scheduler import Scheduler\n"
        "from k8s_vgpu_scheduler_tpu_torch.util.config import Config\n"
        "kube = FakeKube()\n"
        "s = Scheduler(kube, Config(quota_queues=({'name': 'a',\n"
        "    'namespaces': ['a'], 'quota': {'chips': 2}},)))\n"
        "simulate.build_fleet(s, kube, 1, 2, 16384, (2,), 'h100')\n"
        "kube.watch_pods(s.on_pod_event)\n"
        "kube.create_pod({'metadata': {'name': 'p', 'namespace': 'a',\n"
        "    'uid': 'u', 'annotations': {'vtpu.dev/queue': 'a',\n"
        "    'vtpu.dev/queue-state': 'held'}}, 'spec': {'containers': [\n"
        "    {'name': 'c', 'resources': {'limits': {\n"
        "        'nvidia.com/gpu': '1'}}}]}})\n"
        "assert s.observe_capacity() == {'a': 1.0}\n"
        "doc = s.export_capacity()\n"
        "assert doc['queues'][0]['demand_chips'] == 1.0, doc\n"
        "assert set(planner.CAPACITY_ROOT_FIELDS) <= set(doc)\n"
        "s.close()\n"
        "spec = json.load(open(sys.argv[1]))['scenarios']['bursty']\n"
        "r = simulate.run_simulation({'capacity': spec}, nodes=2,\n"
        "                            chips=4, hbm=16384, mesh=(4, 1))\n"
        "assert r['capacity']['verdict']['ok'], r['capacity']['verdict']\n"
        "loaded = {m for m, v in sys.modules.items() if v is not None}\n"
        "assert not {m for m in loaded if m.split('.')[0] in\n"
        "            ('grpc', 'torch', 'numpy')\n"
        "            or m.startswith('google.protobuf')}\n")
    res = subprocess.run(
        [sys.executable, "-c", code,
         str(ROOT / "examples" / "vgpu-capacity-scenarios.json")],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


PORT_EXAMPLES = sorted((ROOT / "examples").glob("vgpu-*.json"))


@pytest.mark.parametrize("path", PORT_EXAMPLES,
                         ids=[p.name for p in PORT_EXAMPLES])
def test_the_port_examples_use_the_ports_names(path):
    """The port's example workloads name no ``vtpu/`` path and no JAX
    workload key (``tpu``, ``tpumem``, ``tpucores``) or resource
    (``google.com/``)."""
    text = path.read_text()
    assert "vtpu/" not in text and "google.com/" not in text

    def keys(node):
        if isinstance(node, dict):
            for k, v in node.items():
                yield k
                yield from keys(v)
        elif isinstance(node, list):
            for v in node:
                yield from keys(v)

    assert not set(keys(json.loads(text))) & {"tpu", "tpumem", "tpucores",
                                              "tpumem-percentage"}


def test_device_plugin_raises_without_nvml_or_the_mock(tmp_path):
    code = (
        "import sys\n"
        "from k8s_vgpu_scheduler_tpu_torch.tpulib import backend\n"
        "backend.nvml.LIBRARY = 'libnvidia-ml-absent.so.1'\n"
        "from k8s_vgpu_scheduler_tpu_torch.cmd import device_plugin\n"
        "try:\n"
        f"    device_plugin.main(['--fake-kube', '--socket-dir', "
        f"{str(tmp_path)!r}])\n"
        "except RuntimeError as e:\n"
        "    assert 'VTPU_MOCK_JSON' in str(e), e\n"
        "else:\n"
        "    raise AssertionError('served without NVML')\n"
        "assert 'torch' not in sys.modules\n")
    env = {k: v for k, v in os.environ.items() if k != "VTPU_MOCK_JSON"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_nothing_in_the_port_reads_lib_tpu():
    hits = [str(p.relative_to(ROOT)) for p in PORT_FILES
            if re.search(rb"lib/tpu|libvtpu|vtpu/", p.read_bytes())]
    assert not hits


def test_vgpu_library_builds_with_gxx_into_the_port_build_dir():
    path = _kernels.build_vgpu()
    assert path.parent == _kernels.BUILD_DIR
    assert re.fullmatch(r"libvgpu_torch-[0-9a-f]{16}\.so", path.name)
    assert _kernels.build_vgpu() == path  # built once, by its sources
    lib = ctypes.CDLL(str(path))
    assert hasattr(lib, "vgpu_init_path") and hasattr(lib, "vgpu_rate_acquire")
    assert not hasattr(lib, "vtpu_init_path")
    assert "-pthread" in _kernels.HOST_FLAGS and "-fPIC" in _kernels.HOST_FLAGS


INTERPOSER_TARGETS = {
    "interposer": (_kernels.build_interposer,
                   r"libvgpu_cuda-[0-9a-f]{16}\.so"),
    "mock_nvml": (lambda: _kernels.build_mock_nvml().parent,
                  r"mock_nvml-[0-9a-f]{16}"),
    "mock_cuda": (_kernels.build_mock_cuda, r"mock_cuda-[0-9a-f]{16}"),
    "interposer_test": (_kernels.build_interposer_test,
                        r"test_interposer-[0-9a-f]{16}"),
}


@pytest.mark.parametrize("target", sorted(INTERPOSER_TARGETS))
def test_interposer_targets_build_with_gxx_into_the_port_build_dir(target):
    build, name = INTERPOSER_TARGETS[target]
    path = build()
    assert path.parent == _kernels.BUILD_DIR
    assert re.fullmatch(name, path.name)
    assert build() == path  # built once, by its sources
    if target == "mock_cuda":
        cuda, nvml = path / "libcuda.so.1", path / "libnvidia-ml.so.1"
        assert cuda.is_file() and nvml.resolve() == cuda.resolve()
    elif target == "mock_nvml":
        lib = ctypes.CDLL(str(path / "libnvidia-ml.so.1"))
        for symbol in ("nvmlInit_v2", "nvmlDeviceGetCount_v2",
                       "nvmlDeviceGetHandleByIndex_v2",
                       "nvmlDeviceGetMemoryInfo_v2", "nvmlEventSetWait_v2",
                       "nvmlErrorString"):
            assert hasattr(lib, symbol), symbol
    elif target == "interposer_test":
        assert path.stat().st_mode & 0o100
    else:
        lib = ctypes.CDLL(str(path))
        for symbol in ("vgpu_init_path", "vgpu_rate_acquire",
                       "vgpu_interposer_active", "vgpu_interposer_stats",
                       "vgpu_interposer_charge",
                       "dlsym", "cuGetProcAddress_v2", "cuMemAlloc_v2",
                       "cuLaunchKernel", "nvmlDeviceGetMemoryInfo"):
            assert hasattr(lib, symbol), symbol
        assert not hasattr(lib, "vtpu_init_path")


def test_interposer_digest_covers_the_enforcement_sources():
    """The interposer links the region and limiter sources: an edit to one
    names a new build of both libraries."""
    srcs = [_kernels.VGPU_DIR / s for s in _kernels.VGPU_SOURCES]
    assert _kernels.build_vgpu().name == \
        f"libvgpu_torch-{_kernels._digest(srcs)}.so"
    assert _kernels.build_interposer().name == "libvgpu_cuda-" + \
        _kernels._digest([_kernels.VGPU_DIR / "cuda_interposer.cc", *srcs]) \
        + ".so"
    assert not {"cuda_interposer.cc", "mock_cuda.cc", "test_interposer.cc"} \
        & set(_kernels.VGPU_SOURCES)


def test_package_data_ships_every_source_the_port_builds():
    """An installed port builds its kernels and its libraries from the
    sources under csrc/: pyproject.toml's package data must name each."""
    import fnmatch
    import tomllib

    conf = tomllib.loads((ROOT / "pyproject.toml").read_text())
    globs = conf["tool"]["setuptools"]["package-data"][PORT.name]
    sources = [p.relative_to(PORT).as_posix()
               for p in sorted((PORT / "csrc").rglob("*")) if p.is_file()]
    assert len(sources) >= 12
    def ships(path, glob):  # setuptools' globs: one segment each
        parts, pattern = path.split("/"), glob.split("/")
        return len(parts) == len(pattern) and all(
            fnmatch.fnmatchcase(a, b) for a, b in zip(parts, pattern))

    missed = [s for s in sources if not any(ships(s, g) for g in globs)]
    assert not missed, missed
    assert conf["project"]["scripts"]["vgpu-monitor"] == \
        "k8s_vgpu_scheduler_tpu_torch.cmd.monitor:main"
    assert conf["project"]["scripts"]["vgpu-serve"] == \
        "k8s_vgpu_scheduler_tpu_torch.cmd.serve:main"
    assert conf["project"]["scripts"]["vgpu-device-plugin"] == \
        "k8s_vgpu_scheduler_tpu_torch.cmd.device_plugin:main"
    assert conf["project"]["scripts"]["vgpu-scheduler"] == \
        "k8s_vgpu_scheduler_tpu_torch.cmd.scheduler:main"
    assert conf["project"]["scripts"]["vgpu-oci-runtime"] == \
        "k8s_vgpu_scheduler_tpu_torch.cmd.oci_runtime:main"


# The observability surface: the node exporter and its RPC, the ledger and
# the join, the writer, the debug endpoints, the cluster exporter and the
# two commands.
OBSERVABILITY = sorted((PORT / "monitor").glob("*.py")) + \
    sorted((PORT / "accounting").glob("*.py")) + [
        PORT / rel for rel in (
            "util/debugz.py", "util/exposition.py", "util/trace.py",
            "scheduler/metrics.py", "scheduler/routes.py", "cmd/monitor.py",
            "cmd/vgpu_smi.py", "cmd/vgpu_report.py", "api/noderpc_pb2.py",
            "deviceplugin/register.py")]


def _imported_names(path: Path):
    """Every module an import statement names, anywhere in the file."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", OBSERVABILITY,
                         ids=[str(p.relative_to(ROOT)) for p in OBSERVABILITY])
def test_the_observability_surface_imports_no_torch(path):
    roots = {n.split(".")[0] for n in _imported_names(path)}
    assert not roots & {"torch", "numpy", "prometheus_client", *FORBIDDEN}


def test_only_the_rpc_edges_import_grpc_or_protobuf():
    edges = {str(p.relative_to(PORT)) for p in OBSERVABILITY
             if any(n.split(".")[0] == "grpc" or n.startswith("google")
                    for n in _imported_names(p))}
    assert edges == {"monitor/noderpc.py", "api/noderpc_pb2.py",
                     "deviceplugin/register.py"}


def test_the_monitor_without_its_rpc_loads_neither_grpc_nor_protobuf(
        tmp_path):
    """vgpu-monitor --grpc-port 0, with grpc, protobuf and torch blocked:
    the loop ticks, the exporter answers a scrape, the debug server its
    vars, and neither edge is loaded."""
    lib = _kernels.build_vgpu()
    code = (
        "import sys, threading, time, urllib.request\n"
        "for name in ('grpc', 'google.protobuf', 'torch'):\n"
        "    sys.modules[name] = None  # importing it raises\n"
        "from k8s_vgpu_scheduler_tpu_torch.cmd import monitor\n"
        "from k8s_vgpu_scheduler_tpu_torch.util import exposition\n"
        "seen = []\n"
        "class Server(exposition.MetricsServer):\n"
        "    def __init__(self, *a, **k):\n"
        "        super().__init__(*a, **k)\n"
        "        seen.append(self)\n"
        "monitor.start_metrics_server.__globals__['MetricsServer'] = Server\n"
        "stop = threading.Event()\n"
        f"args = ['--container-root', {str(tmp_path)!r}, '--grpc-port', '0',\n"
        "        '--metrics-port', '0', '--no-backend', '--interval', '0.1',\n"
        f"        '--library', {str(lib)!r}]\n"
        "t = threading.Thread(target=monitor.main, args=(args, stop))\n"
        "t.start()\n"
        "while not seen:\n"
        "    time.sleep(0.05)\n"
        "time.sleep(0.3)\n"
        "url = f'http://127.0.0.1:{seen[0].port}/metrics'\n"
        "text = urllib.request.urlopen(url, timeout=10).read().decode()\n"
        "assert 'vtpu_monitor_phase_latency_seconds_count{phase=\"region-scan\"' in text, text\n"
        "stop.set()\n"
        "t.join(timeout=30)\n"
        "loaded = {m for m, v in sys.modules.items() if v is not None}\n"
        "assert not {m for m in loaded if m.split('.')[0] in\n"
        "            ('grpc', 'torch') or m.startswith('google.protobuf')}\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_the_observability_commands_are_packaged():
    import tomllib

    conf = tomllib.loads((ROOT / "pyproject.toml").read_text())
    scripts = conf["project"]["scripts"]
    assert scripts["vgpu-smi"] == "k8s_vgpu_scheduler_tpu_torch.cmd.vgpu_smi:main"
    assert scripts["vgpu-report"] == \
        "k8s_vgpu_scheduler_tpu_torch.cmd.vgpu_report:main"


def test_the_simulator_imports_no_torch_grpc_or_protobuf():
    """vgpu-simulate is control plane: no torch, numpy, grpc or protobuf
    anywhere in it; the serving section's lab (shim/simlab.py, on the
    standard library and ops/_kernels.py) is imported inside its
    function."""
    path = PORT / "cmd" / "simulate.py"
    names = set(_imported_names(path))
    assert not {n.split(".")[0] for n in names} & {
        "torch", "numpy", "grpc", "google", *FORBIDDEN}, sorted(names)
    tree = ast.parse(path.read_text())
    top = {node.module for node in tree.body
           if isinstance(node, ast.ImportFrom)}
    assert "shim" not in top and "monitor.feedback" not in top, top


def test_the_simulator_runs_without_grpc_protobuf_or_torch():
    """Its placement, accounting and chaos paths and ``/fleetz``, with
    grpc, protobuf and torch blocked; none of them is loaded after."""
    code = (
        "import sys, json, urllib.request\n"
        "for name in ('grpc', 'google.protobuf', 'torch'):\n"
        "    sys.modules[name] = None  # importing it raises\n"
        "from k8s_vgpu_scheduler_tpu_torch.cmd import simulate\n"
        "from k8s_vgpu_scheduler_tpu_torch.scheduler.routes import "
        "ExtenderServer\n"
        "wl = {'pods': [{'name': 'w', 'count': 6, 'gpu': 1, "
        "'gpumem': 20000, 'duty': 0.5}],\n"
        "      'accounting': {'runtime_s': 60, 'tick_s': 5},\n"
        "      'chaos': {'seed': 3, 'random_events': 4}}\n"
        "r = simulate.run_simulation(wl, nodes=3, chips=2, hbm=81079,\n"
        "                            mesh=(2,))\n"
        "assert r['accounting']['metering_ok'], r['accounting']\n"
        "assert r['chaos']['overbooked_chips'] == [], r['chaos']\n"
        "assert len(r['placed']) + len(r['pending']) == 6\n"
        "rc = simulate.main(['--workload', sys.argv[1], '--json'])\n"
        "assert rc == 0, rc\n"
        "loaded = {m for m, v in sys.modules.items() if v is not None}\n"
        "assert not {m for m in loaded if m.split('.')[0] in\n"
        "            ('grpc', 'torch') or m.startswith('google.protobuf')}\n")
    res = subprocess.run(
        [sys.executable, "-c", code,
         str(ROOT / "examples" / "vgpu-workload-sim.json")],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_the_simulator_is_packaged():
    import tomllib

    conf = tomllib.loads((ROOT / "pyproject.toml").read_text())
    assert conf["project"]["scripts"]["vgpu-simulate"] == \
        "k8s_vgpu_scheduler_tpu_torch.cmd.simulate:main"
