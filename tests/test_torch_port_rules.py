"""Rules of the PyTorch/CUDA port that no parity test would catch.

- The port and chip_smoke.py import nothing of JAX, Flax, optax or the
  JAX package (the port keeps its own copies).
- Entry points run on the card unless the caller asks for the CPU: on a
  box without a card they raise instead of quietly using the CPU.
- Importing the kernel binding compiles nothing (the tests import it on
  boxes without nvcc).
- The CUDA entry points and their ctypes signatures agree.
- A kernel's build is named by its source and the headers it includes.
- The CPU path, forward and backward, builds and launches nothing.
"""

import ast
import hashlib
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import chip_smoke
from k8s_vgpu_scheduler_tpu_torch.device import resolve_device
from k8s_vgpu_scheduler_tpu_torch.entry import entry
from k8s_vgpu_scheduler_tpu_torch.models.convert import init_weights
from k8s_vgpu_scheduler_tpu_torch.models.llama import Llama, llama_tiny
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


@pytest.mark.parametrize("call", [
    lambda: resolve_device(),
    lambda: Llama(llama_tiny()),
    lambda: init_weights(llama_tiny(), torch.Generator()),
    lambda: entry(),
    lambda: init_train_state(llama_tiny(), torch.Generator()),
], ids=["resolve_device", "Llama", "init_weights", "entry",
        "init_train_state"])
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
        "assert not k._libs\n"
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
