"""Rules of the PyTorch/CUDA port that no parity test would catch.

- The port and chip_smoke.py import nothing of JAX, Flax, optax or the
  JAX package (the port keeps its own copies).
- Entry points run on the card unless the caller asks for the CPU: on a
  box without a card they raise instead of quietly using the CPU.
- Importing the kernel binding compiles nothing (the tests import it on
  boxes without nvcc).
- The CUDA entry point and its ctypes signature agree.
"""

import ast
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from k8s_vgpu_scheduler_tpu_torch.device import resolve_device
from k8s_vgpu_scheduler_tpu_torch.entry import entry
from k8s_vgpu_scheduler_tpu_torch.models.convert import init_weights
from k8s_vgpu_scheduler_tpu_torch.models.llama import Llama, llama_tiny
from k8s_vgpu_scheduler_tpu_torch.ops import _kernels

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
], ids=["resolve_device", "Llama", "init_weights", "entry"])
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
        "assert not k._libs\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_cuda_signature_matches_ctypes():
    src = (_kernels.CSRC / "flash_fwd.cu").read_text()
    m = re.search(r'extern "C" int flash_fwd\(([^)]*)\)', src)
    assert m, "flash_fwd entry point not found"
    params = [p.strip() for p in m.group(1).split(",")]
    assert len(params) == len(_kernels.FLASH_FWD_ARGTYPES)
    # c_longlong is an alias of c_long on LP64 platforms.
    ctypes_kind = {"c_void_p": "void*", "c_int": "int",
                   "c_longlong": "long long", "c_long": "long long",
                   "c_float": "float"}
    for decl, ctype in zip(params, _kernels.FLASH_FWD_ARGTYPES):
        want = ctypes_kind[ctype.__name__]
        got = decl.rsplit(" ", 1)[0].replace("const ", "").replace(" *", "*")
        assert got == want, f"{decl!r} bound as {ctype.__name__}"


def test_kernels_build_for_sm90a_into_an_ignored_dir():
    assert "arch=compute_90a,code=sm_90a" in _kernels.ARCH_FLAGS
    ignored = (ROOT / ".gitignore").read_text().split()
    rel = _kernels.BUILD_DIR.relative_to(ROOT).as_posix() + "/"
    assert rel in ignored
