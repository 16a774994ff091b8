"""Build and bind the port's CUDA kernels.

Each kernel source under ``csrc/`` exposes a plain C entry point.  On first
use it is compiled with ``nvcc`` for ``sm_90a`` into a shared library named
by the hash of its source and of the headers it includes (so an edited
source or header never loads a stale build) and loaded with ``ctypes``.
Importing this module compiles nothing and needs no ``nvcc``: the CPU
tests import it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
# Inside the package, so the build stays in the checkout; listed in
# .gitignore.
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_p = ctypes.c_void_p
_i = ctypes.c_int
_ll = ctypes.c_longlong
# flash_fwd(q, k, v, o, lse, dtype, batch, seq_len, heads, head_dim,
#           12 strides, sm_scale, causal, window, stream) — csrc/flash_fwd.cu
FLASH_FWD_ARGTYPES = (
    (_p, _p, _p, _p, _p, _i, _i, _i, _i, _i)
    + (_ll,) * 12
    + (ctypes.c_float, _i, _i, _p)
)
# flash_bwd_dq(q, k, v, do, lse, delta, dq, dtype, batch, seq_len, heads,
#              head_dim, 15 strides, sm_scale, causal, window, stream)
# flash_bwd_dkv(q, k, v, do, lse, delta, dk, dv, dtype, batch, seq_len,
#               heads, head_dim, 18 strides, sm_scale, causal, window,
#               stream) — csrc/flash_bwd.cu
FLASH_BWD_DQ_ARGTYPES = (
    (_p,) * 7 + (_i,) * 5 + (_ll,) * 15 + (ctypes.c_float, _i, _i, _p)
)
FLASH_BWD_DKV_ARGTYPES = (
    (_p,) * 8 + (_i,) * 5 + (_ll,) * 18 + (ctypes.c_float, _i, _i, _p)
)

_lock = threading.Lock()
_libs: dict = {}
build_logs: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def source_digest(src: Path) -> str:
    """Hash of a kernel source and of every header it includes with
    quotes, followed recursively from the including file's directory."""
    h = hashlib.sha256()
    seen = set()

    def add(path: Path) -> None:
        if path in seen:
            return
        seen.add(path)
        text = path.read_bytes()
        h.update(text)
        for inc in re.findall(rb'^\s*#\s*include\s+"([^"]+)"', text, re.M):
            add((path.parent / inc.decode()).resolve())

    add(src.resolve())
    return h.hexdigest()[:16]


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a build of this exact source and
    its headers exists; return the shared library's path."""
    src = CSRC / f"{name}.cu"
    digest = source_digest(src)
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp, str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    build_logs[name] = res.stdout + res.stderr
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {src}:\n{res.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def load(name: str, symbol: str, argtypes) -> "ctypes._CFuncPtr":
    """The C entry point ``symbol`` of kernel ``name``, built on first
    use, with its argument types declared."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _libs[name] = lib
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def flash_fwd():
    return load("flash_fwd", "flash_fwd", FLASH_FWD_ARGTYPES)


def flash_bwd_dq():
    return load("flash_bwd", "flash_bwd_dq", FLASH_BWD_DQ_ARGTYPES)


def flash_bwd_dkv():
    return load("flash_bwd", "flash_bwd_dkv", FLASH_BWD_DKV_ARGTYPES)
