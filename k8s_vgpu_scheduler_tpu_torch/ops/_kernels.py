"""Build and bind the port's CUDA kernels and its native host library.

Each kernel source under ``csrc/`` exposes a plain C entry point.  On first
use it is compiled with ``nvcc`` for ``sm_90a`` into a shared library named
by the hash of its source and of the headers it includes (so an edited
source or header never loads a stale build) and loaded with ``ctypes``.
The enforcement library (``csrc/vgpu/``, host C++) is built the same way
with ``g++`` into ``libvgpu_torch-<hash>.so``; so are the CUDA driver-API
interposer (``libvgpu_cuda-<hash>.so``, the same region and limiter code
with the driver hooks, for ``LD_PRELOAD``), the mock driver its CPU tests
run against (``mock_cuda-<hash>/libcuda.so.1`` and ``libnvidia-ml.so.1``)
and their C test driver (``test_interposer-<hash>``), and the mock NVML
the node agent's CPU tests run against (``mock_nvml-<hash>/
libnvidia-ml.so.1``).  ``install_shim`` puts the interposer, the
``ld.so.preload`` naming it and the shim's startup hook into a node's shim
directory.  Importing this module compiles nothing and needs no compiler:
the CPU tests import it.  A library that is already built is loaded
without looking for a compiler, so a package copied with its ``build/``
(the image's runtime stage) needs none.  ``build_all()``, or

    python -m k8s_vgpu_scheduler_tpu_torch.ops._kernels

builds every library a deployment ships (the image's build stage runs it).
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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
# Inside the package, so the build stays in the checkout; listed in
# .gitignore.
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
#: The kernel sources under ``csrc/``, one library each.
KERNELS = ("flash_fwd", "flash_bwd")
VGPU_DIR = CSRC / "vgpu"
HOST_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-pthread")
# The region, limiter and reader: libvgpu_torch, and the interposer's base.
VGPU_SOURCES = ("rate_limiter.cc", "reader.cc", "region.cc")

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


#: Where nvcc is looked for when it is not on PATH.
NVCC_FALLBACK = Path("/usr/local/cuda/bin/nvcc")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if NVCC_FALLBACK.exists():
        return str(NVCC_FALLBACK)
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


def _compile(name: str, out: Path, compiler, *args) -> Path:
    """Run ``<compiler()> args -o <tmp>`` unless ``out`` exists, then move
    the result to ``out``; raise with the compiler's errors if it fails.
    The compiler is looked for only when there is something to build."""
    if out.exists():
        return out
    cmd = [compiler(), *args]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    res = subprocess.run([*cmd, "-o", tmp], capture_output=True, text=True)
    build_logs[name] = res.stdout + res.stderr
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{cmd[0]} failed for {name}:\n{res.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a build of this exact source and
    its headers exists; return the shared library's path."""
    src = CSRC / f"{name}.cu"
    out = BUILD_DIR / f"lib{name}-{source_digest(src)}.so"
    return _compile(name, out, _nvcc, *ARCH_FLAGS, "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                    str(src))


def _digest(srcs) -> str:
    return hashlib.sha256(
        "".join(source_digest(s) for s in srcs).encode()).hexdigest()[:16]


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the host libraries cannot be built")
    return gxx


def build_vgpu() -> Path:
    """Compile the enforcement library from ``csrc/vgpu/`` with g++
    unless a build of these exact sources and headers exists; return the
    shared library's path.  Raises when g++ is missing or fails."""
    srcs = [VGPU_DIR / s for s in VGPU_SOURCES]
    return _compile("vgpu", BUILD_DIR / f"libvgpu_torch-{_digest(srcs)}.so",
                    _gxx, *HOST_FLAGS, "-shared", *map(str, srcs))


def build_interposer() -> Path:
    """The CUDA driver-API interposer: ``cuda_interposer.cc`` on the
    enforcement library's sources, one shared library for ``LD_PRELOAD``.
    Its references to its own hooks bind inside it (``-Bsymbolic``)."""
    srcs = [VGPU_DIR / "cuda_interposer.cc",
            *(VGPU_DIR / s for s in VGPU_SOURCES)]
    return _compile("interposer",
                    BUILD_DIR / f"libvgpu_cuda-{_digest(srcs)}.so",
                    _gxx, *HOST_FLAGS, "-shared", "-Wl,-Bsymbolic",
                    *map(str, srcs), "-ldl", "-lpthread")


def build_mock_cuda() -> Path:
    """The mock driver, ``libcuda.so.1`` in a directory of its own with
    ``libnvidia-ml.so.1`` beside it (a link to the same file, so the two
    share one state); returns the directory, for ``LD_LIBRARY_PATH``.  Its
    references to its own entry points bind inside it (``-Bsymbolic``), as
    the driver's do: a preloaded library exporting the same names must not
    capture them."""
    src = VGPU_DIR / "mock_cuda.cc"
    out = BUILD_DIR / f"mock_cuda-{_digest([src])}"
    out.mkdir(parents=True, exist_ok=True)
    _compile("mock_cuda", out / "libcuda.so.1",
             _gxx, *HOST_FLAGS, "-shared", "-Wl,-Bsymbolic",
             "-Wl,-soname,libcuda.so.1", str(src), "-ldl", "-lpthread")
    nvml = out / "libnvidia-ml.so.1"
    if not nvml.exists():
        tmp = out / f"libnvidia-ml.so.1.{os.getpid()}"
        tmp.unlink(missing_ok=True)
        tmp.symlink_to("libcuda.so.1")
        os.replace(tmp, nvml)
    return out


def build_mock_nvml() -> Path:
    """The mock NVML, ``libnvidia-ml.so.1`` in a directory of its own,
    driven by a MockBackend fixture named by ``$MOCK_NVML_JSON``
    (``csrc/vgpu/mock_nvml.cc``); returns the library's path."""
    src = VGPU_DIR / "mock_nvml.cc"
    out = BUILD_DIR / f"mock_nvml-{_digest([src])}"
    out.mkdir(parents=True, exist_ok=True)
    return _compile("mock_nvml", out / "libnvidia-ml.so.1",
                    _gxx, *HOST_FLAGS, "-shared",
                    "-Wl,-soname,libnvidia-ml.so.1", str(src))


#: The startup hook's name in a shim directory.
HOOK_FILE = "sitecustomize.py"


def install_shim(shim_dir) -> Path:
    """Install the shim into a node's shim directory, as the device plugin
    mounts it into every container: ``libvgpu_cuda.so`` (built from the
    checkout's sources), ``ld.so.preload`` naming it where the container
    sees the directory, and the startup hook ``sitecustomize.py``
    (``shim/startup.py``, which installs into the port the pod's program
    imports and carries none).  Returns the library's path."""
    from ..util.types import PRELOAD_FILE, SHIM_CONTAINER_DIR, SHIM_LIBRARY

    shim_dir = Path(shim_dir)
    shim_dir.mkdir(parents=True, exist_ok=True)
    lib = shim_dir / SHIM_LIBRARY
    tmp = shim_dir / f".{SHIM_LIBRARY}.{os.getpid()}"
    shutil.copyfile(build_interposer(), tmp)
    os.replace(tmp, lib)
    (shim_dir / PRELOAD_FILE).write_text(
        f"{SHIM_CONTAINER_DIR}/{SHIM_LIBRARY}\n")
    tmp = shim_dir / f".{HOOK_FILE}.{os.getpid()}"
    shutil.copyfile(CSRC.parent / "shim" / "startup.py", tmp)
    os.replace(tmp, shim_dir / HOOK_FILE)
    return lib


def build_interposer_test() -> Path:
    """The C test driver of the interposer (an executable)."""
    src = VGPU_DIR / "test_interposer.cc"
    return _compile("interposer_test",
                    BUILD_DIR / f"test_interposer-{_digest([src])}",
                    _gxx, "-O2", "-std=c++17", str(src), "-ldl")


def build_all() -> dict:
    """Build every library a deployment ships, all started together: each
    kernel of ``KERNELS`` with nvcc, the enforcement library and the
    interposer with g++.  Returns {name: path}.  Raises where nvcc or g++
    is missing or fails; no library is skipped."""
    _nvcc()  # a host without nvcc fails here, before any build starts
    jobs = {name: (build, name) for name in KERNELS}
    jobs.update(vgpu=(build_vgpu,), interposer=(build_interposer,))
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {name: pool.submit(*job) for name, job in jobs.items()}
        return {name: f.result() for name, f in futures.items()}


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


def main() -> None:
    """``python -m k8s_vgpu_scheduler_tpu_torch.ops._kernels``: build_all,
    then one line a library, ``<name>: <path>``."""
    for name, path in build_all().items():
        print(f"{name}: {path}")


if __name__ == "__main__":
    main()
