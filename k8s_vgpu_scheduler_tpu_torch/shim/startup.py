"""The shim's startup hook: a node's shim directory ships this file as
``sitecustomize.py``, and the device plugin's Allocate puts that directory
on the ``PYTHONPATH`` of a pod the Python shim enforces (an
oversubscribed grant, or a node without the interposer), so every Python
process of the pod runs it at interpreter start
(``ops/_kernels.install_shim``).

Outside a managed container (no ``CUDA_DEVICE_MEMORY_SHARED_CACHE``, or
``VTPU_DISABLE`` set) it does nothing.  Inside one it imports nothing
either: it waits for the program to import the port's shim module
(``SHIM_MODULE``, which the port's step callables import for their gate)
and calls that module's ``autoinstall()`` as soon as the module has
loaded, before the import returns.  Under an oversubscribed grant that
attaches the host-swap spiller and the spill-only gate without the
program calling ``install()``.

The hook carries no port of its own.  It installs into the port the
program imports, whether installed or beside the program's script (which
joins ``sys.path`` only after ``sitecustomize`` has run): the gate the
step callables consult and the store they register their state in are
then the ones the shim drives, and its libraries build in that port's
build directory, as they do where the program calls ``install()``
itself.  A process that never imports the port has nothing that consults
the gate; the interposer enforces its memory and compute.

Python reports and swallows an exception raised in ``sitecustomize``; a
managed container must never run unenforced, so a failed install ends the
process with ``EXIT_UNENFORCED`` instead.  This file imports the standard
library alone, and never JAX.
"""

import os
import sys

#: The exit code of a process whose shim did not install.
EXIT_UNENFORCED = 70
#: The module whose import installs the shim.
SHIM_MODULE = "k8s_vgpu_scheduler_tpu_torch.shim.core"


def managed() -> bool:
    return bool(os.environ.get("CUDA_DEVICE_MEMORY_SHARED_CACHE")) \
        and not os.environ.get("VTPU_DISABLE")


def unenforced(e: BaseException) -> None:
    sys.stderr.write(f"vgpu: the shim did not install in this managed "
                     f"container: {type(e).__name__}: {e}\n")
    sys.stderr.flush()
    os._exit(EXIT_UNENFORCED)


class InstallOnImport:
    """A finder first on ``sys.meta_path`` that answers for
    ``SHIM_MODULE`` alone, once: it takes itself off the path, has the
    finders after it find the module, and has the module's loader call
    the module's ``autoinstall()`` once the module has run."""

    def find_spec(self, name, path=None, target=None):
        if name != SHIM_MODULE:
            return None
        sys.meta_path.remove(self)
        import importlib.util

        spec = importlib.util.find_spec(name)
        if spec is None or spec.loader is None:
            return spec
        load = spec.loader.exec_module

        def exec_module(module):
            load(module)
            try:
                module.autoinstall()
            except BaseException as e:  # noqa: BLE001 — never run unenforced
                unenforced(e)

        spec.loader.exec_module = exec_module
        return spec


def run() -> None:
    if managed():
        sys.meta_path.insert(0, InstallOnImport())


if __name__ == "sitecustomize":
    run()
