"""Shim-install policy: loud fail-open vs strict fail-closed.

The port's copy of the JAX package's ``util/enforcement.py``, unchanged:
the device plugin's Allocate mount path (deviceplugin/plugin.py
attach_enforcement) checks the node's install of the interposer before it
mounts it into a container.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

log = logging.getLogger(__name__)

STRICT_ENV = "VTPU_STRICT_ENFORCEMENT"


def strict_enforcement(override: Optional[bool] = None) -> bool:
    if override is not None:
        return override
    return os.environ.get(STRICT_ENV, "") in ("1", "true")


def check_shim_install(shim_host_dir: str, strict: Optional[bool] = None,
                       what: str = "container") -> "tuple[bool, bool]":
    """Validate the node's shim install before creating a container.

    Returns ``(mount_dir, mount_preload)``.  A missing artifact either
    raises FileNotFoundError (strict — the reference never fails open
    silently is OUR improvement on it, SURVEY.md L1) or logs a LOUD
    warning and reports what can still be mounted.
    """
    fail_closed = strict_enforcement(strict)
    if not shim_host_dir:
        return False, False
    if not os.path.isdir(shim_host_dir):
        if fail_closed:
            raise FileNotFoundError(
                f"shim host dir {shim_host_dir} missing and {STRICT_ENV} "
                f"set; refusing to create an unenforced {what}")
        log.warning(
            "shim host dir %s missing — %s will run WITHOUT HBM/core "
            "enforcement", shim_host_dir, what)
        return False, False
    preload = os.path.join(shim_host_dir, "ld.so.preload")
    if not os.path.exists(preload):
        if fail_closed:
            raise FileNotFoundError(
                f"{preload} missing and {STRICT_ENV} set; refusing to "
                f"create an unenforced {what}")
        log.warning(
            "shim ld.so.preload missing at %s — %s will run WITHOUT "
            "HBM/core enforcement", preload, what)
        return True, False
    return True, True
