"""Exec-into-runtime wrappers.

The port's copy of the JAX package's ``oci/runtime.py``, unchanged in
behaviour.  Reference: pkg/oci/runtime.go:21–23 (Runtime interface) and
runtime_exec.go:53–102 (SyscallExecRuntime) — the ``exec`` function is a
swappable attribute precisely so tests can intercept it
(runtime_exec_test.go pattern, SURVEY.md §4).
"""

from __future__ import annotations

import logging
import os
from typing import Callable, List, Optional, Sequence

log = logging.getLogger(__name__)


class RuntimeError_(Exception):
    pass


class SyscallExecRuntime:
    """Exec into a low-level OCI runtime binary (runc), replacing this
    process — the tail call of every runtime shim."""

    def __init__(self, path: str,
                 exec_fn: Optional[Callable[..., None]] = None) -> None:
        if not os.path.isfile(path) or not os.access(path, os.X_OK):
            raise RuntimeError_(f"'{path}' is not an executable file")
        self.path = path
        self._exec = exec_fn or os.execve

    def exec(self, args: Sequence[str]) -> None:
        """argv[0] is forced to the wrapped binary's path
        (runtime_exec.go:86–90)."""
        argv: List[str] = [self.path]
        if len(args) > 1:
            argv.extend(args[1:])
        self._exec(self.path, argv, dict(os.environ))
        # os.execve does not return; reaching here means the swapped-in test
        # exec returned, or the real exec failed silently.
        raise RuntimeError_(f"unexpected return from exec '{self.path}'")


class ModifyingRuntimeWrapper:
    """The interposer: on ``create``, load the bundle's config.json, apply a
    modifier, flush, then exec the real runtime.  Non-create commands pass
    straight through (the reference scaffolds exactly this shape; here it is
    wired to the port's spec modifier).

    The spec path is derived from the create command's ``--bundle`` argv at
    exec time (one long-lived wrapper serves many containers); ``spec`` is a
    fallback for callers that pin a bundle up front.
    """

    def __init__(self, runtime: SyscallExecRuntime,
                 modifier: Callable[[dict], dict],
                 spec=None) -> None:
        self.runtime = runtime
        self.modifier = modifier
        self.spec = spec

    def _spec_for(self, args: Sequence[str]):
        path = bundle_spec_path(args)
        if path is not None:
            from .spec import FileSpec

            return FileSpec(path)
        return self.spec

    def exec(self, args: Sequence[str]) -> None:
        if self._is_create(args):
            spec = self._spec_for(args)
            if spec is None:
                raise RuntimeError_(
                    "create without --bundle and no pinned spec"
                )
            spec.load()
            spec.modify(self.modifier)
            spec.flush()
        self.runtime.exec(args)

    # runc global flags that consume the following argv element.
    _VALUE_FLAGS = frozenset(
        ["--root", "--log", "--log-format", "--criu", "--rootless"]
    )

    @classmethod
    def _is_create(cls, args: Sequence[str]) -> bool:
        """True when argv invokes the OCI ``create`` command (global flags,
        e.g. ``--root /run/runc``, may precede it)."""
        argl = list(args)[1:]
        i = 0
        while i < len(argl):
            a = argl[i]
            if a == "create":
                return True
            if a in cls._VALUE_FLAGS:
                i += 2
                continue
            if a.startswith("-"):
                i += 1
                continue
            return False  # first positional is another command
        return False


def bundle_spec_path(args: Sequence[str]) -> Optional[str]:
    """Extract ``<bundle>/config.json`` from ``--bundle/-b`` argv flags."""
    argl = list(args)
    for i, a in enumerate(argl):
        if a in ("--bundle", "-b") and i + 1 < len(argl):
            return os.path.join(argl[i + 1], "config.json")
        if a.startswith("--bundle="):
            return os.path.join(a.split("=", 1)[1], "config.json")
    return None
