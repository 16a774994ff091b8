"""In-container preemption watch (the port's copy of the JAX package's
``shim/preempt.py``, stdlib only).

The scheduler's eviction request (``vtpu.dev/preempt-requested``) reaches
the container through the standard kubernetes downward API: the pod mounts
its own annotations as a file that kubelet live-updates.  No agent, no
connection to the apiserver from inside the pod — the file appears within
kubelet's sync period (~seconds).  The annotation key and the env name are
the JAX package's: its control plane, which writes the annotation, is
device-agnostic.

Downward-API file format: one ``key="escaped value"`` line per
annotation (Go strconv.Quote escaping; we only need key detection, so a
conservative parse suffices).
"""

from __future__ import annotations

import os
from typing import Optional

PREEMPT_ANNOTATION = "vtpu.dev/preempt-requested"
DEFAULT_PATH = "/etc/podinfo/annotations"
PATH_ENV = "VTPU_PODINFO_ANNOTATIONS"


class PreemptionWatch:
    """Cheap per-step poll of the downward-API annotations file.

    ``requested()`` is designed to sit in a training loop's step boundary:
    it stats the file and re-reads only when the mtime moved (kubelet
    updates the mount atomically via symlink swap, which changes mtime).
    A missing file (no downward-API volume) simply means "never
    preempted" — opting in is the operator's choice.
    """

    def __init__(self, path: Optional[str] = None) -> None:
        self.path = path or os.environ.get(PATH_ENV, DEFAULT_PATH)
        self._stamp: Optional[tuple] = None
        self._cached = False

    def requested(self) -> bool:
        try:
            st = os.stat(self.path)
        except OSError:
            return False
        # Inode + ns-mtime + size: kubelet's atomic symlink swap changes
        # the inode even when a coarse-granularity mtime stands still, so
        # equality of this triple really means "same file contents".
        stamp = (st.st_ino, st.st_mtime_ns, st.st_size)
        if stamp != self._stamp:
            self._stamp = stamp
            self._cached = self._parse()
        return self._cached

    def requester(self) -> Optional[str]:
        """Uid of the pod this eviction makes room for (observability)."""
        val = self._read_value()
        return val if val else None

    def _parse(self) -> bool:
        return bool(self._read_value())

    def _read_value(self) -> Optional[str]:
        """Requester uid, or None when absent OR rescinded (the scheduler
        rescinds by writing an EMPTY value — deleting an annotation key is
        not portable across patch types)."""
        try:
            with open(self.path) as f:
                for line in f:
                    key, sep, val = line.partition("=")
                    if sep and key.strip() == PREEMPT_ANNOTATION:
                        return val.strip().strip('"') or None
        except OSError:
            return None
        return None
