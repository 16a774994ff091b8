"""Checkpoint / resume for the port's training state and weights.

Port of the JAX package's models/checkpoint.py.  The JAX one wraps orbax;
this one writes with ``torch.save`` and keeps orbax's protocol:

- one directory per step, named by the step number, holding ``state.pt``;
- written under a temporary name, flushed to disk and then renamed into
  place, so a save that fails halfway leaves :meth:`latest_step` at the
  previous step;
- temporary directories are ignored by :meth:`latest_step` and cleared at
  the next open;
- only the newest ``keep`` steps are kept.

It holds a :class:`~.train.TrainState` (the f32 master copy, the
optimizer state and the step) or a module's weights (its ``state_dict``:
a :class:`~.llama.Llama` for the serving pod).  :meth:`restore` writes in
place into the live target, on the target's own devices: the file is read
to the host and each tensor copied into its counterpart, so a master copy
that *is* an f32 parameter stays that parameter, and an optimizer state in
pinned host memory stays there.

The file is ``torch.save``'s zip format, which ``torch.load(mmap=True,
weights_only=True)`` maps as well.  A save first stages every card
tensor into pinned host memory (asynchronous copies, one sync; the
caching host allocator keeps the buffers for the next save) and writes
the records without their CRC-32 where the running torch has that switch
(``torch.serialization.set_crc32_options``): nothing in the format needs
it, and on a 5.27 GB train state on an H100 host the per-tensor pageable
copies and the CRC were more than half of the save (``tools/checkpoint_io.py``
times each part).  A restore reads the file whole rather than mapping it:
there, faulting in the mapped pages cost more than reading them.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Optional

import torch

from ..device import resolve_device
from .train import TrainState

STATE_FILE = "state.pt"
_TMP_PREFIX = ".tmp-"


def _tree(state: Any) -> Dict[str, Any]:
    """What a checkpoint of ``state`` holds."""
    if isinstance(state, TrainState):
        o = state.opt_state
        return {"step": state.step, "params": state.params,
                "opt_state": {"count": o.count, "mini_step": o.mini_step,
                              "mu": o.mu, "nu": o.nu, "acc": o.acc}}
    if isinstance(state, torch.nn.Module):
        return {"weights": state.state_dict()}
    raise TypeError(f"cannot checkpoint a {type(state).__name__}: a "
                    "TrainState or an nn.Module")


def _map_tensors(tree: Any, fn) -> Any:
    """``tree`` with ``fn`` applied to every tensor in it (dicts, lists and
    tuples rebuilt with their own types; other leaves kept)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return type(tree)((k, _map_tensors(v, fn)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return tree


def _staged(tree: Any) -> Any:
    """``tree`` with every card tensor copied to pinned host memory: the
    copies are queued on each device's current stream and awaited once, so
    the save serializes host memory only.  Host tensors are kept as they
    are (a state on the CPU is saved from where it lies)."""
    devices = set()

    def stage(t: torch.Tensor) -> torch.Tensor:
        if t.device.type != "cuda":
            return t
        devices.add(t.device)
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        return host

    out = _map_tensors(tree, stage)
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()
    return out


def _write(path: str, tree: Any) -> None:
    """``torch.save`` of ``tree`` into ``path`` through an unbuffered file,
    flushed to disk; the records' CRC-32 is left out where this torch can
    (the setting is process-wide and put back at once)."""
    ser = torch.serialization
    crc = ser.get_crc32_options() if hasattr(ser, "get_crc32_options") \
        else None
    if crc is not None:
        ser.set_crc32_options(False)
    try:
        with open(path, "wb", buffering=0) as f:
            torch.save(tree, f)
            os.fsync(f.fileno())
    finally:
        if crc is not None:
            ser.set_crc32_options(crc)


def _copy_into(dst: torch.Tensor, src: torch.Tensor, what: str) -> None:
    if dst.shape != src.shape or dst.dtype != src.dtype:
        raise ValueError(f"checkpoint {what}: {tuple(src.shape)} {src.dtype}"
                         f", target {tuple(dst.shape)} {dst.dtype}")
    dst.copy_(src)


def _copy_list(dsts, srcs, what: str) -> None:
    if len(dsts) != len(srcs):
        raise ValueError(f"checkpoint {what}: {len(srcs)} tensors, target "
                         f"{len(dsts)}")
    for i, (d, s) in enumerate(zip(dsts, srcs)):
        _copy_into(d, s, f"{what}[{i}]")


@torch.no_grad()
def _restore_into(state: Any, tree: Dict[str, Any]) -> None:
    if isinstance(state, TrainState):
        o, lo = state.opt_state, tree["opt_state"]
        _copy_list(state.params, tree["params"], "params")
        for name in ("mu", "nu", "acc"):
            _copy_list(getattr(o, name), lo[name], f"opt_state.{name}")
        o.count, o.mini_step = int(lo["count"]), int(lo["mini_step"])
        state.step = int(tree["step"])
        # The working copies are the master rounded, as the step writes
        # them.  An f32 parameter is its own master: restored above.
        for i, p in state.working.items():
            p.copy_(state.params[i])
        return
    target = state.state_dict()
    weights = tree["weights"]
    if target.keys() != weights.keys():
        raise ValueError(
            "checkpoint weights do not match the target: missing "
            f"{sorted(target.keys() - weights.keys())[:4]}, unexpected "
            f"{sorted(weights.keys() - target.keys())[:4]}")
    for name, t in target.items():
        _copy_into(t, weights[name], name)


def _target_device(state: Any) -> torch.device:
    if isinstance(state, TrainState):
        return state.params[0].device
    return next(iter(state.state_dict().values())).device


class CheckpointManager:
    """Step directories under ``directory``, pruned to the newest
    ``keep``.  Saves are atomic (a temporary directory, then a rename);
    :meth:`restore` writes into a live target of the same structure."""

    def __init__(self, directory: str, keep: int = 3) -> None:
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)
        for name in os.listdir(self.directory):
            if name.startswith(_TMP_PREFIX):  # a save that never finished
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)

    def steps(self):
        """The saved steps, oldest first."""
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit()
                      and os.path.isdir(os.path.join(self.directory, n)))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def path(self, step: int) -> str:
        """The file that holds ``step``."""
        return os.path.join(self.directory, str(step), STATE_FILE)

    def save(self, step: int, state: Any, wait: bool = False) -> None:
        """Write ``state`` as ``step``.  Returns once the step is on disk,
        whatever ``wait`` says (it is the JAX signature's): the port's step
        updates its state in place, so a save left running would race with
        the next step."""
        step = int(step)
        final = os.path.join(self.directory, str(step))
        if os.path.exists(final):
            raise FileExistsError(f"step {step} already saved under "
                                  f"{self.directory}")
        tmp = os.path.join(self.directory,
                           f"{_TMP_PREFIX}{step}-{os.getpid()}")
        os.makedirs(tmp)
        try:
            _write(os.path.join(tmp, STATE_FILE), _staged(_tree(state)))
            os.rename(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        for old in self.steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)),
                          ignore_errors=True)

    def restore(self, state_like: Any, step: Optional[int] = None) -> Any:
        """Write the checkpoint of ``step`` (the latest by default), read
        from its file to the host, into ``state_like`` in place and return
        it."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        _restore_into(state_like, torch.load(
            self.path(step), map_location="cpu", mmap=False,
            weights_only=True))
        return state_like

    def close(self) -> None:
        """Nothing runs in the background (saves are synchronous)."""


def save_checkpoint(directory: str, step: int, state: Any) -> None:
    """One-shot save."""
    mgr = CheckpointManager(directory)
    try:
        mgr.save(step, state, wait=True)
    finally:
        mgr.close()


def restore_checkpoint(directory: str, state_like: Any,
                       step: Optional[int] = None, device="cuda") -> Any:
    """One-shot restore into ``state_like``, which lives on ``device``:
    the card unless the caller asks for the CPU."""
    dev = resolve_device(device)
    if _target_device(state_like).type != dev.type:
        raise ValueError(f"the restore target lies on "
                         f"{_target_device(state_like)}, not {dev}")
    mgr = CheckpointManager(directory)
    try:
        return mgr.restore(state_like, step)
    finally:
        mgr.close()
