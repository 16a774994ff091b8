"""Time each part of a checkpoint save and restore of the compaction
trainers' train state on the card: llama_7b widths at one layer, bf16
with the f32 master copy and AdamW's mu and nu (5.27 GB), written to
``/dev/shm`` as ``chip_smoke.py``'s trainers write it.

    python3 tools/checkpoint_io.py [--layers N] [--dir /dev/shm] [--repeat R]

Each part is timed on the host clock around a device sync, R times (2 by
default), in one process:

- ``legacy``: the save as it was before the pinned staging (``torch.save``
  of the card's tensors into an open file, then ``fsync``), and its parts:
  ``d2h_pageable`` (each tensor copied to fresh pageable host memory),
  ``serialize_null`` (``torch.save`` of that host tree to ``/dev/null``
  through a file object, CRC-32 on and off), ``write`` (the same into the
  directory, CRC on) and ``fsync``;
- the staged parts: ``pin_alloc`` (pinned host buffers for every tensor),
  ``d2h_pinned`` (copies into them, one sync), and their ``torch.save``
  with CRC off to a path (``save_path``) and to an unbuffered file
  (``save_fileio``);
- ``manager_save`` and ``manager_restore``: ``CheckpointManager.save`` and
  ``restore`` as the tree has them, first in the process (the first
  repetition's save pins its buffers; later ones reuse them);
- ``legacy_restore``: the restore as it was before (``torch.load`` with
  ``mmap``, then the copies), and restore's parts: ``load_mmap`` and
  ``load_read`` (``torch.load`` with and without ``mmap``) and the
  host-to-device copies from each;
- ``raw_write`` and ``raw_read``: 1 GiB through ``os.write`` and
  ``os.readv`` in 64 MiB pieces, the directory's own rate.

Prints the card's name and power limit, then one JSON line ``CKIO {...}``
with every time in seconds, the bytes and the rates in GB/s; writes the
same to ``chiprun_out/checkpoint_io.json``.  Needs one card.
"""
import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def tree_tensors(tree) -> list:
    out = []
    if hasattr(tree, "is_cuda"):
        return [tree]
    if isinstance(tree, dict):
        for v in tree.values():
            out += tree_tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            out += tree_tensors(v)
    return out


def map_tree(tree, fn):
    if hasattr(tree, "is_cuda"):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(v, fn) for v in tree)
    return tree


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--dir", default="/dev/shm")
    ap.add_argument("--repeat", type=int, default=2)
    args = ap.parse_args()

    import torch

    from k8s_vgpu_scheduler_tpu_torch.models import checkpoint, llama, train

    if not torch.cuda.is_available():
        print("checkpoint_io: no card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    cfg = dataclasses.replace(llama.llama_7b(), n_layers=args.layers,
                              attention="flash")
    gen = torch.Generator(device="cuda").manual_seed(6)
    _model, _opt, state = train.init_train_state(cfg, gen)
    tree = checkpoint._tree(state)
    tensors = tree_tensors(tree)
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    work = Path(args.dir) / f"ckio-{os.getpid()}"
    work.mkdir(parents=True)
    sync = torch.cuda.synchronize
    crc = torch.serialization.get_crc32_options() \
        if hasattr(torch.serialization, "get_crc32_options") else None
    rows = []

    def timed(fn):
        sync()
        t0 = time.monotonic()
        out = fn()
        sync()
        return time.monotonic() - t0, out

    def set_crc(on: bool) -> bool:
        if crc is None:
            return False
        torch.serialization.set_crc32_options(on)
        return True

    try:
        for rep in range(args.repeat):
            r = {"rep": rep}
            mgr = checkpoint.CheckpointManager(str(work / "mgr"), keep=1)
            step = 100 + rep
            r["manager_save"], _ = timed(lambda: mgr.save(step, state))
            r["manager_restore"], _ = timed(lambda: mgr.restore(state, step))

            def legacy_restore():
                loaded = torch.load(mgr.path(step), map_location="cpu",
                                    mmap=True, weights_only=True)
                for d, src in zip(tensors, tree_tensors(loaded)):
                    d.copy_(src)

            r["legacy_restore"], _ = timed(legacy_restore)
            path = work / "legacy.pt"

            def legacy():
                with open(path, "wb") as f:
                    torch.save(tree, f)
                    f.flush()
                    os.fsync(f.fileno())

            r["legacy"], _ = timed(legacy)
            path.unlink()
            r["d2h_pageable"], host = timed(
                lambda: map_tree(tree, lambda t: t.cpu()))
            for label, on in (("crc", True), ("nocrc", False)):
                if not set_crc(on) and not on:
                    continue
                with open(os.devnull, "wb") as f:
                    r[f"serialize_null_{label}"], _ = timed(
                        lambda: torch.save(host, f))
            set_crc(True)
            with open(path, "wb") as f:
                r["write"], _ = timed(lambda: (torch.save(host, f),
                                               f.flush()))
                r["fsync"], _ = timed(lambda: os.fsync(f.fileno()))
            path.unlink()
            del host
            r["pin_alloc"], pinned = timed(lambda: map_tree(
                tree, lambda t: torch.empty(t.shape, dtype=t.dtype,
                                            pin_memory=True)))
            r["d2h_pinned"], _ = timed(lambda: [
                d.copy_(s, non_blocking=True) for d, s in
                zip(tree_tensors(pinned), tensors)])
            set_crc(False)
            r["save_path"], _ = timed(lambda: torch.save(pinned, str(path)))
            path.unlink()

            def fileio():
                with open(path, "wb", buffering=0) as f:
                    torch.save(pinned, f)
                    os.fsync(f.fileno())

            r["save_fileio"], _ = timed(fileio)
            set_crc(True)
            path.unlink()
            del pinned
            for label, mm in (("mmap", True), ("read", False)):
                r[f"load_{label}"], loaded = timed(lambda: torch.load(
                    mgr.path(step), map_location="cpu", mmap=mm,
                    weights_only=True))
                r[f"h2d_{label}"], _ = timed(lambda: [
                    d.copy_(s) for d, s in
                    zip(tensors, tree_tensors(loaded))])
                del loaded
            shutil.rmtree(work / "mgr")
            block = os.urandom(64 << 20)
            raw = work / "raw.bin"
            fd = os.open(raw, os.O_WRONLY | os.O_CREAT)
            t0 = time.monotonic()
            for _ in range(16):
                os.write(fd, block)
            os.fsync(fd)
            r["raw_write"] = time.monotonic() - t0
            os.close(fd)
            buf = bytearray(64 << 20)
            fd = os.open(raw, os.O_RDONLY)
            t0 = time.monotonic()
            while os.readv(fd, [buf]):
                pass
            r["raw_read"] = time.monotonic() - t0
            os.close(fd)
            raw.unlink()
            rows.append(r)
            print("CKIO_REP " + json.dumps(r), flush=True)
    finally:
        if crc is not None:
            torch.serialization.set_crc32_options(crc)
        shutil.rmtree(work, ignore_errors=True)
    gb = nbytes / 1e9
    best = {k: min(r[k] for r in rows) for k in rows[0] if k != "rep"}
    rates = {k: (1.0737 if k.startswith("raw_") else gb) / v
             for k, v in best.items() if v > 0}
    out = dict(card=card.strip(), torch=torch.__version__,
               crc_switch=crc is not None, layers=args.layers,
               tensors=len(tensors), bytes=nbytes, dir=args.dir, rows=rows,
               best_s=best, gb_per_s=rates)
    Path(ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "checkpoint_io.json").write_text(
        json.dumps(out, indent=1))
    print("CKIO " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
