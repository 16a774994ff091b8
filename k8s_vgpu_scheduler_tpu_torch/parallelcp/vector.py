"""The numpy half of the columnar fleet (``scheduler/batch.py``): the
process-private column storage and the vectorized whole-fleet class
evaluation, the JAX package's ``ColumnarFleet.mem_need``/``eligibility``
and ``eval_class_full`` as functions of a fleet.

The scheduler package itself imports no numpy (the extender's image
installs none): ``ColumnarFleet`` takes its columns from here where numpy
imports, and otherwise evaluates each row with the scalar
``batch.eval_class_row``, whose rules and arithmetic order are these, so
both give the same bits (tests/test_torch_batch.py pins it).  The solve
workers (``workers.py``) run this evaluation over their row ranges of the
shared columns (``shmem.py``, the same dtypes and shapes).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

# Card-choice sort key: (used_slots, used_mem) packed into one integer
# (scheduler/batch.py's _KEY_BASE).
_KEY_BASE = 1 << 40


def alloc(n: int, c: int) -> Dict[str, np.ndarray]:
    """Zeroed process-private columns for an ``[n, c]`` fleet, named and
    typed as ``shmem.COLUMN_SPECS``' card columns."""
    shape = (n, c)
    return {
        "valid": np.zeros(shape, dtype=bool),
        "health": np.zeros(shape, dtype=bool),
        "type_id": np.zeros(shape, dtype=np.int32),
        "total_slots": np.zeros(shape, dtype=np.int64),
        "used_slots": np.zeros(shape, dtype=np.int64),
        "total_mem": np.zeros(shape, dtype=np.int64),
        "used_mem": np.zeros(shape, dtype=np.int64),
        "total_cores": np.zeros(shape, dtype=np.int64),
        "used_cores": np.zeros(shape, dtype=np.int64),
    }


def scratch(fleet, name: str, shape, dtype) -> np.ndarray:
    """A numpy buffer reused across evaluations (per name, shape and
    dtype, pooled in ``fleet._bufs``): a steady state's evaluation
    allocates nothing."""
    buf = fleet._bufs.get(name)
    if buf is None or buf.shape != shape or buf.dtype != dtype:
        buf = fleet._bufs[name] = np.empty(shape, dtype)
    return buf


def mem_need(fleet, req) -> np.ndarray:
    """Each card's resolved MiB demand (``score._resolve_mem``: absolute
    wins, else the percentage of the card's size), in a scratch buffer
    valid until the next evaluation."""
    mem = scratch(fleet, "mem", (fleet.N, fleet.C), np.int64)
    if req.memreq > 0:
        mem[...] = req.memreq
        return mem
    pct = req.mem_percentage_req if req.mem_percentage_req > 0 else 100
    np.multiply(fleet.total_mem, pct, out=mem)
    np.floor_divide(mem, 100, out=mem)
    return mem


def eligibility(fleet, req, allowed_types) -> Tuple[np.ndarray, np.ndarray]:
    """The pods x cards fit mask of one request class and its resolved MiB
    demand: ``score._chip_reject_reason``'s rules vectorized over scratch
    buffers.  ``allowed_types`` is the class's affinity verdict a type
    id."""
    shape = (fleet.N, fleet.C)
    allowed = (np.fromiter(allowed_types, dtype=bool,
                           count=len(allowed_types))
               if allowed_types else np.ones(1, dtype=bool))
    mem = mem_need(fleet, req)
    elig = scratch(fleet, "elig", shape, bool)
    tmp = scratch(fleet, "elig-tmp", shape, bool)
    np.logical_and(fleet.valid, fleet.health, out=elig)
    np.take(allowed, fleet.type_id, out=tmp)
    elig &= tmp
    np.less(fleet.used_slots, fleet.total_slots, out=tmp)
    elig &= tmp
    np.less(fleet.used_cores, fleet.total_cores, out=tmp)
    elig &= tmp
    free = scratch(fleet, "free", shape, np.int64)
    np.subtract(fleet.total_cores, fleet.used_cores, out=free)
    np.less_equal(req.coresreq, free, out=tmp)
    elig &= tmp
    np.subtract(fleet.total_mem, fleet.used_mem, out=free)
    np.less_equal(mem, free, out=tmp)
    elig &= tmp
    if req.coresreq >= 100:
        # An exclusive request wants an untouched card.
        np.equal(fleet.used_slots, 0, out=tmp)
        elig &= tmp
        np.equal(fleet.used_cores, 0, out=tmp)
        elig &= tmp
    return elig, mem


def eval_class_full(fleet, ce) -> None:
    """One request class over every row in one numpy pass: the pods x
    cards predicates collapse to the class's ``[N, C]`` mask, the card
    choice to a packed-key argmax (one card) or stable argsort (several),
    and the node score to ``base - delta``.  ``ce.allowed`` is set and
    the fleet is not empty (``batch.eval_class_full`` sees to both)."""
    elig, mem = eligibility(fleet, ce.req, ce.allowed)
    k = ce.nums
    base = np.asarray(fleet.base)
    if k <= 1:
        key = scratch(fleet, "key", (fleet.N, fleet.C), np.int64)
        np.multiply(fleet.used_slots, np.int64(_KEY_BASE), out=key)
        key += fleet.used_mem
        notelig = scratch(fleet, "elig-tmp", (fleet.N, fleet.C), bool)
        np.logical_not(elig, out=notelig)
        key[notelig] = np.int64(-1)
        chip = key.argmax(axis=1)
        sel = chip[:, None]
        ok = np.take_along_axis(key, sel, 1)[:, 0] >= 0
        mm = np.take_along_axis(mem, sel, 1)[:, 0]
        tm = np.take_along_axis(fleet.total_mem, sel, 1)[:, 0]
        tc = np.take_along_axis(fleet.total_cores, sel, 1)[:, 0]
        delta = (np.where(tm > 0, mm / np.maximum(tm, 1), 0.0)
                 + np.where(tc > 0, ce.req.coresreq / np.maximum(tc, 1),
                            0.0))
        chips = chip
        mems = mm
    else:
        # Plain multi-card selection (fabric fleets send their multi-card
        # pods to the slice stage first): the first k eligible cards in
        # binpack-preference order, fit_container's sorted()[:k].
        key = fleet.used_slots * np.int64(_KEY_BASE) + fleet.used_mem
        order = np.argsort(-key, axis=1, kind="stable")
        eo = np.take_along_axis(elig, order, 1)
        cs = eo.cumsum(axis=1)
        ok = cs[:, -1] >= k
        pick = eo & (cs <= k)
        memo = np.take_along_axis(mem, order, 1)
        tmo = np.take_along_axis(fleet.total_mem, order, 1)
        tco = np.take_along_axis(fleet.total_cores, order, 1)
        fr = (np.where(tmo > 0, memo / np.maximum(tmo, 1), 0.0)
              + np.where(tco > 0, ce.req.coresreq / np.maximum(tco, 1),
                         0.0))
        # Column by column: the scalar row evaluator's addition order
        # (adding 0.0 for an unpicked card is exact), so both paths give
        # the same floats.
        delta = np.zeros(fleet.N, dtype=np.float64)
        picked = pick * fr
        for c in range(fleet.C):
            delta += picked[:, c]
        chips = None
        mems = None
    after = base - delta
    sc = np.where(ok & np.asarray(fleet.alive),
                  (-after if ce.binpack else after) + np.asarray(fleet.bonus),
                  -np.inf)
    ce.score = sc.tolist()
    if k <= 1:
        ce.chip = chips.tolist()
        ce.mem = mems.tolist()
    else:
        ce.chip = [-1] * fleet.N
        ce.mem = [0] * fleet.N
