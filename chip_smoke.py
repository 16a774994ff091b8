#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout.  Builds the port's CUDA kernels from the
sources in the checkout (one nvcc per source, all at once; the
tensor-core kernels must not spill), holds each to its plain PyTorch
version on the card (f32 through the scalar kernels, bf16 through the
tensor-core ones), and drives the
flagship Llama at llama_7b widths (random weights from a seed) down both
of the port's paths: serving (f32 and bf16 flash-vs-full logits, the
full-sequence flash forward, KV-cache generate and the slot-pool
ServingEngine) and training (f32 flash-vs-full parity of loss, grads and
a 4-step trajectory, then an 8-layer bf16 train step with an f32 master
copy, on the card and with the optimizer state offloaded to pinned host
memory).  It checks the outputs and traces the forward, a window of
decode dispatches and one train step with torch.profiler (device busy
share, top kernels, calls of each of the port's kernels).  Exits non-zero
if any phase fails, and at once (printing no result) without a CUDA
device or outside a checkout.

Stdout ends with: a ``{"kernels": [...]}`` line (per kernel: launches on
the main path, max error, kernel / plain / library times and the card's
bound), the card's name and power limit from nvidia-smi, and the line
``{"ok": true, "device": {...}}``.  The full record is also written to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32
# without tensor cores (the kernel keeps f32 out of TF32), HBM3.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# Tolerances of the forward kernels against the plain version on the same
# inputs.  f32 (the scalar kernel): two f32 softmax orders, O's max abs
# error.  lse is f32 in both dtypes.
TOL_O = 1e-4
TOL_LSE = {"float32": 1e-4, "bfloat16": 1e-3}
# bf16 (the tensor-core kernel), O on its own scale (see grad_errors):
# - max|got - want| / max|want| at most 2**-7 + 2**-8 max|V| / max|want|,
#   derived: rounding P to bf16 moves each weight by at most 2**-8 of
#   itself, so O (a convex sum of V's rows) by at most 2**-8 max|V|; both
#   sides round O to bf16, each by at most 2**-8 of max|O|;
# - relative RMS of the whole O and of its worst (batch, 64-row tile,
#   head) block: 4x the largest reading over all cases on an H100 80GB
#   HBM3 (2.28e-3 and 2.80e-3; max error read 4.85e-3 of max|O|).
TOL_O_BF16_RMS = 9.2e-3
TOL_O_BF16_TILE = 1.12e-2
# f32 logits of 2 llama_7b-width layers, flash kernel vs plain full
# attention: both exact f32; ~1e-5 expected, 1e-3 allowed.
TOL_FLASH_VS_FULL = 1e-3
# bf16 logits of 2 llama_7b-width layers on (1, 2048) tokens, flash kernel
# vs plain full attention (which rounds its logits and P to bf16
# elsewhere): relative RMS, 4x the reading on an H100 80GB HBM3 (1.24e-2).
TOL_BF16_FLASH_VS_FULL = 5e-2
# Backward kernels against the plain backward on the same (q, k, v, dO,
# lse, Δ), each output (dQ, dK, dV) on its own scale (judge_backward):
# - max|got - want| / max|want|.  f32 (the scalar kernels): two f32
#   summation orders, TOL_GRAD.  bf16 (the tensor-core kernels, which
#   round P and dS to bf16 before their products): derived from that
#   rounding in grad_max_limits;
# - the relative RMS error ||got - want|| / ||want|| of the whole output,
#   and the worst one of its (batch, 64-row tile, head) blocks, which a
#   dropped or misweighted tile moves where the largest element hides it;
# - with causal window 1, dQ and dK are zero by the mathematics (P is 1 on
#   the diagonal, so dS = dP - Δ = 0): both sides must stay under an
#   absolute limit instead.
# The RMS and zero limits are 4x the largest reading over all cases on an
# H100 80GB HBM3 (RMS f32 6.06e-7, bf16 2.84e-3; worst block f32
# 1.40e-6, bf16 3.91e-3; zero outputs 8.16e-6).  The bf16 readings are
# the tensor-core kernels' (P and dS rounded to bf16); the plain torch
# emulation of that rounding in tests/test_torch_flash_backward.py reads
# 2.82e-3 and 3.88e-3 on its CPU cases.
TOL_GRAD = 1e-4
TOL_GRAD_RMS = {"float32": 2.5e-6, "bfloat16": 1.14e-2}
TOL_GRAD_TILE = {"float32": 5.7e-6, "bfloat16": 1.57e-2}
TOL_GRAD_ZERO = 3.3e-5
GRAD_TILE = 64
# Training at llama_7b widths in f32, flash kernels vs plain full
# attention: loss relative; each grad against its own largest |value|.
TOL_TRAIN_LOSS = 1e-5
TOL_TRAIN_GRAD = 1e-3
# The bf16 main path at 8 layers, flash kernels vs plain full attention on
# the same weights and batch: step-0 loss relative, and each param grad's
# relative RMS difference.  Both sides round differently in bf16, so the
# limits are 4x the reading on an H100 80GB HBM3 (loss 4.57e-5, worst
# grad 3.20e-2).  The loss reading moved from 1.82e-5 when the bf16
# forward began to round P to bf16 before PV (the tensor-core kernel), so
# its limit moved with it, from 7.3e-5.
TOL_BF16_LOSS = 1.9e-4
TOL_BF16_GRAD_RMS = 0.13
KERNEL_SOURCES = ("flash_fwd", "flash_bwd")
# Device time of a profile summed by kernel family (name substrings): the
# port's kernels (one name each: every __global__ under csrc/), cuBLAS
# products, and everything else (elementwise, reductions, copies).
KERNEL_GROUPS = {"port_kernels": ("flash_fwd_mma_kernel", "flash_fwd_kernel",
                                  "flash_bwd_dq_mma_kernel",
                                  "flash_bwd_dkv_mma_kernel",
                                  "flash_bwd_dq_kernel",
                                  "flash_bwd_dkv_kernel"),
                 "matmul": ("nvjet", "gemm", "cutlass", "sm90_xmma")}


class Fail(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise Fail(what)


def log(*parts) -> None:
    print(*parts, flush=True)


def ptxas_kernels(build_log: str) -> list:
    """Per kernel instantiation in an ``nvcc -Xptxas -v`` log: its name and
    head_dim (the first template argument), registers a thread and spill
    bytes (stores + loads)."""
    rows, cur = [], None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = re.search(r"(flash_[a-z_]+_kernel)(?:ILi(\d+)E)?",
                             m.group(1))
            cur = dict(kernel=name.group(1) if name else m.group(1),
                       head_dim=int(name.group(2)) if name and name.group(2)
                       else None, registers=None, spill_bytes=None)
            rows.append(cur)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur is not None:
            cur["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return rows


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int = 10) -> float:
    """Device time of one call of ``fn``: the summed time of its kernels
    under torch.profiler over ``iters`` calls, without the host's gaps."""
    fn()
    busy = device_profile(torch, lambda: [fn() for _ in range(iters)])
    return busy["device_busy_ms"] / iters


def device_profile(torch, fn, top: int = 6) -> dict:
    """One traced call of ``fn`` (torch.profiler, CPU + CUDA activity):
    its wall time, the summed time of its device kernels and their share
    of the wall (the device's busy share), and the kernels with the most
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    kernels: dict = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            n, tot = kernels.get(evt.name, (0, 0.0))
            kernels[evt.name] = (n + 1, tot + evt.time_range.elapsed_us())
    busy_us = sum(tot for _, tot in kernels.values())
    check(busy_us > 0, "the profiler saw no device kernel")
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:top]
    groups = dict.fromkeys(list(KERNEL_GROUPS) + ["other"], 0.0)
    for name, (_, tot) in kernels.items():
        group = next((g for g, keys in KERNEL_GROUPS.items()
                      if any(key in name for key in keys)), "other")
        groups[group] += tot / 1e3
    port_calls = {key: sum(n for name, (n, _) in kernels.items()
                           if key in name)
                  for key in KERNEL_GROUPS["port_kernels"]}
    return {
        "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_busy_share": busy_us / wall_us,
        "kernel_launches": sum(n for n, _ in kernels.values()),
        "ms_by_group": groups,
        "port_kernel_calls": port_calls,
        "top_kernels": [{"name": name[:90], "calls": n, "ms": tot / 1e3,
                         "share_of_busy": tot / busy_us}
                        for name, (n, tot) in ranked],
    }


def attention_pairs(T: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask keeps: the work this input needs."""
    if not causal:
        return T * T
    if window <= 0:
        return T * (T + 1) // 2
    return sum(min(p + 1, window) for p in range(T))


# Per kernel: flops per (query, key) pair and head-dim element; (B, T, H,
# d) tensors moved (read once or written once); f32 (B, H, T) rows read.
# Forward: QK^T, PV; q, k, v in, O out.  dQ: QK^T, dO V^T, dS K; q, k, v,
# dO in, dQ out; lse, Δ in.  dK/dV: the same two plus P^T dO, dS^T Q;
# dK, dV out.
BOUND_COUNTS = {"fwd": (4, 4, 0), "dq": (6, 5, 2), "dkv": (8, 6, 2)}


def flash_bound(B, T, H, d, dtype: str, causal: bool, window: int,
                kind: str = "fwd"):
    """Least time on the card for one ``kind`` kernel call: the larger of
    operations over the peak rate of the input type and bytes (each input
    read once, each output written once) over the memory rate."""
    per_pair, tensors, rows = BOUND_COUNTS[kind]
    flops = per_pair * B * H * d * attention_pairs(T, causal, window)
    itemsize = 2 if dtype == "bfloat16" else 4
    nbytes = tensors * B * T * H * d * itemsize + rows * B * H * T * 4
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def kernel_cases():
    cases = []
    for dtype in ("float32", "bfloat16"):
        for d in (64, 128):
            for T in (128, 200, 2048):
                cases.append(dict(dtype=dtype, d=d, T=T, window=0,
                                  causal=True, lse=True))
        for window, lse in ((1, True), (16, False), (48, True),
                            (128, False)):
            cases.append(dict(dtype=dtype, d=128, T=2048, window=window,
                              causal=True, lse=lse))
        cases.append(dict(dtype=dtype, d=64, T=200, window=48, causal=True,
                          lse=False))
        cases.append(dict(dtype=dtype, d=128, T=200, window=0, causal=False,
                          lse=True))
        for d in (16, 32):
            cases.append(dict(dtype=dtype, d=d, T=200, window=0,
                              causal=True, lse=True))
    # Views that are not contiguous, which the kernels read through their
    # strides (appended last, so the cases above draw the same inputs).
    for dtype in ("float32", "bfloat16"):
        cases += [dict(dtype=dtype, d=128, T=200, window=0, causal=True,
                       lse=True, layout="fused"),
                  dict(dtype=dtype, d=64, T=200, window=48, causal=True,
                       lse=False, layout="bhtd"),
                  dict(dtype=dtype, d=128, T=2048, window=128, causal=True,
                       lse=True, layout="odd_b1")]
    return cases


def operands(torch, c, B, H, n, gen):
    """``n`` (B, T, H, d) inputs of case ``c`` in its layout: contiguous;
    ``fused``, slices of one (B, T, n, H, d) buffer (as a fused QKV
    projection gives them); ``bhtd``, a (B, H, T, d) tensor transposed;
    ``odd_b1``, B = 1 with a batch stride of 1, which is never stepped."""
    dt = getattr(torch, c["dtype"])
    layout = c.get("layout", "contiguous")

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(dt)

    T, d = c["T"], c["d"]
    if layout == "fused":
        return randn(B, T, n, H, d).unbind(2)
    if layout == "bhtd":
        return tuple(randn(B, H, T, d).transpose(1, 2) for _ in range(n))
    xs = tuple(randn(B, T, H, d) for _ in range(n))
    if layout == "odd_b1":
        check(B == 1, "odd_b1 needs B = 1")
        return tuple(x.as_strided(x.shape, (1,) + x.stride()[1:])
                     for x in xs)
    return xs


def bad_bf16_operands(torch):
    """A contiguous bf16 (1, 128, 4, 64) operand, and two of the same shape
    that the tensor-core kernels cannot copy 16 bytes at a time: data 2
    bytes off 16-byte alignment, and an odd token stride."""
    B, T, H, d = 1, 128, 4, 64
    q = torch.zeros(B, T, H, d, device="cuda", dtype=torch.bfloat16)
    flat = torch.zeros(q.numel() + 1, device="cuda", dtype=torch.bfloat16)
    wide = torch.zeros(B, T, H * d + 1, device="cuda", dtype=torch.bfloat16)
    return q, {"misaligned": flat[1:].view(B, T, H, d),
               "odd_token_stride": wide[..., :H * d].unflatten(-1, (H, d))}


def refusals(torch, counters, calls) -> dict:
    """Which of ``calls`` raised ValueError, and the kernel launches the
    ``counters`` counted meanwhile."""
    before = sum(f.launches for f in counters)
    refused = {}
    for name, call in calls.items():
        try:
            call()
            refused[name] = False
        except ValueError:
            refused[name] = True
    torch.cuda.synchronize()
    return dict(refused=refused,
                launches=sum(f.launches for f in counters) - before)


def check_refusals(torch, fa, record):
    """A bf16 operand the tensor-core kernel cannot copy 16 bytes at a time
    raises before anything is launched: there is no fallback to the scalar
    kernel."""
    q, bad = bad_bf16_operands(torch)
    got = record["bf16_refusals"] = refusals(
        torch, (fa.flash_attention,),
        {name: lambda x=x: fa.flash_attention(x, q, q)
         for name, x in bad.items()})
    log("bf16 refusals", json.dumps(got))
    check(all(got["refused"].values()) and got["launches"] == 0,
          f"a bf16 operand cp.async cannot take was not refused: {got}")


def check_backward_refusals(torch, fa, record):
    """The backward twin of check_refusals: each bad bf16 operand, as dO
    of either backward kernel, raises with no backward launch."""
    q, bad = bad_bf16_operands(torch)
    B, T, H, d = q.shape
    rows = torch.zeros(B, H, T, device="cuda")
    calls = {}
    for name, x in bad.items():
        for f in (fa.flash_bwd_dq, fa.flash_bwd_dkv):
            calls[f"{f.__name__}_{name}"] = (
                lambda f=f, x=x: f(q, q, q, x, rows, rows, d ** -0.5, True))
    got = record["bf16_backward_refusals"] = refusals(
        torch, (fa.flash_bwd_dq, fa.flash_bwd_dkv), calls)
    log("bf16 backward refusals", json.dumps(got))
    check(all(got["refused"].values()) and got["launches"] == 0,
          f"a bf16 backward operand cp.async cannot take was not refused: "
          f"{got}")


def phase_kernel(torch, fa, record):
    """Every case: the kernel against the plain version on the card (f32
    through the scalar kernel, bf16 through the tensor-core one); then the
    bf16 layouts the wrapper refuses."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for c in kernel_cases():
        B, H = (1, 32) if c["T"] == 2048 else (2, 4)
        dt = getattr(torch, c["dtype"])
        q, k, v = operands(torch, c, B, H, 3, gen)
        got = fa.flash_attention(q, k, v, causal=c["causal"],
                                 window=c["window"], return_lse=c["lse"])
        want = fa._reference(q, k, v, c["d"] ** -0.5, c["causal"],
                             c["window"], return_lse=c["lse"])
        torch.cuda.synchronize()
        if not c["lse"]:
            got, want = (got, None), (want, None)
        check(got[0].dtype == dt and got[0].shape == q.shape,
              f"kernel output dtype/shape {c}")
        check(bool(torch.isfinite(got[0].float()).all()),
              f"kernel output not finite {c}")
        if c["dtype"] == "float32":
            err = (got[0] - want[0]).abs().max().item()
            row = dict(c, B=B, H=H, max_abs_err=err, tol=TOL_O)
            ok = err <= TOL_O
        else:
            row = dict(c, B=B, H=H, **grad_errors(torch, got[0], want[0],
                                                  False))
            row.update(tol_rel_max=2 ** -7 + 2 ** -8 * v.float().abs().max()
                       .item() / row["max_abs_want"],
                       tol_rel_rms=TOL_O_BF16_RMS,
                       tol_tile_rel_rms=TOL_O_BF16_TILE)
            ok = (row["rel_max_err"] <= row["tol_rel_max"]
                  and row["rel_rms_err"] <= TOL_O_BF16_RMS
                  and row["tile_rel_rms_err"] <= TOL_O_BF16_TILE)
        if c["lse"]:
            row["lse_err"] = (got[1] - want[1]).abs().max().item()
            row["lse_tol"] = TOL_LSE[c["dtype"]]
            ok = ok and row["lse_err"] <= row["lse_tol"]
        rows.append(row)
        log("kernel case", json.dumps(row))
        check(ok, f"kernel disagrees with its plain version: {row}")
    record["kernel_cases"] = rows
    check_refusals(torch, fa, record)

    # Times at the main path's shape: one llama_7b layer's attention.
    B, T, H, d = 1, 2048, 32, 128
    q, k, v = (torch.randn(B, T, H, d, device="cuda",
                           generator=gen).to(torch.bfloat16)
               for _ in range(3))
    main = [r for r in rows if r["dtype"] == "bfloat16" and r["T"] == T
            and r["d"] == d and r["window"] == 0][0]
    t_kernel = cuda_ms(torch, lambda: fa.flash_attention(q, k, v))
    t_plain = cuda_ms(torch, lambda: fa._reference(q, k, v, d ** -0.5, True))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    t_lib = cuda_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True))
    # The scalar kernel, which every f32 call takes, at the same shape.
    q32, k32, v32 = (x.float() for x in (q, k, v))
    t_f32 = cuda_ms(torch, lambda: fa.flash_attention(q32, k32, v32))
    bound_ms, bound_by = flash_bound(B, T, H, d, "bfloat16", True, 0)
    record["flash_fwd_timing"] = dict(
        shape=[B, T, H, d], dtype="bfloat16", causal=True, ms=t_kernel,
        plain_ms=t_plain, library_ms=t_lib, f32_ms=t_f32,
        bound_ms=bound_ms, bound_by=bound_by,
        bound_share=bound_ms / t_kernel,
        tflops=4 * B * H * d * attention_pairs(T, True, 0) / t_kernel / 1e9,
        max_abs_err=main["max_abs_err"],
        errors={key: main[key] for key in
                ("rel_max_err", "rel_rms_err", "tile_rel_rms_err",
                 "max_abs_want")})
    log("flash_fwd timing", json.dumps(record["flash_fwd_timing"]))


def backward_inputs(fa, q, k, v, do, causal: bool, window: int):
    """The backward's arguments as the train step makes them: lse from the
    forward kernel, Δ from its O."""
    out, lse = fa.flash_attention(q, k, v, causal=causal, window=window,
                                  return_lse=True)
    return (q, k, v, do, lse, fa._delta(out, do), q.shape[-1] ** -0.5,
            causal, window)


def backward_kernels(fa, args):
    return (fa.flash_bwd_dq(*args),) + fa.flash_bwd_dkv(*args)


def grad_errors(torch, got, want, zero: bool) -> dict:
    """How far one (B, T, H, d) kernel output (a bf16 O, dQ, dK or dV)
    lies from the plain one: the largest error and value, and unless the
    output is ``zero`` by the mathematics, the errors on its own scale
    (see TOL_GRAD)."""
    diff = got.float() - want.float()
    row = dict(max_abs_err=diff.abs().max().item(),
               max_abs_want=want.float().abs().max().item())
    if zero:
        return row
    B, T, H, d = diff.shape
    tiles = -(-T // GRAD_TILE)

    def tile_sq(x):  # squared norm of each (batch, tile, head) block
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, tiles * GRAD_TILE - T))
        return x.square().reshape(B, tiles, GRAD_TILE, H, d).sum((2, 4))

    row.update(rel_max_err=row["max_abs_err"] / row["max_abs_want"],
               rel_rms_err=(diff.norm() / want.float().norm()).item(),
               tile_rel_rms_err=(tile_sq(diff) / tile_sq(want.float()))
               .sqrt().max().item())
    return row


def grad_max_limits(torch, fa, args, want) -> dict:
    """The bf16 tensor-core backward's limit on max|got - want| / max|want|
    for each of dQ, dK, dV: 2**-7 + 2**-8 max(B) / max|want|, derived from
    its rounding.  Rounding P (before Pᵀ dO) or dS (before dS K and dSᵀ Q)
    to bf16 moves each entry by at most 2**-8 of itself, so an output
    element by at most 2**-8 of the same sum over absolute values, B: for
    dV, Pᵀ|dO|; for dK, scale·|dS|ᵀ|Q|; for dQ, scale·|dS||K|, each
    computed in f32 by the plain code from the same inputs.  Both sides
    round the output to bf16, each by at most 2**-8 of max|want|."""
    q, k, _, do, _, _, scale, _, _ = args
    _, p, ds = fa._recompute(*args)
    ads = ds.abs()
    bound = dict(
        dq=torch.einsum("bhts,bshd->bthd", ads, k.float().abs()) * scale,
        dk=torch.einsum("bhts,bthd->bshd", ads, q.float().abs()) * scale,
        dv=torch.einsum("bhts,bthd->bshd", p, do.float().abs()))
    return {name: 2 ** -7 + 2 ** -8 * bound[name].max().item()
            / max(w.float().abs().max().item(), 1e-30)
            for name, w in zip(("dq", "dk", "dv"), want)}


def judge_backward(torch, fa, args, got, want):
    """Each of (dQ, dK, dV) ``got`` against the plain ``want`` on the
    backward's inputs ``args``: its errors (grad_errors) beside the limits
    of its dtype (see TOL_GRAD), and whether all three keep them."""
    q, *_, causal, window = args
    dtype = str(q.dtype).removeprefix("torch.")
    limits = (grad_max_limits(torch, fa, args, want)
              if dtype == "bfloat16" else None)
    ok, rows = True, {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        zero = causal and window == 1 and name != "dv"
        e = rows[name] = grad_errors(torch, g, w, zero)
        if zero:
            e["tol_abs"] = TOL_GRAD_ZERO
            ok = ok and max(e["max_abs_err"], e["max_abs_want"]) \
                <= TOL_GRAD_ZERO
            continue
        e.update(tol_rel_max=limits[name] if limits else TOL_GRAD,
                 tol_rel_rms=TOL_GRAD_RMS[dtype],
                 tol_tile_rel_rms=TOL_GRAD_TILE[dtype])
        ok = ok and e["rel_max_err"] <= e["tol_rel_max"] \
            and e["rel_rms_err"] <= e["tol_rel_rms"] \
            and e["tile_rel_rms_err"] <= e["tol_tile_rel_rms"]
    return ok, rows


def phase_backward_kernels(torch, fa, record):
    """Every forward case again for the backward kernels (f32 through the
    scalar kernels, bf16 through the tensor-core ones) against the plain
    backward on the card (judge_backward); the bf16 layouts they refuse;
    bitwise repeatability; times at the main path's shape, bf16 and the f32
    scalar kernels, beside the plain backward's and SDPA's backward."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rows = []
    for c in kernel_cases():
        c = {key: val for key, val in c.items() if key != "lse"}
        B, H = (1, 32) if c["T"] == 2048 else (2, 4)
        dt = getattr(torch, c["dtype"])
        q, k, v, do = operands(torch, c, B, H, 4, gen)
        args = backward_inputs(fa, q, k, v, do, c["causal"],
                               c["window"])
        got = backward_kernels(fa, args)
        want = (fa._dq_reference(*args),) + fa._dkv_reference(*args)
        torch.cuda.synchronize()
        for name, g in zip(("dq", "dk", "dv"), got):
            check(g.dtype == dt and g.shape == q.shape,
                  f"{name} dtype/shape {c}")
            check(bool(torch.isfinite(g.float()).all()),
                  f"{name} not finite {c}")
        ok, errors = judge_backward(torch, fa, args, got, want)
        row = dict(c, B=B, H=H, **errors)
        rows.append(row)
        log("backward case", json.dumps(row))
        check(ok, f"backward kernels disagree with the plain backward: {row}")
    record["backward_cases"] = rows
    check_backward_refusals(torch, fa, record)

    B, T, H, d = 1, 2048, 32, 128
    q, k, v, do = (torch.randn(B, T, H, d, device="cuda",
                               generator=gen).to(torch.bfloat16)
                   for _ in range(4))
    args = backward_inputs(fa, q, k, v, do, True, 0)
    first = backward_kernels(fa, args)
    second = backward_kernels(fa, args)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b) for a, b in zip(first, second))
    log(f"backward kernels bitwise repeatable: {bitwise}")
    check(bitwise, "two backward calls on the same inputs differ")

    main = [r for r in rows if r["dtype"] == "bfloat16" and r["T"] == T
            and r["d"] == d and r["window"] == 0][0]
    out = fa.flash_attention(q, k, v)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    # The scalar kernels, which every f32 call takes, at the same shape.
    args32 = backward_inputs(fa, *(x.float() for x in (q, k, v, do)), True,
                             0)
    timing = dict(
        shape=[B, T, H, d], dtype="bfloat16", causal=True,
        bitwise_repeatable=bitwise,
        dq_ms=cuda_ms(torch, lambda: fa.flash_bwd_dq(*args)),
        dkv_ms=cuda_ms(torch, lambda: fa.flash_bwd_dkv(*args)),
        dq_f32_ms=cuda_ms(torch, lambda: fa.flash_bwd_dq(*args32)),
        dkv_f32_ms=cuda_ms(torch, lambda: fa.flash_bwd_dkv(*args32)),
        delta_ms=cuda_ms(torch, lambda: fa._delta(out, do)),
        plain_dq_ms=cuda_ms(torch, lambda: fa._dq_reference(*args)),
        plain_dkv_ms=cuda_ms(torch, lambda: fa._dkv_reference(*args)),
        # SDPA's backward alone; one call gives dQ, dK and dV.  Its device
        # time comes from the profiler: events around autograd.grad also
        # time the host's launch gaps, which vary from run to run.
        library_ms=device_ms(torch, lambda: torch.autograd.grad(
            sdpa_out, (qt, kt, vt), dot, retain_graph=True)),
        library_event_ms=cuda_ms(torch, lambda: torch.autograd.grad(
            sdpa_out, (qt, kt, vt), dot, retain_graph=True)),
        errors={name: main[name] for name in ("dq", "dk", "dv")})
    timing["kernels_and_delta_ms"] = (timing["dq_ms"] + timing["dkv_ms"]
                                      + timing["delta_ms"])
    for kind in ("dq", "dkv"):
        bound, by = flash_bound(B, T, H, d, "bfloat16", True, 0, kind)
        timing[f"{kind}_bound_ms"], timing[f"{kind}_bound_by"] = bound, by
    record["flash_bwd_timing"] = timing
    log("flash_bwd timing", json.dumps(timing))


def phase_forward_and_serve_f32(torch, port, record):
    """llama_7b widths, 2 layers, f32: flash logits against full; the
    engine token-exact against generate()."""
    llama, convert, generate, serve, _ = port
    cfg = dataclasses.replace(llama.llama_7b(), n_layers=2,
                              dtype="float32", attention="flash")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flash_model = convert.init_weights(cfg, gen)
    full_model = llama.Llama(dataclasses.replace(cfg, attention="full"))
    full_model.load_state_dict(flash_model.state_dict(), assign=True)
    tokens = torch.randint(0, cfg.vocab, (1, 512), device="cuda",
                           generator=gen)
    with torch.inference_mode():
        a = flash_model(tokens)
        b = full_model(tokens)
    torch.cuda.synchronize()
    err = (a - b).abs().max().item()
    record["forward_f32_flash_vs_full"] = dict(
        layers=2, tokens=[1, 512], max_abs_err=err, tol=TOL_FLASH_VS_FULL)
    log("forward f32 flash vs full", json.dumps(
        record["forward_f32_flash_vs_full"]))
    check(bool(torch.isfinite(a).all()), "f32 flash logits not finite")
    check(err <= TOL_FLASH_VS_FULL, f"flash vs full logits: {err}")

    rng = torch.Generator().manual_seed(SEED)
    reqs = [(torch.randint(1, cfg.vocab, (n,), generator=rng).tolist(), 8)
            for n in (5, 17, 40, 64)]
    eng = serve.ServingEngine(flash_model, max_slots=2, max_len=128)
    ids = {eng.submit(p, n): (p, n) for p, n in reqs}
    done = eng.run()
    check(len(done) == len(reqs), "engine lost a request")
    for c in done:
        p, n = ids[c.request_id]
        want = generate.generate(flash_model, torch.tensor([p]), n)
        check(c.tokens == want[0, len(p):].tolist(),
              f"engine request {c.request_id} diverged from generate()")
    record["serve_f32_vs_generate"] = dict(
        requests=len(reqs), prompt_lens=[len(p) for p, _ in reqs],
        new_tokens=8, max_slots=2, token_exact=True)
    log("serve f32 vs generate", json.dumps(record["serve_f32_vs_generate"]))


def phase_forward_bf16(torch, port, record):
    """llama_7b widths, 2 layers, bf16, (1, 2048) tokens: logits through
    the tensor-core kernel against plain full attention (f32 no longer
    reaches that kernel)."""
    llama, convert, _, _, _ = port
    cfg = dataclasses.replace(llama.llama_7b(), n_layers=2,
                              attention="flash")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    flash_model = convert.init_weights(cfg, gen)
    full_model = llama.Llama(dataclasses.replace(cfg, attention="full"))
    full_model.load_state_dict(flash_model.state_dict(), assign=True)
    tokens = torch.randint(0, cfg.vocab, (1, 2048), device="cuda",
                           generator=gen)
    with torch.inference_mode():
        a = flash_model(tokens).float()
        b = full_model(tokens).float()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(a).all()), "bf16 flash logits not finite")
    rms = ((a - b).norm() / b.norm()).item()
    record["forward_bf16_flash_vs_full"] = dict(
        layers=2, tokens=[1, 2048], rel_rms_err=rms,
        max_abs_err=(a - b).abs().max().item(),
        max_abs_want=b.abs().max().item(), tol=TOL_BF16_FLASH_VS_FULL)
    log("forward bf16 flash vs full", json.dumps(
        record["forward_bf16_flash_vs_full"]))
    check(rms <= TOL_BF16_FLASH_VS_FULL, f"bf16 flash vs full logits: {rms}")


def phase_main_path(torch, fa, port, record):
    """The main path at full llama_7b size in bf16: the 32-layer flash
    forward on 2048 tokens, then the engine answering 6 requests.  After
    the launch counts are read, the same forward and 8 decode dispatches
    of the same engine traffic are traced for where the time goes."""
    llama, convert, _, serve, _ = port
    cfg = dataclasses.replace(llama.llama_7b(), attention="flash")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    t0 = time.monotonic()
    model = convert.init_weights(cfg, gen)
    torch.cuda.synchronize()
    record["init_weights_s"] = time.monotonic() - t0
    tokens = torch.randint(0, cfg.vocab, (1, 2048), device="cuda",
                           generator=gen)

    fa.flash_attention.launches = 0
    with torch.inference_mode():
        t0 = time.monotonic()
        logits = model(tokens)
        torch.cuda.synchronize()
        first_s = time.monotonic() - t0
    forward_launches = fa.flash_attention.launches
    check(logits.shape == (1, 2048, cfg.vocab), "bf16 logits shape")
    check(bool(torch.isfinite(logits.float()).all()),
          "bf16 logits not finite")
    check(forward_launches == cfg.n_layers,
          f"flash launches {forward_launches} != {cfg.n_layers} layers")

    lens = (64, 128, 200, 333, 512, 96)
    new = 32

    def engine():
        """A 4-slot engine holding the main path's 6 requests."""
        rng = torch.Generator().manual_seed(SEED + 2)
        eng = serve.ServingEngine(model, max_slots=4, max_len=512 + new)
        for n in lens:
            eng.submit(torch.randint(1, cfg.vocab, (n,),
                                     generator=rng).tolist(), new)
        return eng

    eng = engine()
    t0 = time.monotonic()
    done = eng.run()
    wall = time.monotonic() - t0
    main_launches = fa.flash_attention.launches
    check(len(done) == len(lens), "engine lost a request")
    check(all(len(c.tokens) == new for c in done), "short completion")
    check(all(0 <= t < cfg.vocab for c in done for t in c.tokens),
          "token out of vocabulary")
    ttft = [c.ttft_s for c in done]
    decode_tokens = eng.stats["tokens_out"] - eng.stats["prefills"]

    with torch.inference_mode():
        t_forward = cuda_ms(torch, lambda: model(tokens), iters=3,
                            warmup=1)
    record["main_path"] = dict(
        forward=dict(layers=cfg.n_layers, tokens=[1, 2048],
                     dtype="bfloat16", flash_launches=forward_launches,
                     first_call_s=first_s, ms=t_forward),
        # Six samples give no tail percentile (a nearest-rank p99 of 6
        # is the max), so the tail is reported as the max.
        serve=dict(card=record["card"], requests=len(lens),
                   prompt_lens=list(lens), new_tokens=new, max_slots=4,
                   wall_s=wall, ttft_p50_s=serve.nearest_rank(ttft, 0.50),
                   ttft_max_s=max(ttft),
                   decode_tokens=decode_tokens,
                   decode_s=eng.stats["decode_seconds"],
                   decode_tokens_per_s=(decode_tokens
                                        / eng.stats["decode_seconds"]),
                   decode_dispatches=eng.stats["decode_dispatches"],
                   pool_bytes=eng.pool_hbm_bytes()),
        flash_launches=main_launches,
        peak_memory_bytes=torch.cuda.max_memory_allocated())
    log("main path", json.dumps(record["main_path"]))

    with torch.inference_mode():
        forward_profile = device_profile(torch, lambda: model(tokens))
    eng = engine()
    eng.step()  # admits 4 of the 6 requests: all slots hold one

    def decode():
        for _ in range(8):
            eng.step()

    calls = forward_profile["port_kernel_calls"]
    check(calls["flash_fwd_mma_kernel"] == cfg.n_layers
          and calls["flash_fwd_kernel"] == 0,
          f"the bf16 forward ran the port's kernels {calls}, want the "
          f"tensor-core kernel {cfg.n_layers} times and the scalar one 0")
    record["profile"] = {"card": record["card"],
                         "forward_1x2048": forward_profile,
                         "decode_8_dispatches_4_slots":
                             device_profile(torch, decode)}
    for name, w in record["profile"].items():
        if name == "card":
            continue
        log(f"profile {name}: wall {w['wall_ms']:.2f} ms, device busy "
            f"{w['device_busy_ms']:.2f} ms ({w['device_busy_share']:.1%}),"
            f" {w['kernel_launches']} kernel launches;",
            "; ".join(f"{k['ms']:.3f} ms x{k['calls']} {k['name'][:40]}"
                      for k in w["top_kernels"]))
    return main_launches


def phase_train_f32_parity(torch, port, record):
    """llama_7b widths, 2 layers, f32: loss and every grad, then a 4-step
    loss trajectory, through the flash kernels against full attention."""
    llama, convert, _, _, train = port
    cfg = dataclasses.replace(llama.llama_7b(), n_layers=2,
                              dtype="float32", attention="flash")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    flash_model = convert.init_weights(cfg, gen)
    full_model = llama.Llama(dataclasses.replace(cfg, attention="full"))
    full_model.load_state_dict(flash_model.state_dict())
    # A batch a step: on one repeated batch the loss falls to ~1e-3 by
    # step 3, where a relative tolerance measures rounding, not the path.
    batches = [torch.randint(0, cfg.vocab, (2, 257), device="cuda",
                             generator=gen) for _ in range(4)]

    def loss_and_grads(model):
        loss = train.loss_fn(model, batches[0])
        return loss.item(), torch.autograd.grad(loss,
                                                list(model.parameters()))

    def trajectory(model):
        opt = train.make_optimizer()
        state = train.TrainState.for_model(model, opt)
        step = train.make_train_step(model, opt)
        return [step(state, tokens)[1].item() for tokens in batches]

    loss_f, grads_f = loss_and_grads(flash_model)
    loss_u, grads_u = loss_and_grads(full_model)
    grad_err = max(
        ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
        for a, b in zip(grads_f, grads_u))
    del grads_f, grads_u
    traj_f = trajectory(flash_model)
    traj_u = trajectory(full_model)
    traj_err = max(abs(a - b) / abs(b) for a, b in zip(traj_f, traj_u))
    row = dict(layers=2, tokens=[2, 257], loss_flash=loss_f,
               loss_full=loss_u, loss_err=abs(loss_f - loss_u) / abs(loss_u),
               grad_err=grad_err, trajectory_flash=traj_f,
               trajectory_full=traj_u, trajectory_err=traj_err,
               tol_loss=TOL_TRAIN_LOSS, tol_grad=TOL_TRAIN_GRAD)
    record["train_f32_flash_vs_full"] = row
    log("train f32 flash vs full", json.dumps(row))
    check(all(map(math.isfinite, traj_f + traj_u)), "f32 losses not finite")
    check(row["loss_err"] <= TOL_TRAIN_LOSS, f"step-0 loss: {row}")
    check(grad_err <= TOL_TRAIN_GRAD, f"step-0 grads: {row}")
    check(traj_err <= TOL_TRAIN_LOSS, f"4-step trajectory: {row}")


def train_bf16_flash_vs_full(torch, llama, train, model, tokens, record):
    """The main path's model and batch: step-0 loss and every param grad
    through the flash kernels against plain full attention."""
    full = llama.Llama(dataclasses.replace(model.cfg, attention="full"),
                       device=model.device)
    full.load_state_dict(model.state_dict(), assign=True)  # shared weights

    def loss_and_grads(m):
        loss = train.loss_fn(m, tokens)
        return loss.item(), torch.autograd.grad(loss, list(m.parameters()))

    loss_f, grads_f = loss_and_grads(model)
    loss_u, grads_u = loss_and_grads(full)
    names = [n for n, _ in model.named_parameters()]
    rms = {n: ((a.float() - b.float()).norm() / b.float().norm()).item()
           for n, a, b in zip(names, grads_f, grads_u)}
    worst = max(rms, key=rms.get)
    row = dict(layers=model.cfg.n_layers, tokens=list(tokens.shape),
               dtype="bfloat16", loss_flash=loss_f, loss_full=loss_u,
               loss_err=abs(loss_f - loss_u) / abs(loss_u),
               grad_rel_rms_err_max=rms[worst], worst_grad=worst,
               grad_rel_rms_err_median=statistics.median(rms.values()),
               tol_loss=TOL_BF16_LOSS, tol_grad_rms=TOL_BF16_GRAD_RMS)
    del full, grads_f, grads_u
    record["train_bf16_flash_vs_full"] = row
    log("train bf16 flash vs full", json.dumps(row))
    check(math.isfinite(loss_f) and row["loss_err"] <= TOL_BF16_LOSS,
          f"bf16 step-0 loss: {row}")
    check(rms[worst] <= TOL_BF16_GRAD_RMS, f"bf16 step-0 grads: {row}")


def phase_train_main(torch, fa, port, record):
    """The training path: llama_7b widths cut to 8 layers, bf16 with the
    f32 master copy, flash attention, 6 steps on one (1, 2049) batch; then
    3 steps from the same seed with the optimizer state offloaded."""
    llama, _, _, _, train = port
    cfg = dataclasses.replace(llama.llama_7b(), n_layers=8,
                              attention="flash")
    tokens = torch.randint(
        0, cfg.vocab, (1, 2049), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(SEED + 5))
    n_tokens = tokens.shape[1] - 1

    def fresh():
        gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
        return train.init_train_state(cfg, gen)

    counters = (fa.flash_attention, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    model, opt, state = fresh()
    train_bf16_flash_vs_full(torch, llama, train, model, tokens, record)
    step = train.make_train_step(model, opt)
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times, per_step = [], [], []
    for f in counters:
        f.launches = 0
    # The largest tensor of the optimizer state (the last of the two
    # vocab-sized ones): after step 3 it shows that the offloaded state
    # is whole on the host as soon as the step returns.
    big = max(range(len(state.params)),
              key=lambda i: (state.params[i].numel(), i))
    for i in range(6):
        before = [f.launches for f in counters]
        t0 = time.monotonic()
        state, loss = step(state, tokens)
        losses.append(loss.item())  # waits for the step
        times.append(time.monotonic() - t0)
        per_step.append([f.launches - b for f, b in zip(counters, before)])
        if i == 2:
            nu_step3 = state.opt_state.nu[big].cpu()
    launches = [f.launches for f in counters]
    between = torch.cuda.memory_allocated()
    peak = torch.cuda.max_memory_allocated()
    check(all(map(math.isfinite, losses)), f"train losses {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(all(n == [cfg.n_layers] * 3 for n in per_step),
          f"kernel launches per step {per_step}, want {cfg.n_layers} each")
    median = statistics.median(times[1:])
    main = dict(card=record["card"], layers=cfg.n_layers, params=n_params,
                tokens=[1, n_tokens + 1], dtype="bfloat16",
                master="float32", lr=opt.lr, losses=losses, step_s=times,
                median_step_s_2_to_6=median,
                tokens_per_s=n_tokens / median,
                launches_per_step=dict(zip(
                    ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
                    per_step[0])),
                peak_memory_bytes=peak, between_steps_bytes=between)
    log("train main path", json.dumps(main))
    record["train_profile"] = device_profile(
        torch, lambda: step(state, tokens), top=10)
    w = record["train_profile"]
    log(f"profile train step: wall {w['wall_ms']:.2f} ms, device busy "
        f"{w['device_busy_ms']:.2f} ms ({w['device_busy_share']:.1%}), "
        f"{w['kernel_launches']} kernel launches; by group (ms) "
        f"{json.dumps(w['ms_by_group'])};",
        "; ".join(f"{k['ms']:.3f} ms x{k['calls']} {k['name'][:40]}"
                  for k in w["top_kernels"]))
    check(w["port_kernel_calls"] == dict(
        flash_fwd_mma_kernel=cfg.n_layers, flash_fwd_kernel=0,
        flash_bwd_dq_mma_kernel=cfg.n_layers,
        flash_bwd_dkv_mma_kernel=cfg.n_layers,
        flash_bwd_dq_kernel=0, flash_bwd_dkv_kernel=0),
        f"the traced train step ran the port's kernels "
        f"{w['port_kernel_calls']}")
    del model, opt, state, step
    gc.collect()
    torch.cuda.empty_cache()

    model, opt, state = fresh()
    state = train.offload_state(state)
    step = train.OffloadedTrainStep(train.make_train_step(model, opt))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    off_losses, off_times = [], []
    for _ in range(3):
        t0 = time.monotonic()
        state, loss = step(state, tokens)  # waits for the host copy
        off_times.append(time.monotonic() - t0)
        # Read on the host before anything else waits for the card.
        host_state_whole = torch.equal(state.opt_state.nu[big], nu_step3)
        off_losses.append(loss.item())
    torch.cuda.synchronize()
    main["offloaded"] = dict(
        mode=step.mode, losses=off_losses, step_s=off_times,
        equal_bitwise=off_losses == losses[:3],
        host_state_equal_after_step_3=host_state_whole,
        peak_memory_bytes=torch.cuda.max_memory_allocated(),
        between_steps_bytes=torch.cuda.memory_allocated(),
        opt_state_pinned=all(t.is_pinned() for t in state.opt_state.mu))
    main["offload_saves_bytes"] = (between
                                   - main["offloaded"]["between_steps_bytes"])
    record["train_main_path"] = main
    log("train offloaded", json.dumps(main["offloaded"]),
        f"saves {main['offload_saves_bytes'] / 1e9:.2f} GB between steps")
    check(main["offloaded"]["equal_bitwise"],
          f"offloaded losses {off_losses} != on-device {losses[:3]}")
    check(main["offloaded"]["opt_state_pinned"],
          "optimizer state not in pinned host memory")
    check(host_state_whole, "the host's optimizer state after step 3, read "
          "as the step returned, differs from the on-device step's")
    del model, opt, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def kernel_row(name, source, replaces, launches, max_abs_err, ms, plain_ms,
               bound, library_ms, **extra):
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches, max_abs_err=max_abs_err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
                library_ms=library_ms, **extra)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from k8s_vgpu_scheduler_tpu_torch.entry import entry
    from k8s_vgpu_scheduler_tpu_torch.models import (
        convert, generate, llama, serve, train)
    from k8s_vgpu_scheduler_tpu_torch.ops import _kernels
    from k8s_vgpu_scheduler_tpu_torch.ops import flash_attention as fa

    # The plain versions are the f32 reference: no TF32 anywhere.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log("card:", card)
    record = {"card": card, "device": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "cuda": torch.version.cuda}
    t0 = time.monotonic()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        list(pool.map(_kernels.build, KERNEL_SOURCES))
    record["build_s"] = time.monotonic() - t0
    log(f"built {', '.join(KERNEL_SOURCES)} in {record['build_s']:.1f} s")
    record["ptxas"] = {name: _kernels.build_logs.get(name, "")
                       for name in KERNEL_SOURCES}
    for name in KERNEL_SOURCES:
        log(record["ptxas"][name].strip())
    record["registers"] = [row for name in KERNEL_SOURCES
                           for row in ptxas_kernels(record["ptxas"][name])]
    log("registers", json.dumps(record["registers"]))

    port = (llama, convert, generate, serve, train)
    try:
        # The tensor-core kernels keep every value in registers.
        mma = [r for r in record["registers"] if "mma" in r["kernel"]]
        check(len(mma) == 3 * len(fa._HEAD_DIMS)
              and all(r["spill_bytes"] == 0 for r in mma),
              f"tensor-core kernels spill or are missing: {mma}")
        forward, (model, tokens) = entry()
        logits = forward(model, tokens)
        check(logits.shape == (2, 32, 256)
              and bool(torch.isfinite(logits.float()).all()),
              "entry() logits")
        phase_kernel(torch, fa, record)
        phase_backward_kernels(torch, fa, record)
        phase_forward_and_serve_f32(torch, port, record)
        gc.collect()
        torch.cuda.empty_cache()
        phase_forward_bf16(torch, port, record)
        gc.collect()
        torch.cuda.empty_cache()
        serve_launches = phase_main_path(torch, fa, port, record)
        gc.collect()
        torch.cuda.empty_cache()  # the 32-layer serving model is gone
        phase_train_f32_parity(torch, port, record)
        gc.collect()
        torch.cuda.empty_cache()
        train_launches = phase_train_main(torch, fa, port, record)
    except Fail as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        return 1

    t = record["flash_fwd_timing"]
    b = record["flash_bwd_timing"]
    src = "k8s_vgpu_scheduler_tpu_torch/csrc/"
    tpu = "k8s_vgpu_scheduler_tpu/ops/flash_attention.py:"
    kernels = [
        kernel_row("flash_fwd", src + "flash_fwd.cu", tpu + "57",
                   serve_launches + train_launches[0], t["max_abs_err"],
                   t["ms"], t["plain_ms"], (t["bound_ms"], t["bound_by"]),
                   t["library_ms"],
                   launches_by_path={"serve": serve_launches,
                                     "train": train_launches[0]},
                   kernel="flash_fwd_mma_kernel (bf16, mma.sync)",
                   f32_kernel="flash_fwd_kernel (scalar f32)",
                   f32_ms=t["f32_ms"], errors=t["errors"]),
        kernel_row("flash_bwd_dq", src + "flash_bwd.cu", tpu + "172",
                   train_launches[1], b["errors"]["dq"]["max_abs_err"],
                   b["dq_ms"], b["plain_dq_ms"],
                   (b["dq_bound_ms"], b["dq_bound_by"]), b["library_ms"],
                   library_covers="dq, dk and dv",
                   kernel="flash_bwd_dq_mma_kernel (bf16, mma.sync)",
                   f32_kernel="flash_bwd_dq_kernel (scalar f32)",
                   f32_ms=b["dq_f32_ms"], errors={"dq": b["errors"]["dq"]}),
        kernel_row("flash_bwd_dkv", src + "flash_bwd.cu", tpu + "213",
                   train_launches[2],
                   max(b["errors"][n]["max_abs_err"] for n in ("dk", "dv")),
                   b["dkv_ms"], b["plain_dkv_ms"],
                   (b["dkv_bound_ms"], b["dkv_bound_by"]), b["library_ms"],
                   library_covers="dq, dk and dv",
                   kernel="flash_bwd_dkv_mma_kernel (bf16, mma.sync)",
                   f32_kernel="flash_bwd_dkv_kernel (scalar f32)",
                   f32_ms=b["dkv_f32_ms"],
                   errors={n: b["errors"][n] for n in ("dk", "dv")}),
    ]
    record["kernels"] = kernels
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
