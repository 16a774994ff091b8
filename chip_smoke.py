#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout.  Builds the port's CUDA kernels from the
sources in the checkout, holds each to its plain PyTorch version on the
card, drives the flagship Llama at llama_7b widths (random weights from a
seed) through the full-sequence flash forward, KV-cache generate and the
slot-pool ServingEngine, checks the outputs, and traces the forward and a
window of decode dispatches with torch.profiler (device busy share, top
kernels).  Exits non-zero if any phase fails, and at once (printing no
result) without a CUDA device or outside a checkout.

Stdout ends with: a ``{"kernels": [...]}`` line (per kernel: launches on
the main path, max error, kernel / plain / library times and the card's
bound), the card's name and power limit from nvidia-smi, and the line
``{"ok": true, "device": {...}}``.  The full record is also written to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32
# without tensor cores (the kernel keeps f32 out of TF32), HBM3.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# Tolerances of the kernel against its plain version on the same inputs:
# f32 — two f32 softmax orders; bf16 — one bf16 ULP of O (|O| < 4), and
# lse is f32 in both.
TOL_O = {"float32": 1e-4, "bfloat16": 2e-2}
TOL_LSE = {"float32": 1e-4, "bfloat16": 1e-3}
# f32 logits of 2 llama_7b-width layers, flash kernel vs plain full
# attention: both exact f32; ~1e-5 expected, 1e-3 allowed.
TOL_FLASH_VS_FULL = 1e-3


class Fail(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise Fail(what)


def log(*parts) -> None:
    print(*parts, flush=True)


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
    return {
        "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_busy_share": busy_us / wall_us,
        "kernel_launches": sum(n for n, _ in kernels.values()),
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


def flash_bound(B, T, H, d, dtype: str, causal: bool, window: int):
    """Least time on the card: the larger of operations over the peak
    rate of the input type and bytes (q, k, v read once, O written once)
    over the memory rate."""
    flops = 4 * B * H * d * attention_pairs(T, causal, window)
    itemsize = 2 if dtype == "bfloat16" else 4
    nbytes = 4 * B * T * H * d * itemsize
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
    return cases


def phase_kernel(torch, fa, record):
    """Every case: the kernel against the plain version on the card."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for c in kernel_cases():
        B, H = (1, 32) if c["T"] == 2048 else (2, 4)
        dt = getattr(torch, c["dtype"])
        q, k, v = (torch.randn(B, c["T"], H, c["d"], device="cuda",
                               generator=gen).to(dt) for _ in range(3))
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
        err = (got[0].float() - want[0].float()).abs().max().item()
        row = dict(c, B=B, H=H, max_abs_err=err, tol=TOL_O[c["dtype"]])
        ok = err <= TOL_O[c["dtype"]]
        if c["lse"]:
            row["lse_err"] = (got[1] - want[1]).abs().max().item()
            row["lse_tol"] = TOL_LSE[c["dtype"]]
            ok = ok and row["lse_err"] <= row["lse_tol"]
        rows.append(row)
        log("kernel case", json.dumps(row))
        check(ok, f"kernel disagrees with its plain version: {row}")
    record["kernel_cases"] = rows

    # Times at the main path's shape: one llama_7b layer's attention.
    B, T, H, d = 1, 2048, 32, 128
    q, k, v = (torch.randn(B, T, H, d, device="cuda",
                           generator=gen).to(torch.bfloat16)
               for _ in range(3))
    main = [r for r in rows if r["dtype"] == "bfloat16" and r["T"] == T
            and r["d"] == d and r["window"] == 0]
    t_kernel = cuda_ms(torch, lambda: fa.flash_attention(q, k, v))
    t_plain = cuda_ms(torch, lambda: fa._reference(q, k, v, d ** -0.5, True))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    t_lib = cuda_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True))
    bound_ms, bound_by = flash_bound(B, T, H, d, "bfloat16", True, 0)
    record["flash_fwd_timing"] = dict(
        shape=[B, T, H, d], dtype="bfloat16", causal=True, ms=t_kernel,
        plain_ms=t_plain, library_ms=t_lib, bound_ms=bound_ms,
        bound_by=bound_by, max_abs_err=main[0]["max_abs_err"])
    log("flash_fwd timing", json.dumps(record["flash_fwd_timing"]))


def phase_forward_and_serve_f32(torch, port, record):
    """llama_7b widths, 2 layers, f32: flash logits against full; the
    engine token-exact against generate()."""
    llama, convert, generate, serve = port
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


def phase_main_path(torch, fa, port, record):
    """The main path at full llama_7b size in bf16: the 32-layer flash
    forward on 2048 tokens, then the engine answering 6 requests.  After
    the launch counts are read, the same forward and 8 decode dispatches
    of the same engine traffic are traced for where the time goes."""
    llama, convert, _, serve = port
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from k8s_vgpu_scheduler_tpu_torch.entry import entry
    from k8s_vgpu_scheduler_tpu_torch.models import (
        convert, generate, llama, serve)
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
    _kernels.flash_fwd()
    record["build_s"] = time.monotonic() - t0
    log(f"built flash_fwd in {record['build_s']:.1f} s")
    log(_kernels.build_logs.get("flash_fwd", "").strip())

    port = (llama, convert, generate, serve)
    try:
        forward, (model, tokens) = entry()
        logits = forward(model, tokens)
        check(logits.shape == (2, 32, 256)
              and bool(torch.isfinite(logits.float()).all()),
              "entry() logits")
        phase_kernel(torch, fa, record)
        phase_forward_and_serve_f32(torch, port, record)
        torch.cuda.empty_cache()
        launches = phase_main_path(torch, fa, port, record)
    except Fail as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        return 1

    t = record["flash_fwd_timing"]
    kernels = [{
        "name": "flash_fwd", "route": "cuda",
        "source": "k8s_vgpu_scheduler_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "k8s_vgpu_scheduler_tpu/ops/flash_attention.py:57",
        "launches": launches, "max_abs_err": t["max_abs_err"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
    }]
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
