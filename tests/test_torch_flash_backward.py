"""The port's flash-attention backward against the JAX package's.

Same inputs (numpy, seeded) through the JAX Pallas backward kernels in
interpret mode and through the port on the CPU, where the backward takes
its plain version.  The CUDA backward kernels are held to that plain
version on the card by chip_smoke.py.  Tolerances: f32 1e-5 (two f32
summation orders over T=128); bf16 2e-2 (gradients of order 1 rounded to
bf16 on both sides: one bf16 ULP).

The bf16 tensor-core kernels round P and dS to bf16 before their
products.  That arithmetic is emulated here in plain torch and held to
chip_smoke.py's own limits (``judge_backward``), which must pass it and
must catch a backward that is visibly wrong.  The layout rule the
backward wrappers share with the forward is pinned on the CPU.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from k8s_vgpu_scheduler_tpu_torch.ops import flash_attention as tfa

# The JAX package's ops/__init__ re-exports the function under the
# submodule's name; take the module itself.
jfa = importlib.import_module("k8s_vgpu_scheduler_tpu.ops.flash_attention")

# Tier-1 runs the test files in several processes at once; a few torch
# threads each keep them from crowding the cores.
torch.set_num_threads(2)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
CASES = [
    (True, 0, "float32"),
    (False, 0, "float32"),
    (True, 1, "float32"),
    (True, 16, "float32"),
    (True, 48, "float32"),
    (True, 0, "bfloat16"),
    (True, 16, "bfloat16"),
]


def arrays(B=2, T=128, H=4, d=32, seed=0, n=4):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal((B, T, H, d)).astype(np.float32)
            for _ in range(n)]


def to_jax(xs, dtype):
    return [jnp.asarray(x, dtype=getattr(jnp, dtype)) for x in xs]


def to_torch(xs, dtype, grad=False):
    return [torch.from_numpy(np.asarray(x, np.float32)).to(
        getattr(torch, dtype)).requires_grad_(grad) for x in xs]


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x.astype(jnp.float32))


def close(got, want, dtype):
    np.testing.assert_allclose(f32(got), f32(want), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("causal,window,dtype", CASES)
def test_plain_backward_matches_jax_kernels(causal, window, dtype):
    # The same O, lse and dO into both backwards: JAX's _dq_kernel and
    # _dkv_kernel (interpret mode) against the port's plain versions.
    q, k, v, g = arrays()
    B, T, H, d = q.shape
    scale = 1.0 / d ** 0.5
    jq, jk, jv, jg = to_jax((q, k, v, g), dtype)
    o, lse = jfa._flash_fwd_impl(jq, jk, jv, scale, causal, 32, 32, True,
                                 window=window, return_lse=True)
    want = jfa._flash_bwd_impl(jq, jk, jv, o, lse, jg, scale, causal, 32, 32,
                               True, window=window)
    tq, tk, tv, tg = to_torch((q, k, v, g), dtype)
    to = torch.from_numpy(np.array(f32(o))).to(tq.dtype)
    tlse = torch.from_numpy(np.array(lse).reshape(B, H, T))
    delta = tfa._delta(to, tg)
    dq = tfa.flash_bwd_dq(tq, tk, tv, tg, tlse, delta, scale, causal, window)
    dk, dv = tfa.flash_bwd_dkv(tq, tk, tv, tg, tlse, delta, scale, causal,
                               window)
    for got, w in zip((dq, dk, dv), want):
        assert got.dtype == tq.dtype and got.shape == tq.shape
        close(got, w, dtype)


@pytest.mark.parametrize("causal,window,dtype", CASES[:6])
def test_grad_matches_jax_grad(causal, window, dtype):
    # End to end: torch autograd through the port's flash_attention (its
    # autograd Function) against jax.grad through the Pallas custom VJP.
    q, k, v, g = arrays(seed=1)

    def jloss(q, k, v):
        o = jfa.flash_attention(q, k, v, causal=causal, window=window,
                                block_q=32, block_k=32)
        return jnp.sum(o.astype(jnp.float32) * jg.astype(jnp.float32))

    jq, jk, jv, jg = to_jax((q, k, v, g), dtype)
    want = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = to_torch((q, k, v), dtype, grad=True)
    out = tfa.flash_attention(tq, tk, tv, causal=causal, window=window,
                              block_q=32, block_k=32)
    got = torch.autograd.grad(out, (tq, tk, tv), to_torch([g], dtype)[0])
    for a, w in zip(got, want):
        close(a, w, dtype)


@pytest.mark.parametrize("window", [0, 16])
def test_ragged_length_matches_reference_grad(window):
    # T=100 tiles no block: JAX differentiates its plain reference, the
    # port runs its backward (on the card, the kernels, which mask the
    # tail).
    q, k, v, g = arrays(T=100, seed=2)

    def jloss(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, causal=True,
                                           window=window) * jg)

    jq, jk, jv, jg = to_jax((q, k, v, g), "float32")
    want = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = to_torch((q, k, v), "float32", grad=True)
    out = tfa.flash_attention(tq, tk, tv, causal=True, window=window)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    for a, w in zip(got, want):
        close(a, w, "float32")


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 1),
                                           (True, 5)])
def test_function_backward_matches_autograd_of_plain_forward(causal, window):
    q, k, v, g = arrays(T=24, H=3, d=16, seed=3)
    tq, tk, tv = to_torch((q, k, v), "float32", grad=True)
    do = torch.from_numpy(g)
    out = tfa.flash_attention(tq, tk, tv, causal=causal, window=window)
    got = torch.autograd.grad(out, (tq, tk, tv), do)
    ref = tfa._reference(tq, tk, tv, 16 ** -0.5, causal, window)
    want = torch.autograd.grad(ref, (tq, tk, tv), do)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), w.numpy(), atol=1e-5,
                                   rtol=1e-5)


def test_delta_reads_the_stored_output():
    # Δ comes from O as stored: in bf16 the rounded O, as JAX's
    # g.astype(f32) * o.astype(f32).
    o, g = to_torch(arrays(T=16, n=2, seed=4), "bfloat16")
    want = (g.float() * o.float()).sum(-1).transpose(1, 2)
    got = tfa._delta(o, g)
    assert got.dtype == torch.float32 and got.is_contiguous()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_lse_output_is_not_differentiable():
    q, k, v = to_torch(arrays(T=16, n=3, seed=5), "float32", grad=True)
    out, lse = tfa.flash_attention(q, k, v, return_lse=True)
    assert out.requires_grad and not lse.requires_grad


# chip_smoke.py's bf16 cases that are small enough for the CPU (B=2, H=4
# as there): T 128 and ragged 200, d 16 to 128, causal, window 48 and not
# causal.
BF16_CASES = [c for c in chip_smoke.kernel_cases()
              if c["dtype"] == "bfloat16" and c["T"] <= 200
              and c.get("layout", "contiguous") == "contiguous"]
BF16_IDS = [f"d{c['d']}-T{c['T']}-w{c['window']}-"
            f"{'causal' if c['causal'] else 'full'}" for c in BF16_CASES]


def backward_args(c, seed=0):
    """The backward's inputs for case ``c``: bf16 q, k, v, dO from numpy,
    lse and Δ from the plain forward."""
    q, k, v, do = to_torch(arrays(B=2, T=c["T"], H=4, d=c["d"], seed=seed),
                           "bfloat16")
    scale = c["d"] ** -0.5
    o, lse = tfa._reference(q, k, v, scale, c["causal"], c["window"],
                            return_lse=True)
    return (q, k, v, do, lse, tfa._delta(o, do), scale, c["causal"],
            c["window"])


def tensor_core_backward(args, fault=None):
    """The bf16 tensor-core kernels' arithmetic in plain torch: f32 P and
    dS (the port's _recompute), rounded to bf16 before Pᵀ dO, dS K and
    dSᵀ Q, which multiply bf16 operands in f32; sm_scale applied once at
    the end; outputs rounded to bf16.  ``fault`` makes it visibly wrong:
    ``drop_tile`` loses keys 64-127, ``scale_twice`` scales dQ and dK
    twice."""
    q, k, v, do, lse, delta, scale, causal, window = args
    _, p, ds = tfa._recompute(*args)
    p, ds = p.bfloat16().float(), ds.bfloat16().float()
    if fault == "drop_tile":
        p[..., 64:128] = 0
        ds[..., 64:128] = 0
    dq = torch.einsum("bhts,bshd->bthd", ds, k.float()) * scale
    dk = torch.einsum("bhts,bthd->bshd", ds, q.float()) * scale
    dv = torch.einsum("bhts,bthd->bshd", p, do.float())
    if fault == "scale_twice":
        dq, dk = dq * scale, dk * scale
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


def plain_backward(args):
    return (tfa._dq_reference(*args),) + tfa._dkv_reference(*args)


@pytest.mark.parametrize("c", BF16_CASES, ids=BF16_IDS)
def test_tensor_core_rounding_within_derived_limits(c):
    args = backward_args(c)
    ok, errors = chip_smoke.judge_backward(
        torch, tfa, args, tensor_core_backward(args), plain_backward(args))
    assert ok, errors
    for e in errors.values():
        # The rounding is visible, and the derived max limit sits above it
        # with room: it is not a limit that nothing could exceed.
        assert 1e-3 < e["rel_max_err"] < e["tol_rel_max"] < 2.5e-2


@pytest.mark.parametrize("fault", ["drop_tile", "scale_twice"])
@pytest.mark.parametrize("c", BF16_CASES[:4], ids=BF16_IDS[:4])
def test_derived_limits_catch_a_wrong_backward(c, fault):
    args = backward_args(c, seed=1)
    ok, errors = chip_smoke.judge_backward(
        torch, tfa, args, tensor_core_backward(args, fault),
        plain_backward(args))
    assert not ok
    # Every output the fault touches breaks its max or RMS limit.
    touched = ("dq", "dk", "dv") if fault == "drop_tile" else ("dq", "dk")
    for name in touched:
        e = errors[name]
        assert (e["rel_max_err"] > e["tol_rel_max"]
                or e["rel_rms_err"] > e["tol_rel_rms"]), (name, e)


def bad_layouts(dtype=torch.bfloat16):
    """(2, 16, 4, 16) operands the tensor-core kernels cannot copy 16 bytes
    at a time: 2 bytes off alignment, and an odd token stride."""
    flat = torch.randn(2 * 16 * 4 * 16 + 1).to(dtype)
    wide = torch.randn(2, 16, 4 * 16 + 1).to(dtype)
    return {"misaligned": flat[1:].view(2, 16, 4, 16),
            "odd_token_stride": wide[:, :, :64].unflatten(-1, (4, 16))}


@pytest.mark.parametrize("operand", [0, 3], ids=["q", "do"])
@pytest.mark.parametrize("layout", ["misaligned", "odd_token_stride"])
@pytest.mark.parametrize("launch", ["_launch_dq", "_launch_dkv"])
def test_backward_wrappers_refuse_bf16_layouts(launch, layout, operand,
                                               monkeypatch):
    def refuse():
        raise AssertionError("refused before any build or launch")

    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        monkeypatch.setattr(tfa._kernels, name, refuse)
    args = list(backward_args(dict(T=16, d=16, causal=True, window=0)))
    args[operand] = bad_layouts()[layout]
    with pytest.raises(ValueError, match="aligned|strides"):
        getattr(tfa, launch)(*args)


@pytest.mark.parametrize("layout", ["misaligned", "odd_token_stride"])
def test_f32_operands_of_any_layout_pass_the_check(layout):
    x = bad_layouts(torch.float32)[layout]
    y = torch.zeros(2, 16, 4, 16)
    tfa._check(x, k=y, v=y, do=x)
    tfa._check(y, k=x, v=x, do=y)


@pytest.mark.parametrize("layout", ["misaligned", "odd_token_stride"])
def test_backward_copies_a_bf16_grad_it_cannot_read(layout, monkeypatch):
    # A dO that breaks the 16-byte rule is copied into a contiguous
    # tensor: the gradients are those of the same values laid out densely.
    seen = []
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        def spy(q, k, v, do, *rest, _f=getattr(tfa, name)):
            seen.append(tfa._cp_async_fault(do))
            return _f(q, k, v, do, *rest)
        monkeypatch.setattr(tfa, name, spy)
    q, k, v = to_torch(arrays(T=16, H=4, d=16, n=3, seed=6), "bfloat16",
                       grad=True)
    bad = bad_layouts()[layout]
    assert tfa._cp_async_fault(bad)
    out = tfa.flash_attention(q, k, v)
    got = torch.autograd.grad(out, (q, k, v), bad, retain_graph=True)
    assert seen == [None, None]
    want = torch.autograd.grad(out, (q, k, v), bad.contiguous().clone())
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=0, atol=0)
