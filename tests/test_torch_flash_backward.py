"""The port's flash-attention backward against the JAX package's.

Same inputs (numpy, seeded) through the JAX Pallas backward kernels in
interpret mode and through the port on the CPU, where the backward takes
its plain version.  The CUDA backward kernels are held to that plain
version on the card by chip_smoke.py.  Tolerances: f32 1e-5 (two f32
summation orders over T=128); bf16 2e-2 (gradients of order 1 rounded to
bf16 on both sides: one bf16 ULP).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
