"""The port's flash-attention op against the JAX package's.

Same inputs (numpy, seeded) through the JAX Pallas kernel in interpret
mode and through the port on the CPU, where it takes its plain version.
The CUDA kernel itself is held to that plain version on the card by
chip_smoke.py.  Tolerances: f32 1e-5 (two f32 softmax orders); bf16 2e-2
(one bf16 ULP of outputs of order 1).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_vgpu_scheduler_tpu.parallel import ring as jring
from k8s_vgpu_scheduler_tpu_torch.ops import flash_attention as tfa
from k8s_vgpu_scheduler_tpu_torch.parallel import ring as tring

# The JAX package's ops/__init__ re-exports the function under the
# submodule's name; take the module itself.
jfa = importlib.import_module("k8s_vgpu_scheduler_tpu.ops.flash_attention")

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def qkv(B=2, T=128, H=4, d=32, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal((B, T, H, d)).astype(np.float32)
            for _ in range(3)]


def to_jax(xs, dtype):
    return [jnp.asarray(x, dtype=getattr(jnp, dtype)) for x in xs]


def to_torch(xs, dtype):
    return [torch.from_numpy(x).to(getattr(torch, dtype)) for x in xs]


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("causal,window,dtype", [
    (True, 0, "float32"),
    (False, 0, "float32"),
    (True, 1, "float32"),
    (True, 16, "float32"),
    (True, 48, "float32"),
    (True, 0, "bfloat16"),
    (True, 16, "bfloat16"),
])
def test_matches_jax_kernel(causal, window, dtype):
    xs = qkv()
    want = jfa.flash_attention(*to_jax(xs, dtype), causal=causal,
                               window=window, block_q=32, block_k=32)
    got = tfa.flash_attention(*to_torch(xs, dtype), causal=causal,
                              window=window, block_q=32, block_k=32)
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == want.shape
    np.testing.assert_allclose(f32(got), f32(want), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("window", [0, 16])
def test_ragged_length(window):
    # T=100 tiles no block: JAX routes it to its plain reference, the port
    # (on the card) to the same kernel, which masks the tail.
    xs = qkv(T=100, seed=1)
    want = jfa.flash_attention(*to_jax(xs, "float32"), causal=True,
                               window=window)
    got = tfa.flash_attention(*to_torch(xs, "float32"), causal=True,
                              window=window)
    np.testing.assert_allclose(f32(got), f32(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("window,dtype", [(0, "float32"), (16, "float32"),
                                          (0, "bfloat16")])
def test_logsumexp_matches_kernel(window, dtype):
    xs = qkv(seed=2)
    B, T, H, d = xs[0].shape
    want_o, want_lse = jfa._flash_fwd_impl(
        *to_jax(xs, dtype), 1.0 / d ** 0.5, True, 32, 32, True,
        window=window, return_lse=True)
    got_o, got_lse = tfa.flash_attention(*to_torch(xs, dtype), causal=True,
                                         window=window, return_lse=True)
    assert got_lse.dtype == torch.float32 and got_lse.shape == (B, H, T)
    np.testing.assert_allclose(got_lse.numpy(),
                               np.asarray(want_lse).reshape(B, H, T),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(f32(got_o), f32(want_o), atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_window_without_causal_raises():
    xs = qkv(T=32)
    with pytest.raises(ValueError):
        jfa.flash_attention(*to_jax(xs, "float32"), causal=False, window=4)
    with pytest.raises(ValueError):
        tfa.flash_attention(*to_torch(xs, "float32"), causal=False,
                            window=4)


def test_blocks_clamped_and_scale_default():
    xs = qkv(T=64, seed=3)
    want = jfa._reference(*to_jax(xs, "float32"), 0.25, True)
    got = tfa.flash_attention(*to_torch(xs, "float32"), sm_scale=0.25,
                              block_q=512, block_k=1024)
    np.testing.assert_allclose(f32(got), f32(want), atol=1e-5, rtol=1e-5)
    default = tfa.flash_attention(*to_torch(xs, "float32"))
    explicit = tfa.flash_attention(*to_torch(xs, "float32"),
                                   sm_scale=1.0 / 32 ** 0.5)
    torch.testing.assert_close(default, explicit, rtol=0, atol=0)


def test_cpu_path_launches_nothing(monkeypatch):
    def refuse():
        raise AssertionError("the CPU path must not build or launch")

    monkeypatch.setattr(tfa._kernels, "flash_fwd", refuse)
    before = tfa.flash_attention.launches
    tfa.flash_attention(*to_torch(qkv(T=16), "float32"))
    assert tfa.flash_attention.launches == before


def test_bf16_operands_must_suit_cp_async():
    # The tensor-core kernels copy 16-byte chunks: bf16 data 16-byte
    # aligned, batch/token/head strides multiples of 8 elements.
    q, k, v = to_torch(qkv(T=16, d=16), "bfloat16")
    tfa._check(q, k=k, v=v)  # the contiguous layout passes
    wide = torch.zeros(2, 16, 4, 24, dtype=torch.bfloat16)
    tfa._check(wide[..., :16], k=k, v=v)  # 1536, 96, 24
    odd = torch.zeros(2, 16, 4 * 16 + 1, dtype=torch.bfloat16)
    sliced = odd[:, :, :64].unflatten(-1, (4, 16))  # token stride 65
    with pytest.raises(ValueError, match="strides"):
        tfa._check(sliced, k=k, v=v)
    with pytest.raises(ValueError, match="strides"):
        tfa._check(q, k=k, v=sliced)
    flat = torch.zeros(2 * 16 * 4 * 16 + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(2, 16, 4, 16)  # 2 bytes off the allocation
    with pytest.raises(ValueError, match="aligned"):
        tfa._check(shifted, k=k, v=v)
    # Every wrapper asks for the rule: the forward and both backward
    # kernels run bf16 on the tensor cores.  The f32 scalar kernels take
    # any layout with a contiguous head dimension.
    with pytest.raises(ValueError, match="aligned"):
        tfa._launch(shifted, k, v, 0.25, True, 0, False)
    with pytest.raises(ValueError, match="aligned"):
        tfa._check(shifted, k=sliced, v=v, do=q)
    odd32 = torch.zeros(2 * 16 * 65 + 1)[1:].view(2, 16, 65)
    tfa._check(odd32[:, :, :64].unflatten(-1, (4, 16)), k=k.float(),
               v=v.float())


def test_other_devices_raise():
    q = torch.empty((1, 8, 2, 16), device="meta")
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q, q)


@pytest.mark.parametrize("causal,dtype", [(True, "float32"),
                                          (False, "float32"),
                                          (True, "bfloat16")])
def test_full_attention_reference_matches(causal, dtype):
    xs = qkv(T=48, seed=4)
    want = jring.full_attention_reference(*to_jax(xs, dtype), causal=causal)
    got = tring.full_attention_reference(*to_torch(xs, dtype), causal=causal)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(f32(got), f32(want), atol=TOL[dtype],
                               rtol=TOL[dtype])
