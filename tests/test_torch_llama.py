"""The port's Llama against the JAX package's, on llama_tiny in f32.

Weights come from the Flax init through ``from_flax``; tokens from a
numpy seed.  Logits are held to 1e-4 (f32 through two layers: matmul and
softmax orders differ between XLA and PyTorch at ~1e-6).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_vgpu_scheduler_tpu.models import llama as jllama
from k8s_vgpu_scheduler_tpu_torch.entry import entry
from k8s_vgpu_scheduler_tpu_torch.models import llama as tllama
from k8s_vgpu_scheduler_tpu_torch.models.convert import (
    from_flax, init_weights)

TOL = 1e-4


def cfg_pair(**kw):
    base = dict(vocab=256, dim=128, n_layers=2, n_heads=8, n_kv_heads=4,
                ffn_hidden=256, dtype="float32")
    base.update(kw)
    return jllama.LlamaConfig(**base), tllama.LlamaConfig(**base)


@pytest.fixture(scope="module")
def params():
    jcfg, _ = cfg_pair()
    p = jllama.Llama(jcfg).init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 8), jnp.int32))
    return jax.tree.map(np.asarray, p)


def tokens(B=2, T=32, seed=0):
    return np.random.RandomState(seed).randint(0, 256, size=(B, T))


def test_config_matches_reference():
    for name in ("llama_7b", "llama_tiny"):
        want = dataclasses.asdict(getattr(jllama, name)())
        got = dataclasses.asdict(getattr(tllama, name)())
        assert got == want
    assert tllama.llama_7b().head_dim == 128
    assert tllama.llama_tiny().head_dim == 16
    assert tllama.PAD_POSITION == jllama.PAD_POSITION


@pytest.mark.parametrize("attention,window", [("full", 0), ("flash", 0),
                                              ("flash", 8)])
def test_forward_logits_match(params, attention, window):
    jcfg, tcfg = cfg_pair(attention=attention, attention_window=window)
    toks = tokens()
    want = jllama.Llama(jcfg).apply(params, jnp.asarray(toks, jnp.int32))
    model = from_flax(params, tcfg, device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_decode_prefill_then_step_match(params):
    P, L = 24, 32
    jcfg, tcfg = cfg_pair(decode_cache_len=L)
    toks = tokens()
    B = toks.shape[0]
    pos = np.tile(np.arange(P), (B, 1))
    key_pos = np.full((B, L), jllama.PAD_POSITION, np.int64)
    key_pos[:, :P] = pos
    jm = jllama.Llama(jcfg, decode=True)
    want1, st = jm.apply(params, jnp.asarray(toks[:, :P]), jnp.asarray(pos),
                         jnp.asarray(key_pos), mutable=["cache"])
    key_pos[:, P] = P
    step_pos = np.full((B, 1), P)
    want2, _ = jm.apply({"params": params["params"], "cache": st["cache"]},
                        jnp.asarray(toks[:, P:P + 1]), jnp.asarray(step_pos),
                        jnp.asarray(key_pos), mutable=["cache"])

    model = from_flax(params, tcfg, device="cpu")
    cache = model.new_cache(B, L)
    kp = torch.from_numpy(key_pos)
    kp[:, P] = tllama.PAD_POSITION
    with torch.no_grad():
        got1 = model(torch.from_numpy(toks[:, :P]), torch.from_numpy(pos),
                     kp, cache=cache)
        kp[:, P] = P
        got2 = model(torch.from_numpy(toks[:, P:P + 1]),
                     torch.from_numpy(step_pos), kp, cache=cache)
    assert cache[0].idx == P + 1
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), atol=TOL,
                               rtol=TOL)


def test_decode_per_row_write_index(params):
    # Continuous batching: each row writes at its own index.
    L = 16
    jcfg, tcfg = cfg_pair(decode_cache_len=L)
    rng = np.random.RandomState(5)
    B = 3
    wi = np.array([0, 4, 9])
    toks = rng.randint(0, 256, size=(B, 1))
    pos = wi[:, None]
    key_pos = np.full((B, L), jllama.PAD_POSITION, np.int64)
    for b in range(B):
        key_pos[b, :wi[b] + 1] = np.arange(wi[b] + 1)
    jm = jllama.Llama(jcfg, decode=True)
    kv = (B, L, jcfg.n_kv_heads, jcfg.head_dim)
    cache_np = {f"layer_{i}": {"attn": {
        "k": rng.standard_normal(kv).astype(np.float32),
        "v": rng.standard_normal(kv).astype(np.float32),
        "idx": np.zeros((), np.int32)}} for i in range(jcfg.n_layers)}
    want, st = jm.apply({"params": params["params"],
                         "cache": jax.tree.map(jnp.asarray, cache_np)},
                        jnp.asarray(toks), jnp.asarray(pos),
                        jnp.asarray(key_pos), jnp.asarray(wi),
                        mutable=["cache"])
    model = from_flax(params, tcfg, device="cpu")
    cache = [tllama.LayerCache(torch.from_numpy(c["attn"]["k"].copy()),
                               torch.from_numpy(c["attn"]["v"].copy()))
             for c in cache_np.values()]
    with torch.no_grad():
        got = model(torch.from_numpy(toks), torch.from_numpy(pos),
                    torch.from_numpy(key_pos), torch.from_numpy(wi),
                    cache=cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(
        cache[1].k.numpy(), np.asarray(st["cache"]["layer_1"]["attn"]["k"]),
        atol=TOL, rtol=TOL)


def test_rope_and_rmsnorm_match():
    rng = np.random.RandomState(3)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    pos = rng.randint(0, 100, size=(2, 5))
    want = jllama._rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = tllama._rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    h = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    want = jllama.RMSNorm(1e-5).apply({"params": {"scale": scale}},
                                      jnp.asarray(h, jnp.bfloat16))
    norm = tllama.RMSNorm(64, 1e-5, "cpu")
    with torch.no_grad():
        norm.scale.copy_(torch.from_numpy(scale))
        got = norm(torch.from_numpy(h).bfloat16())
    assert got.dtype == torch.bfloat16 and norm.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_from_flax_layout(params):
    _, tcfg = cfg_pair()
    model = from_flax(params, tcfg, device="cpu")
    q = params["params"]["layer_1"]["attn"]["q_proj"]["kernel"]
    got = model.layers[1].attn.q_proj.weight.detach().numpy()
    np.testing.assert_array_equal(got, q.T)
    bf = from_flax(params, dataclasses.replace(tcfg, dtype="bfloat16"),
                   device="cpu")
    assert bf.lm_head.weight.dtype == torch.bfloat16
    assert bf.final_norm.scale.dtype == torch.float32


def test_init_weights_scales_match_flax(params):
    _, tcfg = cfg_pair()
    model = init_weights(tcfg, torch.Generator().manual_seed(0),
                         device="cpu")
    p = params["params"]
    pairs = [(model.embed.weight, p["embed"]["embedding"]),
             (model.layers[0].mlp.down_proj.weight,
              p["layer_0"]["mlp"]["down_proj"]["kernel"]),
             (model.lm_head.weight, p["lm_head"]["kernel"])]
    for got, want in pairs:
        assert got.std().item() == pytest.approx(float(want.std()), rel=0.05)
    # Dense kernels are truncated at two (pre-divided) standard deviations.
    for lin in (model.lm_head, model.layers[0].mlp.down_proj):
        bound = 2 * (1.0 / lin.weight.shape[1]) ** 0.5 / 0.87962566103423978
        assert lin.weight.abs().max().item() <= bound * (1 + 1e-6)
    assert all(torch.all(n.scale == 1) for n in
               (model.final_norm, model.layers[0].attn_norm))


def test_entry_on_cpu():
    forward, (model, toks) = entry(device="cpu")
    logits = forward(model, toks)
    assert logits.shape == (2, 32, 256) and logits.dtype == torch.bfloat16
    assert torch.isfinite(logits.float()).all()


# Quantization is ported (tests/test_torch_quant.py); a quantized MoE is
# not, with MoE itself.
@pytest.mark.parametrize("kw", [{"quant": "int8", "n_experts": 2},
                                {"n_experts": 2},
                                {"attention": "ring"},
                                {"attention": "ulysses"}])
def test_later_slices_raise(kw):
    _, tcfg = cfg_pair(**kw)
    with pytest.raises(NotImplementedError):
        tllama.Llama(tcfg, device="cpu")
