"""The port's generate() against the JAX package's, in f32.

Greedy decoding must be token-exact (f32 leaves no near-ties that a
~1e-6 logit difference could flip).  Sampling cannot share a random
stream between jax.random and torch.Generator, so the truncation masks
are compared: the support of the JAX sampler's draws against the port's
kept set.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_vgpu_scheduler_tpu.models import generate as jgen
from k8s_vgpu_scheduler_tpu.models import llama as jllama
from k8s_vgpu_scheduler_tpu_torch.models import generate as tgen
from k8s_vgpu_scheduler_tpu_torch.models import llama as tllama
from k8s_vgpu_scheduler_tpu_torch.models.convert import from_flax

CFG = dict(vocab=64, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
           ffn_hidden=128, dtype="float32")


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig(**CFG)
    params = jllama.Llama(jcfg).init(jax.random.PRNGKey(0),
                                     jnp.zeros((1, 8), jnp.int32))
    model = from_flax(jax.tree.map(np.asarray, params),
                      tllama.LlamaConfig(**CFG), device="cpu")
    return jcfg, params, model


def prompts(B=2, P=10, seed=0):
    return np.random.RandomState(seed).randint(1, 64, size=(B, P))


@pytest.mark.parametrize("case", ["plain", "left_pad", "chunked",
                                  "left_pad_chunked"])
def test_greedy_token_exact(models, case):
    jcfg, params, model = models
    prompt = prompts()
    lens = (np.array([10, 6]) if "left_pad" in case else None)
    chunk = 5 if "chunked" in case else None
    if lens is not None:
        prompt[1, :4] = 0  # left padding
    n = 8
    want = jgen.jit_generate(jcfg, n, prefill_chunk=chunk)(
        params, jnp.asarray(prompt, jnp.int32), None,
        None if lens is None else jnp.asarray(lens, jnp.int32))
    got = tgen.generate(model, torch.from_numpy(prompt), n,
                        prompt_lens=None if lens is None
                        else torch.from_numpy(lens),
                        prefill_chunk=chunk)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_zero_new_tokens_and_rng_contract(models):
    _, _, model = models
    prompt = torch.from_numpy(prompts())
    assert torch.equal(tgen.generate(model, prompt, 0), prompt)
    with pytest.raises(ValueError):
        tgen.generate(model, prompt, 4, temperature=0.7)


@pytest.mark.parametrize("top_k,top_p", [(5, 0.0), (0, 0.7), (4, 0.6),
                                         (3, 0.95)])
def test_sampling_masks_match(top_k, top_p):
    temperature = 1.5
    logits = np.random.RandomState(1).standard_normal((4, 12)).astype(
        np.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), 3000)
    draws = np.asarray(jax.vmap(lambda k: jgen._sample(
        jnp.asarray(logits), temperature, k, top_k=top_k, top_p=top_p))(keys))
    kept = torch.isfinite(tgen._truncate_logits(
        torch.from_numpy(logits), temperature, top_k, top_p)).numpy()
    for row in range(logits.shape[0]):
        assert set(np.unique(draws[:, row])) == set(np.flatnonzero(kept[row]))
    g = torch.Generator().manual_seed(0)
    for _ in range(20):
        tok = tgen._sample(torch.from_numpy(logits), temperature, g,
                           top_k=top_k, top_p=top_p)
        assert kept[np.arange(4), tok.numpy()].all()


def test_greedy_sample_is_argmax():
    logits = np.random.RandomState(2).standard_normal((3, 50)).astype(
        np.float32)
    want = np.asarray(jgen._sample(jnp.asarray(logits), 0.0, None))
    got = tgen._sample(torch.from_numpy(logits), 0.0, None)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampled_generate_is_seeded(models):
    _, _, model = models
    prompt = torch.from_numpy(prompts())
    a = tgen.generate(model, prompt, 6, temperature=0.8, top_k=8,
                      generator=torch.Generator().manual_seed(3))
    b = tgen.generate(model, prompt, 6, temperature=0.8, top_k=8,
                      generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and a.shape == (2, 16)
