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


# ---------------------------------------------------------------------------
# Speculative decoding: the cases of the JAX package's TestSpeculative, each
# run through both packages on the same Flax weights in f32.
# ---------------------------------------------------------------------------

SPEC_CFG = dict(vocab=256, dim=128, n_layers=2, n_heads=8, n_kv_heads=4,
                ffn_hidden=256, dtype="float32")
SPEC_DRAFT = dict(SPEC_CFG, dim=32, n_layers=1, n_heads=2, n_kv_heads=2,
                  ffn_hidden=64)


@pytest.fixture(scope="module")
def spec():
    """The JAX test's setup: llama_tiny in f32, an untrained 1-layer draft
    of other widths (low acceptance: the hardest case for the rollback),
    and a 5-token prompt; the port's models from the same trees."""
    jcfg = jllama.LlamaConfig(**SPEC_CFG)
    jdraft = jllama.LlamaConfig(**SPEC_DRAFT)
    prompt = jax.random.randint(jax.random.PRNGKey(1), (1, 5), 0, jcfg.vocab)
    params = jllama.Llama(jcfg).init(jax.random.PRNGKey(0), prompt)
    dparams = jllama.Llama(jdraft).init(jax.random.PRNGKey(9), prompt)
    target = from_flax(jax.tree.map(np.asarray, params),
                       tllama.LlamaConfig(**SPEC_CFG), device="cpu")
    draft = from_flax(jax.tree.map(np.asarray, dparams),
                      tllama.LlamaConfig(**SPEC_DRAFT), device="cpu")
    return dict(jcfg=jcfg, jdraft=jdraft, params=params, dparams=dparams,
                prompt=prompt, target=target, draft=draft,
                tprompt=torch.from_numpy(np.array(prompt)))


def both(spec, n, k, self_draft=False):
    """(port tokens, port stats, JAX tokens, JAX stats, JAX generate,
    port generate) for one case."""
    s = spec
    jd, jdp = ((s["jcfg"], s["params"]) if self_draft
               else (s["jdraft"], s["dparams"]))
    jtok, jstats = jgen.speculative_generate(
        s["jcfg"], s["params"], jd, jdp, s["prompt"], n, k=k)
    ttok, tstats = tgen.speculative_generate(
        s["target"], s["target"] if self_draft else s["draft"],
        s["tprompt"], n, k=k)
    want = np.asarray(jgen.generate(s["jcfg"], s["params"], s["prompt"], n))
    plain = tgen.generate(s["target"], s["tprompt"], n).numpy()
    return (ttok.numpy(), tstats, np.asarray(jtok),
            {key: int(v) for key, v in jstats.items()}, want, plain)


def check_identical(got, stats, jtok, jstats, want, plain):
    np.testing.assert_array_equal(got, jtok)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(plain, want)
    assert stats == jstats
    assert all(type(v) is int for v in stats.values())


def test_speculative_random_draft_token_identical_to_greedy(spec):
    out = both(spec, 12, 3)
    check_identical(*out)
    stats = out[1]
    assert stats["target_forwards"] >= 1
    assert stats["accepted"] <= stats["drafted"]


def test_speculative_self_draft_high_acceptance_few_forwards(spec):
    """draft == target: the JAX test's bounds on rounds and acceptance."""
    n, k = 12, 3
    out = both(spec, n, k, self_draft=True)
    check_identical(*out)
    stats = out[1]
    assert -(-(n - 1) // (k + 1)) <= stats["target_forwards"] < n - 1
    assert stats["accepted"] >= stats["drafted"] * 2 // 3


@pytest.mark.parametrize("k,n", [(1, 7), (2, 2), (5, 3), (3, 1)])
def test_speculative_edge_shapes_token_identical(spec, k, n):
    """k = 1, n <= k (the verify overshoots the budget), n = 1 (the
    prefill's token alone)."""
    check_identical(*both(spec, n, k))


def test_speculative_contract(spec):
    target, draft = spec["target"], spec["draft"]
    with pytest.raises(ValueError, match="one sequence"):
        tgen.speculative_generate(target, draft,
                                  torch.ones((2, 4), dtype=torch.long), 4)
    tokens, stats = tgen.speculative_generate(target, draft,
                                              spec["tprompt"], 0)
    assert torch.equal(tokens, spec["tprompt"])
    assert stats == {"target_forwards": 0, "drafted": 0, "accepted": 0}


def test_early_exit_draft_is_bench_graft(spec):
    """bench.py's early-exit draft (every draft leaf whose path and shape
    exist in the target takes the target's weights) against the port's
    ``early_exit_draft``: the same logits, the draft's tensors the
    target's own, and the same speculative tokens and stats as JAX's run
    on the grafted tree."""
    import dataclasses

    from k8s_vgpu_scheduler_tpu_torch.models.convert import early_exit_draft

    s = spec
    jdraft = dataclasses.replace(s["jcfg"], n_layers=1)
    draft0 = jllama.Llama(jdraft).init(jax.random.PRNGKey(2), s["prompt"])
    by_path = {jax.tree_util.keystr(p): x for p, x in
               jax.tree_util.tree_flatten_with_path(s["params"])[0]}

    def graft(path, x):
        t = by_path.get(jax.tree_util.keystr(path))
        return t if t is not None and t.shape == x.shape else x

    grafted = jax.tree_util.tree_map_with_path(graft, draft0)
    draft = early_exit_draft(s["target"], 1)
    assert draft.cfg.n_layers == 1 and len(draft.layers) == 1
    assert draft.embed.weight is s["target"].embed.weight
    assert draft.layers[0] is s["target"].layers[0]
    assert draft.lm_head.weight is s["target"].lm_head.weight
    with pytest.raises(ValueError):
        early_exit_draft(s["target"], 3)
    want = np.asarray(jllama.Llama(jdraft).apply(grafted, s["prompt"]))
    with torch.inference_mode():
        got = draft(s["tprompt"]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    n, k = 12, 3
    jtok, jstats = jgen.speculative_generate(
        s["jcfg"], s["params"], jdraft, grafted, s["prompt"], n, k=k)
    ttok, tstats = tgen.speculative_generate(s["target"], draft,
                                             s["tprompt"], n, k=k)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    assert tstats == {key: int(v) for key, v in jstats.items()}
