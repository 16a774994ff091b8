"""The port's ServingEngine against the JAX package's, in f32.

Config as tests/test_serve.py: f32 so that the engine (pool-shaped
batches) and generate() (one request) cannot flip a greedy near-tie.
Completions must be token-exact against the JAX engine and against the
port's own generate(), through slot reuse, horizon > 1 and EOS.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_vgpu_scheduler_tpu.models import llama as jllama
from k8s_vgpu_scheduler_tpu.models import serve as jserve
from k8s_vgpu_scheduler_tpu_torch.models import llama as tllama
from k8s_vgpu_scheduler_tpu_torch.models import serve as tserve
from k8s_vgpu_scheduler_tpu_torch.models.convert import from_flax
from k8s_vgpu_scheduler_tpu_torch.models.generate import generate

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


def oracle(model, prompt, n):
    out = generate(model, torch.tensor([prompt]), n)
    return out[0, len(prompt):].tolist()


def run_both(models, reqs, **kw):
    jcfg, params, model = models
    jeng = jserve.ServingEngine(jcfg, params, **kw)
    teng = tserve.ServingEngine(model, **kw)
    for p, n in reqs:
        assert jeng.submit(p, n) == teng.submit(p, n)
    want = {c.request_id: c for c in jeng.run()}
    got = {c.request_id: c for c in teng.run()}
    assert got.keys() == want.keys()
    for rid in want:
        assert got[rid].tokens == want[rid].tokens, f"request {rid}"
        assert got[rid].finished_by == want[rid].finished_by
    return teng, got


@pytest.mark.parametrize("max_slots,horizon", [(2, 1), (2, 3)])
def test_engine_matches_jax_engine_and_generate(models, max_slots, horizon):
    rng = np.random.RandomState(7)
    reqs = [(list(rng.randint(1, 64, size=plen)), n)
            for plen, n in [(3, 6), (9, 4), (5, 8), (12, 3), (7, 5)]]
    eng, got = run_both(models, reqs, max_slots=max_slots, max_len=32,
                        horizon=horizon)
    model = models[2]
    for rid, (p, n) in enumerate(reqs):
        assert got[rid].prompt == p
        assert got[rid].tokens == oracle(model, p, n)
    assert eng.stats["completions"] == 5 and eng.stats["prefills"] == 5
    assert eng.stats["tokens_out"] == sum(n for _, n in reqs)


def test_slot_reuse_has_no_stale_leak(models):
    a = list(np.random.RandomState(0).randint(1, 64, size=20))  # long
    b = [5, 6, 7]                                               # short
    _, got = run_both(models, [(a, 4), (b, 10)], max_slots=1, max_len=32)
    assert got[1].tokens == oracle(models[2], b, 10)


def test_eos_mid_horizon(models):
    p1, p2 = [3, 1, 4, 1, 5], [2, 7, 1]
    full = oracle(models[2], p2, 9)
    eos = full[2]
    _, got = run_both(models, [(p1, 7), (p2, 9)], max_slots=2, max_len=32,
                      horizon=4, eos_id=eos)
    assert got[1].finished_by == "eos"
    assert got[1].tokens == full[:full.index(eos) + 1]


def test_capacity_and_intake_match(models):
    jcfg, params, model = models
    jeng = jserve.ServingEngine(jcfg, params, max_slots=3, max_len=48)
    teng = tserve.ServingEngine(model, max_slots=3, max_len=48)
    assert teng.pool_hbm_bytes() == jeng.pool_hbm_bytes()
    assert [teng._bucket(n) for n in (1, 8, 9, 30, 47)] == \
        [jeng._bucket(n) for n in (1, 8, 9, 30, 47)]
    for bad in (([], 3), ([1, 2], 0), ([1] * 40, 9)):
        with pytest.raises(ValueError):
            teng.validate_request(*bad)
    assert tserve.nearest_rank([5, 1, 3, 2, 4], 0.5) == \
        jserve.nearest_rank([5, 1, 3, 2, 4], 0.5)


def test_cancel_and_latency(models):
    model = models[2]
    eng = tserve.ServingEngine(model, max_slots=1, max_len=32)
    assert eng.latency_percentiles() == {}
    a = eng.submit([1, 2, 3], 6)
    b = eng.submit([4, 5], 6)
    c = eng.submit([6], 3)
    eng.step()                       # a admitted and decoding
    assert eng.cancel(b)             # queued
    assert eng.cancel(a)             # mid-decode: frees the slot
    assert not eng.cancel(a)
    done = eng.run()
    assert [x.request_id for x in done] == [c]
    assert done[0].tokens == oracle(model, [6], 3)
    assert eng.stats["cancelled"] == 2
    lat = eng.latency_percentiles()
    assert lat["n"] == 1 and lat["ttft_s"]["p50"] >= 0.0


def test_sampling_engine_is_seeded(models):
    model = models[2]

    def draw():
        eng = tserve.ServingEngine(model, max_slots=2, max_len=32,
                                   temperature=0.9, top_p=0.9,
                                   generator=torch.Generator().manual_seed(1))
        eng.submit([1, 2, 3], 5)
        eng.submit([9, 8], 4)
        return [c.tokens for c in eng.run()]

    assert draw() == draw()
    with pytest.raises(ValueError):
        tserve.ServingEngine(model, max_slots=1, max_len=8, temperature=0.5)
