"""The port's weight-only quantization against the JAX package's, on the
CPU, at llama_tiny widths in f32 with weights from the Flax init.

- int8 and int4 bytes of ``quantize_params`` are identical to JAX's, and
  so are those of ``quantize_model`` on a live model (transposed from
  ``Linear``'s [out, in] to the buffers' Flax [in, out] layout: none is
  needed after that); ``dequantize_params`` is equal.
- Odd widths are refused; only the projections change.
- Logits of ``from_flax`` of the quantized tree against JAX
  ``Llama(qcfg).apply``: int8 at 2e-4 (both compute ``(x @ q) * s`` in
  f32; the JAX test of that product against the dequantized weights
  allows the same); int4 at 3e-4 (JAX sums a partial product per group,
  the port multiplies once by the dequantized weights: the bound of the
  JAX test ``test_int4_matches_dequantized_reference`` that states the
  two are one function).  Greedy tokens of the quantized model equal JAX
  ``generate``'s.
- A quantized model refuses a train step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_vgpu_scheduler_tpu.models import generate as jgenerate
from k8s_vgpu_scheduler_tpu.models import llama as jllama
from k8s_vgpu_scheduler_tpu.models import quant as jquant
from k8s_vgpu_scheduler_tpu_torch.models import llama as tllama
from k8s_vgpu_scheduler_tpu_torch.models import quant as tquant
from k8s_vgpu_scheduler_tpu_torch.models import train as ttrain
from k8s_vgpu_scheduler_tpu_torch.models.convert import (
    from_flax, init_weights, quantize_model)
from k8s_vgpu_scheduler_tpu_torch.models.generate import generate

torch.set_num_threads(2)

CFG = dict(vocab=256, dim=128, n_layers=2, n_heads=8, n_kv_heads=4,
           ffn_hidden=256, dtype="float32")
# Logits against JAX's quantized model (see the module docstring).
LOGIT_TOL = {"int8": 2e-4, "int4": 3e-4}
BITS = {"int8": 8, "int4": 4}


@pytest.fixture(scope="module")
def params():
    jcfg = jllama.LlamaConfig(**CFG)
    p = jllama.Llama(jcfg).init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 8), jnp.int32))
    return jax.tree.map(np.asarray, p)


def leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def assert_trees_equal(got, want):
    g, w = dict(leaves(got)), dict(leaves(want))
    assert g.keys() == w.keys()
    for path in w:
        assert g[path].dtype == w[path].dtype, path
        assert g[path].shape == w[path].shape, path
        assert np.array_equal(g[path], w[path]), path


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_params_bytes_equal_jax(params, bits):
    want = jax.tree.map(np.asarray, jquant.quantize_params(params, bits))
    assert_trees_equal(tquant.quantize_params(params, bits), want)
    assert tquant.quantized_bytes(tquant.quantize_params(params, bits)) == \
        jquant.quantized_bytes(want)


@pytest.mark.parametrize("bits", [8, 4])
def test_wide_and_awkward_values_quantize_as_jax(bits):
    # Wider than one int4 group, values on rounding half-points, a column
    # of zeros (scale 1) and one of a single huge value.
    rng = np.random.RandomState(3)
    w = rng.standard_normal((512, 96)).astype(np.float32)
    w[:, 0] = 0.0
    w[:, 1] = np.arange(512, dtype=np.float32) / 511.0 * 127.0
    w[7, 2] = 1e30
    tree = {"x_proj": {"kernel": w}}
    want = jax.tree.map(np.asarray, jquant.quantize_params(tree, bits))
    assert_trees_equal(tquant.quantize_params(tree, bits), want)


@pytest.mark.parametrize("bits", [8, 4])
def test_dequantize_params_equal_jax(params, bits):
    q = tquant.quantize_params(params, bits)
    want = jax.tree.map(np.asarray, jquant.dequantize_params(
        jax.tree.map(jnp.asarray, q)))
    assert_trees_equal(tquant.dequantize_params(q), want)


def test_odd_widths_refused():
    with pytest.raises(ValueError, match="int4"):
        tquant._quantize_kernel_int4(torch.ones((7, 4)))
    with pytest.raises(ValueError, match="int4"):
        tquant.QuantLinear4(200, 4, torch.float32)  # 200 % 128 != 0
    with pytest.raises(ValueError, match="int4"):
        tquant.quantize_params({"a_proj": {"kernel": np.ones((7, 4))}}, 4)
    with pytest.raises(ValueError, match="bits"):
        tquant.quantize_params({}, 3)


@pytest.mark.parametrize("bits", [8, 4])
def test_only_projections_change(params, bits):
    q = tquant.quantize_params(params, bits)["params"]
    p = params["params"]
    assert np.array_equal(q["embed"]["embedding"], p["embed"]["embedding"])
    assert np.array_equal(q["lm_head"]["kernel"], p["lm_head"]["kernel"])
    assert np.array_equal(q["final_norm"]["scale"], p["final_norm"]["scale"])
    key = "kernel_q" if bits == 8 else "kernel_q4"
    for group, names in (("attn", ("q_proj", "k_proj", "v_proj", "o_proj")),
                         ("mlp", ("gate_proj", "up_proj", "down_proj"))):
        for name in names:
            assert set(q["layer_0"][group][name]) == {key, "scale"}
    assert np.array_equal(q["layer_0"]["attn_norm"]["scale"],
                          p["layer_0"]["attn_norm"]["scale"])


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_logits_match_jax_quantized_llama(params, quant):
    qparams = tquant.quantize_params(params, BITS[quant])
    jcfg = jllama.LlamaConfig(**CFG, quant=quant)
    tokens = np.random.RandomState(1).randint(0, CFG["vocab"], size=(2, 16))
    want = jllama.Llama(jcfg).apply(
        {"params": jax.tree.map(jnp.asarray, qparams["params"])},
        jnp.asarray(tokens))
    model = from_flax(qparams, tllama.LlamaConfig(**CFG, quant=quant),
                      device="cpu")
    assert isinstance(model.layers[0].mlp.up_proj,
                      tquant.QuantLinear if quant == "int8"
                      else tquant.QuantLinear4)
    with torch.no_grad():
        got = model(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=LOGIT_TOL[quant], atol=LOGIT_TOL[quant])


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_quantized_generate_matches_jax(params, quant):
    qparams = tquant.quantize_params(params, BITS[quant])
    jcfg = jllama.LlamaConfig(**CFG, quant=quant)
    prompt = np.random.RandomState(2).randint(1, CFG["vocab"], size=(1, 7))
    want = jgenerate.generate(jcfg, jax.tree.map(jnp.asarray, qparams),
                              jnp.asarray(prompt), 6)
    model = from_flax(qparams, tllama.LlamaConfig(**CFG, quant=quant),
                      device="cpu")
    got = generate(model, torch.from_numpy(prompt), 6)
    assert got.tolist() == np.asarray(want).tolist()


def test_int4_linear_is_the_dequantized_product():
    # The port's form: dequantize (exactly dequantize_params), cast, one
    # product — equal to a plain linear over the dequantized weights.
    rng = np.random.RandomState(4)
    w = torch.from_numpy(rng.standard_normal((256, 48)).astype(np.float32))
    lin = tquant.QuantLinear4(256, 48, torch.float32)
    lin.load(w)
    deq = tquant.dequantize_params(
        {"w_proj": {"kernel_q4": lin.kernel_q4.numpy(),
                    "scale": lin.scale.numpy()}})["w_proj"]["kernel"]
    x = torch.from_numpy(rng.standard_normal((3, 5, 256)).astype(np.float32))
    assert torch.equal(lin(x), x @ torch.from_numpy(deq))


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_model_bytes_equal_quantize_params(params, bits):
    model = from_flax(params, tllama.LlamaConfig(**CFG), device="cpu")
    out = quantize_model(model, bits, device="cpu")
    assert out is model and model.cfg.quant == ("int8" if bits == 8
                                                else "int4")
    assert model.layers[0].attn.cfg.quant == model.cfg.quant
    want = jax.tree.map(np.asarray, jquant.quantize_params(params, bits))
    key = "kernel_q" if bits == 8 else "kernel_q4"
    for i, layer in enumerate(model.layers):
        for group, mod in (("attn", layer.attn), ("mlp", layer.mlp)):
            for name, q in mod.named_children():
                w = want["params"][f"layer_{i}"][group][name]
                assert np.array_equal(getattr(q, key).numpy(), w[key])
                assert np.array_equal(q.scale.numpy(), w["scale"])
    # The same model as from_flax of the quantized tree.
    ref = from_flax(tquant.quantize_params(params, bits),
                    model.cfg, device="cpu")
    for (n, a), b in zip(model.state_dict().items(),
                         ref.state_dict().values()):
        assert torch.equal(a, b), n


def test_quantize_model_refuses_what_it_cannot_do(params):
    model = from_flax(params, tllama.LlamaConfig(**CFG), device="cpu")
    with pytest.raises(ValueError, match="bits"):
        quantize_model(model, 3, device="cpu")
    quantize_model(model, 8, device="cpu")
    with pytest.raises(ValueError, match="already"):
        quantize_model(model, 4, device="cpu")
    with pytest.raises(ValueError, match="full-precision"):
        init_weights(tllama.LlamaConfig(**CFG, quant="int8"),
                     torch.Generator(), device="cpu")
    with pytest.raises(ValueError, match="quant"):
        tllama.Llama(tllama.LlamaConfig(**CFG, quant="int2"), device="cpu")


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_quantized_model_refuses_a_train_step(params, quant):
    qparams = tquant.quantize_params(params, BITS[quant])
    model = from_flax(qparams, tllama.LlamaConfig(**CFG, quant=quant),
                      device="cpu")
    with pytest.raises(ValueError, match="serves only"):
        ttrain.make_train_step(model, ttrain.make_optimizer())


def test_bf16_quantized_model_runs_in_its_dtype(params):
    cfg = dataclasses.replace(tllama.LlamaConfig(**CFG), dtype="bfloat16")
    model = from_flax(params, cfg, device="cpu")
    quantize_model(model, 4, device="cpu")
    with torch.no_grad():
        logits = model(torch.ones((1, 8), dtype=torch.long))
    assert logits.dtype == torch.bfloat16
    assert torch.isfinite(logits.float()).all()
