"""Weights for the port's Llama: from a Flax parameter tree, or from a
seed; and the weight-only quantization of a live model.

The Flax tree is taken as numpy arrays (``{"params": {...}}`` or the inner
dict), so this module needs no JAX.  Dense kernels are [in, out] in Flax
and become ``Linear.weight`` [out, in]; the quantized leaves
(``kernel_q``/``kernel_q4`` and ``scale``, models/quant.py) keep Flax's
layout.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..device import resolve_device
from .llama import Llama, LlamaConfig
from .quant import BITS, QuantLinear, QuantLinear4

_ATTN = ("q_proj", "k_proj", "v_proj", "o_proj")
_MLP = ("gate_proj", "up_proj", "down_proj")


def _projections(model: Llama):
    """(flax path, parent module, name) of every block projection."""
    for i, layer in enumerate(model.layers):
        for name in _ATTN:
            yield (f"layer_{i}", "attn", name), layer.attn, name
        for name in _MLP:
            yield (f"layer_{i}", "mlp", name), layer.mlp, name


def _linears(model: Llama):
    """(flax path, torch Linear) for every Dense of a full-precision
    model."""
    yield ("lm_head",), model.lm_head
    for path, parent, name in _projections(model):
        yield path, getattr(parent, name)


def _norms(model: Llama):
    yield ("final_norm",), model.final_norm
    for i, layer in enumerate(model.layers):
        yield (f"layer_{i}", "attn_norm"), layer.attn_norm
        yield (f"layer_{i}", "mlp_norm"), layer.mlp_norm


@torch.no_grad()
def from_flax(params, cfg: LlamaConfig, device="cuda") -> Llama:
    """A Llama holding the Flax tree's weights (cast once to cfg.dtype).
    With ``cfg.quant`` the tree is a quantized one
    (``quant.quantize_params``): its projections' bytes are copied as
    they are."""
    tree = params.get("params", params)

    def at(path):
        node = tree
        for key in path:
            node = node[key]
        a = np.asarray(node)
        return torch.from_numpy(
            np.array(a, dtype=a.dtype if a.dtype.kind in "iu" else np.float32))

    model = Llama(cfg, device=device)
    model.embed.weight.copy_(at(("embed", "embedding")))
    model.lm_head.weight.copy_(at(("lm_head", "kernel")).T)
    for path, parent, name in _projections(model):
        mod = getattr(parent, name)
        if isinstance(mod, QuantLinear):
            mod.kernel_q.copy_(at(path + ("kernel_q",)))
        elif isinstance(mod, QuantLinear4):
            mod.kernel_q4.copy_(at(path + ("kernel_q4",)))
        else:
            mod.weight.copy_(at(path + ("kernel",)).T)
            continue
        mod.scale.copy_(at(path + ("scale",)))
    for path, norm in _norms(model):
        norm.scale.copy_(at(path + ("scale",)))
    return model


@torch.no_grad()
def quantize_model(model: Llama, bits: int, device="cuda") -> Llama:
    """Quantize a full-precision Llama in place and move it to ``device``
    (the card unless the caller asks for the CPU), one projection at a
    time: each weight goes to ``device`` in f32, is quantized there into a
    :class:`~.quant.QuantLinear` (int8) or :class:`~.quant.QuantLinear4`
    (int4) that takes its place, and is freed before the next, so the
    whole full-precision tree is never on ``device`` unless it started
    there.  The embedding, the norms and ``lm_head`` move as they are.
    The bytes equal ``quant.quantize_params`` of the same f32 values."""
    dev = resolve_device(device)
    quant = {b: name for name, b in BITS.items()}.get(bits)
    if quant is None:
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if model.cfg.quant is not None:
        raise ValueError(f"the model is quantized already ({model.cfg.quant})")
    module = QuantLinear if bits == 8 else QuantLinear4
    dtype = model.embed.weight.dtype
    for _, parent, name in _projections(model):
        lin = getattr(parent, name)
        n_out, n_in = lin.weight.shape
        q = module(n_in, n_out, dtype, dev)
        q.load(lin.weight.detach().to(dev).float().T)
        setattr(parent, name, q)
    model.to(dev)
    cfg = dataclasses.replace(model.cfg, quant=quant)
    model.cfg = cfg
    for layer in model.layers:
        layer.attn.cfg = cfg
    return model


def _truncated_normal_(t: torch.Tensor, std: float,
                       generator: torch.Generator) -> None:
    """Fill ``t`` from N(0, std²) truncated to ±2 std, by inverse CDF —
    the distribution of Flax's lecun_normal (whose std is pre-divided by
    the truncated normal's own std, 0.8796)."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    u.uniform_(lo, 1.0 - lo, generator=generator)
    t.copy_(torch.erfinv(2.0 * u - 1.0) * (math.sqrt(2.0) * std))


@torch.no_grad()
def init_weights(cfg: LlamaConfig, generator: torch.Generator,
                 device="cuda") -> Llama:
    """Full-size weights from a seed, at the Flax init scales: Dense
    kernels lecun-normal (truncated, std sqrt(1/fan_in)/0.8796), the
    embedding N(0, 1/dim), norm scales one.  Made on ``device``; the
    generator must live there too.  Not the numbers JAX draws from the
    same seed.  Full precision only: quantize the result with
    :func:`quantize_model`."""
    if cfg.quant is not None:
        raise ValueError("init_weights makes full-precision weights; "
                         "quantize them with quantize_model")
    model = Llama(cfg, device=device)
    emb = torch.empty(model.embed.weight.shape, dtype=torch.float32,
                      device=model.device)
    emb.normal_(0.0, 1.0 / math.sqrt(cfg.dim), generator=generator)
    model.embed.weight.copy_(emb)
    del emb
    for _, lin in _linears(model):
        fan_in = lin.weight.shape[1]
        w = torch.empty(lin.weight.shape, dtype=torch.float32,
                        device=model.device)
        _truncated_normal_(w, math.sqrt(1.0 / fan_in) / 0.87962566103423978,
                           generator)
        lin.weight.copy_(w)
    for _, norm in _norms(model):
        norm.scale.fill_(1.0)
    return model
