"""Weights for the port's Llama: from a Flax parameter tree, or from a seed.

The Flax tree is taken as numpy arrays (``{"params": {...}}`` or the inner
dict), so this module needs no JAX.  Dense kernels are [in, out] in Flax
and become ``Linear.weight`` [out, in].
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .llama import Llama, LlamaConfig

_ATTN = ("q_proj", "k_proj", "v_proj", "o_proj")
_MLP = ("gate_proj", "up_proj", "down_proj")


def _linears(model: Llama):
    """(flax path, torch Linear) for every Dense of the model."""
    yield ("lm_head",), model.lm_head
    for i, layer in enumerate(model.layers):
        for name in _ATTN:
            yield (f"layer_{i}", "attn", name), getattr(layer.attn, name)
        for name in _MLP:
            yield (f"layer_{i}", "mlp", name), getattr(layer.mlp, name)


def _norms(model: Llama):
    yield ("final_norm",), model.final_norm
    for i, layer in enumerate(model.layers):
        yield (f"layer_{i}", "attn_norm"), layer.attn_norm
        yield (f"layer_{i}", "mlp_norm"), layer.mlp_norm


@torch.no_grad()
def from_flax(params, cfg: LlamaConfig, device="cuda") -> Llama:
    """A Llama holding the Flax tree's weights (cast once to cfg.dtype)."""
    tree = params.get("params", params)

    def at(path):
        node = tree
        for key in path:
            node = node[key]
        return torch.from_numpy(np.array(node, dtype=np.float32))

    model = Llama(cfg, device=device)
    model.embed.weight.copy_(at(("embed", "embedding")))
    for path, lin in _linears(model):
        lin.weight.copy_(at(path + ("kernel",)).T)
    for path, norm in _norms(model):
        norm.scale.copy_(at(path + ("scale",)))
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
    same seed."""
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
