"""Weights for the port's models: from a Flax parameter tree, or from a
seed; and the weight-only quantization of a live Llama.

The Flax tree is taken as numpy arrays (``{"params": {...}}`` or the inner
dict), so this module needs no JAX.  Dense kernels are [in, out] in Flax
and become ``Linear.weight`` [out, in]; the quantized leaves
(``kernel_q``/``kernel_q4`` and ``scale``, models/quant.py) keep Flax's
layout.  For the benchmark families (ResNet-V2, VGG-16, DeepLab-v3, the
LSTM) Conv kernels go HWIO -> OIHW and GroupNorm scales and biases are
taken as they are; the port's module names are Flax's.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..device import resolve_device
from .deeplab import DeepLabConfig, DeepLabV3
from .layers import Conv, Dense, GroupNorm
from .llama import Llama, LlamaConfig
from .lstm import LSTMClassifier
from .quant import BITS, QuantLinear, QuantLinear4
from .resnet import ResNetConfig, ResNetV2
from .vgg import VGG16

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


def early_exit_draft(model: Llama, n_layers: int) -> Llama:
    """A draft for speculative decoding that is the target's first
    ``n_layers`` layers: the target's embedding, those blocks, its final
    norm and its head, the same tensors on the same device (nothing is
    copied).  bench.py builds its draft so in JAX: every draft leaf whose
    path and shape exist in the target takes the target's weights."""
    if not 0 < n_layers <= model.cfg.n_layers:
        raise ValueError(f"n_layers={n_layers}: 1..{model.cfg.n_layers}")
    draft = Llama.__new__(Llama)
    torch.nn.Module.__init__(draft)
    draft.cfg = dataclasses.replace(model.cfg, n_layers=n_layers)
    draft.embed = model.embed
    draft.layers = torch.nn.ModuleList(list(model.layers)[:n_layers])
    draft.final_norm = model.final_norm
    draft.lm_head = model.lm_head
    return draft


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


def _lecun_normal_(t: torch.Tensor, fan_in: int,
                   generator: torch.Generator) -> None:
    """Flax's lecun_normal: truncated, std sqrt(1/fan_in)/0.8796."""
    _truncated_normal_(t, math.sqrt(1.0 / fan_in) / 0.87962566103423978,
                       generator)


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
        w = torch.empty(lin.weight.shape, dtype=torch.float32,
                        device=model.device)
        _lecun_normal_(w, lin.weight.shape[1], generator)
        lin.weight.copy_(w)
    for _, norm in _norms(model):
        norm.scale.fill_(1.0)
    return model


# -- the benchmark families -------------------------------------------------
def _leaves(tree, path=()):
    for key, node in tree.items():
        if isinstance(node, dict):
            yield from _leaves(node, path + (key,))
        else:
            yield path + (key,)


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(a), dtype=np.float32))


def _load_tree(model: torch.nn.Module, params) -> None:
    """Copy a Flax tree into ``model`` by module name; every leaf of the
    tree must land in a parameter, and every parameter get a leaf."""
    tree = params.get("params", params)
    used = set()

    def leaf(*path):
        node = tree
        for key in path:
            node = node[key]
        used.add(path)
        return _f32(node)

    for name, mod in model.named_modules():
        path = tuple(name.split("."))
        if isinstance(mod, Conv):
            mod.weight.copy_(leaf(*path, "kernel").permute(3, 2, 0, 1))
        elif isinstance(mod, Dense):
            mod.weight.copy_(leaf(*path, "kernel").T)
        elif isinstance(mod, GroupNorm):
            mod.weight.copy_(leaf(*path, "scale"))
        elif isinstance(mod, torch.nn.LSTM):
            # Flax's OptimizedLSTMCell: input kernels {ii,if,ig,io} [in, h]
            # with no bias, hidden kernels {hi,hf,hg,ho} [h, h] with one;
            # torch's gate order is also i, f, g, o.
            cell = ("OptimizedLSTMCell_0",)
            gates = "ifgo"
            mod.weight_ih_l0.copy_(torch.cat(
                [leaf(*cell, f"i{g}", "kernel") for g in gates], 1).T)
            mod.weight_hh_l0.copy_(torch.cat(
                [leaf(*cell, f"h{g}", "kernel") for g in gates], 1).T)
            mod.bias_ih_l0.zero_()
            mod.bias_hh_l0.copy_(torch.cat(
                [leaf(*cell, f"h{g}", "bias") for g in gates]))
            continue
        else:
            continue
        if mod.bias is not None:
            mod.bias.copy_(leaf(*path, "bias"))
    missed = sorted(set(_leaves(tree)) - used)
    if missed:
        raise ValueError(f"Flax leaves with no parameter: {missed}")


def _seeded_(model: torch.nn.Module, generator: torch.Generator):
    """Flax's default init scales on ``model`` (in place): Conv and Dense
    kernels lecun-normal (truncated, std sqrt(1/fan_in)/0.8796), biases
    zero, GroupNorm scale one; the LSTM's input kernels lecun-normal and
    its recurrent ones orthogonal, a gate at a time.  ``generator`` must
    live on the model's device.  Not the numbers JAX draws."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (Conv, Dense)):
                _lecun_normal_(mod.weight, mod.weight[0].numel(), generator)
            elif isinstance(mod, torch.nn.LSTM):
                h = mod.hidden_size
                for gate in range(4):
                    rows = slice(gate * h, (gate + 1) * h)
                    _lecun_normal_(mod.weight_ih_l0[rows], mod.input_size,
                                   generator)
                    torch.nn.init.orthogonal_(mod.weight_hh_l0[rows],
                                              generator=generator)
                mod.bias_ih_l0.zero_()
                mod.bias_hh_l0.zero_()
    return model


def init_resnet(cfg: ResNetConfig, generator: torch.Generator,
                device="cuda") -> ResNetV2:
    """A ResNetV2 with seeded weights (:func:`_seeded_`) on ``device``."""
    return _seeded_(ResNetV2(cfg, device), generator)


def init_vgg(generator: torch.Generator, num_classes: int = 1000,
             size: int = 224, device="cuda") -> VGG16:
    """A VGG16 for ``size``² inputs with seeded weights on ``device``."""
    return _seeded_(VGG16(num_classes, size=size, device=device), generator)


def init_deeplab(cfg: DeepLabConfig, generator: torch.Generator,
                 device="cuda") -> DeepLabV3:
    """A DeepLabV3 with seeded weights on ``device``."""
    return _seeded_(DeepLabV3(cfg, device), generator)


def init_lstm(generator: torch.Generator, hidden: int = 300,
              num_classes: int = 2, features: int = 300,
              device="cuda") -> LSTMClassifier:
    """An LSTMClassifier with seeded weights on ``device``."""
    return _seeded_(LSTMClassifier(hidden, num_classes, features,
                                   device=device), generator)


@torch.no_grad()
def resnet_from_flax(params, cfg: ResNetConfig, device="cuda") -> ResNetV2:
    model = ResNetV2(cfg, device)
    _load_tree(model, params)
    return model


@torch.no_grad()
def deeplab_from_flax(params, cfg: DeepLabConfig,
                      device="cuda") -> DeepLabV3:
    model = DeepLabV3(cfg, device)
    _load_tree(model, params)
    return model


@torch.no_grad()
def vgg_from_flax(params, dtype: str = "bfloat16", device="cuda") -> VGG16:
    """The tree's ``fc1`` fixes the input size and ``fc3`` the classes."""
    device = resolve_device(device)
    tree = params.get("params", params)
    side = math.isqrt(np.shape(tree["fc1"]["kernel"])[0] // 512)
    model = VGG16(np.shape(tree["fc3"]["kernel"])[1], dtype, side * 32,
                  device)
    _load_tree(model, tree)
    return model


@torch.no_grad()
def lstm_from_flax(params, dtype: str = "bfloat16",
                   device="cuda") -> LSTMClassifier:
    """The tree's shapes fix the features, the hidden width and the
    classes."""
    device = resolve_device(device)
    tree = params.get("params", params)
    features, hidden = np.shape(tree["OptimizedLSTMCell_0"]["ii"]["kernel"])
    model = LSTMClassifier(hidden, np.shape(tree["classifier"]["kernel"])[1],
                           features, dtype, device)
    _load_tree(model, tree)
    return model
