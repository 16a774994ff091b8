"""Llama-style decoder — the flagship model, in PyTorch.

Port of the JAX package's models/llama.py: RMSNorm/RoPE/SwiGLU/GQA with
the same parameter layout, the ``full`` and ``flash`` attention paths of
the full-sequence forward, and the KV-cache decode path used by
models/generate.py and models/serve.py.  Weights come from
:mod:`.convert` (a Flax tree, or a seeded init).

Numerics follow the reference: projections run in ``cfg.dtype``; RMSNorm
and RoPE compute in f32 and cast back; norm scales stay f32.  Flax's
``nn.Dense(dtype=bf16)`` keeps f32 params and casts them at every matmul;
the port stores that cast once, which gives the same numbers.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.flash_attention import flash_attention
from ..parallel.ring import full_attention_reference
from .quant import BITS, QuantLinear, QuantLinear4


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_hidden: int = 11008
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # Weight-only quantization of the block projections ("int8" | "int4";
    # models/quant.py): serving only.
    quant: Optional[str] = None
    # "full" | "flash" here; "ring" | "ulysses" come with the
    # multi-device slice.
    attention: str = "full"
    # >0 with attention="flash": causal sliding window (Mistral-style).
    attention_window: int = 0
    # >0 switches the FFN to a routed MoE: a later slice.
    n_experts: int = 0
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.25
    # KV-cache length for decode (models/generate.py sizes it).
    decode_cache_len: int = 0

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


def llama_7b() -> LlamaConfig:
    return LlamaConfig()


def llama_tiny(attention: str = "full") -> LlamaConfig:
    """Test/dry-run scale."""
    return LlamaConfig(vocab=256, dim=128, n_layers=2, n_heads=8,
                       n_kv_heads=4, ffn_hidden=256, attention=attention)


def torch_dtype(cfg: LlamaConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# Cache-position sentinel for slots that must never be attended (unwritten
# slots and left-padding): larger than any real position, so the mask
# "key_pos <= query_pos" excludes them for every query.
PAD_POSITION = 2 ** 30


def _rope(x: torch.Tensor, positions: torch.Tensor,
          theta: float) -> torch.Tensor:
    """Rotary embedding, rotate-half layout. x: [B, T, H, D],
    positions: [B, T]."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=x.device) / d))
    angles = positions[..., None].float() * freqs  # [B,T,D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, device):
        super().__init__()
        self.eps = eps
        # f32 like the Flax param: the product with the normed f32
        # activations happens before the cast back.
        self.scale = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x):
        x32 = x.float()
        normed = x32 * torch.rsqrt(
            (x32 * x32).mean(dim=-1, keepdim=True) + self.eps)
        return (normed * self.scale).to(x.dtype)


@dataclasses.dataclass
class LayerCache:
    """One layer's KV cache, [B, L, KV, D] each, updated in place (the
    JAX cache collection is rewritten functionally instead).  ``idx`` is
    the shared append index used when no per-row write index is given."""
    k: torch.Tensor
    v: torch.Tensor
    idx: int = 0


def _cached_attention(q, k_all, v_all, q_pos, key_pos, window: int = 0):
    """q: [B,T,H,D] against the unrepeated cache [B,L,KV,D] — GQA query
    groups attend their kv head via a grouped einsum.  ``key_pos`` [B,L]
    holds each cache slot's logical position (PAD_POSITION when invalid);
    key slot l is attended iff key_pos[l] <= the query's position, which
    covers causality, unwritten slots and left-padding.  Masked logits are
    -inf here, unlike the flash kernel's finite -1e30."""
    B, T, H, D = q.shape
    KV = k_all.shape[2]
    qg = q.reshape(B, T, KV, H // KV, D)
    scale = 1.0 / (D ** 0.5)
    logits = torch.einsum("btkrd,blkd->bkrtl", qg, k_all).float() * scale
    mask = key_pos[:, None, :] <= q_pos[:, :, None]          # [B,T,L]
    if window > 0:
        mask = mask & (q_pos[:, :, None] - key_pos[:, None, :] < window)
    logits = logits.masked_fill(~mask[:, None, None], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkrtl,blkd->btkrd", probs.to(v_all.dtype), v_all)
    return out.reshape(B, T, H, D)


class _EmptyLinear(nn.Linear):
    """An ``nn.Linear`` left uninitialized: its weights come from
    convert.from_flax / init_weights.  (``torch.nn.utils.skip_init`` would
    do the same through the meta device, whose first use imports torch's
    fake-tensor and compiler stacks: seconds in every new process.)"""

    def reset_parameters(self) -> None:
        pass


class _EmptyEmbedding(nn.Embedding):
    """An ``nn.Embedding`` left uninitialized, as :class:`_EmptyLinear`."""

    def reset_parameters(self) -> None:
        pass


def _linear(n_in: int, n_out: int, device, dtype) -> nn.Linear:
    return _EmptyLinear(n_in, n_out, bias=False, device=device, dtype=dtype)


def _proj(cfg: LlamaConfig, n_in: int, n_out: int, device, dtype):
    """Block projection layer: a Linear, or a quant module when the config
    carries weight-only quantization (the JAX ``_dense``)."""
    if cfg.quant == "int8":
        return QuantLinear(n_in, n_out, dtype, device)
    if cfg.quant == "int4":
        return QuantLinear4(n_in, n_out, dtype, device)
    return _linear(n_in, n_out, device, dtype)


class Attention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device, dtype):
        super().__init__()
        self.cfg = cfg
        hd = cfg.head_dim
        self.q_proj = _proj(cfg, cfg.dim, cfg.n_heads * hd, device, dtype)
        self.k_proj = _proj(cfg, cfg.dim, cfg.n_kv_heads * hd, device, dtype)
        self.v_proj = _proj(cfg, cfg.dim, cfg.n_kv_heads * hd, device, dtype)
        self.o_proj = _proj(cfg, cfg.n_heads * hd, cfg.dim, device, dtype)

    def forward(self, x, positions, key_positions=None, write_index=None,
                cache: Optional[LayerCache] = None):
        cfg = self.cfg
        B, T, _ = x.shape
        q = self.q_proj(x).reshape(B, T, cfg.n_heads, cfg.head_dim)
        k = self.k_proj(x).reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
        v = self.v_proj(x).reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
        q = _rope(q, positions, cfg.rope_theta)
        k = _rope(k, positions, cfg.rope_theta)
        if cache is not None:
            # Decode: append this call's keys/values (prefill writes T at
            # once, steps write 1), then attend the whole cache.
            L = cache.k.shape[1]
            if L < T:
                raise ValueError(f"cache length {L} < input length {T}")
            if key_positions is None:
                raise ValueError("decode mode requires key_positions "
                                 "([B, cache_len] logical positions, "
                                 "PAD_POSITION for invalid)")
            if write_index is not None:
                # Per-row write positions (continuous batching: every slot
                # sits at its own length).  The shared index is untouched.
                rows = torch.arange(B, device=x.device)[:, None]
                cols = (write_index.long()[:, None]
                        + torch.arange(T, device=x.device)[None, :])
                cache.k[rows, cols] = k.to(cache.k.dtype)
                cache.v[rows, cols] = v.to(cache.v.dtype)
            else:
                cur = cache.idx
                cache.k[:, cur:cur + T] = k.to(cache.k.dtype)
                cache.v[:, cur:cur + T] = v.to(cache.v.dtype)
                cache.idx = cur + T
            out = _cached_attention(q, cache.k, cache.v, positions,
                                    key_positions,
                                    window=cfg.attention_window)
            out = out.to(x.dtype)
        else:
            rep = cfg.n_heads // cfg.n_kv_heads
            if rep > 1:
                # jnp.repeat: each kv head repeated in place (h0 h0 h1 h1).
                k = torch.repeat_interleave(k, rep, dim=2)
                v = torch.repeat_interleave(v, rep, dim=2)
            if cfg.attention == "flash":
                out = flash_attention(q, k, v, causal=True,
                                      window=cfg.attention_window)
            else:
                out = full_attention_reference(q, k, v, causal=True)
        return self.o_proj(out.reshape(B, T, cfg.n_heads * cfg.head_dim))


class MLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, device, dtype):
        super().__init__()
        self.gate_proj = _proj(cfg, cfg.dim, cfg.ffn_hidden, device, dtype)
        self.up_proj = _proj(cfg, cfg.dim, cfg.ffn_hidden, device, dtype)
        self.down_proj = _proj(cfg, cfg.ffn_hidden, cfg.dim, device, dtype)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Block(nn.Module):
    def __init__(self, cfg: LlamaConfig, device, dtype):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.dim, cfg.norm_eps, device)
        self.attn = Attention(cfg, device, dtype)
        self.mlp_norm = RMSNorm(cfg.dim, cfg.norm_eps, device)
        self.mlp = MLP(cfg, device, dtype)

    def forward(self, x, positions, key_positions=None, write_index=None,
                cache: Optional[LayerCache] = None):
        x = x + self.attn(self.attn_norm(x), positions, key_positions,
                          write_index, cache)
        return x + self.mlp(self.mlp_norm(x))


class Llama(nn.Module):
    """The decoder.  Weights are left uninitialized: build it through
    :func:`..convert.from_flax` or :func:`..convert.init_weights`.

    ``forward(tokens)`` is the full-sequence forward (``cfg.attention``
    picks ``full`` or ``flash``); passing ``cache`` (see
    :meth:`new_cache`) runs the decode path instead, which attends through
    the cache mask whatever ``cfg.attention`` says.  With ``cfg.quant``
    the block projections are :mod:`.quant` modules (serving only)."""

    def __init__(self, cfg: LlamaConfig, device="cuda"):
        super().__init__()
        if cfg.quant not in (None, *BITS):
            raise ValueError(f"quant={cfg.quant!r}: None, 'int8' or 'int4'")
        if cfg.n_experts:
            raise NotImplementedError(
                "MoE arrives with the multi-device slice (parallel/moe.py)")
        if cfg.attention not in ("full", "flash"):
            raise NotImplementedError(
                f"attention={cfg.attention!r} arrives with the "
                f"multi-device slice")
        dev = resolve_device(device)
        dtype = torch_dtype(cfg)
        self.cfg = cfg
        self.embed = _EmptyEmbedding(cfg.vocab, cfg.dim, device=dev,
                                     dtype=dtype)
        self.layers = nn.ModuleList(
            Block(cfg, dev, dtype) for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.dim, cfg.norm_eps, dev)
        self.lm_head = _linear(cfg.dim, cfg.vocab, dev, dtype)

    @property
    def device(self) -> torch.device:
        return self.embed.weight.device

    def new_cache(self, batch: int, length: int) -> List[LayerCache]:
        """Zeroed per-layer KV caches of ``length`` slots."""
        cfg = self.cfg
        shape = (batch, length, cfg.n_kv_heads, cfg.head_dim)
        dtype = torch_dtype(cfg)
        return [LayerCache(torch.zeros(shape, dtype=dtype, device=self.device),
                           torch.zeros(shape, dtype=dtype, device=self.device))
                for _ in range(cfg.n_layers)]

    def forward(self, tokens, positions=None, key_positions=None,
                write_index=None, cache: Optional[List[LayerCache]] = None):
        B, T = tokens.shape
        if positions is None:
            positions = torch.arange(T, device=tokens.device).expand(B, T)
        x = self.embed(tokens)
        for i, layer in enumerate(self.layers):
            x = layer(x, positions, key_positions, write_index,
                      None if cache is None else cache[i])
        return self.lm_head(self.final_norm(x))
