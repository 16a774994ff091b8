"""Weight-only int8 / int4 quantization for serving.

Port of the JAX package's models/quant.py.  Decode streams every weight
matrix once per generated token, so bytes per weight bound it; two
precisions, one transform:

- **int8**, per output channel, symmetric: ``scale = amax / 127``,
  ``q = round(w / scale)`` (half to even) clipped to ±127.  The
  dequantization commutes with the product for column scales, so
  :class:`QuantLinear` computes ``(x @ q) * scale`` in ``cfg.dtype``, as
  the JAX ``QuantDense`` does.
- **int4**, group-wise: one scale per (128-row input group, output
  channel), ``scale = amax / 7``, ``q`` in [-8, 7], two weights a byte
  (input row 2i in the low nibble, 2i+1 in the high).  Group scales sit on
  the contracting dimension and do not commute; the JAX ``QuantDense4``
  sums a partial product per group.  :class:`QuantLinear4` instead
  dequantizes the weights in f32 (exactly :func:`dequantize_params`),
  casts them to ``cfg.dtype`` and takes one product: the same function
  (the JAX test ``test_int4_matches_dequantized_reference`` states it),
  without a [..., groups, out] tensor of partials (32 x 11008 x 512 x 2 B
  for ``gate_proj`` at 512 tokens).

Layout: the modules hold their weights as buffers in Flax's [in, out]
layout (``kernel_q`` int8 [in, out], ``kernel_q4`` uint8 [in/2, out],
``scale`` f32 [out] or [in/group, out]), so the bytes are the JAX
package's as they stand, with no transpose; ``torch.matmul`` takes them
as the right operand.

Scope: the block projections (q/k/v/o, gate/up/down); the embedding, the
norms and ``lm_head`` stay in ``cfg.dtype``.  Serving only: a quantized
model refuses a train step (``models/train.py``).  The products run in
``torch.matmul``, outside any kernel of the port, as the JAX package
computes them outside its Pallas kernel.

One implementation of the arithmetic, in torch: :func:`quantize_params`
and :func:`dequantize_params` take a Flax-layout tree of numpy arrays
through it on the host, and :func:`~.convert.quantize_model` runs it on
the model's device.  f32 division and round-half-to-even are exact IEEE
operations on the CPU and on the card, so both give the same bytes; every
divisor is a tensor, never a host scalar (a CUDA division by a host scalar
multiplies by its reciprocal instead).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

# Input-dim rows per int4 scale group (GPTQ/AWQ convention).  Matrices
# narrower than this use one group per matrix; other non-divisible
# widths are refused loudly.
INT4_GROUP = 128
BITS = {"int8": 8, "int4": 4}


def _int4_group(in_: int) -> int:
    """Scale-group size for an input width; refuses widths the packed
    layout cannot represent instead of silently mis-grouping."""
    group = min(INT4_GROUP, in_)
    if in_ % 2 or in_ % group:
        raise ValueError(
            f"int4 quantization needs the input dim divisible by 2 and "
            f"by the scale group ({group}); got {in_}")
    return group


def _scale(amax: torch.Tensor, qmax: float) -> torch.Tensor:
    return torch.where(amax > 0, amax / torch.full_like(amax, qmax),
                       torch.ones_like(amax))


def _quantize_kernel(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[in, out] float -> (int8 [in, out], f32 [out]) per-channel
    symmetric: scale = amax/127, q = round(w/scale)."""
    w32 = w.float()
    scale = _scale(w32.abs().amax(dim=0), 127.0)
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return q.contiguous(), scale


def _quantize_kernel_int4(w: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[in, out] float -> (uint8 [in/2, out] packed nibbles,
    f32 [in/group, out]) group-wise symmetric: per (group, out-channel)
    scale = amax/7, q = round(w/scale) in [-8, 7], rows 2i/2i+1 packed
    low/high."""
    in_, out = w.shape
    group = _int4_group(in_)
    w32 = w.float().reshape(in_ // group, group, out)
    scale = _scale(w32.abs().amax(dim=1), 7.0)                # [G, out]
    q = torch.clamp(torch.round(w32 / scale[:, None, :]), -8, 7)
    q = q.to(torch.int8).reshape(in_, out)
    packed = (((q[1::2] + 8).to(torch.uint8) << 4)
              | (q[0::2] + 8).to(torch.uint8))
    return packed.contiguous(), scale


def _dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale[None, :]


def _dequantize_int4(q4: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """f32 [in, out] from the packed nibbles and the group scales.  One
    f32 temporary, updated in place: a decode step dequantizes every
    projection, inside a grant sized for the packed weights."""
    in_, out = q4.shape[0] * 2, q4.shape[1]
    group = in_ // scale.shape[0]
    w = torch.stack([q4 & 0xF, q4 >> 4], dim=1).float()   # the nibbles + 8
    w = w.view(in_ // group, group, out).sub_(8.0).mul_(scale[:, None, :])
    return w.view(in_, out)


class QuantLinear(nn.Module):
    """Drop-in for a bias-free ``Linear`` over int8 weights and
    per-output-channel f32 scales (the JAX ``QuantDense``)."""

    def __init__(self, n_in: int, n_out: int, dtype: torch.dtype,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.register_buffer("kernel_q", torch.empty(
            (n_in, n_out), dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.empty(
            (n_out,), dtype=torch.float32, device=device))

    @torch.no_grad()
    def load(self, w: torch.Tensor) -> None:
        """Quantize ``w`` ([in, out], on this module's device) into it."""
        q, scale = _quantize_kernel(w)
        self.kernel_q.copy_(q)
        self.scale.copy_(scale)

    def forward(self, x):
        y = torch.matmul(x.to(self.dtype), self.kernel_q.to(self.dtype))
        return (y * self.scale.to(self.dtype)).to(self.dtype)


class QuantLinear4(nn.Module):
    """Drop-in for a bias-free ``Linear`` over packed int4 weights and
    group scales (the JAX ``QuantDense4``)."""

    def __init__(self, n_in: int, n_out: int, dtype: torch.dtype,
                 device=None):
        super().__init__()
        group = _int4_group(n_in)
        self.dtype = dtype
        self.register_buffer("kernel_q4", torch.empty(
            (n_in // 2, n_out), dtype=torch.uint8, device=device))
        self.register_buffer("scale", torch.empty(
            (n_in // group, n_out), dtype=torch.float32, device=device))

    @torch.no_grad()
    def load(self, w: torch.Tensor) -> None:
        """Quantize ``w`` ([in, out], on this module's device) into it."""
        q4, scale = _quantize_kernel_int4(w)
        self.kernel_q4.copy_(q4)
        self.scale.copy_(scale)

    def forward(self, x):
        w = _dequantize_int4(self.kernel_q4, self.scale).to(self.dtype)
        return torch.matmul(x.to(self.dtype), w)


def _is_proj(key: str) -> bool:
    return key.endswith("_proj")


def quantize_params(params: dict, bits: int = 8) -> dict:
    """Rewrite a full-precision Flax-layout tree of numpy arrays into the
    layout the quant modules consume: every ``*_proj: {kernel}`` becomes
    ``{kernel_q, scale}`` (int8) or ``{kernel_q4, scale}`` (int4).
    Everything else (embed, norms, head, MoE expert stacks) passes
    through untouched."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")

    def walk(node):
        if not isinstance(node, dict):
            return node
        out = {}
        for key, child in node.items():
            if (_is_proj(key) and isinstance(child, dict)
                    and "kernel" in child and np.ndim(child["kernel"]) == 2):
                w = torch.from_numpy(np.array(child["kernel"], np.float32))
                if bits == 4:
                    q, scale = _quantize_kernel_int4(w)
                    out[key] = {"kernel_q4": q.numpy(),
                                "scale": scale.numpy()}
                else:
                    q, scale = _quantize_kernel(w)
                    out[key] = {"kernel_q": q.numpy(), "scale": scale.numpy()}
            else:
                out[key] = walk(child)
        return out

    return walk(params)


def dequantize_params(qparams: dict) -> dict:
    """Inverse layout transform (values carry the quantization error)."""
    def walk(node):
        if not isinstance(node, dict):
            return node
        out = {}
        for key, child in node.items():
            if _is_proj(key) and isinstance(child, dict) and (
                    "kernel_q" in child or "kernel_q4" in child):
                scale = torch.from_numpy(np.array(child["scale"]))
                if "kernel_q" in child:
                    w = _dequantize_int8(
                        torch.from_numpy(np.array(child["kernel_q"])),
                        scale)
                else:
                    w = _dequantize_int4(
                        torch.from_numpy(np.array(child["kernel_q4"])),
                        scale)
                out[key] = {"kernel": w.numpy()}
            else:
                out[key] = walk(child)
        return out

    return walk(qparams)


def quantized_bytes(params: dict) -> int:
    """Bytes of a tree of arrays (a quantized one, say)."""
    if isinstance(params, dict):
        return sum(quantized_bytes(v) for v in params.values())
    return int(np.asarray(params).nbytes)
