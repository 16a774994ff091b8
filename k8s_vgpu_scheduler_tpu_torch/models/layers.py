"""Flax's layer semantics as plain torch functions and modules, for the
port's benchmark families (models/resnet.py, vgg.py, deeplab.py).

Activations are NCHW tensors laid out channels_last: an NHWC tensor
permuted to NCHW already is that layout, so cuDNN takes its NHWC path and
nothing is copied.  Parameters are f32 and each layer casts them, and its
input, to the compute dtype its caller passes, as Flax's ``dtype=`` does
(f32 params, bf16 compute).  Three of Flax's rules differ from torch's
defaults:

- ``"SAME"`` padding is asymmetric: the total pad is
  max((ceil(n/s) - 1)·s + (k - 1)·d + 1 - n, 0), the low side gets half
  of it rounded down, the high side the rest.  At stride 2 on an even
  size the low pad is 0, where torch's ``padding=k//2`` pads both sides;
- ``max_pool(..., padding="SAME")`` pads with -inf by the same rule;
- ``GroupNorm``'s epsilon is 1e-6 (torch's 1e-5), its statistics and its
  affine step are computed in f32 and the result cast to the dtype.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

GN_GROUPS = 32
GN_EPS = 1e-6


def same_pads(n: int, k: int, stride: int = 1,
              dilation: int = 1) -> Tuple[int, int]:
    """(low, high) padding of one spatial dim under Flax's "SAME"."""
    out = -(-n // stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - n, 0)
    return total // 2, total - total // 2


def conv2d_same(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                dilation: int = 1, bias=None) -> torch.Tensor:
    """A conv of NCHW ``x`` by OIHW ``w`` with Flax's "SAME" padding: the
    conv's own padding where both sides agree, else an explicit pad."""
    ph = same_pads(x.shape[2], w.shape[2], stride, dilation)
    pw = same_pads(x.shape[3], w.shape[3], stride, dilation)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, w, bias, stride, (ph[0], pw[0]), dilation)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, w, bias, stride, 0, dilation)


def max_pool_same(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """Flax's ``max_pool(x, (k, k), (stride, stride), padding="SAME")``:
    padded with -inf."""
    ph = same_pads(x.shape[2], k, stride)
    pw = same_pads(x.shape[3], k, stride)
    if ph[0] == ph[1] and pw[0] == pw[1] and max(ph[0], pw[0]) <= k // 2:
        return F.max_pool2d(x, k, stride, (ph[0], pw[0]))
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, k, stride)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               dtype: torch.dtype, groups: int = GN_GROUPS,
               eps: float = GN_EPS) -> torch.Tensor:
    """Flax's ``GroupNorm(num_groups=groups, dtype=dtype)`` of NCHW ``x``:
    mean and variance over (H, W, C/groups) in f32, then
    (x - mean)·rsqrt(var + eps)·scale + bias in f32, cast to ``dtype``.
    Works on the NHWC view, which a channels_last ``x`` is without a
    copy, and returns channels_last."""
    n, c, h, w = x.shape
    view = x.permute(0, 2, 3, 1).reshape(n, h * w, groups, c // groups)
    var, mean = torch.var_mean(view.float(), dim=(1, 3), correction=0,
                               keepdim=True)
    scale = torch.rsqrt(var + eps) * weight.view(groups, c // groups)
    shift = bias.view(groups, c // groups) - mean * scale
    y = torch.addcmul(shift, view, scale).to(dtype)
    return y.view(n, h, w, c).permute(0, 3, 1, 2)


class Conv(nn.Module):
    """Flax ``nn.Conv(features, (k, k), stride, padding="SAME",
    kernel_dilation=dilation)``: an f32 OIHW kernel kept channels_last,
    an optional f32 bias; both cast to the compute dtype at each call."""

    def __init__(self, c_in: int, c_out: int, k: int, stride: int = 1,
                 dilation: int = 1, bias: bool = False, device=None) -> None:
        super().__init__()
        self.stride, self.dilation = stride, dilation
        self.weight = nn.Parameter(torch.empty(
            c_out, c_in, k, k, device=device,
            memory_format=torch.channels_last))
        self.bias = (nn.Parameter(torch.zeros(c_out, device=device))
                     if bias else None)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(dtype)
        return conv2d_same(x.to(dtype), self.weight.to(dtype), self.stride,
                           self.dilation, bias)


class GroupNorm(nn.Module):
    """Flax ``nn.GroupNorm(num_groups=32)``: f32 scale (``weight``) and
    bias; see :func:`group_norm`."""

    def __init__(self, channels: int, device=None) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias, dtype)


class Dense(nn.Module):
    """Flax ``nn.Dense(features)``: an f32 [out, in] weight and bias, cast
    with the input to the compute dtype at each call."""

    def __init__(self, c_in: int, c_out: int, device=None) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_out, c_in, device=device))
        self.bias = nn.Parameter(torch.zeros(c_out, device=device))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return F.linear(x.to(dtype), self.weight.to(dtype),
                        self.bias.to(dtype))


def dtype_of(name) -> torch.dtype:
    """A config's dtype name ("bfloat16", "float32") as a torch dtype."""
    return name if isinstance(name, torch.dtype) else getattr(torch, name)
