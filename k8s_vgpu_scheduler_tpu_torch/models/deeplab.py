"""DeepLab-v3 semantic segmentation — benchmark model 4.x, in PyTorch.

Port of the JAX package's models/deeplab.py (BASELINE.md tests 4.1/4.2)
with its parameter tree: a ResNet-V2 backbone at output stride 16 (the
last stage atrous at dilation 2), an ASPP head (a 1x1 branch, three
dilated 3x3 branches and an image-level branch broadcast back), GN, ReLU
and a projection, an f32 classifier, and bilinear upsampling to the
input's size.  NHWC in and out, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .layers import Conv, GroupNorm, dtype_of, max_pool_same
from .resnet import add_stages


@dataclasses.dataclass(frozen=True)
class DeepLabConfig:
    backbone_stages: Tuple[int, ...] = (3, 4, 6, 3)  # ResNet-V2-50
    num_classes: int = 21  # PASCAL VOC
    width: int = 64
    aspp_features: int = 256
    atrous_rates: Tuple[int, ...] = (6, 12, 18)
    dtype: str = "bfloat16"


def deeplab_v3() -> DeepLabConfig:
    return DeepLabConfig()


class ASPP(nn.Module):
    """Atrous Spatial Pyramid Pooling: 1x1 + dilated 3x3 branches +
    image-level pooling, concatenated and projected."""

    def __init__(self, c_in: int, features: int, rates, device=None) -> None:
        super().__init__()
        self.b0 = Conv(c_in, features, 1, device=device)
        self.n_rates = len(rates)
        for i, rate in enumerate(rates):
            self.add_module(f"b{i + 1}", Conv(c_in, features, 3,
                                              dilation=rate, device=device))
        self.pool_proj = Conv(c_in, features, 1, device=device)
        self.proj_gn = GroupNorm(features * (len(rates) + 2), device)
        self.proj = Conv(features * (len(rates) + 2), features, 1,
                         device=device)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        n, _, h, w = x.shape
        branches = [getattr(self, f"b{i}")(x, dtype)
                    for i in range(self.n_rates + 1)]
        # The image-level branch: mean, 1x1 conv, broadcast (no resize).
        pooled = self.pool_proj(x.mean((2, 3), keepdim=True), dtype)
        branches.append(pooled.expand(n, -1, h, w))
        # Concatenated on the channels of the NHWC views: channels_last.
        y = torch.cat([b.permute(0, 2, 3, 1) for b in branches], dim=-1)
        y = F.relu(self.proj_gn(y.permute(0, 3, 1, 2), dtype))
        return self.proj(y, dtype)


class DeepLabV3(nn.Module):
    def __init__(self, cfg: DeepLabConfig, device="cuda") -> None:
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.dtype = dtype_of(cfg.dtype)
        self.stem = Conv(3, cfg.width, 7, 2, device=dev)
        self.blocks = add_stages(self, cfg.backbone_stages, cfg.width, dev,
                                 atrous_last=True)
        c_out = cfg.width * 2 ** (len(cfg.backbone_stages) - 1) * 4
        self.backbone_gn = GroupNorm(c_out, dev)
        self.aspp = ASPP(c_out, cfg.aspp_features, cfg.atrous_rates, dev)
        self.classifier = Conv(cfg.aspp_features, cfg.num_classes, 1,
                               bias=True, device=dev)

    def forward(self, x: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Per-pixel logits (f32, NHWC at the input's size) of NHWC images
        ``x``, computed in ``dtype`` (default ``cfg.dtype``; float32 is
        the plain f32 path of the same weights)."""
        dtype = dtype or self.dtype
        size = x.shape[1:3]
        x = self.stem(x.permute(0, 3, 1, 2).to(dtype), dtype)
        x = max_pool_same(x, 3, 2)
        for name in self.blocks:
            x = getattr(self, name)(x, dtype)
        x = F.relu(self.backbone_gn(x, dtype))
        logits = self.classifier(self.aspp(x, dtype), torch.float32)
        # align_corners=False matches jax.image.resize's "bilinear" when
        # upsampling, which is all this does (its antialiasing acts only
        # when shrinking).
        up = F.interpolate(logits, size=size, mode="bilinear",
                           align_corners=False)
        return up.permute(0, 2, 3, 1)
