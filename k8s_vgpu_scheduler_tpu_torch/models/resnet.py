"""ResNet-V2 (pre-activation) — benchmark models 1.x/2.x, in PyTorch.

Port of the JAX package's models/resnet.py (BASELINE.md tests 1.1–2.2:
ResNet-V2-50 and ResNet-V2-152) with its parameter tree: f32 parameters,
convs and GroupNorm outputs in ``cfg.dtype``, the classifier in f32.
Inputs are NHWC, as in JAX; inside, activations are NCHW laid out
channels_last (models/layers.py).  Weights come from :mod:`.convert`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .layers import Conv, Dense, GroupNorm, dtype_of, max_pool_same


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Tuple[int, ...]
    num_classes: int = 1000
    width: int = 64
    dtype: str = "bfloat16"


def resnet_v2_50() -> ResNetConfig:
    return ResNetConfig(stage_sizes=(3, 4, 6, 3))


def resnet_v2_152() -> ResNetConfig:
    return ResNetConfig(stage_sizes=(3, 8, 36, 3))


class PreActBottleneck(nn.Module):
    """GN-ReLU-conv x3 with a projected shortcut where the width or the
    stride changes.  ``dilation`` > 1 (DeepLab's atrous last stage)
    dilates the 3x3 conv instead of striding."""

    def __init__(self, c_in: int, features: int, stride: int = 1,
                 dilation: int = 1, device=None) -> None:
        super().__init__()
        self.gn1 = GroupNorm(c_in, device)
        self.proj = (Conv(c_in, features * 4, 1, stride, device=device)
                     if c_in != features * 4 or stride != 1 else None)
        self.conv1 = Conv(c_in, features, 1, device=device)
        self.gn2 = GroupNorm(features, device)
        self.conv2 = Conv(features, features, 3, stride, dilation,
                          device=device)
        self.gn3 = GroupNorm(features, device)
        self.conv3 = Conv(features, features * 4, 1, device=device)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = F.relu(self.gn1(x, dtype))
        shortcut = x if self.proj is None else self.proj(y, dtype)
        y = F.relu(self.gn2(self.conv1(y, dtype), dtype))
        y = F.relu(self.gn3(self.conv2(y, dtype), dtype))
        return shortcut + self.conv3(y, dtype)


def add_stages(module: nn.Module, stage_sizes, width: int, device,
               atrous_last: bool = False) -> list:
    """Add the bottleneck stages to ``module`` under Flax's names
    (``stage{s}_block{b}``); stages after the first stride 2 in their
    first block, except an atrous last stage (dilation 2, stride 1).
    Returns the block names in order."""
    names, c_in = [], width
    last = len(stage_sizes) - 1
    for stage, n_blocks in enumerate(stage_sizes):
        features = width * 2 ** stage
        for block in range(n_blocks):
            atrous = atrous_last and stage == last
            stride = 2 if stage > 0 and block == 0 and not atrous else 1
            name = f"stage{stage}_block{block}"
            module.add_module(name, PreActBottleneck(
                c_in, features, stride, 2 if atrous else 1, device))
            names.append(name)
            c_in = features * 4
    return names


class ResNetV2(nn.Module):
    def __init__(self, cfg: ResNetConfig, device="cuda") -> None:
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.dtype = dtype_of(cfg.dtype)
        self.stem = Conv(3, cfg.width, 7, 2, device=dev)
        self.blocks = add_stages(self, cfg.stage_sizes, cfg.width, dev)
        c_out = cfg.width * 2 ** (len(cfg.stage_sizes) - 1) * 4
        self.final_gn = GroupNorm(c_out, dev)
        self.classifier = Dense(c_out, cfg.num_classes, dev)

    def forward(self, x: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Logits (f32) of NHWC images ``x``, computed in ``dtype``
        (default ``cfg.dtype``; float32 is the plain f32 path of the same
        weights)."""
        dtype = dtype or self.dtype
        x = self.stem(x.permute(0, 3, 1, 2).to(dtype), dtype)
        x = max_pool_same(x, 3, 2)
        for name in self.blocks:
            x = getattr(self, name)(x, dtype)
        x = F.relu(self.final_gn(x, dtype))
        return self.classifier(x.mean((2, 3)), torch.float32)
