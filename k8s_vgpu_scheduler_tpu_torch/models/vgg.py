"""VGG-16 — benchmark model 3.x (BASELINE.md tests 3.1/3.2), in PyTorch.

Port of the JAX package's models/vgg.py with its parameter tree: f32
parameters, convs and ``fc1``/``fc2`` in ``dtype``, ``fc3`` in f32.  The
flatten before ``fc1`` follows JAX's NHWC order (h, w, c), so ``fc1``'s
rows are Flax's as they are.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .layers import Conv, Dense, dtype_of

VGG16_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


class VGG16(nn.Module):
    def __init__(self, num_classes: int = 1000, dtype: str = "bfloat16",
                 size: int = 224, device="cuda") -> None:
        """``size``: the square input's side, which fixes ``fc1``'s width
        ((size // 32)² x 512), as Flax's init does from its sample."""
        super().__init__()
        dev = resolve_device(device)
        self.num_classes = num_classes
        self.dtype = dtype_of(dtype)
        self.convs, c_in = [], 3
        for si, (feats, n) in enumerate(VGG16_STAGES):
            for ci in range(n):
                name = f"conv{si}_{ci}"
                self.add_module(name, Conv(c_in, feats, 3, bias=True,
                                           device=dev))
                self.convs.append((name, ci == n - 1))
                c_in = feats
        side = size >> len(VGG16_STAGES)
        self.fc1 = Dense(side * side * c_in, 4096, dev)
        self.fc2 = Dense(4096, 4096, dev)
        self.fc3 = Dense(4096, num_classes, dev)

    def forward(self, x: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Logits (f32) of NHWC images ``x``, computed in ``dtype``
        (default the model's; float32 is the plain f32 path)."""
        dtype = dtype or self.dtype
        x = x.permute(0, 3, 1, 2).to(dtype)
        for name, pool in self.convs:
            x = F.relu(getattr(self, name)(x, dtype))
            if pool:
                x = F.max_pool2d(x, 2, 2)  # Flax's default "VALID"
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # (h, w, c)
        x = F.relu(self.fc1(x, dtype))
        x = F.relu(self.fc2(x, dtype))
        return self.fc3(x, torch.float32)
