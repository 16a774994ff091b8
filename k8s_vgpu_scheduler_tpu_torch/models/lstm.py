"""LSTM sequence classifier — benchmark model 5.x (BASELINE.md tests
5.1/5.2: batch 100, sequence 1024, hidden 300), in PyTorch.

Port of the JAX package's models/lstm.py: one LSTM layer over the
sequence (``nn.LSTM``'s parameters and op, batch first), then an f32
classifier on the last step's output.  The weights are f32 and cast to
the compute dtype at each call.  On the card the bf16 path does not
reach cuDNN's RNN: it runs torch's own cell, two launches a time step
(PERF.md §6).  Flax's ``OptimizedLSTMCell`` under ``dtype=bf16``
computes its gates in bf16 but keeps its carry (c, h) and outputs in
f32; the port's bf16 path keeps them in bf16, so the two agree closely
only in f32 (tests/test_torch_vision_models.py), and chip_smoke.py
measures the bf16 path's distance from the f32 one.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from .layers import Dense, dtype_of


class LSTMClassifier(nn.Module):
    def __init__(self, hidden: int = 300, num_classes: int = 2,
                 features: int = 300, dtype: str = "bfloat16",
                 device="cuda") -> None:
        """``features``: the input's last dim, which Flax reads from its
        init sample."""
        super().__init__()
        dev = resolve_device(device)
        self.hidden = hidden
        self.num_classes = num_classes
        self.dtype = dtype_of(dtype)
        self.lstm = nn.LSTM(features, hidden, batch_first=True, device=dev)
        # Flax's cell has one bias (on the hidden kernels): torch's input
        # bias stays zero and out of training.
        self.lstm.bias_ih_l0.requires_grad_(False)
        self.classifier = Dense(hidden, num_classes, dev)

    def forward(self, x: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Logits (f32) of ``x`` [batch, seq, features], computed in
        ``dtype`` (default the model's; float32 is the plain f32 path)."""
        dtype = dtype or self.dtype
        x = x.to(dtype)
        zeros = x.new_zeros(1, x.shape[0], self.hidden)
        weights = [w.to(dtype) for w in self.lstm.all_weights[0]]
        y, _, _ = torch.lstm(x, (zeros, zeros), weights, True, 1, 0.0,
                             self.training, False, True)
        return self.classifier(y[:, -1], torch.float32)
