"""Entry point: the flagship forward and its example arguments.

Counterpart of the JAX package's ``__graft_entry__.entry()``: a
``llama_tiny`` decoder with weights from seed 0 and (2, 32) tokens of
ones.  ``forward(model, tokens)`` returns the logits.
"""

from __future__ import annotations

import torch

from .device import resolve_device
from .models.convert import init_weights
from .models.llama import llama_tiny


def entry(device="cuda"):
    dev = resolve_device(device)
    cfg = llama_tiny()
    generator = torch.Generator(device=dev).manual_seed(0)
    model = init_weights(cfg, generator, device=dev)
    tokens = torch.ones((2, 32), dtype=torch.long, device=dev)

    @torch.inference_mode()
    def forward(model, tokens):
        return model(tokens)

    return forward, (model, tokens)
