"""Autoregressive generation for the port's flagship decoder.

Port of the JAX package's models/generate.py ``generate``: one prefill
pass (optionally in chunks) writes the prompt's keys/values into the
per-layer KV cache, then one token per step.  PyTorch runs eagerly, so the
step loop is a Python loop where JAX has ``lax.scan``.

Sampling: greedy (temperature 0) or temperature sampling with optional
top-k / top-p truncation, drawn from a ``torch.Generator`` (not the
numbers ``jax.random`` draws).  Ragged batches: LEFT-pad prompts and pass
``prompt_lens``.
"""

from __future__ import annotations

from typing import Optional

import torch

from .llama import Llama, PAD_POSITION


def _truncate_logits(logits, temperature: float, top_k: int = 0,
                     top_p: float = 0.0):
    """Temperature-scaled f32 logits with top-k and/or nucleus (top-p)
    truncation applied as -inf masks."""
    logits = logits.float() / temperature
    if 0 < top_k < logits.shape[-1]:
        kth = torch.sort(logits, dim=-1).values[..., -top_k][..., None]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if 0.0 < top_p < 1.0:
        # Keep the smallest prefix of descending-prob tokens whose mass
        # reaches p (always at least the top token).
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < top_p  # mass BEFORE token i is < p
        cutoff = sorted_logits.masked_fill(~keep, float("-inf")).amax(
            dim=-1, keepdim=True)  # smallest kept logit
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    return logits


def _sample(logits, temperature: float,
            generator: Optional[torch.Generator],
            top_k: int = 0, top_p: float = 0.0):
    """Greedy (temperature 0), else a categorical draw from the truncated
    logits.  logits [..., V] -> int64 tokens [...]."""
    if temperature == 0.0 or generator is None:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(_truncate_logits(logits, temperature, top_k,
                                           top_p), dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    draw = torch.multinomial(flat, 1, generator=generator)
    return draw.reshape(probs.shape[:-1])


@torch.inference_mode()
def generate(model: Llama, prompt: torch.Tensor, max_new_tokens: int,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             prompt_lens: Optional[torch.Tensor] = None,
             prefill_chunk: Optional[int] = None,
             top_k: int = 0, top_p: float = 0.0) -> torch.Tensor:
    """prompt: [B, P] tokens on the model's device -> [B, P + new] tokens.

    ``prompt_lens`` [B]: real length of each LEFT-padded row (defaults to
    P).  ``prefill_chunk``: feed the prompt through the cache in chunks of
    this size (must divide P; ignored otherwise) — later chunks attend
    earlier ones through the cache.
    """
    if temperature != 0.0 and generator is None:
        raise ValueError("temperature sampling requires a generator")
    if max_new_tokens <= 0:
        return prompt
    dev = model.device
    prompt = prompt.to(dev).long()
    B, P = prompt.shape
    total = P + max_new_tokens
    if prompt_lens is None:
        prompt_lens = torch.full((B,), P, dtype=torch.long, device=dev)
    # Out-of-range lengths would silently shift every RoPE phase.
    prompt_lens = prompt_lens.to(dev).long().clamp(1, P)
    pad = P - prompt_lens                                    # [B]
    slots = torch.arange(P, device=dev)
    # Row b's first real token sits at slot pad_b with logical position 0;
    # pad slots carry the sentinel so no real query ever attends them.
    positions = torch.where(slots[None, :] >= pad[:, None],
                            slots[None, :] - pad[:, None],
                            torch.full((), PAD_POSITION, device=dev))
    # One slot->position map shared by every layer.
    key_pos = torch.full((B, total), PAD_POSITION, dtype=torch.long,
                         device=dev)
    key_pos[:, :P] = positions
    cache = model.new_cache(B, total)
    if prefill_chunk and 0 < prefill_chunk < P and P % prefill_chunk == 0:
        for c0 in range(0, P, prefill_chunk):
            logits = model(prompt[:, c0:c0 + prefill_chunk],
                           positions[:, c0:c0 + prefill_chunk], key_pos,
                           cache=cache)
    else:
        logits = model(prompt, positions, key_pos, cache=cache)
    tok = _sample(logits[:, -1], temperature, generator, top_k, top_p)
    out = [tok]
    # n-1 steps: the prefill already produced token 1.
    for i in range(max_new_tokens - 1):
        pos = (prompt_lens + i)[:, None]  # each row's own sequence
        key_pos[:, P + i] = pos[:, 0]
        logits = model(tok[:, None], pos, key_pos, cache=cache)
        tok = _sample(logits[:, -1], temperature, generator, top_k, top_p)
        out.append(tok)
    return torch.cat([prompt, torch.stack(out, dim=1)], dim=1)
