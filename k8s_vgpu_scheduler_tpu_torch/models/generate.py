"""Autoregressive generation for the port's flagship decoder.

Port of the JAX package's models/generate.py ``generate``: one prefill
pass (optionally in chunks) writes the prompt's keys/values into the
per-layer KV cache, then one token per step.  PyTorch runs eagerly, so the
step loop is a Python loop where JAX has ``lax.scan``.

Sampling: greedy (temperature 0) or temperature sampling with optional
top-k / top-p truncation, drawn from a ``torch.Generator`` (not the
numbers ``jax.random`` draws).  Ragged batches: LEFT-pad prompts and pass
``prompt_lens``.

:func:`speculative_generate` is the JAX package's greedy speculative
decoding: a draft model proposes k tokens, one target forward verifies
them.
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


def _rewind(cache, n_ctx: int) -> None:
    """Set every layer's append index to ``n_ctx`` (the JAX
    ``_set_cache_idx``).  Slots past it keep the keys of rejected tokens:
    their positions lie above every query that reads the cache before they
    are written again, so the mask ``key_pos <= q_pos`` hides them."""
    for layer in cache:
        layer.idx = n_ctx


@torch.inference_mode()
def speculative_generate(model: Llama, draft: Llama, prompt: torch.Tensor,
                         max_new_tokens: int, k: int = 4):
    """Greedy speculative decoding of one sequence (B = 1).

    The draft proposes ``k`` tokens one at a time; the target verifies all
    of them in ONE forward over k + 1 positions and keeps the longest
    agreeing prefix plus its own next token, so each target forward emits
    between 1 and k + 1 tokens.  Greedy acceptance makes the output the
    tokens of greedy :func:`generate` whatever the draft, up to argmax
    near-ties that the 1-token and the (k + 1)-token forwards may break
    differently in low precision.

    Returns ``(tokens [1, P + max_new_tokens], stats)``; ``stats`` holds
    ``target_forwards`` (the prefill excluded), ``drafted`` and
    ``accepted`` as ints.  The round loop is a Python ``while`` where the
    JAX function has ``lax.while_loop``, and it reads the accepted count
    back once a round.  The port has no ``jit_generate``, so JAX's
    ``jit_speculative_generate`` has no counterpart here.
    """
    dev = model.device
    prompt = prompt.to(dev).long()
    B, P = prompt.shape
    if B != 1:
        raise ValueError("speculative decoding serves one sequence (B=1); "
                         "batch serving uses generate()")
    if draft.device != dev:
        raise ValueError(f"the draft is on {draft.device}, the target on "
                         f"{dev}")
    stats = {"target_forwards": 0, "drafted": 0, "accepted": 0}
    if max_new_tokens <= 0:
        return prompt, stats
    total = P + max_new_tokens + k + 1  # verify-overshoot slack
    # B = 1, no padding: slot == logical position, so one constant map
    # serves every round.
    key_pos = torch.arange(total, device=dev)[None]
    tcache = model.new_cache(1, total)
    dcache = draft.new_cache(1, total)
    logits = model(prompt, key_pos[:, :P], key_pos, cache=tcache)
    draft(prompt, key_pos[:, :P], key_pos, cache=dcache)
    pending = torch.argmax(logits[:, -1], dim=-1, keepdim=True)  # [1, 1]
    out = [pending]
    n_out, n_ctx = 1, P
    while n_out < max_new_tokens:
        # 1) k draft tokens from the pending (emitted, not yet cached) one.
        _rewind(dcache, n_ctx)
        tok, drafts = pending, []
        for j in range(k):
            lg = draft(tok, key_pos[:, n_ctx + j:n_ctx + j + 1], key_pos,
                       cache=dcache)
            tok = torch.argmax(lg[:, -1], dim=-1, keepdim=True)
            drafts.append(tok)
        drafts = torch.cat(drafts, dim=1)                       # [1, k]
        # 2) One target forward over pending + the k drafts.
        _rewind(tcache, n_ctx)
        lg = model(torch.cat([pending, drafts], dim=1),
                   key_pos[:, n_ctx:n_ctx + k + 1], key_pos, cache=tcache)
        tpred = torch.argmax(lg[0], dim=-1)                     # [k + 1]
        # 3) The longest agreeing prefix, then the target's own token.
        m = int(torch.cumprod((drafts[0] == tpred[:k]).long(), 0).sum())
        out.extend([drafts[:, :m], tpred[m:m + 1][None]])
        pending = tpred[m:m + 1][None]
        n_out += m + 1
        n_ctx += m + 1
        stats["target_forwards"] += 1
        stats["accepted"] += m
    stats["drafted"] = stats["target_forwards"] * k
    new = torch.cat(out, dim=1)[:, :max_new_tokens]
    return torch.cat([prompt, new], dim=1), stats
