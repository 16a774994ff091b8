"""Plain full attention, the ``attention="full"`` path of the flagship.

The port's own copy of ``_block_attn`` and ``full_attention_reference``
from the JAX package's parallel/ring.py.  Ring attention itself (K/V
rotation over devices) arrives with the multi-device slice.
"""

from __future__ import annotations

from typing import Optional

import torch


def _block_attn(q, k, v, q_offset: int, kv_offset: int, causal: bool,
                sm_scale: float):
    """One (q-shard x kv-block) partial attention.

    Returns (unnormalized_out, row_max, row_sumexp) in f32.
    q: [B, Tq, H, D]  k/v: [B, Tk, H, D].  As in the reference, the logits
    are formed in the input dtype before the f32 upcast, and P is cast to
    v's dtype for P·V — so in bf16 this differs from the flash kernel by
    more than the kernel's own error.
    """
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * sm_scale
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        qpos = q_offset + torch.arange(tq, device=q.device)[:, None]
        kpos = kv_offset + torch.arange(tk, device=q.device)[None, :]
        logits = logits.masked_fill(~(qpos >= kpos), float("-inf"))
    m = logits.amax(dim=-1)  # [B,H,Tq]
    # Guard fully-masked rows (exp(-inf - -inf)).
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(logits - m_safe[..., None])
    p = torch.where(torch.isfinite(logits), p, torch.zeros_like(p))
    l = p.sum(dim=-1)  # [B,H,Tq]
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v).float()
    return out, m_safe, l


def full_attention_reference(q, k, v, causal: bool = True,
                             sm_scale: Optional[float] = None):
    """Unsharded attention over [B, T, H, D]; same layout out."""
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    out, _, l = _block_attn(q, k, v, 0, 0, causal, sm_scale)
    l = l.clamp_min(1e-20)
    return (out / l.transpose(1, 2)[..., None]).to(q.dtype)
