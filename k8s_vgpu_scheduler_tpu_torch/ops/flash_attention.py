"""Flash attention over (B, T, H, d) tensors: a hand-written CUDA kernel
(csrc/flash_fwd.cu) and its plain PyTorch version.

The kernel ports the Pallas TPU forward kernel of the JAX package
(k8s_vgpu_scheduler_tpu/ops/flash_attention.py, ``_kernel``).  Dispatch
goes by the tensor's device: a CPU tensor takes the plain version
:func:`_reference`, a CUDA tensor launches the kernel or raises.  There is
no fallback between the two.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _kernels

# Finite mask value, as in the TPU kernel: a fully masked tile yields
# exp(0) weights that the first visible key's rescale wipes, never NaN.
NEG_INF = -1e30


def _mask(T: int, causal: bool, window: int, device) -> Optional[torch.Tensor]:
    """(T, T) keep-mask: query p sees key s iff s <= p (causal) and
    p - s < window (window > 0)."""
    if not causal and window <= 0:
        return None
    pos = torch.arange(T, device=device)
    diff = pos[:, None] - pos[None, :]
    keep = None
    if causal:
        keep = diff >= 0
    if window > 0:
        near = diff < window
        keep = near if keep is None else keep & near
    return keep


def _reference(q, k, v, sm_scale: float, causal: bool, window: int = 0,
               return_lse: bool = False):
    """Plain attention in f32: the CPU path and the oracle the kernel is
    held to.  Returns O in q's dtype, and with ``return_lse`` also the
    per-row logsumexp of the masked, scaled scores as (B, H, T) f32."""
    T = q.shape[1]
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * sm_scale
    keep = _mask(T, causal, window, q.device)
    if keep is not None:
        s = torch.where(keep, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", p, v.float()).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)


def _launch(q, k, v, sm_scale: float, causal: bool, window: int,
            return_lse: bool):
    B, T, H, d = q.shape
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash kernel takes float32 or bfloat16, "
                        f"not {q.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {_HEAD_DIMS}, "
                         f"not {d}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q in shape, dtype and "
                             f"device")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s head dimension must be contiguous")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "the flash kernel has no backward yet (training slice)")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = (torch.empty((B, H, T), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if T == 0:
        return (out, lse) if return_lse else out
    fn = _kernels.flash_fwd()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr() if lse is not None else None,
                 _DTYPES[q.dtype], B, T, H, d,
                 q.stride(0), q.stride(1), q.stride(2),
                 k.stride(0), k.stride(1), k.stride(2),
                 v.stride(0), v.stride(1), v.stride(2),
                 out.stride(0), out.stride(1), out.stride(2),
                 float(sm_scale), int(causal), int(window), stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


def flash_attention(q, k, v, *, causal: bool = True,
                    sm_scale: Optional[float] = None,
                    block_q: int = 256, block_k: int = 256,
                    window: int = 0, return_lse: bool = False):
    """Fused attention over (B, T, H, d) tensors.

    ``window > 0`` is causal sliding-window attention: query p attends keys
    in [p-window+1, p].  ``block_q``/``block_k`` are the TPU tiling knobs;
    they are accepted and clamped to T as there, and the CUDA kernel keeps
    its own tiles.  Every shape goes to the kernel, T not divisible by any
    tile included (it masks the ragged tail).  ``return_lse`` adds the
    per-row logsumexp as (B, H, T) f32.

    ``flash_attention.launches`` counts kernel launches.
    """
    B, T, H, d = q.shape
    if window > 0 and not causal:
        raise ValueError("sliding window requires causal attention")
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    block_q = min(block_q, T)
    block_k = min(block_k, T)
    if T and (block_q < 1 or block_k < 1):
        raise ValueError("block sizes must be positive")
    if q.device.type == "cpu":
        return _reference(q, k, v, sm_scale, causal, window, return_lse)
    if q.device.type == "cuda":
        return _launch(q, k, v, sm_scale, causal, window, return_lse)
    raise ValueError(f"flash_attention runs on cpu or cuda, not "
                     f"{q.device.type}")


flash_attention.launches = 0
