"""Flash attention over (B, T, H, d) tensors: hand-written CUDA kernels
for the forward (csrc/flash_fwd.cu) and the backward (csrc/flash_bwd.cu),
each beside its plain PyTorch version.

The kernels port the Pallas TPU kernels of the JAX package
(k8s_vgpu_scheduler_tpu/ops/flash_attention.py): ``_kernel`` (forward),
``_dq_kernel`` and ``_dkv_kernel`` (backward, joined to the forward by
the ``_flash`` custom VJP there and by :class:`_Flash` here).  Dispatch
goes by the tensor's device: a CPU tensor takes the plain version, a CUDA
tensor launches the kernel or raises.  There is no fallback between the
two.
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


def _delta(o, do) -> torch.Tensor:
    """Δ = rowsum(dO ⊙ O) in f32 over the stored dtypes (a bf16 O is the
    rounded one, as in JAX), as (B, H, T)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def _recompute(q, k, v, do, lse, delta, sm_scale: float, causal: bool,
               window: int):
    """The backward's recomputation in f32 on upcast inputs: scale·Q,
    P = exp(scale·QKᵀ − lse) with the finite mask, and
    dS = P ⊙ (dO Vᵀ − Δ), each (B, H, T, T) but scale·Q."""
    qs = q.float() * sm_scale
    s = torch.einsum("bthd,bshd->bhts", qs, k.float())
    keep = _mask(q.shape[1], causal, window, q.device)
    if keep is not None:
        s = torch.where(keep, s, torch.full((), NEG_INF, device=q.device))
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bthd,bshd->bhts", do.float(), v.float())
    return qs, p, p * (dp - delta[..., None])


def _dq_reference(q, k, v, do, lse, delta, sm_scale: float, causal: bool,
                  window: int = 0):
    """Plain dQ = scale · dS K (``_dq_kernel``), in q's dtype: the CPU path
    and the oracle the dQ kernel is held to."""
    _, _, ds = _recompute(q, k, v, do, lse, delta, sm_scale, causal, window)
    dq = torch.einsum("bhts,bshd->bthd", ds, k.float()) * sm_scale
    return dq.to(q.dtype)


def _dkv_reference(q, k, v, do, lse, delta, sm_scale: float, causal: bool,
                   window: int = 0):
    """Plain dK = dSᵀ (scale·Q) and dV = Pᵀ dO (``_dkv_kernel``), in k's
    and v's dtypes: the CPU path and the oracle the dK/dV kernel is held
    to."""
    qs, p, ds = _recompute(q, k, v, do, lse, delta, sm_scale, causal, window)
    dk = torch.einsum("bhts,bthd->bshd", ds, qs)
    dv = torch.einsum("bhts,bthd->bshd", p, do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)


def _cp_async_fault(t) -> Optional[str]:
    """Why the bf16 tensor-core kernels, which copy 16 bytes at a time with
    ``cp.async``, cannot read ``t``; None if they can (or ``t`` is not
    bf16).  They need 16-byte aligned data and batch, token and head
    strides that are multiples of 8 elements (a dimension of size 1 is
    never stepped)."""
    if t.dtype != torch.bfloat16:
        return None
    if t.data_ptr() % 16:
        return "data must be 16-byte aligned"
    if any(t.stride(i) % 8 for i in range(3) if t.shape[i] > 1):
        return (f"batch, token and head strides must be multiples of 8 "
                f"elements, not {t.stride()[:3]}")
    return None


def _check(q, **others) -> None:
    """What every kernel takes: f32 or bf16, a head_dim it was built for,
    operands of q's shape, dtype and device, a contiguous head dim; and
    bf16 operands the tensor-core kernels can copy (:func:`_cp_async_fault`).
    The f32 kernels take any layout with a contiguous head dim."""
    d = q.shape[-1]
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash kernel takes float32 or bfloat16, "
                        f"not {q.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {_HEAD_DIMS}, "
                         f"not {d}")
    for name, t in others.items():
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q in shape, dtype and "
                             f"device")
    for name, t in dict(q=q, **others).items():
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s head dimension must be contiguous")
        fault = _cp_async_fault(t)
        if fault:
            raise ValueError(f"{name}'s {fault}")


def _check_rows(q, **rows) -> None:
    """lse and Δ: contiguous (B, H, T) f32 on q's device."""
    B, T, H, _ = q.shape
    for name, t in rows.items():
        if (t.shape != (B, H, T) or t.dtype != torch.float32
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous (B, H, T) f32 "
                             f"tensor on q's device")


def _strides(*ts):
    return [s for t in ts for s in (t.stride(0), t.stride(1), t.stride(2))]


def _call(name: str, counter, device, *args) -> None:
    """Build (first use) and launch kernel ``name`` on the current stream
    of ``device``; raise if the launch was refused; count it."""
    fn = getattr(_kernels, name)()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    counter.launches += 1


def _launch(q, k, v, sm_scale: float, causal: bool, window: int,
            return_lse: bool):
    B, T, H, d = q.shape
    _check(q, k=k, v=v)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = (torch.empty((B, H, T), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if T == 0:
        return (out, lse) if return_lse else out
    _call("flash_fwd", flash_attention, q.device,
          q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
          lse.data_ptr() if lse is not None else None,
          _DTYPES[q.dtype], B, T, H, d, *_strides(q, k, v, out),
          float(sm_scale), int(causal), int(window))
    return (out, lse) if return_lse else out


def _launch_dq(q, k, v, do, lse, delta, sm_scale: float, causal: bool,
               window: int):
    B, T, H, d = q.shape
    _check(q, k=k, v=v, do=do)
    _check_rows(q, lse=lse, delta=delta)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    if T == 0:
        return dq
    _call("flash_bwd_dq", flash_bwd_dq, q.device,
          q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
          lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
          _DTYPES[q.dtype], B, T, H, d, *_strides(q, k, v, do, dq),
          float(sm_scale), int(causal), int(window))
    return dq


def _launch_dkv(q, k, v, do, lse, delta, sm_scale: float, causal: bool,
                window: int):
    B, T, H, d = q.shape
    _check(q, k=k, v=v, do=do)
    _check_rows(q, lse=lse, delta=delta)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    if T == 0:
        return dk, dv
    _call("flash_bwd_dkv", flash_bwd_dkv, q.device,
          q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
          lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
          _DTYPES[q.dtype], B, T, H, d, *_strides(q, k, v, do, dk, dv),
          float(sm_scale), int(causal), int(window))
    return dk, dv


def _on_device(kernel, plain, q, *args):
    """The plain version for a CPU tensor, the kernel for a CUDA one."""
    if q.device.type == "cpu":
        return plain(q, *args)
    if q.device.type == "cuda":
        return kernel(q, *args)
    raise ValueError(f"flash attention runs on cpu or cuda, not "
                     f"{q.device.type}")


def flash_bwd_dq(q, k, v, do, lse, delta, sm_scale: float, causal: bool,
                 window: int = 0):
    """dQ of flash attention from the forward's lse and Δ = rowsum(dO ⊙ O),
    both (B, H, T) f32.  ``flash_bwd_dq.launches`` counts kernel launches."""
    return _on_device(_launch_dq, _dq_reference, q, k, v, do, lse, delta,
                      sm_scale, causal, window)


def flash_bwd_dkv(q, k, v, do, lse, delta, sm_scale: float, causal: bool,
                  window: int = 0):
    """(dK, dV) of flash attention, as :func:`flash_bwd_dq` takes them.
    ``flash_bwd_dkv.launches`` counts kernel launches."""
    return _on_device(_launch_dkv, _dkv_reference, q, k, v, do, lse, delta,
                      sm_scale, causal, window)


flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


def _forward(q, k, v, sm_scale: float, causal: bool, window: int,
             return_lse: bool):
    return _on_device(_launch, _reference, q, k, v, sm_scale, causal,
                      window, return_lse)


class _Flash(torch.autograd.Function):
    """Flash attention with its backward (the JAX package's ``_flash``
    custom VJP): the forward keeps O and lse; the backward computes Δ, then
    dQ, then dK/dV, each on the tensor's device."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale, causal, window):
        out, lse = _forward(q, k, v, sm_scale, causal, window, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.attrs = (sm_scale, causal, window)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        """Δ, dQ and dK/dV from the incoming dO.  q, k and v are the
        forward's, already checked; a dO the kernels cannot read (head
        dimension not contiguous, or a bf16 layout that breaks the 16-byte
        ``cp.async`` rule) is first copied into a fresh contiguous tensor:
        a layout copy, after which the kernels run as usual."""
        q, k, v, out, lse = ctx.saved_tensors
        sm_scale, causal, window = ctx.attrs
        if do.stride(-1) != 1 or _cp_async_fault(do):
            do = do.clone(memory_format=torch.contiguous_format)
        delta = _delta(out, do)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, sm_scale, causal, window)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, sm_scale, causal,
                               window)
        return dq, dk, dv, None, None, None


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
    per-row logsumexp as (B, H, T) f32.  Where grad is needed the call
    goes through :class:`_Flash`, whose backward runs the backward kernels.

    ``flash_attention.launches`` counts forward kernel launches.
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
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        out, lse = _Flash.apply(q, k, v, sm_scale, causal, window)
        return (out, lse) if return_lse else out
    return _forward(q, k, v, sm_scale, causal, window, return_lse)


flash_attention.launches = 0
