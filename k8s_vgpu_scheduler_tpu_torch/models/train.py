"""Next-token training step for the flagship model, on one device.

Port of the JAX package's models/train.py, single-device parts: the
cross-entropy loss, ``make_optimizer`` (optax's adamw behind optional
global-norm clipping, a warmup/cosine schedule and MultiSteps
accumulation, re-implemented here over lists of tensors), the train state
and step, and the optimizer-state offload to pinned host memory.  The
sharded step, ``run_preemptible`` and MoE come with later slices.

Precision: Flax keeps f32 params and casts them to ``cfg.dtype`` at every
matmul, so the gradient of an f32 param is the working-dtype gradient
cast up.  The port's :class:`~.llama.Llama` stores its weights in
``cfg.dtype`` (right for serving), so the train state keeps an f32 master
copy beside it: each step casts the working grads to f32, updates the
master copy and writes it back, rounded, into the model.  Where a param
is f32 already (every param of an f32 config, the RMSNorm scales of any)
the master copy *is* the param.  Unlike JAX, the step updates in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Tuple

import torch

from ..device import resolve_device
from ..shim.core import gated
from ..shim.oversub import host_copy
from .convert import init_weights
from .llama import Llama, LlamaConfig

# optax.adamw as make_optimizer calls it (train.py:66).  Weight decay
# applies to every param, the RMSNorm scales and the embedding included.
B1, B2, EPS, WEIGHT_DECAY = 0.9, 0.95, 1e-8, 0.1


def ce_from_logits(logits: torch.Tensor,
                   targets: torch.Tensor) -> torch.Tensor:
    """Next-token cross-entropy; logits reduced in f32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets[..., None]).squeeze(-1).mean()


def loss_fn(model: Llama, tokens: torch.Tensor) -> torch.Tensor:
    """Cross-entropy of ``tokens[:, 1:]`` given ``tokens[:, :-1]``."""
    if model.cfg.n_experts > 0:
        raise NotImplementedError(
            "the MoE loss (routers' load-balance terms) arrives with the "
            "multi-device slice (parallel/moe.py)")
    return ce_from_logits(model(tokens[:, :-1]), tokens[:, 1:])


@dataclasses.dataclass
class OptState:
    """What the optimizer carries between steps.  ``count`` is the number
    of updates applied (optax's adam and schedule count); ``acc`` the
    running mean of the micro-batch grads under accumulation (empty
    without), with ``mini_step`` of them in it."""
    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    acc: List[torch.Tensor]
    mini_step: int = 0

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "OptState":
        """A copy with ``fn`` applied to every tensor."""
        return dataclasses.replace(
            self, mu=[fn(t) for t in self.mu], nu=[fn(t) for t in self.nu],
            acc=[fn(t) for t in self.acc])


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """``make_optimizer``'s chain: AdamW (b1 0.9, b2 0.95, eps 1e-8, weight
    decay 0.1) with the JAX package's options, all off by default:

    - ``clip_norm > 0``: global-norm gradient clipping first;
    - ``warmup_steps``/``decay_steps``: linear warmup into cosine decay;
      ``warmup_steps`` alone ramps to ``lr`` and holds;
    - ``accum_steps > 1``: inside MultiSteps, k micro-batch calls apply one
      update with the mean of their grads.
    """
    lr: float = 3e-4
    _: dataclasses.KW_ONLY
    clip_norm: float = 0.0
    warmup_steps: int = 0
    decay_steps: int = 0
    accum_steps: int = 1

    def schedule(self, count: int) -> float:
        """The learning rate of update ``count`` (from 0), as optax's
        warmup_cosine_decay_schedule or warmup-then-hold join gives it."""
        lr, count = self.lr, float(count)
        if self.decay_steps:
            warmup = max(self.warmup_steps, 1)
            decay = max(self.decay_steps, warmup + 1)
            if count < warmup:
                return _linear(count, lr, warmup)
            t = min(count - warmup, decay - warmup)
            return lr * (0.5 * (1 + math.cos(math.pi * t / (decay - warmup))))
        if self.warmup_steps and count < self.warmup_steps:
            return _linear(count, lr, self.warmup_steps)
        return lr

    def init(self, params: List[torch.Tensor]) -> OptState:
        def zeros():
            return [torch.zeros_like(p) for p in params]

        return OptState(count=0, mu=zeros(), nu=zeros(),
                        acc=zeros() if self.accum_steps > 1 else [])

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: OptState,
               params: List[torch.Tensor]) -> bool:
        """Apply one step to ``params`` and ``state`` in place; return
        whether the params changed (under accumulation only every
        ``accum_steps``-th call does).  ``grads`` are f32 and are consumed."""
        if self.accum_steps > 1:
            n = state.mini_step
            for a, g in zip(state.acc, grads):
                a.add_((g - a) / (n + 1))  # MultiSteps' running mean
            if n + 1 < self.accum_steps:
                state.mini_step = n + 1
                return False
            grads, state.mini_step = state.acc, 0
        if self.clip_norm > 0:
            _clip_by_global_norm(grads, self.clip_norm)
        lr = self.schedule(state.count)
        state.count += 1
        bc1 = 1 - B1 ** state.count
        bc2 = 1 - B2 ** state.count
        for p, g, m, v in zip(params, grads, state.mu, state.nu):
            m.mul_(B1).add_(g, alpha=1 - B1)
            v.mul_(B2).addcmul_(g, g, value=1 - B2)
            step = (m / bc1).div_((v / bc2).sqrt_().add_(EPS))
            p.add_(step.add_(p, alpha=WEIGHT_DECAY), alpha=-lr)
        for a in state.acc:
            a.zero_()
        return True


def _linear(count: float, lr: float, steps: int) -> float:
    """optax.linear_schedule(0, lr, steps) before its end."""
    return (0.0 - lr) * (1 - count / steps) + lr


def _clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> None:
    """optax.clip_by_global_norm in place: scale by max/norm only when the
    norm reaches max, with no epsilon (torch's clip_grad_norm_ adds one)."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    if bool(norm < max_norm):
        return
    for g in grads:
        g.div_(norm).mul_(max_norm)


make_optimizer = Optimizer


@dataclasses.dataclass
class TrainState:
    """``params``: the f32 master copy, one tensor per parameter of the
    model in ``model.parameters()`` order (the parameter itself where it is
    f32); ``opt_state``: the optimizer's state; ``step``: calls made."""
    params: List[torch.Tensor]
    opt_state: OptState
    step: int = 0

    @classmethod
    def for_model(cls, model: Llama, optimizer: Optimizer) -> "TrainState":
        master = [p.detach() if p.dtype == torch.float32
                  else p.detach().float() for p in model.parameters()]
        return cls(master, optimizer.init(master))


def init_train_state(cfg: LlamaConfig, generator: torch.Generator,
                     device="cuda", optimizer: Optional[Optimizer] = None
                     ) -> Tuple[Llama, Optimizer, TrainState]:
    """A seeded model (:func:`..convert.init_weights`; the generator must
    live on ``device``), the optimizer (``make_optimizer()`` by default)
    and a fresh train state, on the card unless ``device`` says
    otherwise."""
    dev = resolve_device(device)
    model = init_weights(cfg, generator, device=dev)
    optimizer = make_optimizer() if optimizer is None else optimizer
    return model, optimizer, TrainState.for_model(model, optimizer)


def make_train_step(model: Llama, optimizer: Optimizer):
    """``train_step(state, tokens) -> (state, loss)``: one optimizer step
    on the next-token loss of ``tokens``.  Updates the model, the master
    copy and the optimizer state in place and returns ``state``; the loss
    is a detached device scalar (reading it waits for the step)."""
    params = list(model.parameters())

    @gated
    def train_step(state: TrainState, tokens: torch.Tensor):
        loss = loss_fn(model, tokens)
        grads = list(torch.autograd.grad(loss, params))
        for i, g in enumerate(grads):
            grads[i] = g.float()  # one at a time, freeing each as it goes
        if optimizer.update(grads, state.opt_state, state.params):
            with torch.no_grad():
                for p, master in zip(params, state.params):
                    if p.dtype != torch.float32:  # else p is the master
                        p.copy_(master)
        state.step += 1
        return state, loss.detach()

    return train_step


def _to_host(opt_state: OptState) -> OptState:
    """A host copy of ``opt_state``, pinned where it comes from the card so
    the copies both ways are plain DMA.  Returns once the copies have
    landed: a reader on the host may use it at once."""
    device = opt_state.mu[0].device if opt_state.mu else None
    host = opt_state.map(host_copy)
    if device is not None and device.type == "cuda":
        landed = torch.cuda.Event()
        landed.record(torch.cuda.current_stream(device))
        landed.synchronize()
    return host


def offload_state(state: TrainState) -> TrainState:
    """The state with its optimizer state moved to (pinned) host memory."""
    return dataclasses.replace(state, opt_state=_to_host(state.opt_state))


class OffloadedTrainStep:
    """A train step whose optimizer state lives in pinned host memory
    between steps (the reference's "virtual device memory" for training):
    it is staged onto the master copy's device for the update and written
    back after, so between steps the card holds the model and the master
    copy only.  The math is the device step's, so the trajectory is the
    same.  The step returns once the host copy is whole, which waits for
    the step itself."""

    # The JAX package also has an "in-jit" mode where XLA overlaps the
    # copies with the step; eager PyTorch has only the staged one.
    mode = "staged"

    def __init__(self, device_step):
        self._step = device_step

    @gated
    def __call__(self, state: TrainState, tokens: torch.Tensor):
        device = state.params[0].device
        state.opt_state = state.opt_state.map(
            lambda t: t.to(device, non_blocking=True))
        state, loss = self._step(state, tokens)
        state.opt_state = _to_host(state.opt_state)
        return state, loss
