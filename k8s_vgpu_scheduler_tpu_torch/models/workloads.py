"""The reference's benchmark cases on the port's models: the port's own
copy of bench.py's per-case logic (its ``CASES`` and its inference and
train steps), with nothing of its harness.

A case is one row of the ai-benchmark matrix the reference measures
(BASELINE.md tests 1.1–5.2): a model, a batch, an input size, the steps a
timed run takes, whether it trains, and the reference's vGPU-plugin
images/s on a Tesla V100 under TF 2.4 (a yardstick of that card, not of
this one).  ``grant_mib`` is the device memory a pod of the case is
granted: :func:`grant_for` its bare peak on an H100 80GB HBM3 (PERF.md
§4 has the readings).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from ..device import resolve_device
from . import convert
from .deeplab import deeplab_v3
from .resnet import resnet_v2_50, resnet_v2_152

LSTM_FEATURES = 300
LR = 0.01


@dataclasses.dataclass(frozen=True)
class Case:
    model: str  # resnet50 | resnet152 | vgg16 | deeplab | lstm
    batch: int
    size: int  # image side; the sequence length for the LSTM
    iters: int
    baseline: float  # images/s, the reference's vGPU column (V100, TF 2.4)
    train: bool
    grant_mib: int = 3000


CASES = {
    "resnet_v2_50_inference_bf16_b50_346": Case(
        "resnet50", 50, 346, 20, 141.2, False),
    "resnet_v2_152_inference_bf16_b10_256": Case(
        "resnet152", 10, 256, 20, 102.0, False),
    "resnet_v2_50_train_bf16_b20_346": Case(
        "resnet50", 20, 346, 10, 43.68, True, grant_mib=7000),
    "vgg16_inference_bf16_b20_224": Case(
        "vgg16", 20, 224, 20, 134.2, False),
    "deeplab_inference_bf16_b2_512": Case(
        "deeplab", 2, 512, 10, 8.92, False),
    "lstm_inference_bf16_b100_1024x300": Case(
        "lstm", 100, 1024, 10, 22.32, False),
    "resnet_v2_152_train_bf16_b10_256": Case(
        "resnet152", 10, 256, 10, 30.2, True, grant_mib=5000),
    "vgg16_train_bf16_b2_224": Case(
        "vgg16", 2, 224, 10, 8.62, True, grant_mib=4000),
    "deeplab_train_bf16_b1_384": Case(
        "deeplab", 1, 384, 10, 4.09, True),
    "lstm_train_bf16_b10_1024x300": Case(
        "lstm", 10, 1024, 10, 3.96, True),
}


def grant_for(peak_mib: float) -> int:
    """The grant of a case whose peak on the card (nvidia-smi, the context
    included) is ``peak_mib``: the JAX bench's 3000 MiB, unless the peak
    passes 2700 MiB; then the smallest multiple of 1000 MiB at or above
    1.2x the peak."""
    if peak_mib <= 2700:
        return 3000
    return 1000 * math.ceil(1.2 * peak_mib / 1000)


@dataclasses.dataclass
class Workload:
    """A case's model and data on one device: ``x`` NHWC bf16 images (the
    LSTM's [batch, size, 300]); ``labels`` (training only) one class per
    image or sequence, one per pixel for DeepLab."""
    case: Case
    model: torch.nn.Module
    x: torch.Tensor
    labels: Optional[torch.Tensor] = None


def build(name: str, generator: torch.Generator,
          device="cuda") -> Workload:
    """The case's model with seeded weights, its input and its labels,
    drawn from ``generator`` (which must live on ``device``)."""
    case = CASES[name]
    dev = resolve_device(device)
    if case.model in ("resnet50", "resnet152"):
        cfg = resnet_v2_50() if case.model == "resnet50" else resnet_v2_152()
        model = convert.init_resnet(cfg, generator, dev)
        classes = cfg.num_classes
    elif case.model == "vgg16":
        model = convert.init_vgg(generator, size=case.size, device=dev)
        classes = model.num_classes
    elif case.model == "deeplab":
        cfg = deeplab_v3()
        model = convert.init_deeplab(cfg, generator, dev)
        classes = cfg.num_classes
    elif case.model == "lstm":
        model = convert.init_lstm(generator, features=LSTM_FEATURES,
                                  device=dev)
        classes = model.num_classes
    else:
        raise ValueError(f"unknown model {case.model}")
    shape = ((case.batch, case.size, LSTM_FEATURES) if case.model == "lstm"
             else (case.batch, case.size, case.size, 3))
    x = torch.randn(shape, generator=generator, device=dev).bfloat16()
    labels = None
    if case.train:
        label_shape = ((case.batch, case.size, case.size)
                       if case.model == "deeplab" else (case.batch,))
        labels = torch.randint(0, classes, label_shape, generator=generator,
                               device=dev)
    return Workload(case, model, x, labels)


def infer_step(w: Workload, dtype: Optional[torch.dtype] = None):
    """The model's f32 logits of the case's input, computed in ``dtype``
    (default the model's bf16; float32 is the plain f32 path of the same
    weights)."""
    with torch.no_grad():
        return w.model(w.x, dtype)


def loss(w: Workload, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """bench.py's loss: f32 logits, log_softmax, mean NLL of the labels."""
    logz = F.log_softmax(w.model(w.x, dtype).float(), dim=-1)
    return -logz.gather(-1, w.labels.unsqueeze(-1)).mean()


def train_step(w: Workload, lr: float = LR) -> torch.Tensor:
    """One step of bench.py's train step: the loss and its gradients
    (bf16 compute), then ``w - lr·g`` on the f32 parameters.  Returns the
    loss before the update."""
    params = [p for p in w.model.parameters() if p.requires_grad]
    value = loss(w)
    grads = torch.autograd.grad(value, params)
    with torch.no_grad():
        torch._foreach_add_(params, grads, alpha=-lr)
    return value.detach()


def timed(w: Workload) -> dict:
    """``iters`` steps after 2 warm-ups, timed by CUDA events:
    images/s = batch·iters / elapsed; in training, each step's loss."""
    if w.x.device.type != "cuda":
        raise RuntimeError("timed() measures on the card: build the "
                           "workload on a CUDA device")
    step = train_step if w.case.train else infer_step
    for _ in range(2):
        step(w)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    outs = [step(w) for _ in range(w.case.iters)]
    end.record()
    torch.cuda.synchronize()
    seconds = start.elapsed_time(end) / 1e3
    return dict(seconds=seconds,
                images_per_s=w.case.batch * w.case.iters / seconds,
                losses=[float(v) for v in outs] if w.case.train else None)


def lstm_flops(batch: int, seq: int, features: int, hidden: int,
               train: bool) -> float:
    """bench.py's analytic count: per sample and step, the gate matmuls
    [in + h] -> 4h are 2·(in + h)·4h FLOPs; backward is 2x forward."""
    gate = 2.0 * (features + hidden) * 4 * hidden
    return batch * seq * gate * (3.0 if train else 1.0)


def step_flops(w: Workload) -> float:
    """FLOPs of one step: convs and matmuls as FlopCounterMode counts them
    on one step (in training, forward and backward, and the step updates
    the weights), the LSTM's recurrence (which it does not count) by
    :func:`lstm_flops`."""
    if w.case.model == "lstm":
        return lstm_flops(w.case.batch, w.case.size, w.x.shape[-1],
                          w.model.hidden, w.case.train)
    with FlopCounterMode(display=False) as counter:
        (train_step if w.case.train else infer_step)(w)
    return float(counter.get_total_flops())
