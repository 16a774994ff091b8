"""The port's copy of bench.py's per-case logic (models/workloads.py)
against bench.py and the JAX package, on the CPU.

- ``CASES``: bench.py's ten cases, shape for shape and baseline for
  baseline; each grant 3000 MiB or a larger multiple of 1000 MiB, and
  ``grant_for``'s rule at its edges.
- ``train_step`` against the step as bench.py writes it in JAX
  (``value_and_grad`` of f32 logits' mean NLL, then ``w - 0.01·g``), in
  f32 at the small configs of tests/test_torch_vision_models.py and with
  the same numpy-seeded parameters: the loss to 1e-5 relative, each
  parameter after the step to 1e-5 of its largest |value|, and each
  parameter's update (new - old) to TOL_UPDATE of its largest |value|
  (plus 4 f32 ulps of the parameter, the rounding of new - old).
  DeepLab's labels are per pixel.
- Each family at its published widths (``resnet_v2_50()`` and
  ``deeplab_v3()`` at (1, 64, 64, 3), ``VGG16()`` at (1, 64, 64, 3),
  ``LSTMClassifier()`` at (2, 16, 300)), compute dtype f32: logits to
  1e-4 of max|jax|.
- ``build``'s shapes, dtypes and seeding; ``step_flops``: the LSTM's
  analytic count is bench.py's formula, and FlopCounterMode counts a
  one-conv model's 2·MACs (forward) and 2x that in training (the
  weight's gradient; the input needs none).  ``timed`` refuses the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from k8s_vgpu_scheduler_tpu.models import deeplab as jdeeplab
from k8s_vgpu_scheduler_tpu.models import lstm as jlstm
from k8s_vgpu_scheduler_tpu.models import resnet as jresnet
from k8s_vgpu_scheduler_tpu.models import vgg as jvgg
from k8s_vgpu_scheduler_tpu_torch.models import convert, layers, workloads
from k8s_vgpu_scheduler_tpu_torch.models import deeplab as tdeeplab
from k8s_vgpu_scheduler_tpu_torch.models import resnet as tresnet
from test_torch_vision_models import F32_TOL, family, flax_params, rel_err

torch.set_num_threads(2)

TOL_LOSS = 1e-5
TOL_PARAM = 1e-5
TOL_UPDATE = 1e-3
EPS32 = float(np.finfo(np.float32).eps)
CLASSES = {"resnet": 10, "vgg": 10, "deeplab": 21, "lstm": 2}


def test_cases_are_bench_pys():
    assert list(workloads.CASES) == list(bench.CASES)
    for name, want in bench.CASES.items():
        case = workloads.CASES[name]
        assert {k: getattr(case, k) for k in want} == want, name
        assert case.grant_mib >= 3000 and case.grant_mib % 1000 == 0


@pytest.mark.parametrize("peak,grant", [
    (1205, 3000), (2700, 3000), (2703, 4000), (3901, 5000), (5373, 7000),
    (5000, 6000)])
def test_grant_for_a_peak(peak, grant):
    # The JAX bench's 3000 MiB up to a 2700 MiB peak, then 1.2x the peak
    # rounded up to 1000 MiB.
    assert workloads.grant_for(peak) == grant


def jax_train_step(module, p, xb, yb):
    """bench.py's train step (its loss_fn and train_step)."""
    def loss_fn(p, xb, yb):
        logits = module.apply(p, xb).astype(jnp.float32)
        logz = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logz, yb[..., None], axis=-1))

    loss, grads = jax.value_and_grad(loss_fn)(p, xb, yb)
    p = jax.tree_util.tree_map(
        lambda w, g: (w - 0.01 * g).astype(w.dtype), p, grads)
    return p, loss


@pytest.mark.parametrize("name", ["resnet", "deeplab", "vgg", "lstm"])
def test_train_step_matches_bench_pys_jax_step(name):
    module, x, to_port = family(name, "float32")
    x = x.astype(np.float32)
    params = flax_params(module, x, seed=11)
    rng = np.random.default_rng(12)
    label_shape = x.shape[:3] if name == "deeplab" else x.shape[:1]
    labels = rng.integers(0, CLASSES[name], label_shape).astype(np.int32)
    new, want_loss = jax.jit(lambda p, xb, yb: jax_train_step(
        module, p, xb, yb))(params, jnp.asarray(x), jnp.asarray(labels))
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = to_port(tree)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    case = dataclasses.replace(workloads.CASES["deeplab_train_bf16_b1_384"],
                               model=name)
    w = workloads.Workload(case, model, torch.from_numpy(x),
                           torch.from_numpy(labels).long())
    got_loss = workloads.train_step(w)
    assert abs(float(got_loss) - float(want_loss)) <= \
        TOL_LOSS * abs(float(want_loss))
    want = to_port(jax.tree_util.tree_map(np.asarray, new))
    for key, want_p in want.named_parameters():
        got_p = dict(model.named_parameters())[key].detach()
        scale = want_p.detach().abs().max()
        assert (got_p - want_p).abs().max() <= TOL_PARAM * scale, key
        # The update, less the f32 rounding of the subtraction itself.
        step = want_p.detach() - before[key]
        assert ((got_p - before[key]) - step).abs().max() <= \
            TOL_UPDATE * step.abs().max() + 4 * EPS32 * scale, key


def _published(name):
    x = np.random.default_rng(3).standard_normal(
        (2, 16, 300) if name == "lstm" else (1, 64, 64, 3))
    if name == "resnet_v2_50":
        cfg = dataclasses.replace(tresnet.resnet_v2_50(), dtype="float32")
        return (jresnet.ResNetV2(jresnet.ResNetConfig(
                    **dataclasses.asdict(cfg))), x,
                lambda p: convert.resnet_from_flax(p, cfg, device="cpu"))
    if name == "deeplab_v3":
        cfg = dataclasses.replace(tdeeplab.deeplab_v3(), dtype="float32")
        return (jdeeplab.DeepLabV3(jdeeplab.DeepLabConfig(
                    **dataclasses.asdict(cfg))), x,
                lambda p: convert.deeplab_from_flax(p, cfg, device="cpu"))
    if name == "vgg16":
        return (jvgg.VGG16(dtype="float32"), x,
                lambda p: convert.vgg_from_flax(p, "float32", device="cpu"))
    return (jlstm.LSTMClassifier(dtype="float32"), x,
            lambda p: convert.lstm_from_flax(p, "float32", device="cpu"))


@pytest.mark.parametrize("name", ["resnet_v2_50", "deeplab_v3", "vgg16",
                                  "lstm"])
def test_published_config_matches_jax(name):
    module, x, to_port = _published(name)
    x = x.astype(np.float32)
    params = flax_params(module, x, seed=4)
    want = jax.jit(module.apply)(params, jnp.asarray(x))
    got = to_port(jax.tree_util.tree_map(np.asarray, params))(
        torch.from_numpy(x))
    assert rel_err(got, want) <= F32_TOL


@pytest.mark.parametrize("name", ["lstm_inference_bf16_b100_1024x300",
                                  "lstm_train_bf16_b10_1024x300",
                                  "deeplab_train_bf16_b1_384"])
def test_build_draws_the_case_from_its_seed(name):
    case = workloads.CASES[name]
    a = workloads.build(name, torch.Generator().manual_seed(0), "cpu")
    b = workloads.build(name, torch.Generator().manual_seed(0), "cpu")
    want = ((case.batch, case.size, 300) if case.model == "lstm"
            else (case.batch, case.size, case.size, 3))
    assert a.x.shape == want and a.x.dtype == torch.bfloat16
    assert torch.equal(a.x, b.x)
    for (k, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert p.dtype == torch.float32 and torch.equal(p, q), k
    if case.train:
        labels = (case.batch, case.size, case.size) \
            if case.model == "deeplab" else (case.batch,)
        assert a.labels.shape == labels and torch.equal(a.labels, b.labels)
    else:
        assert a.labels is None


def test_lstm_flops_are_bench_pys_formula():
    for name in ("lstm_inference_bf16_b100_1024x300",
                 "lstm_train_bf16_b10_1024x300"):
        case = workloads.CASES[name]
        # bench.py: gate = 2·(in + h)·4h; batch·size·gate·(3 if train).
        h, feats = 300, 300
        want = case.batch * case.size * (2.0 * (feats + h) * 4 * h) * (
            3.0 if case.train else 1.0)
        model = convert.init_lstm(torch.Generator(), device="cpu")
        w = workloads.Workload(case, model, torch.zeros(
            case.batch, case.size, feats, dtype=torch.bfloat16))
        assert workloads.step_flops(w) == want


class OneConv(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = layers.Conv(8, 16, 3, stride=2)
        torch.nn.init.normal_(self.conv.weight)

    def forward(self, x, dtype=None):
        return self.conv(x.permute(0, 3, 1, 2), torch.float32).mean((2, 3))


@pytest.mark.parametrize("train", [False, True])
def test_flop_counter_counts_a_convs_macs(train):
    x = torch.randn(2, 10, 10, 8)
    case = workloads.Case("resnet50", 2, 10, 1, 1.0, train)
    w = workloads.Workload(case, OneConv(), x,
                           torch.zeros(2, dtype=torch.long))
    macs = 2 * 5 * 5 * 16 * 8 * 3 * 3  # batch, 5x5 out, c_out, c_in, k²
    assert workloads.step_flops(w) == 2 * macs * (2 if train else 1)


def test_timed_measures_only_on_the_card():
    case = workloads.CASES["lstm_inference_bf16_b100_1024x300"]
    w = workloads.Workload(case, OneConv(), torch.zeros(1, 4, 4, 8))
    with pytest.raises(RuntimeError, match="on the card"):
        workloads.timed(w)
