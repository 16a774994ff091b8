"""The port's benchmark families (ResNet-V2, VGG-16, DeepLab-v3, the LSTM)
against the JAX package's, on the CPU.

The same inputs and the same Flax parameters (both drawn from a numpy
seed: kernels N(0, 1/fan_in), GroupNorm scales 1 + N(0, 0.1²), biases
N(0, 0.1²), so that a scale or a bias loaded into the wrong place shows)
go through the JAX module's ``apply`` (jitted: one compile a config
instead of one an op) and through the port's module made by its
``*_from_flax`` converter.  Bounds, max|port - jax| / max|jax|:

- f32, 1e-4: each family at a small config (ResNet stages (1,1,1,1),
  width 32, at a 32² and a 33² input; DeepLab the same with ASPP 64 and
  the published rates; VGG16 at 64², where the flattened map is 2x2x512
  so that its (h, w, c) order shows; the LSTM at hidden 16, features 8,
  sequence 12); each family at its published widths is in
  tests/test_torch_workloads.py;
- bf16, against JAX's bf16 at the small configs: BF16_TOL, 2x the
  first reading of each family on an x86 CPU (ResNet 6.42e-3, VGG
  2.14e-3, DeepLab 1.32e-2, LSTM 6.63e-3; the LSTM's carry is f32 in
  Flax and bf16 in the port).
- Flax's "SAME" padding at an odd and an even size for the 7x7 stride-2
  stem, the stride-2 3x3 and the 3x3 stride-2 pool, each against
  ``lax.conv_general_dilated`` / ``nn.max_pool``; torch's symmetric pad
  fails at the even size.  GroupNorm's epsilon (1e-6) at a variance near
  it.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from k8s_vgpu_scheduler_tpu.models import deeplab as jdeeplab
from k8s_vgpu_scheduler_tpu.models import lstm as jlstm
from k8s_vgpu_scheduler_tpu.models import resnet as jresnet
from k8s_vgpu_scheduler_tpu.models import vgg as jvgg
from k8s_vgpu_scheduler_tpu_torch.models import convert, layers
from k8s_vgpu_scheduler_tpu_torch.models import deeplab as tdeeplab
from k8s_vgpu_scheduler_tpu_torch.models import resnet as tresnet

torch.set_num_threads(2)

F32_TOL = 1e-4
BF16_TOL = {"resnet": 1.3e-2, "vgg": 4.3e-3, "deeplab": 2.7e-2,
            "lstm": 1.4e-2}
SMALL_RESNET = dict(stage_sizes=(1, 1, 1, 1), num_classes=10, width=32)
SMALL_DEEPLAB = dict(backbone_stages=(1, 1, 1, 1), width=32,
                     aspp_features=64)


def flax_params(module, x, seed):
    """The module's Flax tree, every leaf drawn from a numpy seed."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
                np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.1 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def rel_err(got, want) -> float:
    got = np.asarray(torch.as_tensor(got).detach().float(), np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def family(name, dtype, size=None):
    """(JAX module, its input, port converter) of a small config."""
    rng = np.random.default_rng(7)
    if name == "resnet":
        cfg = dict(SMALL_RESNET, dtype=dtype)
        x = rng.standard_normal((2, size or 33, size or 33, 3))
        return (jresnet.ResNetV2(jresnet.ResNetConfig(**cfg)), x,
                lambda p: convert.resnet_from_flax(
                    p, tresnet.ResNetConfig(**cfg), device="cpu"))
    if name == "deeplab":
        cfg = dict(SMALL_DEEPLAB, dtype=dtype)
        x = rng.standard_normal((2, size or 33, size or 33, 3))
        return (jdeeplab.DeepLabV3(jdeeplab.DeepLabConfig(**cfg)), x,
                lambda p: convert.deeplab_from_flax(
                    p, tdeeplab.DeepLabConfig(**cfg), device="cpu"))
    if name == "vgg":
        x = rng.standard_normal((2, 64, 64, 3))
        return (jvgg.VGG16(num_classes=10, dtype=dtype), x,
                lambda p: convert.vgg_from_flax(p, dtype, device="cpu"))
    x = rng.standard_normal((3, 12, 8))
    return (jlstm.LSTMClassifier(hidden=16, dtype=dtype), x,
            lambda p: convert.lstm_from_flax(p, dtype, device="cpu"))


def both(module, x, to_port, seed=0):
    x = x.astype(np.float32)
    params = flax_params(module, x, seed)
    want = jax.jit(module.apply)(params, jnp.asarray(x))
    got = to_port(jax.tree_util.tree_map(np.asarray, params))(
        torch.from_numpy(x))
    return got, want


@pytest.mark.parametrize("name,size", [
    ("resnet", 32), ("resnet", 33), ("deeplab", 32), ("deeplab", 33),
    ("vgg", None), ("lstm", None)])
def test_small_config_matches_jax_in_f32(name, size):
    got, want = both(*family(name, "float32", size))
    assert rel_err(got, want) <= F32_TOL


@pytest.mark.parametrize("name", ["resnet", "deeplab", "vgg", "lstm"])
def test_small_config_matches_jax_in_bf16(name):
    got, want = both(*family(name, "bfloat16"))
    assert got.dtype == torch.float32  # the classifier is f32 in both
    assert rel_err(got, want) <= BF16_TOL[name]


def test_published_configs_are_the_jax_packages():
    assert dataclasses.asdict(tresnet.resnet_v2_50()) == \
        dataclasses.asdict(jresnet.resnet_v2_50())
    assert dataclasses.asdict(tresnet.resnet_v2_152()) == \
        dataclasses.asdict(jresnet.resnet_v2_152())
    assert dataclasses.asdict(tdeeplab.deeplab_v3()) == \
        dataclasses.asdict(jdeeplab.deeplab_v3())


# (kernel, stride, dilation) of the stem, the stride-2 3x3, a dilated 3x3.
SAME_CONVS = [(7, 2, 1), (3, 2, 1), (3, 1, 2)]


@pytest.mark.parametrize("n", [32, 33])
@pytest.mark.parametrize("k,stride,dilation", SAME_CONVS)
def test_conv_same_padding_matches_flax(n, k, stride, dilation):
    rng = np.random.default_rng(n + k)
    x = rng.standard_normal((1, n, n, 4)).astype(np.float32)
    w = rng.standard_normal((k, k, 4, 5)).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        x, w, (stride, stride), "SAME", rhs_dilation=(dilation, dilation),
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)
    tw = torch.from_numpy(w).permute(3, 2, 0, 1)
    got = layers.conv2d_same(tx, tw, stride, dilation).permute(0, 2, 3, 1)
    assert rel_err(got, want) <= 1e-5
    # torch's symmetric padding holds only where Flax's pad is symmetric.
    sym = F.conv2d(tx, tw, None, stride, (k - 1) * dilation // 2,
                   dilation).permute(0, 2, 3, 1)
    lo, hi = layers.same_pads(n, k, stride, dilation)
    assert (sym.shape == got.shape and rel_err(sym, want) <= 1e-5) == \
        (lo == hi)


@pytest.mark.parametrize("n", [16, 17, 32, 33])
def test_max_pool_same_matches_flax(n):
    # Negative inputs: a zero pad would win the max at the border.
    x = -np.abs(np.random.default_rng(n).standard_normal(
        (2, n, n, 3))).astype(np.float32) - 1.0
    want = fnn.max_pool(jnp.asarray(x), (3, 3), (2, 2), padding="SAME")
    got = layers.max_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2), 3, 2)
    assert rel_err(got.permute(0, 2, 3, 1), want) == 0.0
    sym = F.max_pool2d(torch.from_numpy(x).permute(0, 3, 1, 2), 3, 2, 1)
    assert (sym.shape == got.shape and torch.equal(sym, got)) == (n % 2 == 1)


def test_group_norm_matches_flax_epsilon_and_layout():
    # A variance near 1e-6, where torch's default epsilon (1e-5) would not
    # do; channels_last in and out.  Mean near 0: Flax's E[x²] - E[x]²
    # loses the variance where |mean| >> std, the port's two-pass
    # statistics do not.
    rng = np.random.default_rng(5)
    x = (1e-3 * rng.standard_normal((2, 5, 6, 64))).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(64)).astype(np.float32)
    gn = fnn.GroupNorm(num_groups=32)
    want = gn.apply({"params": {"scale": scale, "bias": bias}},
                    jnp.asarray(x))
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = layers.group_norm(tx, torch.from_numpy(scale),
                            torch.from_numpy(bias), torch.float32)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert rel_err(got.permute(0, 2, 3, 1), want) <= 1e-5
    torch_eps = F.group_norm(tx, 32, torch.from_numpy(scale),
                             torch.from_numpy(bias))
    assert rel_err(torch_eps.permute(0, 2, 3, 1), want) > 1e-2


def test_converter_refuses_a_tree_it_cannot_place():
    module, x, _ = family("lstm", "float32")
    params = jax.tree_util.tree_map(np.asarray, flax_params(module, x, 0))
    params["params"]["extra"] = {"kernel": np.zeros((1, 1), np.float32)}
    with pytest.raises(ValueError, match="extra"):
        convert.lstm_from_flax(params, "float32", device="cpu")
