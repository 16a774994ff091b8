"""The port's train step against the JAX package's, on llama_tiny in f32.

Weights come from the Flax init through ``from_flax``; tokens from a
numpy seed; JAX runs its single-device step (``make_train_step``, jitted),
with the flash path through the Pallas kernels in interpret mode.
Tolerances: loss 1e-5 relative, grads 1e-4 (f32 through two layers and a
log-softmax over 256 logits: XLA and PyTorch sum in other orders; the
differences measured ~3e-7 on grads of up to 0.25); each loss of the
4-step trajectories 1e-5 relative (measured <= 1.5e-6 absolute on losses
of ~6: AdamW normalizes each update, so grad noise can move a param by up
to ~lr only where its grad is ~0).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from k8s_vgpu_scheduler_tpu.models import llama as jllama
from k8s_vgpu_scheduler_tpu.models import train as jtrain
from k8s_vgpu_scheduler_tpu_torch.models import llama as tllama
from k8s_vgpu_scheduler_tpu_torch.models import train as ttrain
from k8s_vgpu_scheduler_tpu_torch.models.convert import (
    from_flax, init_weights)

# Tier-1 runs the test files in several processes at once; a few torch
# threads each keep them from crowding the cores.
torch.set_num_threads(2)

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
OPTIONS = {
    "defaults": {},
    "clip_schedule": dict(clip_norm=1.0, warmup_steps=2, decay_steps=8),
    "accum": dict(accum_steps=2),
}


def cfg_pair(**kw):
    base = dict(vocab=256, dim=128, n_layers=2, n_heads=8, n_kv_heads=4,
                ffn_hidden=256, dtype="float32")
    base.update(kw)
    return jllama.LlamaConfig(**base), tllama.LlamaConfig(**base)


@pytest.fixture(scope="module")
def params():
    jcfg, _ = cfg_pair()
    p = jllama.Llama(jcfg).init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 8), jnp.int32))
    return jax.tree.map(np.asarray, p)


def batches(n=4, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, size=(2, 33)) for _ in range(n)]


def test_ce_from_logits_matches():
    rng = np.random.RandomState(1)
    logits = rng.standard_normal((2, 8, 256)).astype(np.float32) * 3
    targets = rng.randint(0, 256, size=(2, 8))
    for dtype in ("float32", "bfloat16"):
        want = jtrain.ce_from_logits(
            jnp.asarray(logits, getattr(jnp, dtype)), jnp.asarray(targets))
        got = ttrain.ce_from_logits(
            torch.from_numpy(logits).to(getattr(torch, dtype)),
            torch.from_numpy(targets))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("attention", ["full", "flash"])
def test_loss_and_grads_match(params, attention):
    jcfg, tcfg = cfg_pair(attention=attention)
    toks = batches(1)[0]
    jmodel = jllama.Llama(jcfg)
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p: jtrain.loss_fn(jmodel, p, jnp.asarray(toks))))(params)
    model = from_flax(params, tcfg, device="cpu")
    loss = ttrain.loss_fn(model, torch.from_numpy(toks))
    grads = torch.autograd.grad(loss, list(model.parameters()))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LOSS_TOL)
    # The JAX grad tree in the port's layout: from_flax of the grads.
    want = from_flax(jax.tree.map(np.asarray, want_grads), tcfg,
                     device="cpu")
    names = [n for n, _ in model.named_parameters()]
    for name, g, w in zip(names, grads, want.parameters()):
        np.testing.assert_allclose(g.numpy(), w.detach().numpy(),
                                   rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)


def jax_trajectory(params, jcfg, toks, **opts):
    opt = jtrain.make_optimizer(**opts)
    step = jax.jit(jtrain.make_train_step(jllama.Llama(jcfg), opt))
    state = jtrain.TrainState(params, opt.init(params),
                              jnp.zeros((), jnp.int32))
    losses = []
    for t in toks:
        state, loss = step(state, jnp.asarray(t))
        losses.append(float(loss))
    return losses


def torch_trajectory(model, toks, step_fn=None, **opts):
    opt = ttrain.make_optimizer(**opts)
    state = ttrain.TrainState.for_model(model, opt)
    step = ttrain.make_train_step(model, opt)
    if step_fn is not None:
        state, step = step_fn(state, step)
    losses = []
    for t in toks:
        state, loss = step(state, torch.from_numpy(t))
        losses.append(loss.item())
    return losses, state


@pytest.mark.parametrize("attention", ["full", "flash"])
@pytest.mark.parametrize("options", list(OPTIONS))
def test_trajectory_matches(params, attention, options):
    jcfg, tcfg = cfg_pair(attention=attention)
    toks = batches()
    want = jax_trajectory(params, jcfg, toks, **OPTIONS[options])
    got, state = torch_trajectory(from_flax(params, tcfg, device="cpu"),
                                  toks, **OPTIONS[options])
    np.testing.assert_allclose(got, want, rtol=LOSS_TOL)
    assert state.step == 4
    assert state.opt_state.count == (2 if options == "accum" else 4)


def test_loss_falls_on_a_repeated_batch(params):
    _, tcfg = cfg_pair(attention="flash")
    toks = batches(1) * 4
    losses, _ = torch_trajectory(from_flax(params, tcfg, device="cpu"),
                                 toks, lr=1e-2)
    assert losses[-1] < losses[0]


def test_offloaded_step_equals_device_step(params):
    _, tcfg = cfg_pair()
    toks = batches(3, seed=2)

    def offloaded(state, step):
        return (ttrain.offload_state(state),
                ttrain.OffloadedTrainStep(step))

    dev_model = from_flax(params, tcfg, device="cpu")
    off_model = from_flax(params, tcfg, device="cpu")
    want, dev_state = torch_trajectory(dev_model, toks)
    got, off_state = torch_trajectory(off_model, toks, step_fn=offloaded)
    assert got == want
    for a, b in zip(dev_model.parameters(), off_model.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(dev_state.opt_state.nu, off_state.opt_state.nu):
        assert torch.equal(a, b)


def test_offloaded_state_is_whole_when_the_step_returns(params):
    # The host copy is read straight after each step, before anything
    # else waits: it must already hold the device step's state.
    _, tcfg = cfg_pair()
    dev_model = from_flax(params, tcfg, device="cpu")
    off_model = from_flax(params, tcfg, device="cpu")
    opt = ttrain.make_optimizer()
    dev_state = ttrain.TrainState.for_model(dev_model, opt)
    dev_step = ttrain.make_train_step(dev_model, opt)
    off_state = ttrain.offload_state(ttrain.TrainState.for_model(off_model,
                                                                 opt))
    off_step = ttrain.OffloadedTrainStep(ttrain.make_train_step(off_model,
                                                                opt))
    for t in batches(2, seed=4):
        off_state, _ = off_step(off_state, torch.from_numpy(t))
        host = [m.clone() for m in off_state.opt_state.mu]
        dev_state, _ = dev_step(dev_state, torch.from_numpy(t))
        for a, b in zip(host, dev_state.opt_state.mu):
            assert torch.equal(a, b)
        assert all(m.device.type == "cpu" for m in off_state.opt_state.nu)


def test_offload_state_moves_the_optimizer_state_only():
    model = init_weights(tllama.llama_tiny(), torch.Generator(),
                         device="cpu")
    state = ttrain.TrainState.for_model(model, ttrain.make_optimizer())
    moved = ttrain.offload_state(state)
    assert moved.params is state.params
    for a, b in zip(moved.opt_state.mu, state.opt_state.mu):
        assert a is not b and torch.equal(a, b)


def test_bf16_working_weights_follow_the_f32_master():
    model = init_weights(tllama.llama_tiny(), torch.Generator().manual_seed(0),
                         device="cpu")
    opt = ttrain.make_optimizer(1e-3)
    state = ttrain.TrainState.for_model(model, opt)
    pairs = list(zip(model.parameters(), state.params))
    assert all(m.dtype == torch.float32 for _, m in pairs)
    # f32 params (the RMSNorm scales) are their own master copy.
    for p, m in pairs:
        assert (m.data_ptr() == p.data_ptr()) == (p.dtype == torch.float32)
    step = ttrain.make_train_step(model, opt)
    toks = torch.from_numpy(batches(1)[0])
    before = [m.clone() for m in state.params]
    state, loss = step(state, toks)
    assert torch.isfinite(loss)
    for (p, m), m0 in zip(pairs, before):
        assert torch.equal(p, m.to(p.dtype))
        assert not torch.equal(m, m0)
    # Steps smaller than a bf16 ULP still move the master copy.
    emb = state.params[0]
    assert not torch.equal(emb, emb.to(torch.bfloat16).float())


@pytest.mark.parametrize("opts", [
    dict(lr=1e-3, warmup_steps=3),
    dict(lr=1e-3, decay_steps=10),
    dict(lr=2e-3, warmup_steps=2, decay_steps=8),
    dict(lr=1e-3, warmup_steps=5, decay_steps=3),
])
def test_schedule_matches_optax(opts):
    # The schedules make_optimizer builds (train.py:50-62), from optax.
    lr, w, d = opts["lr"], opts.get("warmup_steps", 0), opts.get(
        "decay_steps", 0)
    if d:
        want = optax.warmup_cosine_decay_schedule(
            init_value=0.0, peak_value=lr, warmup_steps=max(w, 1),
            decay_steps=max(d, w + 1))
    else:
        want = optax.join_schedules(
            [optax.linear_schedule(0.0, lr, w), optax.constant_schedule(lr)],
            boundaries=[w])
    opt = ttrain.make_optimizer(**opts)
    for count in range(14):
        np.testing.assert_allclose(opt.schedule(count), float(want(count)),
                                   rtol=1e-6, atol=1e-10)


@pytest.mark.parametrize("scale", [1e-3, 10.0])
def test_clip_matches_optax(scale):
    rng = np.random.RandomState(3)
    grads = [rng.standard_normal(s).astype(np.float32) * scale
             for s in ((4, 5), (7,), (3, 2, 2))]
    want, _ = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    got = [torch.from_numpy(g.copy()) for g in grads]
    ttrain._clip_by_global_norm(got, 1.0)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-6)


def test_moe_loss_raises():
    _, tcfg = cfg_pair(n_experts=2)
    model = types.SimpleNamespace(cfg=tcfg)
    with pytest.raises(NotImplementedError, match="multi-device"):
        ttrain.loss_fn(model, torch.zeros((1, 4), dtype=torch.long))


def test_init_train_state_on_cpu():
    cfg = dataclasses.replace(tllama.llama_tiny(), n_layers=1)
    model, opt, state = ttrain.init_train_state(
        cfg, torch.Generator().manual_seed(0), device="cpu")
    assert model.device.type == "cpu" and opt == ttrain.make_optimizer()
    n = len(list(model.parameters()))
    assert len(state.params) == len(state.opt_state.mu) == n
    assert state.step == 0 and state.opt_state.count == 0
    assert not state.opt_state.acc
    assert all(not m.any() for m in state.opt_state.nu)
