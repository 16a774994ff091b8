"""The port's preemption watch, checkpoint and ``run_preemptible`` against
the JAX package's, on the CPU.

- The watch: the port's ``PreemptionWatch`` and the JAX one read the same
  files (tests/test_preempt.py's cases: a missing file, an annotation that
  appears, an empty value, kubelet's symlink swap, the env path) and must
  answer the same, and as those tests expect.
- The checkpoint protocol: a round trip is bitwise; ``keep`` prunes; no
  checkpoint raises ``FileNotFoundError``; a save that raises halfway
  leaves the previous step latest; a restore keeps every f32 parameter
  its own master copy and rewrites the bf16 working weights from theirs.
- The trajectory: preempted at step 3, resumed in a fresh state, finished
  at 6, it is bitwise the uninterrupted run's, on the device step and
  through ``OffloadedTrainStep``; and the losses and final params are
  held to JAX ``run_preemptible`` (its orbax manager) on the same weights
  and tokens, preempted and resumed the same way, at test_torch_train.py's
  LOSS_TOL (losses, relative) and GRAD_TOL (params).
- The save's file and staging: the file maps through ``torch.load(mmap=
  True, weights_only=True)`` and resumes bit for bit; staging leaves host
  tensors as they are; a save that fails at its flush leaves no partial
  step; the CRC setting is the process's again after each save.
"""

import dataclasses
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_vgpu_scheduler_tpu.models import llama as jllama
from k8s_vgpu_scheduler_tpu.models import train as jtrain
from k8s_vgpu_scheduler_tpu.shim import preempt as jpreempt
from k8s_vgpu_scheduler_tpu_torch.models import checkpoint as tckpt
from k8s_vgpu_scheduler_tpu_torch.models import llama as tllama
from k8s_vgpu_scheduler_tpu_torch.models import train as ttrain
from k8s_vgpu_scheduler_tpu_torch.models.convert import (
    from_flax, init_weights)
from k8s_vgpu_scheduler_tpu_torch.shim import preempt as tpreempt

torch.set_num_threads(2)

LOSS_TOL = 1e-5   # tests/test_torch_train.py
GRAD_TOL = 1e-4
N_STEPS = 6
CFG = dict(vocab=256, dim=128, n_layers=2, n_heads=8, n_kv_heads=4,
           ffn_hidden=256, dtype="float32")


# -- the watch ---------------------------------------------------------------

WATCHES = {"jax": jpreempt.PreemptionWatch, "port": tpreempt.PreemptionWatch}


def test_watch_constants_are_the_jax_packages():
    assert tpreempt.PREEMPT_ANNOTATION == jpreempt.PREEMPT_ANNOTATION \
        == "vtpu.dev/preempt-requested"
    assert tpreempt.PATH_ENV == jpreempt.PATH_ENV \
        == "VTPU_PODINFO_ANNOTATIONS"
    assert tpreempt.DEFAULT_PATH == jpreempt.DEFAULT_PATH


def _write(path, lines):
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _both(path=None):
    return {k: w(path) for k, w in WATCHES.items()}


def _ask(watches):
    """Each watch's (requested, requester); they must agree."""
    got = {k: (w.requested(), w.requester()) for k, w in watches.items()}
    assert got["port"] == got["jax"], got
    return got["port"]


def test_watch_missing_file_means_never(tmp_path):
    assert _ask(_both(str(tmp_path / "annotations"))) == (False, None)


def test_watch_detects_annotation(tmp_path):
    path = str(tmp_path / "annotations")
    _write(path, ['kubernetes.io/config.seen="2026"'])
    watches = _both(path)
    assert _ask(watches) == (False, None)
    _write(path, ['kubernetes.io/config.seen="2026"',
                  'vtpu.dev/preempt-requested="u-hp"'])
    os.utime(path, (time.time() + 5, time.time() + 5))  # force mtime move
    assert _ask(watches) == (True, "u-hp")


def test_watch_treats_empty_value_as_not_requested(tmp_path):
    path = str(tmp_path / "annotations")
    _write(path, ['vtpu.dev/preempt-requested="u-hp"'])
    watches = _both(path)
    assert _ask(watches) == (True, "u-hp")
    _write(path, ['vtpu.dev/preempt-requested=""'])
    os.utime(path, (time.time() + 5, time.time() + 5))
    assert _ask(watches) == (False, None)


def test_watch_kubelet_style_symlink_swap_detected(tmp_path):
    d1, d2 = tmp_path / "..data_1", tmp_path / "..data_2"
    d1.mkdir()
    d2.mkdir()
    (d1 / "annotations").write_text('other="x"\n')
    (d2 / "annotations").write_text(
        'other="x"\nvtpu.dev/preempt-requested="u-hp"\n')
    link = tmp_path / "annotations"
    link.symlink_to(d1 / "annotations")
    watches = _both(str(link))
    assert _ask(watches) == (False, None)
    tmp_link = tmp_path / ".tmp_link"
    tmp_link.symlink_to(d2 / "annotations")
    os.replace(tmp_link, link)
    assert _ask(watches) == (True, "u-hp")


def test_watch_env_var_path(tmp_path, monkeypatch):
    path = str(tmp_path / "ann")
    _write(path, ['vtpu.dev/preempt-requested="x"'])
    monkeypatch.setenv("VTPU_PODINFO_ANNOTATIONS", path)
    watches = _both()
    assert watches["port"].path == watches["jax"].path == path
    assert _ask(watches) == (True, "x")


# -- the checkpoint protocol -------------------------------------------------

@pytest.fixture(scope="module")
def params():
    jcfg = jllama.LlamaConfig(**CFG)
    p = jllama.Llama(jcfg).init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 8), jnp.int32))
    return jax.tree.map(np.asarray, p)


def batch(seed=1):
    return np.random.RandomState(seed).randint(0, CFG["vocab"], size=(2, 33))


def fresh(params, offloaded=False):
    """A model from the Flax weights, its step and a fresh train state."""
    model = from_flax(params, tllama.LlamaConfig(**CFG), device="cpu")
    opt = ttrain.make_optimizer()
    step = ttrain.make_train_step(model, opt)
    state = ttrain.TrainState.for_model(model, opt)
    if offloaded:
        state = ttrain.offload_state(state)
        step = ttrain.OffloadedTrainStep(step)
    return model, step, state


def recording(step, losses):
    def run(state, tokens):
        state, loss = step(state, tokens)
        losses.append(loss.item())
        return state, loss
    return run


def assert_states_equal(a, b):
    assert a.step == b.step
    for x, y in zip(a.params, b.params):
        assert torch.equal(x, y)
    oa, ob = a.opt_state, b.opt_state
    assert (oa.count, oa.mini_step) == (ob.count, ob.mini_step)
    for name in ("mu", "nu", "acc"):
        for x, y in zip(getattr(oa, name), getattr(ob, name)):
            assert torch.equal(x, y)


def test_round_trip_is_bitwise_and_in_place(params, tmp_path):
    _, step, state = fresh(params)
    for _ in range(2):
        state, _ = step(state, torch.from_numpy(batch()))
    tckpt.save_checkpoint(str(tmp_path), 2, state)
    model, _, target = fresh(params)
    before = [t for t in target.params]
    mu = target.opt_state.mu
    got = tckpt.restore_checkpoint(str(tmp_path), target, device="cpu")
    assert got is target
    assert_states_equal(state, target)
    # In place: the same tensors, and every f32 master is still its param.
    assert all(a is b for a, b in zip(target.params, before))
    assert target.opt_state.mu is mu
    for p, m in zip(model.parameters(), target.params):
        assert p.data_ptr() == m.data_ptr()
    assert os.listdir(tmp_path) == ["2"]
    assert os.listdir(tmp_path / "2") == [tckpt.STATE_FILE]


def test_bf16_working_weights_are_rewritten_from_the_master(tmp_path):
    cfg = tllama.llama_tiny()
    model = init_weights(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = ttrain.make_optimizer(1e-3)
    step = ttrain.make_train_step(model, opt)
    state = ttrain.TrainState.for_model(model, opt)
    assert state.working and all(
        p.dtype == torch.bfloat16 for p in state.working.values())
    state, _ = step(state, torch.from_numpy(batch()))
    mgr = tckpt.CheckpointManager(str(tmp_path))
    mgr.save(1, state)
    fresh_model = init_weights(cfg, torch.Generator().manual_seed(9),
                               device="cpu")
    target = ttrain.TrainState.for_model(fresh_model, opt)
    mgr.restore(target)
    for a, b in zip(model.parameters(), fresh_model.parameters()):
        assert torch.equal(a, b)
    for i, p in target.working.items():
        assert torch.equal(p, target.params[i].to(p.dtype))


def test_model_weights_round_trip(tmp_path):
    cfg = tllama.llama_tiny()
    model = init_weights(cfg, torch.Generator().manual_seed(0), device="cpu")
    tckpt.save_checkpoint(str(tmp_path), 0, model)
    other = init_weights(cfg, torch.Generator().manual_seed(1), device="cpu")
    tckpt.restore_checkpoint(str(tmp_path), other, device="cpu")
    for (n, a), b in zip(model.state_dict().items(),
                         other.state_dict().values()):
        assert torch.equal(a, b), n
    wrong = init_weights(dataclasses.replace(cfg, n_layers=1),
                         torch.Generator(), device="cpu")
    with pytest.raises(ValueError, match="do not match"):
        tckpt.restore_checkpoint(str(tmp_path), wrong, device="cpu")


def test_keep_prunes_to_the_newest(params, tmp_path):
    _, _, state = fresh(params)
    mgr = tckpt.CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 5):
        mgr.save(s, state)
    assert mgr.steps() == [2, 5] and mgr.latest_step() == 5
    with pytest.raises(FileExistsError):
        mgr.save(5, state)


def test_no_checkpoint_raises(params, tmp_path):
    _, _, state = fresh(params)
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(str(tmp_path / "missing"), state,
                                 device="cpu")
    assert tckpt.CheckpointManager(str(tmp_path / "empty")).latest_step() \
        is None


def test_a_failed_save_leaves_the_previous_step(params, tmp_path,
                                                monkeypatch):
    _, _, state = fresh(params)
    mgr = tckpt.CheckpointManager(str(tmp_path))
    mgr.save(1, state)
    real_save = torch.save

    def half_then_fail(obj, f):
        real_save(obj["params"][:1], f)   # some bytes reach the disk
        raise OSError("disk full")

    monkeypatch.setattr(tckpt.torch, "save", half_then_fail)
    with pytest.raises(OSError, match="disk full"):
        mgr.save(2, state)
    assert mgr.latest_step() == 1
    monkeypatch.undo()
    # A temporary directory left by a killed writer is ignored, then
    # cleared at the next open.
    leftover = tmp_path / ".tmp-3-1234"
    leftover.mkdir()
    (leftover / tckpt.STATE_FILE).write_bytes(b"partial")
    assert mgr.latest_step() == 1
    assert tckpt.CheckpointManager(str(tmp_path)).latest_step() == 1
    assert sorted(os.listdir(tmp_path)) == ["1"]


def test_restore_checkpoint_takes_the_targets_device(params, tmp_path):
    _, _, state = fresh(params)
    tckpt.save_checkpoint(str(tmp_path), 1, state)
    with pytest.raises((ValueError, RuntimeError)):
        tckpt.restore_checkpoint(str(tmp_path), state, device="cuda")


# -- the trajectory ----------------------------------------------------------

def port_run(params, ckpt_dir, should_stop, offloaded=False):
    _, step, state = fresh(params, offloaded)
    losses = []
    mgr = tckpt.CheckpointManager(str(ckpt_dir))
    state, done, preempted = ttrain.run_preemptible(
        recording(step, losses), state, torch.from_numpy(batch()), N_STEPS,
        mgr, should_stop)
    mgr.close()
    return state, done, preempted, losses


def preempt_at(k):
    answers = iter([False] * k + [True])
    return lambda: next(answers)


@pytest.fixture(scope="module")
def uninterrupted(params, tmp_path_factory):
    return port_run(params, tmp_path_factory.mktemp("ref"), lambda: False)


@pytest.mark.parametrize("offloaded", [False, True],
                         ids=["device_step", "offloaded_step"])
def test_resumed_trajectory_is_bitwise(params, uninterrupted, tmp_path,
                                       offloaded):
    ref, done, preempted, ref_losses = uninterrupted
    assert (done, preempted) == (N_STEPS, False)
    mid, done, preempted, first = port_run(params, tmp_path, preempt_at(3),
                                           offloaded)
    assert (done, preempted, mid.step) == (3, True, 3)
    assert tckpt.CheckpointManager(str(tmp_path)).latest_step() == 3
    res, done, preempted, rest = port_run(params, tmp_path, lambda: False,
                                          offloaded)
    assert (done, preempted) == (N_STEPS, False)
    assert first + rest == ref_losses
    assert_states_equal(res, ref)
    if offloaded:  # restored into the host copy, where the step keeps it
        assert all(t.device.type == "cpu" for t in res.opt_state.mu)
    # A finished run resumed again takes no step and saves nothing new.
    again, done, preempted, none = port_run(params, tmp_path, lambda: True,
                                            offloaded)
    assert (done, preempted, none) == (N_STEPS, False, [])
    assert tckpt.CheckpointManager(str(tmp_path)).steps() == [3, N_STEPS]


def jax_run(params, ckpt_dir, should_stop):
    from k8s_vgpu_scheduler_tpu.models.checkpoint import CheckpointManager

    jcfg = jllama.LlamaConfig(**CFG)
    opt = jtrain.make_optimizer()
    train_step = jax.jit(jtrain.make_train_step(jllama.Llama(jcfg), opt))
    losses = []

    def step(state, tokens):
        state, loss = train_step(state, tokens)
        losses.append(float(loss))
        return state, loss

    p = jax.tree.map(jnp.asarray, params)
    state = jtrain.TrainState(p, opt.init(p), jnp.zeros((), jnp.int32))
    mgr = CheckpointManager(str(ckpt_dir))
    try:
        state, done, preempted = jtrain.run_preemptible(
            step, state, jnp.asarray(batch()), N_STEPS, mgr, should_stop)
    finally:
        mgr.close()
    return state, done, preempted, losses


def test_resumed_trajectory_matches_jax_run_preemptible(params, tmp_path):
    _, done, preempted, jfirst = jax_run(params, tmp_path / "jax",
                                         preempt_at(3))
    assert (done, preempted) == (3, True)
    jres, done, preempted, jrest = jax_run(params, tmp_path / "jax",
                                           lambda: False)
    assert (done, preempted) == (N_STEPS, False)
    _, done, _, first = port_run(params, tmp_path / "port", preempt_at(3))
    res, done, _, rest = port_run(params, tmp_path / "port", lambda: False)
    assert done == N_STEPS and int(jres.step) == res.step == N_STEPS
    np.testing.assert_allclose(first + rest, jfirst + jrest, rtol=LOSS_TOL)
    # The JAX params in the port's order: from_flax of the final tree.
    want = from_flax(jax.tree.map(np.asarray, jres.params),
                     tllama.LlamaConfig(**CFG), device="cpu")
    for got, w in zip(res.params, want.parameters()):
        np.testing.assert_allclose(got.numpy(), w.detach().numpy(),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)


# -- the save's staging and its file ------------------------------------------

def test_a_saved_file_maps_and_resumes_bitwise(params, uninterrupted,
                                               tmp_path):
    """The file a save writes (records without their CRC-32 where this
    torch can leave it out) loads through ``torch.load(mmap=True,
    weights_only=True)``, the read the restore used before its whole-file
    read and the one ``chip_smoke.py``'s ``same_checkpoints`` makes; the
    state it maps, copied into a fresh one by the restore's own copy,
    finishes the run bit for bit as the uninterrupted one.  The CRC
    setting is the process's again after the save."""
    import zipfile

    ser = torch.serialization
    crc = ser.get_crc32_options() if hasattr(ser, "get_crc32_options") \
        else None
    state, done, preempted, first = port_run(params, tmp_path / "run",
                                             preempt_at(3))
    assert (done, preempted) == (3, True)
    mgr = tckpt.CheckpointManager(str(tmp_path / "run"))
    path = mgr.path(3)
    if crc is not None:
        assert ser.get_crc32_options() == crc
        data = [i for i in zipfile.ZipFile(path).infolist()
                if "/data/" in i.filename]
        assert data and all(i.CRC == 0 for i in data)
    mapped = torch.load(path, map_location="cpu", mmap=True,
                        weights_only=True)
    assert mapped["step"] == 3
    _, step, target = fresh(params)
    tckpt._restore_into(target, mapped)
    assert_states_equal(state, target)
    rest = []
    mgr2 = tckpt.CheckpointManager(str(tmp_path / "rest"))
    target, done, preempted = ttrain.run_preemptible(
        recording(step, rest), target, torch.from_numpy(batch()), N_STEPS,
        mgr2, lambda: False)
    ref_state, _, _, ref_losses = uninterrupted
    assert (done, preempted) == (N_STEPS, False)
    assert first + rest == ref_losses
    assert_states_equal(target, ref_state)


def test_staging_leaves_host_tensors_and_the_tree_as_they_are(params):
    """On the host the staging is the tree itself: the same tensors (a
    state on the CPU is saved from where it lies), in dicts, lists and
    tuples of their own types; card tensors are the only ones copied."""
    _, _, state = fresh(params)
    tree = tckpt._tree(state)
    staged = tckpt._staged(tree)
    assert staged["step"] == tree["step"]
    assert all(a is b for a, b in zip(staged["params"], tree["params"]))
    assert all(a is b for a, b in zip(staged["opt_state"]["mu"],
                                      tree["opt_state"]["mu"]))
    nested = {"a": (torch.ones(2), [torch.zeros(1)]), "n": 3}
    out = tckpt._staged(nested)
    assert type(out["a"]) is tuple and type(out["a"][1]) is list
    assert out["a"][0] is nested["a"][0] and out["n"] == 3


def test_a_save_that_fails_at_its_flush_leaves_no_partial_step(
        params, tmp_path, monkeypatch):
    """Tmp plus rename around the unbuffered write: a save whose bytes
    reached the disk but whose flush failed leaves neither its step nor
    its temporary directory, the previous step stays the latest, and the
    CRC setting is the process's again."""
    ser = torch.serialization
    crc = ser.get_crc32_options() if hasattr(ser, "get_crc32_options") \
        else None
    _, _, state = fresh(params)
    mgr = tckpt.CheckpointManager(str(tmp_path))
    mgr.save(1, state)

    def failing_fsync(fd):
        assert os.fstat(fd).st_size > 0   # the bytes were written
        raise OSError("flush failed")

    monkeypatch.setattr(tckpt.os, "fsync", failing_fsync)
    with pytest.raises(OSError, match="flush failed"):
        mgr.save(2, state)
    monkeypatch.undo()
    assert mgr.latest_step() == 1
    assert sorted(os.listdir(tmp_path)) == ["1"]
    if crc is not None:
        assert ser.get_crc32_options() == crc
