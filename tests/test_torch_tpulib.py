"""The port's device inventory (``tpulib/``) against the JAX package's.

``MockBackend`` takes the same fixtures (tests/test_tpulib.py's, and the
H100 one) and must give the same ``NodeInventory`` fields as the JAX
backend, apart from the device kind: the default type string and UUID
prefix name a GPU ("NVIDIA-<gen>", "GPU-<gen>-mock-<i>") where the JAX
backend names a TPU, and a fixture without a memory size defaults to the
H100's 80 GiB.  ``detect()`` picks the mock under ``VTPU_MOCK_JSON``, else
NVML, and raises without either (tests/test_torch_nvml.py drives
``NvmlBackend`` over the mock NVML).  ``TorchBackend`` on a card runs in
chip_smoke.py.
"""

import dataclasses
import json

import pytest
import torch

from k8s_vgpu_scheduler_tpu import tpulib as jtpulib
from k8s_vgpu_scheduler_tpu_torch import tpulib as ttpulib
from k8s_vgpu_scheduler_tpu_torch.tpulib import backend as tbackend

FIXTURES = {
    "v5e_4x2_default_chips": {"generation": "v5e", "mesh": [4, 2],
                              "hbm_mib": 16384},
    "explicit_chips_and_health": {
        "generation": "v5p", "mesh": [2, 2, 1],
        "wraparound": [False, False, False], "hbm_mib": 95 * 1024,
        "chips": [{"coords": [0, 0, 0], "uuid": "a", "hbm_mib": 95000},
                  {"coords": [1, 0, 0], "uuid": "b", "healthy": False}]},
    "h100": ttpulib.H100_FIXTURE,
    "h100_typed": {**ttpulib.H100_FIXTURE, "mesh": [2],
                   "chips": [{"coords": [0], "type": "NVIDIA-h100",
                              "serial": "1654", "board": "hgx"},
                             {"coords": [1], "uuid": "GPU-1"}]},
}


def as_gpu(inv):
    """The JAX backend's inventory with its defaulted device-kind strings
    ("TPU-<gen>", "TPU-<gen>-mock-<i>") written as the port's, and no MIG
    device on any card (a field the JAX ChipInfo has not)."""
    gen = inv.topology.generation
    chips = []
    for c in inv.chips:
        d = dataclasses.asdict(c)
        d["mig_enabled"], d["mig"] = False, ()
        if d["type"] == f"TPU-{gen}":
            d["type"] = f"NVIDIA-{gen}"
        if d["uuid"] == f"TPU-{gen}-mock-{c.index}":
            d["uuid"] = f"GPU-{gen}-mock-{c.index}"
        chips.append(d)
    return chips, dataclasses.asdict(inv.topology)


@pytest.mark.parametrize("name", list(FIXTURES))
def test_mock_inventory_matches_the_jax_backend(name):
    fx = json.dumps(FIXTURES[name])
    t = ttpulib.MockBackend(json.loads(fx)).inventory()
    j = jtpulib.MockBackend(json.loads(fx)).inventory()
    assert ([dataclasses.asdict(c) for c in t.chips],
            dataclasses.asdict(t.topology)) == as_gpu(j)


def test_h100_fixture_is_one_nvlink_domain_of_80gib_cards():
    inv = ttpulib.MockBackend(ttpulib.H100_FIXTURE).inventory()
    assert len(inv.chips) == 8
    assert inv.topology == ttpulib.TopologyDesc(generation="h100", mesh=(8,))
    # What the card's driver reports, not the 80 GiB of its name.
    assert {c.hbm_mib for c in inv.chips} == {81079}
    assert {c.type for c in inv.chips} == {"NVIDIA-h100"}
    assert len({c.uuid for c in inv.chips}) == 8


def test_generation_defaults_to_the_h100():
    inv = ttpulib.MockBackend({"mesh": [2]}).inventory()
    assert inv.topology.generation == "h100"
    assert [c.hbm_mib for c in inv.chips] == [81079] * 2


@pytest.mark.parametrize("from_file", [False, True], ids=["dict", "file"])
def test_refresh_health_applies_fixture_mutation(tmp_path, from_file):
    fx = {"generation": "h100", "mesh": [2],
          "chips": [{"coords": [0], "uuid": "a"},
                    {"coords": [1], "uuid": "b"}]}
    outs = []
    for mod in (ttpulib, jtpulib):
        path = tmp_path / f"{mod.__name__}.json"
        path.write_text(json.dumps(fx))
        backend = mod.MockBackend(path=str(path)) if from_file \
            else mod.MockBackend(json.loads(json.dumps(fx)))
        inv = backend.inventory()
        before = backend.refresh_health(inv)
        if from_file:
            bad = json.loads(json.dumps(fx))
            bad["chips"][1]["healthy"] = False
            path.write_text(json.dumps(bad))
        else:
            backend.fixture["chips"][1]["healthy"] = False
        outs.append((before, backend.refresh_health(inv),
                     [c.healthy for c in inv.chips]))
    assert outs[0] == outs[1] == (False, True, [True, False])


def test_detect_returns_the_mock_under_vtpu_mock_json(tmp_path, monkeypatch):
    path = tmp_path / "mock.json"
    path.write_text(json.dumps(ttpulib.H100_FIXTURE))
    monkeypatch.setenv("VTPU_MOCK_JSON", str(path))
    backend = ttpulib.detect()
    assert isinstance(backend, ttpulib.MockBackend)
    assert len(backend.inventory().chips) == 8


def test_detect_raises_without_a_card(monkeypatch):
    """No mock and no NVML: detect() raises, and never falls back to
    TorchBackend (a node agent must hold no context on a card)."""
    monkeypatch.delenv("VTPU_MOCK_JSON", raising=False)
    monkeypatch.setattr(tbackend.nvml, "LIBRARY", "libnvidia-ml-absent.so.1")

    def refuse(*args):
        raise AssertionError("detect() touched torch")

    monkeypatch.setattr(torch.cuda, "get_device_properties", refuse)
    monkeypatch.setattr(torch.cuda, "device_count", refuse)
    with pytest.raises(RuntimeError, match="VTPU_MOCK_JSON"):
        ttpulib.detect()


def test_torch_backend_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA devices"):
        ttpulib.TorchBackend().inventory()


def test_torch_backend_reads_device_properties(monkeypatch):
    """Name, memory, UUID and SM count from get_device_properties, with
    an injected card."""
    props = type("Props", (), dict(
        name="NVIDIA H100 80GB HBM3", total_memory=85_031_714_816,
        uuid="5b3f0a1c-0000-1111-2222-333344445555",
        multi_processor_count=132))()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda i: props)
    inv = ttpulib.TorchBackend().inventory()
    assert inv.topology == ttpulib.TopologyDesc(generation="h100", mesh=(2,))
    c = inv.chips[1]
    assert (c.index, c.uuid, c.type, c.hbm_mib, c.coords) == (
        1, "GPU-5b3f0a1c-0000-1111-2222-333344445555", "NVIDIA-h100",
        85_031_714_816 >> 20, (1,))
    assert c.board == "NVIDIA H100 80GB HBM3, 132 SMs"


@pytest.mark.parametrize("name,gen", [
    ("NVIDIA H100 80GB HBM3", "h100"), ("NVIDIA H100 PCIe", "h100"),
    ("NVIDIA A100-SXM4-80GB", "a100"), ("Tesla T4", "tesla-t4")])
def test_normalize_kind(name, gen):
    assert tbackend.normalize_kind(name) == gen
