"""``chip_smoke.py``'s reading of the card's used memory (``smi_card_mib``):
NVML's v2 ``used`` (nvidia-smi's ``memory.used``, the reserve apart), read
by a child without the preloaded interposer, the least over a window;
a window whose highest reading stands above both of its ends is kept as
one of the card's transients, a ramp is not.  The reading runs over the
mock NVML (``csrc/vgpu/mock_nvml.cc``), whose v1 ``used`` is the reserve
and whose v2 ``used`` is 0, so the v1 struct would read 480 here."""

import json
import subprocess

import pytest

import chip_smoke
from k8s_vgpu_scheduler_tpu_torch.ops import _kernels


@pytest.fixture
def transients(monkeypatch):
    monkeypatch.setattr(chip_smoke, "CARD_TRANSIENTS", [])
    return chip_smoke.CARD_TRANSIENTS


def test_the_card_reading_is_nvml_v2_used_over_the_mock(
        tmp_path, monkeypatch, transients):
    lib = _kernels.build_mock_nvml()
    fixture = tmp_path / "node.json"
    fixture.write_text(json.dumps({"generation": "h100", "mesh": [1],
                                   "hbm_mib": 81079, "reserved_mib": 480}))
    monkeypatch.setenv("MOCK_NVML_JSON", str(fixture))
    monkeypatch.setenv("LD_LIBRARY_PATH", str(lib.parent))
    monkeypatch.setenv("LD_PRELOAD", "/nonexistent/libvgpu_cuda.so")
    assert chip_smoke.smi_card_mib() == 0
    assert transients == []


@pytest.mark.parametrize("printed, least, kept", [
    ("4844 5363 4844 4844", 4844, True),     # a rise that fell back
    ("4844 5363 5363 4844", 4844, False),    # cut by the window's start
    ("630 4600 630 4600", 630, False),       # a pod taking memory
    ("4844 4844 4844 4844", 4844, False),
])
def test_the_window_keeps_its_least_and_its_transients(
        monkeypatch, transients, printed, least, kept):
    seen = {}

    def run(argv, **kw):
        seen.update(argv=argv, env=kw["env"])
        return subprocess.CompletedProcess(argv, 0, printed + "\n", "")

    monkeypatch.setenv("LD_PRELOAD", "/nonexistent/libvgpu_cuda.so")
    monkeypatch.setattr(chip_smoke.subprocess, "run", run)
    assert chip_smoke.smi_card_mib() == least
    assert [t[1:] for t in transients] == (
        [(least, int(printed.split()[1]))] if kept else [])
    assert seen["argv"][1:3] == ["-I", "-S"]
    assert "LD_PRELOAD" not in seen["env"]
