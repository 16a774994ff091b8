"""The port's co-residency lab against the JAX package's, on the CPU.

``k8s_vgpu_scheduler_tpu_torch/shim/simlab.py`` drives copies of
``libvgpu_torch.so`` on virtual clocks under the port's own monitor; the
JAX package's lab drives ``libvtpu.so`` under its monitor.  The same
scenario must give the same result dict on both, to the microsecond
(the tolerance is 0: waits, duties and weights are integers on a manual
clock), with no grant violation.
"""

import random

import pytest

from k8s_vgpu_scheduler_tpu.shim import simlab as jax_lab
from k8s_vgpu_scheduler_tpu_torch.shim import simlab as port_lab
from tests.test_torch_shim import libs  # noqa: F401 — a fixture


@pytest.mark.parametrize("tiered", [False, True], ids=["flat", "tiered"])
@pytest.mark.parametrize("phases", ["SERVING_PHASES", "BENCH_PHASES"])
def test_drive_serving_equals_the_jax_lab(tmp_path, libs, phases, tiered):
    port = port_lab.drive_serving(
        str(tmp_path / "port"), tiered, getattr(port_lab, phases),
        qos_cfg=port_lab.serving_qos_config(), library=libs["port"])
    ref = jax_lab.drive_serving(
        str(tmp_path / "tpu"), tiered, getattr(jax_lab, phases),
        qos_cfg=jax_lab.serving_qos_config(), library=libs["tpu"])
    assert port == ref
    assert port_lab.serving_violations(port) == []
    assert jax_lab.serving_violations(ref) == []
    if phases == "SERVING_PHASES":
        # The re-weighting loop reaches its ceiling and floor only where
        # the classes are tiered.
        assert (port["duty_weights"]["critical_max"],
                port["duty_weights"]["best_effort_min"],
                port["reweights"] > 0) == \
            ((175, 25, True) if tiered else (100, 100, False))


def test_scenarios_equal_the_jax_ones():
    assert port_lab.SERVING_PHASES == jax_lab.SERVING_PHASES
    assert port_lab.BENCH_PHASES == jax_lab.BENCH_PHASES
    assert vars(port_lab.serving_qos_config()) == \
        vars(jax_lab.serving_qos_config())
    leg = {"tiered": True, "elapsed_s": 10.0,
           "critical": {"admitted_device_s": 9.2},
           "best_effort": {"admitted_device_s": 10.5}}
    for tiered in (True, False):
        leg["tiered"] = tiered
        assert port_lab.serving_violations(leg) == \
            jax_lab.serving_violations(leg)
        assert port_lab.serving_violations(leg)
    assert [port_lab.percentile(list(range(n)), q)
            for n in (0, 1, 7, 100) for q in (0.5, 0.99)] == \
        [jax_lab.percentile(list(range(n)), q)
         for n in (0, 1, 7, 100) for q in (0.5, 0.99)]


def _lab(mod, tmp_path, library):
    return mod.CoresidencyLab(str(tmp_path), library=library)


def test_lab_regions_carry_the_ports_grant(tmp_path, libs):
    from k8s_vgpu_scheduler_tpu_torch.monitor.reader import (
        RegionReader, scan_container_dirs)

    lab = _lab(port_lab, tmp_path, libs["port"])
    try:
        lab.add_container("uidS_serve", core_limit=50, priority=0,
                          qos_class="latency-critical", mem_mib=24000)
        found = scan_container_dirs(str(tmp_path))
        assert list(found) == ["uidS_serve"]
        assert found["uidS_serve"].endswith("/cudevshr.cache")
        r = RegionReader(libs["port"]).open(found["uidS_serve"])
        try:
            assert (r.uuids(), r.sm_limit(0), r.limit(0), r.priority,
                    r.qos_class) == ([port_lab.LAB_GPU], 50, 24000 << 20, 0,
                                     1)
        finally:
            r.close()
    finally:
        lab.close()


# -- degenerate parity, after tests/test_shim.py's TestQosLimiter ----------


def best_effort_vs_flat(mod, tmp_path, library):
    """A best-effort-only GPU (weight 100, no yield) gives EXACTLY the flat
    limiter's waits across a randomized schedule."""
    lab = _lab(mod, tmp_path, library)
    try:
        flat = lab.add_container("u1_flat", core_limit=30, priority=1)
        be = lab.add_container("u2_be", core_limit=30, priority=1,
                               qos_class="best-effort")
        flat.set_switch(True)
        be.set_switch(True)
        rng = random.Random(7)
        schedule = [(rng.randint(500, 30000), rng.randint(0, 20000))
                    for _ in range(300)]
        waits_flat, waits_be = [], []
        for cost, gap in schedule:
            waits_flat.append(flat.acquire(cost))
            flat.advance(gap)
            waits_be.append(be.acquire(cost))
            be.advance(gap)
        assert waits_flat == waits_be
        assert sum(waits_flat) > 0  # the schedule actually throttled
        # Observability is the one allowed difference: the flat region
        # records nothing, the QoS region records every dispatch.
        assert flat.qos_stats()["wait_count"] == 0
        assert be.qos_stats()["wait_count"] == len(schedule)
        return waits_flat, be.qos_stats()
    finally:
        lab.close()


def flat_priority_gates(mod, tmp_path, library):
    """High-priority and switch-off bypasses survive the QoS branch: a
    best-effort container at neutral weight runs free exactly when the
    flat limiter would."""
    lab = _lab(mod, tmp_path, library)
    try:
        hi = lab.add_container("u1_hi", core_limit=30, priority=0,
                               qos_class="best-effort")
        hi.set_switch(True)  # high priority: never throttled anyway
        lo = lab.add_container("u2_lo", core_limit=30, priority=1,
                               qos_class="best-effort")  # switch off
        waits = []
        for _ in range(50):
            waits += [hi.acquire(20000), lo.acquire(20000)]
        assert waits == [0] * 100
        return waits, hi.qos_stats(), lo.qos_stats()
    finally:
        lab.close()


@pytest.mark.parametrize("case", [best_effort_vs_flat, flat_priority_gates],
                         ids=lambda c: c.__name__)
def test_degenerate_parity_on_the_port_lab(tmp_path, libs, case):
    port = case(port_lab, tmp_path / "port", libs["port"])
    assert port == case(jax_lab, tmp_path / "tpu", libs["tpu"])
