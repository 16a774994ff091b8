"""The port's scheduling protocol (``util/codec.py``, ``nodelock.py``,
``protocol.py``, ``k8s/fake.py``) against the JAX package's.

The codec must write the same bytes and read them back the same (random
device lists); each handshake scenario of tests/test_protocol.py runs on
both packages' FakeKube and must pass through the same bind phases,
device lists to allocate and node-lock states, step by step.  The port's
node agent pops "NVIDIA" grants where the JAX one pops "TPU" ones, so the
scenarios name each package's device type.
"""

import datetime

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from k8s_vgpu_scheduler_tpu.k8s import FakeKube as JKube
from k8s_vgpu_scheduler_tpu.k8s.client import Conflict as JConflict
from k8s_vgpu_scheduler_tpu.util import codec as jcodec
from k8s_vgpu_scheduler_tpu.util import nodelock as jnodelock
from k8s_vgpu_scheduler_tpu.util import protocol as jprotocol
from k8s_vgpu_scheduler_tpu.util import types as jtypes
from k8s_vgpu_scheduler_tpu_torch.k8s import FakeKube as TKube
from k8s_vgpu_scheduler_tpu_torch.k8s.client import Conflict as TConflict
from k8s_vgpu_scheduler_tpu_torch.util import codec as tcodec
from k8s_vgpu_scheduler_tpu_torch.util import nodelock as tnodelock
from k8s_vgpu_scheduler_tpu_torch.util import protocol as tprotocol
from k8s_vgpu_scheduler_tpu_torch.util import types as ttypes

JAX = (JKube, JConflict, jcodec, jnodelock, jprotocol, jtypes, "TPU")
PORT = (TKube, TConflict, tcodec, tnodelock, tprotocol, ttypes, "NVIDIA")

VOCABULARY = ("TO_ALLOCATE_ANNOTATION", "ASSIGNED_NODE_ANNOTATION",
              "BIND_TIME_ANNOTATION", "BIND_PHASE_ANNOTATION",
              "QOS_ANNOTATION", "QOS_DUTY_SPLIT_ANNOTATION",
              "NODE_LOCK_ANNOTATION", "MAX_LOCK_RETRY",
              "NODE_LOCK_EXPIRE_SECONDS", "BIND_ALLOCATING", "BIND_FAILED",
              "BIND_SUCCESS", "ENV_QOS_CLASS", "ENV_QOS_DUTY_SPLIT")


@pytest.mark.parametrize("name", VOCABULARY)
def test_annotation_vocabulary_is_the_jax_packages(name):
    assert getattr(ttypes, name) == getattr(jtypes, name)


def test_trace_and_oversubscribe_keys_are_the_jax_packages():
    from k8s_vgpu_scheduler_tpu.deviceplugin import plugin
    from k8s_vgpu_scheduler_tpu.util import trace as jtrace
    from k8s_vgpu_scheduler_tpu_torch.util import trace as ttrace

    assert ttypes.OVERSUBSCRIBE_ANNOTATION == plugin.OVERSUBSCRIBE_ANNOTATION
    assert (ttrace.TRACE_ID_ANNOTATION, ttrace.ENV_TRACE_ID) == (
        jtrace.TRACE_ID_ANNOTATION, jtrace.ENV_TRACE_ID)


def test_gang_annotations_are_the_jax_schedulers():
    from k8s_vgpu_scheduler_tpu.scheduler import gang

    for name in ("GANG_GROUP_ANNOTATION", "GANG_TOTAL_ANNOTATION",
                 "GANG_RANK_ANNOTATION", "GANG_COORDINATOR_ANNOTATION"):
        assert getattr(ttypes, name) == getattr(gang, name)


def test_resource_names_are_the_references():
    from k8s_vgpu_scheduler_tpu_torch.util.config import Config

    r = Config().resources
    assert (r.count, r.memory, r.memory_percentage, r.cores, r.priority) == (
        "nvidia.com/gpu", "nvidia.com/gpumem",
        "nvidia.com/gpumem-percentage", "nvidia.com/gpucores",
        "nvidia.com/priority")


def test_cache_dir_is_the_monitors_container_root():
    """The plugin writes each pod's region dir where the port's monitor
    scans by default."""
    from k8s_vgpu_scheduler_tpu_torch.cmd import device_plugin, monitor
    from k8s_vgpu_scheduler_tpu_torch.util.config import Config

    root = monitor.parse_args([]).container_root
    assert Config().cache_host_dir == root
    assert device_plugin.parse_args([]).cache_dir == root
    assert device_plugin.parse_args([]).shim_dir == Config().shim_host_dir


SAFE = st.text(alphabet="abcdefGPU0123456789-_.", min_size=1, max_size=40)
DEVICE = st.tuples(SAFE, st.sampled_from(["NVIDIA-h100", "TPU-v5e", "x"]),
                   st.integers(0, 10 ** 6), st.integers(0, 100))
POD = st.lists(st.lists(DEVICE, max_size=4), max_size=4)


def as_objects(types, pod):
    return [[types.ContainerDevice(*d) for d in ctr] for ctr in pod]


@settings(max_examples=200, deadline=None)
@given(POD)
def test_codec_writes_the_jax_bytes(pod):
    t = tcodec.encode_pod_devices(as_objects(ttypes, pod))
    j = jcodec.encode_pod_devices(as_objects(jtypes, pod))
    assert t == j
    back = [[(d.uuid, d.type, d.usedmem, d.usedcores) for d in ctr]
            for ctr in tcodec.decode_pod_devices(j)]
    want = [[(d.uuid, d.type, d.usedmem, d.usedcores) for d in ctr]
            for ctr in jcodec.decode_pod_devices(j)]
    assert back == want


@pytest.mark.parametrize("text", ["a,b,1", "a,b,x,1:", "a,b,1,2,3:"])
def test_codec_refuses_what_the_jax_codec_refuses(text):
    with pytest.raises(jcodec.CodecError):
        jcodec.decode_pod_devices(text)
    with pytest.raises(tcodec.CodecError):
        tcodec.decode_pod_devices(text)


@pytest.mark.parametrize("ch", [",", ":", ";"])
def test_codec_refuses_reserved_characters(ch):
    for codec, types in ((jcodec, jtypes), (tcodec, ttypes)):
        with pytest.raises(codec.CodecError):
            codec.encode_container_devices(
                [types.ContainerDevice(f"a{ch}b", "NVIDIA-h100", 1, 1)])


def make_pod(types, codec, dtype, containers, name="p1", node="node-a"):
    to_alloc = codec.encode_pod_devices([
        [types.ContainerDevice(f"GPU-{c}-{k}", f"{dtype}-h100", mem, cores)
         for k, (mem, cores) in enumerate(ctr)]
        for c, ctr in enumerate(containers)])
    return {
        "metadata": {
            "name": name, "namespace": "default", "uid": f"uid-{name}",
            "annotations": {
                types.BIND_TIME_ANNOTATION: "123",
                types.BIND_PHASE_ANNOTATION: types.BIND_ALLOCATING,
                types.ASSIGNED_NODE_ANNOTATION: node,
                types.TO_ALLOCATE_ANNOTATION: to_alloc,
            },
        },
        "spec": {"containers": [], "nodeName": node},
    }


def run(pkg, scenario):
    """The scenario on one package: the list of states it records (bind
    phase, devices left to allocate, lock held, what each call returned)."""
    kube_cls, conflict, codec, nodelock, protocol, types, dtype = pkg
    kube = kube_cls()
    kube.add_node({"metadata": {"name": "node-a", "annotations": {}}})
    trail = []

    def state(name="p1"):
        try:
            anns = kube.get_pod("default", name)["metadata"]["annotations"]
        except Exception as e:  # noqa: BLE001 — a vanished pod is a state
            anns = {"gone": type(e).__name__}
        trail.append((anns.get(types.BIND_PHASE_ANNOTATION, anns.get("gone")),
                      anns.get(types.TO_ALLOCATE_ANNOTATION),
                      nodelock.is_locked(kube, "node-a")))

    def grant_of(pod):
        return [(d.uuid, d.usedmem, d.usedcores)
                for d in protocol.get_next_device_request(dtype, pod)]

    if scenario == "lock_release":
        nodelock.lock_node(kube, "node-a")
        trail.append(nodelock.is_locked(kube, "node-a"))
        with pytest.raises(nodelock.NodeLockError):
            nodelock.lock_node(kube, "node-a", retries=2, backoff=0.01)
        nodelock.release_node(kube, "node-a")
        trail.append(nodelock.is_locked(kube, "node-a"))
        nodelock.lock_node(kube, "node-a")
        trail.append(nodelock.is_locked(kube, "node-a"))
    elif scenario in ("stale_lock", "garbage_lock"):
        old = datetime.datetime.now(datetime.timezone.utc) - \
            datetime.timedelta(seconds=nodelock.NODE_LOCK_EXPIRE_SECONDS + 10)
        kube.patch_node_annotations("node-a", {
            types.NODE_LOCK_ANNOTATION: old.strftime("%Y-%m-%dT%H:%M:%SZ")
            if scenario == "stale_lock" else "not-a-time"})
        nodelock.lock_node(kube, "node-a", retries=1)
        stamp = kube.get_node("node-a")["metadata"]["annotations"][
            types.NODE_LOCK_ANNOTATION]
        trail.append(stamp.endswith("Z") and stamp != "not-a-time")
    elif scenario == "cas_loser":
        rv = kube.get_node("node-a")["metadata"]["resourceVersion"]
        kube.patch_node_annotations(
            "node-a", {types.NODE_LOCK_ANNOTATION: "2026-01-01T00:00:00Z"},
            resource_version=rv)
        with pytest.raises(conflict):
            kube.patch_node_annotations(
                "node-a", {types.NODE_LOCK_ANNOTATION: "2026-01-01T00:00:01Z"},
                resource_version=rv)
        trail.append(nodelock.is_locked(kube, "node-a"))
    elif scenario == "pending_pod":
        kube.create_pod(make_pod(types, codec, dtype, [[(3000, 30)]]))
        done = make_pod(types, codec, dtype, [[(1, 1)]], name="p2")
        done["metadata"]["annotations"][types.BIND_PHASE_ANNOTATION] = \
            types.BIND_SUCCESS
        kube.create_pod(done)
        trail.append(protocol.get_pending_pod(kube, "node-a")["metadata"]
                     ["name"])
        trail.append(protocol.get_pending_pod(kube, "node-b"))
    elif scenario == "full_allocate_sequence":
        nodelock.lock_node(kube, "node-a")
        kube.create_pod(make_pod(types, codec, dtype,
                                 [[(3000, 30)], [(1000, 0), (1000, 0)]]))
        state()
        for _ in range(2):
            pod = protocol.get_pending_pod(kube, "node-a")
            trail.append(grant_of(pod))
            protocol.erase_next_device_type(kube, dtype, pod)
            state()
            protocol.pod_allocation_try_success(kube, pod)
            state()
    elif scenario == "other_device_type_left":
        nodelock.lock_node(kube, "node-a")
        pod = make_pod(types, codec, dtype, [[(3000, 30)]])
        other = codec.decode_pod_devices(
            pod["metadata"]["annotations"][types.TO_ALLOCATE_ANNOTATION])
        other.insert(0, [types.ContainerDevice("MLU-0", "MLU-370", 1, 1)])
        pod["metadata"]["annotations"][types.TO_ALLOCATE_ANNOTATION] = \
            codec.encode_pod_devices(other)
        kube.create_pod(pod)
        pod = protocol.get_pending_pod(kube, "node-a")
        trail.append(grant_of(pod))
        protocol.erase_next_device_type(kube, dtype, pod)
        protocol.pod_allocation_try_success(kube, pod)
        state()
    elif scenario == "allocation_failed":
        nodelock.lock_node(kube, "node-a")
        kube.create_pod(make_pod(types, codec, dtype, [[(3000, 30)]]))
        protocol.pod_allocation_failed(
            kube, protocol.get_pending_pod(kube, "node-a"))
        state()
    elif scenario in ("vanish_before_success", "vanish_before_failure"):
        nodelock.lock_node(kube, "node-a")
        pod = make_pod(types, codec, dtype, [])
        kube.create_pod(pod)
        kube.delete_pod("default", "p1")
        if scenario == "vanish_before_success":
            protocol.pod_allocation_try_success(kube, pod)
        else:
            protocol.pod_allocation_failed(kube, pod)
        state()
    elif scenario == "no_pending_request":
        kube.create_pod(make_pod(types, codec, dtype, []))
        with pytest.raises(LookupError):
            grant_of(protocol.get_pending_pod(kube, "node-a"))
        state()
    else:
        raise AssertionError(scenario)
    return trail


SCENARIOS = ["lock_release", "stale_lock", "garbage_lock", "cas_loser",
             "pending_pod", "full_allocate_sequence",
             "other_device_type_left", "allocation_failed",
             "vanish_before_success", "vanish_before_failure",
             "no_pending_request"]


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_handshake_transitions_equal_the_jax_packages(scenario):
    j = run(JAX, scenario)
    t = run(PORT, scenario)
    # The devices left to allocate name each package's device type.
    assert [x if not isinstance(x, tuple) or not isinstance(x[1], str)
            else (x[0], x[1].replace("NVIDIA-", "TPU-"), x[2])
            for x in t] == j
    assert j  # the scenario recorded something
