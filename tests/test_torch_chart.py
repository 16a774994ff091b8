"""The port's Helm chart, charts/vgpu, rendered and held to the port.

The chart is rendered by ``tests/gotmpl.py`` (the repo's stand-in for
``helm template``) as ``helm install vgpu charts/vgpu -n kube-system``
would render it.  Each daemon's command line must parse under its own
module's ``parse_args``; the names, verbs, paths and mounts must be the
port's own (``util/config.py``, ``util/types.py``, the routes the
extender serves); the schema must refuse the values of the subsystems
that wait for ROADMAP A.5.  The dashboards and alert rules are pinned to
the port's collectors both ways: every name they query is one the port
emits, none is an A.5 family, and every family the port emits is on them,
exempt with a reason, or in ``A5_FAMILIES``.
"""

import json
import re
from pathlib import Path

import pytest

import chip_smoke
from k8s_vgpu_scheduler_tpu_torch.cmd import device_plugin, monitor, scheduler
from k8s_vgpu_scheduler_tpu_torch.cmd.serve import prometheus_text
from k8s_vgpu_scheduler_tpu_torch.cmd.vgpu_smi import parse_prom
from k8s_vgpu_scheduler_tpu_torch.scheduler.metrics import A5_FAMILIES
from k8s_vgpu_scheduler_tpu_torch.util.config import Config
from k8s_vgpu_scheduler_tpu_torch.util.types import SHIM_CONTAINER_DIR
from tests.gotmpl import Engine, TemplateError, render_chart

yaml = pytest.importorskip("yaml")

ROOT = Path(__file__).resolve().parent.parent
CHART = ROOT / "charts" / "vgpu"
RELEASE, NAMESPACE = chip_smoke.CHART_RELEASE
CMD = "k8s_vgpu_scheduler_tpu_torch.cmd."
CONTAINERS = {"vgpu-extender": CMD + "scheduler",
              "device-plugin": CMD + "device_plugin",
              "monitor": CMD + "monitor"}
PARSERS = {CMD + "scheduler": scheduler.parse_args,
           CMD + "device_plugin": device_plugin.parse_args,
           CMD + "monitor": monitor.parse_args}


def render(values=None):
    return render_chart(str(CHART), values_override=values,
                        release_name=RELEASE, namespace=NAMESPACE)


def docs(rendered):
    return [(path, d) for path, text in rendered.items()
            for d in yaml.safe_load_all(text) if d]


def one(rendered, kind):
    [d] = [d for _, d in docs(rendered) if d["kind"] == kind]
    return d


def containers(rendered):
    out = {}
    for kind in ("Deployment", "DaemonSet"):
        for c in one(rendered, kind)["spec"]["template"]["spec"][
                "containers"]:
            out[c["name"]] = c
    return out


def values():
    return yaml.safe_load((CHART / "values.yaml").read_text())


@pytest.fixture(scope="module")
def rendered():
    return render()


# -- the rendering ----------------------------------------------------------


def test_every_manifest_is_k8s_shaped_yaml(rendered):
    found = docs(rendered)
    assert len(found) >= 15
    for path, d in found:
        assert d.get("apiVersion") and d.get("kind"), path
        assert d.get("metadata", {}).get("name"), path
    kinds = {d["kind"] for _, d in found}
    assert {"Deployment", "DaemonSet", "ConfigMap", "Service",
            "ServiceAccount", "ClusterRole", "ClusterRoleBinding",
            "MutatingWebhookConfiguration", "Job"} <= kinds


def test_the_files_the_chart_is_made_of():
    names = {str(p.relative_to(CHART)) for p in CHART.rglob("*")
             if p.is_file()}
    assert names == {
        "Chart.yaml", "values.yaml", "values.schema.json",
        "templates/_helpers.tpl", "templates/NOTES.txt",
        "templates/scheduler/deployment.yaml",
        "templates/scheduler/configmap.yaml",
        "templates/scheduler/service.yaml",
        "templates/scheduler/serviceaccount.yaml",
        "templates/scheduler/rolebinding.yaml",
        "templates/scheduler/webhook.yaml",
        "templates/scheduler/job-patch/job-createSecret.yaml",
        "templates/scheduler/job-patch/job-patchWebhook.yaml",
        "templates/scheduler/job-patch/rbac.yaml",
        "templates/device-plugin/daemonset.yaml",
        "templates/device-plugin/configmap.yaml",
        "templates/device-plugin/monitorservice.yaml",
        "templates/device-plugin/rbac.yaml",
        "dashboards/vgpu-overview.json", "dashboards/vgpu-alerts.yaml"}
    meta = yaml.safe_load((CHART / "Chart.yaml").read_text())
    assert meta["name"] == "vgpu" and meta["apiVersion"] == "v2"


def test_every_included_helper_is_defined():
    helpers = (CHART / "templates" / "_helpers.tpl").read_text()
    defined = set(re.findall(r'define\s+"([^"]+)"', helpers))
    used = set()
    for path in (CHART / "templates").rglob("*"):
        if path.is_file():
            used |= set(re.findall(r'include\s+"([^"]+)"', path.read_text()))
    assert used and used <= defined, used - defined


def test_the_notes_render_and_name_what_waits_for_a5():
    notes = (CHART / "templates" / "NOTES.txt").read_text()
    ctx = {"Values": values(), "Chart": {"AppVersion": "0.1.0"},
           "Release": {"Namespace": NAMESPACE}}
    text = Engine().render(notes, ctx)
    assert "nvidia.com/gpumem: 3000" in text and "ROADMAP A.5" in text
    assert "failurePolicy is Ignore" in text


@pytest.mark.parametrize("override, present, absent", [
    ({"resourceMem": "example.com/fraction-mem"},
     "--resource-mem=example.com/fraction-mem",
     "--resource-mem=nvidia.com/gpumem"),
    ({"devicePlugin": {"deviceSplitCount": 17}},
     "--device-split-count=17", "--device-split-count=10"),
    ({"devicePlugin": {"disablecorelimit": "true"}},
     "--disable-core-limit", None),
    ({"scheduler": {"enablePreemption": True}}, "--enable-preemption", None),
    ({"scheduler": {"service": {"grpcPort": 7070}}},
     "vgpu-scheduler.kube-system.svc:7070", "svc:1080"),
    ({"devicePlugin": {"monitor": {"grpcPort": 7071}}},
     "--usage-from=127.0.0.1:7071", "--usage-from=127.0.0.1:9395"),
    ({"devicePlugin": {"runtimeClassName": "nvidia"}},
     "runtimeClassName: nvidia", None),
], ids=["resource", "split", "core_limit", "preemption", "grpc_port",
        "monitor_port", "runtime_class"])
def test_a_value_override_changes_the_output(rendered, override, present,
                                             absent):
    base = "\n".join(rendered.values())
    out = "\n".join(render(override).values())
    assert present in out and present not in base
    if absent:
        assert absent in base and absent not in out


@pytest.mark.parametrize("name", sorted(CONTAINERS))
def test_each_daemon_argv_parses_under_its_own_parse_args(rendered, name):
    c = containers(rendered)[name]
    argv = [str(a) for a in c["command"]]
    assert argv[:3] == ["python", "-m", CONTAINERS[name]]
    assert all(a.startswith("-") for a in argv[3:]), argv
    args = PARSERS[argv[2]](argv[3:])
    if name == "vgpu-extender":
        cfg = scheduler.build_config(args)
        assert cfg.scheduler_name == "vgpu-scheduler"
        assert cfg.resources == Config().resources
        assert (args.cert_file, args.key_file) == ("/tls/tls.crt",
                                                   "/tls/tls.key")
    elif name == "device-plugin":
        assert args.install_shim and args.shim_dir == SHIM_CONTAINER_DIR
        assert args.cache_dir == Config().cache_host_dir
        assert args.config_file == "/config/config.json"
    else:
        assert args.container_root == Config().cache_host_dir
        assert args.grpc_port == int(device_plugin.parse_args(
            containers(rendered)["device-plugin"]["command"][3:])
            .usage_from.rpartition(":")[2])


QUOTA = {"queues": [{"name": "team-a", "namespaces": ["team-a"],
                     "cohort": "research", "weight": 3,
                     "quota": {"chips": 6}, "borrow_limit_chips": 2},
                    {"name": "team-b", "namespaces": ["team-b"],
                     "cohort": "research", "quota": {"chips": 2}}],
         "usageInformedFairShare": True}


def test_the_quota_values_render_into_the_extender(tmp_path):
    """The JAX chart's quota values: the config map's quota.yaml, mounted
    at /config, is what the extender's --quota-config loads, and its argv
    parses into the port's Config."""
    import jsonschema

    vals = values()
    vals["scheduler"]["quota"] = QUOTA
    jsonschema.validate(vals, schema())
    out = render({"scheduler": {"quota": QUOTA}})
    ext = containers(out)["vgpu-extender"]
    argv = [str(a) for a in ext["command"][3:]]
    assert "--quota-config=/config/quota.yaml" in argv
    assert "--fair-share-usage-informed" in argv
    assert {"name": "scheduler-config", "mountPath": "/config"} in \
        ext["volumeMounts"]
    cm = [d for _, d in docs(out) if d["kind"] == "ConfigMap"
          and "config.yaml" in d["data"]][0]
    (tmp_path / "quota.yaml").write_text(cm["data"]["quota.yaml"])
    argv = [a.replace("/config/", f"{tmp_path}/") for a in argv]
    cfg = scheduler.build_config(scheduler.parse_args(argv))
    assert cfg.quota_queues == tuple(QUOTA["queues"])
    assert cfg.fair_share_usage_informed
    base = containers(render())["vgpu-extender"]
    assert not any("quota" in str(a) for a in base["command"])
    assert all(m["name"] != "scheduler-config" for m in base["volumeMounts"])


def test_the_backfill_value_renders_no_queue_backfill():
    """``scheduler.quota.backfill`` (default true, in the schema): false
    renders ``--no-queue-backfill``, which the port's ``parse_args``
    reads into ``Config.enable_queue_backfill``."""
    import jsonschema

    base = containers(render())["vgpu-extender"]
    argv = [str(a) for a in base["command"][3:]]
    assert "--no-queue-backfill" not in argv
    assert scheduler.build_config(scheduler.parse_args(argv)) \
        .enable_queue_backfill
    vals = values()
    assert vals["scheduler"]["quota"]["backfill"] is True
    vals["scheduler"]["quota"]["backfill"] = False
    jsonschema.validate(vals, schema())
    out = containers(render({"scheduler": {"quota": {"backfill": False}}}))
    argv = [str(a) for a in out["vgpu-extender"]["command"][3:]]
    assert "--no-queue-backfill" in argv
    cfg = scheduler.build_config(scheduler.parse_args(argv))
    assert not cfg.enable_queue_backfill
    vals["scheduler"]["quota"]["backfill"] = "no"
    with pytest.raises(jsonschema.ValidationError):
        jsonschema.validate(vals, schema())


def test_the_defrag_values_render_into_the_extender():
    """``scheduler.defrag`` (off by default, in the schema): enabled
    renders ``--enable-defrag`` with the grace, the reservation TTL and
    the victim cap, which the port's ``parse_args`` reads into the
    defragmenter's config fields."""
    import jsonschema

    base = containers(render())["vgpu-extender"]
    argv = [str(a) for a in base["command"][3:]]
    assert not any("defrag" in a for a in argv)
    assert not scheduler.build_config(scheduler.parse_args(argv)) \
        .enable_defrag
    vals = values()
    assert vals["scheduler"]["defrag"] == {
        "enabled": False, "checkpointGrace": 120, "reservationTtl": 300,
        "maxVictims": 8}
    over = {"enabled": True, "checkpointGrace": 45, "reservationTtl": 90,
            "maxVictims": 3}
    vals["scheduler"]["defrag"] = over
    jsonschema.validate(vals, schema())
    out = containers(render({"scheduler": {"defrag": over}}))
    argv = [str(a) for a in out["vgpu-extender"]["command"][3:]]
    assert [a for a in argv if "defrag" in a] == [
        "--enable-defrag", "--defrag-checkpoint-grace=45",
        "--defrag-reservation-ttl=90", "--defrag-max-victims=3"]
    cfg = scheduler.build_config(scheduler.parse_args(argv))
    assert (cfg.enable_defrag, cfg.defrag_checkpoint_grace_s,
            cfg.defrag_reservation_ttl_s, cfg.defrag_max_victims) == (
        True, 45.0, 90.0, 3)
    for key, bad in (("maxVictims", 0), ("checkpointGrace", 0),
                     ("enabled", "yes"), ("interval", 5)):
        broken = values()
        broken["scheduler"]["defrag"][key] = bad
        with pytest.raises(jsonschema.ValidationError):
            jsonschema.validate(broken, schema())


BATCH_VALUES = {"filterBatch": (True, False), "batchTickMs": (5, 2),
                "batchMax": (64, 256)}


@pytest.mark.parametrize("key", sorted(BATCH_VALUES))
def test_the_batch_values_render_into_the_extender(key):
    """``scheduler.filterBatch``, ``batchTickMs`` and ``batchMax`` (in the
    schema since the batched cycles came to the port, with the JAX chart's
    defaults): off renders no batch flag; on renders ``--filter-batch``
    with the tick and the cap, which the port's ``parse_args`` reads into
    the batch engine's config fields; a bad value is refused."""
    import jsonschema

    value, default = BATCH_VALUES[key]
    vals = values()
    assert vals["scheduler"][key] == default
    base = containers(render())["vgpu-extender"]
    argv = [str(a) for a in base["command"][3:]]
    assert not any("batch" in a for a in argv)
    over = {"filterBatch": True, key: value}
    vals["scheduler"].update(over)
    jsonschema.validate(vals, schema())
    out = containers(render({"scheduler": over}))
    argv = [str(a) for a in out["vgpu-extender"]["command"][3:]]
    cfg = scheduler.build_config(scheduler.parse_args(argv))
    got = {"filterBatch": cfg.filter_batch,
           "batchTickMs": cfg.batch_tick_ms, "batchMax": cfg.batch_max}
    assert got == {**{k: d for k, (_v, d) in BATCH_VALUES.items()},
                   "filterBatch": True, key: value}
    tick = vals["scheduler"]["batchTickMs"]
    assert [a for a in argv if "batch" in a] == [
        "--filter-batch", f"--batch-tick-ms={tick}",
        f"--batch-max={got['batchMax']}"]
    broken = values()
    broken["scheduler"][key] = "yes" if key == "filterBatch" else 0
    if key == "batchTickMs":
        broken["scheduler"][key] = -1
    with pytest.raises(jsonschema.ValidationError):
        jsonschema.validate(broken, schema())


SHARD_VALUES = {"shardTtl": 15, "shardTick": 3, "shardStaleTtl": 10,
                "shardAdoptionGrace": 12}


def jax_extender(override) -> dict:
    """The JAX chart's extender container (and its Deployment's replica
    count) rendered with ``override``."""
    out = render_chart(str(ROOT / "charts" / "vtpu"),
                       values_override=override, release_name=RELEASE,
                       namespace=NAMESPACE)
    [dep] = [d for _, d in docs(out) if d["kind"] == "Deployment"]
    [ext] = [c for c in dep["spec"]["template"]["spec"]["containers"]
             if c["name"] == "vtpu-extender"]
    return dict(replicas=dep["spec"]["replicas"], env=ext.get("env"),
                shard=[str(a) for a in ext["command"] if "shard" in str(a)])


@pytest.mark.parametrize("replicas", [1, 2])
def test_the_replicas_render_the_shard_flags_as_the_jax_chart(replicas):
    """``scheduler.replicas`` with the four shard timings (the JAX
    chart's values and defaults): one replica renders no shard flag and no
    POD_NAME; two render the JAX chart's ``--shard-*`` flags and env, with
    ``--shard-replica=$(POD_NAME)``; the argv parses into the port's
    config, with the pod's name as the replica."""
    import jsonschema

    vals = values()
    assert {k: vals["scheduler"][k] for k in SHARD_VALUES} == SHARD_VALUES
    assert vals["scheduler"]["replicas"] == 1
    vals["scheduler"]["replicas"] = replicas
    jsonschema.validate(vals, schema())
    out = render({"scheduler": {"replicas": replicas}})
    dep = one(out, "Deployment")
    ext = containers(out)["vgpu-extender"]
    mine = dict(replicas=dep["spec"]["replicas"], env=ext.get("env"),
                shard=[str(a) for a in ext["command"] if "shard" in str(a)])
    assert mine == jax_extender({"scheduler": {"replicas": replicas}})
    argv = [str(a).replace("$(POD_NAME)", "vgpu-scheduler-0")
            for a in ext["command"][3:]]
    cfg = scheduler.build_config(scheduler.parse_args(argv))
    if replicas == 1:
        assert mine["shard"] == [] and mine["env"] is None
        assert cfg.shard_replica == ""
        return
    assert mine["shard"][0] == "--shard-replica=$(POD_NAME)"
    assert (cfg.shard_replica, cfg.shard_ttl_s, cfg.shard_tick_s,
            cfg.shard_stale_ttl_s, cfg.shard_adoption_grace_s) == (
        "vgpu-scheduler-0", 15.0, 3.0, 10.0, 12.0)


def test_the_shard_timings_render_and_bad_ones_are_refused():
    import jsonschema

    over = {"replicas": 3, "shardTtl": 5, "shardTick": 1,
            "shardStaleTtl": 2, "shardAdoptionGrace": 2.5}
    out = containers(render({"scheduler": over}))["vgpu-extender"]
    assert [str(a) for a in out["command"] if "shard" in str(a)] == \
        jax_extender({"scheduler": over})["shard"] == [
            "--shard-replica=$(POD_NAME)", "--shard-ttl=5", "--shard-tick=1",
            "--shard-stale-ttl=2", "--shard-adoption-grace=2.5"]
    for key, bad in (("replicas", 0), ("shardTtl", 0), ("shardTick", -1),
                     ("replicas", 1.5), ("shardAdoptionGrace", "x")):
        broken = values()
        broken["scheduler"][key] = bad
        with pytest.raises(jsonschema.ValidationError):
            jsonschema.validate(broken, schema())


def test_the_capacity_values_render_into_the_extender():
    """``scheduler.capacity`` (in the schema since the capacity forecast
    came to the port) renders the five ``--capacity-*`` flags at the JAX
    defaults, which the port's ``parse_args`` reads into the forecaster's
    config fields; an override changes them, and bad values are
    refused."""
    import jsonschema

    vals = values()
    assert vals["scheduler"]["capacity"] == {
        "interval": 30, "bucket": 60, "seasonBuckets": 24, "horizon": 1800,
        "starveAfter": 300}
    base = containers(render())["vgpu-extender"]
    argv = [str(a) for a in base["command"][3:]]
    assert [a for a in argv if a.startswith("--capacity")] == [
        "--capacity-interval=30", "--capacity-bucket=60",
        "--capacity-season-buckets=24", "--capacity-horizon=1800",
        "--capacity-starve-after=300"]
    cfg = scheduler.build_config(scheduler.parse_args(argv))
    default = scheduler.build_config(scheduler.parse_args([]))
    fields = ("capacity_interval_s", "capacity_bucket_s",
              "capacity_season_buckets", "capacity_horizon_s",
              "capacity_starve_after_s")
    assert [getattr(cfg, f) for f in fields] == \
        [getattr(default, f) for f in fields] == [30.0, 60.0, 24, 1800.0,
                                                   300.0]
    over = {"interval": 0, "bucket": 3600, "seasonBuckets": 24,
            "horizon": 86400, "starveAfter": 120}
    vals["scheduler"]["capacity"] = over
    jsonschema.validate(vals, schema())
    out = containers(render({"scheduler": {"capacity": over}}))
    argv = [str(a) for a in out["vgpu-extender"]["command"][3:]]
    cfg = scheduler.build_config(scheduler.parse_args(argv))
    assert [getattr(cfg, f) for f in fields] == [0.0, 3600.0, 24, 86400.0,
                                                 120.0]
    for key, bad in (("bucket", 0), ("seasonBuckets", 0),
                     ("interval", -1), ("horizon", "1h"), ("window", 5)):
        broken = values()
        broken["scheduler"]["capacity"][key] = bad
        with pytest.raises(jsonschema.ValidationError):
            jsonschema.validate(broken, schema())


@pytest.mark.parametrize("bad", [
    {"queues": [{"name": "a"}]},
    {"queues": [{"name": "a", "namespaces": [], "weight": 0}]},
    {"queues": [{"name": "a", "namespaces": [], "quota": {"gpus": 1}}]},
    {"queues": [], "shrink": False},
], ids=["no_namespaces", "zero_weight", "unknown_quota_key", "unknown_key"])
def test_the_schema_refuses_bad_quota_values(bad):
    import jsonschema

    broken = values()
    broken["scheduler"]["quota"] = bad
    with pytest.raises(jsonschema.ValidationError):
        jsonschema.validate(broken, schema())


@pytest.mark.parametrize("values_override", [
    {"scheduler": {"enablePreemption": True, "scoreByActual": True,
                   "topologyPolicy": "guaranteed"}},
    {"devicePlugin": {"disablecorelimit": "true",
                      "partitionStrategy": "mixed",
                      "partitionChips": "GPU-a,GPU-b", "mode": "env-share"}},
], ids=["scheduler_options", "plugin_options"])
def test_every_option_still_parses(values_override):
    for name, c in containers(render(values_override)).items():
        if name in CONTAINERS:
            PARSERS[CONTAINERS[name]]([str(a) for a in c["command"][3:]])


@pytest.mark.parametrize("needle", ["k8s_vgpu_scheduler_tpu.", "vtpu/",
                                    "libvtpu", "google.com/"])
def test_no_rendered_byte_names_the_jax_package(rendered, needle):
    for path, text in rendered.items():
        assert needle not in text, path
    for path in CHART.rglob("*"):
        if path.is_file():
            assert needle not in path.read_text(), path


def test_managed_resources_are_the_port_configs_four_names(rendered):
    cm = next(d for _, d in docs(rendered) if d["kind"] == "ConfigMap"
              and "config.yaml" in d["data"])
    cfg = yaml.safe_load(cm["data"]["config.yaml"])
    assert cfg["apiVersion"] == "kubescheduler.config.k8s.io/v1"
    assert cfg["profiles"] == [{"schedulerName": Config().scheduler_name}]
    [ext] = cfg["extenders"]
    names = Config().resources
    assert [m["name"] for m in ext["managedResources"]] == [
        names.count, names.memory, names.memory_percentage, names.cores]
    assert all(m["ignoredByScheduler"] for m in ext["managedResources"])


def test_the_verbs_and_the_webhook_path_are_the_routes_the_extender_serves(
        rendered):
    """The extender config's filterVerb and bindVerb under its urlPrefix,
    and the webhook's path, each answered by the port's ExtenderServer
    (a path it does not serve answers 404)."""
    from k8s_vgpu_scheduler_tpu_torch.k8s import FakeKube
    from k8s_vgpu_scheduler_tpu_torch.scheduler import Scheduler
    from k8s_vgpu_scheduler_tpu_torch.scheduler.routes import ExtenderServer

    cm = next(d for _, d in docs(rendered) if d["kind"] == "ConfigMap"
              and "config.yaml" in d["data"])
    [ext] = yaml.safe_load(cm["data"]["config.yaml"])["extenders"]
    hook = one(rendered, "MutatingWebhookConfiguration")
    [wh] = hook["webhooks"]
    svc = wh["clientConfig"]["service"]
    assert svc["name"] == f"{RELEASE}-scheduler"
    assert ext["urlPrefix"] == f"https://127.0.0.1:{svc['port']}"
    paths = ["/" + ext["filterVerb"], "/" + ext["bindVerb"], svc["path"]]
    assert paths == ["/filter", "/bind", "/webhook"]
    cfg = Config()
    kube = FakeKube()
    kube.add_node({"metadata": {"name": "n", "annotations": {}}})
    server = ExtenderServer(Scheduler(kube, cfg), cfg,
                            host="127.0.0.1", port=0)
    server.start()
    try:
        base = f"http://127.0.0.1:{server.port}"
        pod = chip_smoke.user_pod("p", "uidP", 1000, 1)
        bodies = [{"Pod": pod, "NodeNames": []},
                  {"PodName": "p", "PodNamespace": "default",
                   "PodUID": "uidP", "Node": "n"},
                  {"apiVersion": "admission.k8s.io/v1",
                   "kind": "AdmissionReview",
                   "request": {"uid": "r", "operation": "CREATE",
                               "namespace": "default", "object": pod}}]
        for path, body in zip(paths, bodies):
            status, _ = chip_smoke.http(base + path, body, timeout=30)
            assert status == 200, path
        assert chip_smoke.http(base + "/nosuch", {}, timeout=30)[0] == 404
    finally:
        server.stop()


def test_the_daemonset_gets_nvml_from_the_nvidia_runtime(rendered):
    spec = one(rendered, "DaemonSet")["spec"]["template"]["spec"]
    for c in spec["containers"]:
        env = {e["name"]: e.get("value") for e in c["env"]}
        assert env["NVIDIA_VISIBLE_DEVICES"] == "all", c["name"]
        assert env["NVIDIA_DRIVER_CAPABILITIES"] == "utility", c["name"]
        assert "NODE_NAME" in env
    plugin = containers(rendered)["device-plugin"]
    assert "--install-shim" in plugin["command"]
    assert "runtimeClassName" not in spec
    assert "NVIDIA container runtime" in (CHART / "values.yaml").read_text()


def test_the_mounts_are_the_ports_paths(rendered):
    spec = one(rendered, "DaemonSet")["spec"]["template"]["spec"]
    host = {v["name"]: v["hostPath"]["path"] for v in spec["volumes"]
            if "hostPath" in v}
    mounts = {c["name"]: {m["mountPath"]: m["name"]
                          for m in c["volumeMounts"]}
              for c in spec["containers"]}
    cache = Config().cache_host_dir
    assert cache == "/tmp/vgpu/containers"
    assert host[mounts["device-plugin"][SHIM_CONTAINER_DIR]] == \
        SHIM_CONTAINER_DIR
    for name in ("device-plugin", "monitor"):
        assert host[mounts[name][cache]] == cache
    v = values()["devicePlugin"]
    assert (v["libPath"], v["monitorctrPath"]) == (SHIM_CONTAINER_DIR, cache)


def test_the_node_configmap_is_what_the_agent_reads(rendered, tmp_path):
    cm = next(d for _, d in docs(rendered) if d["kind"] == "ConfigMap"
              and "config.json" in d["data"])
    data = json.loads(cm["data"]["config.json"])
    assert data == {"nodeconfig": []}
    data["nodeconfig"].append({"name": "n1", "devicesplitcount": 20,
                               "devicememoryscaling": 2.0,
                               "devicecorescaling": 1.5})
    path = tmp_path / "config.json"
    path.write_text(json.dumps(data))
    cfg = device_plugin.apply_node_config_overrides(
        Config(node_name="n1"), str(path))
    assert (cfg.device_split_count, cfg.device_memory_scaling,
            cfg.device_cores_scaling) == (20, 2.0, 1.5)


# -- the schema -------------------------------------------------------------


def schema():
    return json.loads((CHART / "values.schema.json").read_text())


def test_the_default_values_validate():
    import jsonschema

    jsonschema.validate(values(), schema())


def test_every_object_of_the_schema_refuses_unknown_keys():
    def walk(node, where):
        if isinstance(node, dict):
            if node.get("type") == "object":
                extra = node.get("additionalProperties")
                if "properties" in node:
                    assert extra is False, where
                else:  # a map of strings (labels, selectors)
                    assert extra == {"type": "string"}, where
            for k, v in node.items():
                walk(v, f"{where}/{k}")
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{where}/{i}")
    walk(schema(), "")


#: Values of the JAX chart the port's schema refuses: those whose
#: subsystems wait for ROADMAP A.5, and its flat defrag keys (the port's
#: are ``scheduler.defrag.*``, test_the_defrag_values_render_into_the_
#: extender).
A5_VALUES = [("scheduler", "defragCheckpointGrace", 120),
             ("scheduler", "slo", {"objectives": []}),
             ("scheduler", "enableDefrag", True),
             (None, "vgpuMonitor", {})]


@pytest.mark.parametrize("section, key, value", A5_VALUES,
                         ids=[v[1] for v in A5_VALUES])
def test_the_schema_refuses_what_waits_for_a5(section, key, value):
    import jsonschema

    bad = values()
    (bad[section] if section else bad)[key] = value
    with pytest.raises(jsonschema.ValidationError,
                       match="Additional properties"):
        jsonschema.validate(bad, schema())


@pytest.mark.parametrize("path, bad", [
    (("devicePlugin", "mode"), "sriov"),
    (("devicePlugin", "deviceSplitCount"), 0),
    (("devicePlugin", "partitionStrategy"), "mig"),
    (("scheduler", "nodeSchedulerPolicy"), "random"),
    (("scheduler", "topologyPolicy"), "strict"),
    (("scheduler", "service", "httpPort"), "https"),
    (("devicePlugin", "gpunodeSelector", "gpu"), True),
])
def test_the_schema_refuses_bad_values(path, bad):
    import jsonschema

    broken = values()
    cur = broken
    for k in path[:-1]:
        cur = cur[k]
    cur[path[-1]] = bad
    with pytest.raises(jsonschema.ValidationError):
        jsonschema.validate(broken, schema())


def test_a_construct_the_renderer_does_not_know_fails_loudly():
    with pytest.raises(TemplateError):
        Engine().render('{{ lookup "v1" "Secret" "ns" "x" }}', {})


# -- the dashboards, pinned to the port's collectors both ways --------------


def _sources() -> str:
    return "\n".join((ROOT / "k8s_vgpu_scheduler_tpu_torch" / rel).read_text()
                     for rel in ("scheduler/metrics.py", "monitor/metrics.py"))


def _serve_metrics() -> set:
    """The serving pod's names, from its exposition of a full stats
    snapshot (its latency gauges are named at run time)."""
    stats = {"stats": {}, "utilization": 0.0, "queue_depth": 0,
             "pool_hbm_bytes": 0,
             "latency": {"n": 1, "ttft_s": {"p50": 0.1, "p95": 0.2},
                         "per_token_s": {"p50": 0.01, "p95": 0.02}}}
    return set(parse_prom(prometheus_text(stats)))


def emitted_metrics() -> set:
    """Names as the port's exposition writes them: counters only as
    ``_total``, histograms as their ``_bucket``/``_sum``/``_count``
    series, gauges as declared."""
    src = _sources()
    counters = set(re.findall(r'CounterMetricFamily\(\s*"([a-z0-9_]+)"', src))
    gauges = set(re.findall(r'GaugeMetricFamily\(\s*"([a-z0-9_]+)"', src))
    hists = set(re.findall(r'HistogramMetricFamily\(\s*"([a-z0-9_]+)"', src))
    return (gauges | {f"{c}_total" for c in counters}
            | {f"{h}_{s}" for h in hists for s in ("bucket", "sum", "count")}
            | _serve_metrics())


#: Emitted families on neither the dashboard nor the alert rules, each
#: with its reason.
DASHBOARD_EXEMPT = {
    "host_tpu_memory_total_mib": "raw card capacity; the dashboard shows "
    "the granted/advertised pair from the extender",
    "vtpu_device_core_limit_percent": "a container's static compute cap",
    "vtpu_serve_decode_dispatches_total": "serving internals",
    "vtpu_serve_decode_steps_total": "serving internals",
    "vtpu_serve_per_token_seconds_p50": "serving internals",
    "vtpu_serve_pool_hbm_bytes": "serving internals",
    "vtpu_serve_prefills_total": "serving internals",
}


def dashboard_text() -> str:
    return "".join((CHART / "dashboards" / n).read_text()
                   for n in ("vgpu-overview.json", "vgpu-alerts.yaml"))


def test_the_dashboards_query_only_names_the_port_emits():
    names = chip_smoke.dashboard_metrics(CHART)
    assert len(names) >= 40
    missing = names - emitted_metrics()
    assert not missing, f"the dashboards query unknown metrics: {missing}"


def test_the_dashboards_query_no_a5_family():
    hits = {n for n in chip_smoke.dashboard_metrics(CHART)
            if chip_smoke.family_of(n) in A5_FAMILIES}
    assert not hits


def test_every_emitted_family_is_dashboarded_exempt_or_a5():
    text = dashboard_text()
    emitted = emitted_metrics()
    orphans = set()
    for name in emitted:
        base = chip_smoke.family_of(name)
        seen = {name, base} | {f"{base}_{s}"
                               for s in ("bucket", "sum", "count", "total")}
        if any(re.search(rf"\b{re.escape(n)}\b", text) for n in seen):
            continue
        if name in DASHBOARD_EXEMPT or base in A5_FAMILIES:
            continue
        orphans.add(name)
    assert not orphans, ("the port emits families the dashboards and alerts "
                         f"never query (add a panel, or exempt): {orphans}")
    stale = {n for n in DASHBOARD_EXEMPT if n not in emitted}
    assert not stale


def test_the_dashboard_is_the_jax_ones_less_a5():
    """The JAX dashboard's panels with their queries on an A.5 family
    left out (a panel left with none goes), and its alert rules less
    those on an A.5 family, in order, with their queries as they were;
    titles say GPU."""
    jax = json.loads((ROOT / "charts" / "vtpu" / "dashboards"
                      / "vtpu-overview.json").read_text())
    ours = json.loads((CHART / "dashboards" / "vgpu-overview.json")
                      .read_text())

    def a5(exprs):
        return any(chip_smoke.family_of(n) in A5_FAMILIES
                   for e in exprs for n in re.findall(r"[a-z][a-z0-9_]+", e))

    want = [kept for kept in ([t["expr"] for t in p["targets"]
                              if not a5([t["expr"]])]
                             for p in jax["panels"]) if kept]
    assert [[t["expr"] for t in p["targets"]]
            for p in ours["panels"]] == want
    # 34 since the placement families (reserved cards, defrag counters)
    # left A5_FAMILIES: the max-free-box and compaction panels came back;
    # 36 since the elastic families left: the resize and state panels; 39
    # since the capacity forecast's: the three "Capacity" panels; 46 since
    # the throughput machinery's: commit conflicts, pool saturation, phase
    # cost, lock wait and hold, decision-write failures, and the informer
    # lag and GC panels less their batched-cycle queries; 50 since the
    # batched cycles' and the solve workers': batch size, cycle latency,
    # fallbacks by cause and the solve-worker pool, and the pending queue
    # depth and batch fallbacks back in the informer-lag and GC panels; 53
    # since the shard layer's: the three "Control-plane HA" panels.
    assert len(want) == 53 and ours["uid"] == "vgpu-overview"
    for p in ours["panels"]:
        assert "TPU" not in p["title"] + p.get("description", "")
    alerts = yaml.safe_load((CHART / "dashboards" / "vgpu-alerts.yaml")
                            .read_text())
    jax_alerts = yaml.safe_load((ROOT / "charts" / "vtpu" / "dashboards"
                                 / "vtpu-alerts.yaml").read_text())
    ours_rules = [r for g in alerts["groups"] for r in g["rules"]]
    want_rules = [r for g in jax_alerts["groups"] for r in g["rules"]
                  if not a5([r["expr"]])]
    assert [r["alert"] for r in ours_rules] == [r["alert"] for r in
                                                want_rules]
    assert [r["expr"] for r in ours_rules] == [
        r["expr"].replace('job="vtpu-monitor"', 'job="vgpu-monitor"')
        for r in want_rules]
    # VtpuDefragAbortStorm came back with placement, VtpuResizeThrash
    # with elastic meshes, VtpuQueueStarvationForecast and
    # VtpuCapacityForecastDrift with the capacity forecast,
    # VtpuFilterCommitConflictStorm, VtpuSchedulerTickStall and
    # VtpuDecisionWriteFailures with the throughput machinery,
    # VtpuFilterBatchFallbackStorm with the batched cycles, and
    # VtpuShardOrphaned with the shard layer.
    assert len(ours_rules) == 25
    for r in ours_rules:
        assert r["annotations"]["summary"]
        assert "TPU" not in r["annotations"]["summary"]


@pytest.mark.parametrize("expr, want", [
    ('rate(vtpu_preemption_requests_total[10m]) > 0.005',
     {"vtpu_preemption_requests_total"}),
    ('histogram_quantile(0.99, sum by (le) (rate('
     'vtpu_dispatch_wait_seconds_bucket{class="latency-critical"}[5m])))',
     {"vtpu_dispatch_wait_seconds_bucket"}),
    ('up{job="vgpu-monitor"} == 0', set()),
    ('vtpu_queue_pending > 0 and rate(vtpu_queue_admitted_total[30m]) == 0',
     {"vtpu_queue_pending", "vtpu_queue_admitted_total"}),
], ids=["rate", "quantile", "scrape_series", "and"])
def test_dashboard_metrics_reads_promql(tmp_path, expr, want):
    (tmp_path / "dashboards").mkdir()
    (tmp_path / "dashboards" / "a.yaml").write_text(yaml.safe_dump(
        {"groups": [{"name": "g", "rules": [{"alert": "A", "expr": expr}]}]}))
    assert chip_smoke.dashboard_metrics(tmp_path) == want
