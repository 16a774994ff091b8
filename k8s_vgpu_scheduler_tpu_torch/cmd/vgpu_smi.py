"""vgpu-smi: the nvidia-smi view of a fractional GPU share (the port's
counterpart of the JAX package's ``cmd/vtpu_smi.py``).

The reference's headline isolation claim is "nvidia-smi inside the
container shows the vGPU memory limit" (reference README.md:133, through
the intercept library's virtualized nvmlDeviceGetMemoryInfo).  This CLI
reads the same shared region the interposer and the shim write:

- inside a container (``CUDA_DEVICE_MEMORY_SHARED_CACHE`` set, the port's
  grant env): THIS pod's view: each card's grant as "total", the
  accounted use, the core cap, the throttle state;
- on a node (``--containers-dir``): one section per container, the
  monitor's view;
- cluster-wide (``--cluster http://<scheduler>:9395``): per-card grants
  against capacity, sharer counts and per-pod grants, from the extender's
  exporter;
- ``top`` (``--cluster`` required): per-pod ACTUAL use (the ledger's
  counters) against the grant, sorted by wasted cards.

:func:`parse_prom` is the port's own exposition parser (no client
library).  Standard library only.

Usage:
  vgpu-smi [--json]
  vgpu-smi --containers-dir /tmp/vgpu/containers
  vgpu-smi --cluster http://sched:9395
  vgpu-smi top --cluster http://sched:9395
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
from typing import List, Optional

from ..monitor.reader import scan_container_dirs
from ..shim.core import QOS_CLASSES as QOS_CLASS_NAMES

MIB = 1024 * 1024


def region_info(region) -> dict:
    devs = []
    for i in range(region.num_devices):
        limit = region.limit(i)
        used = region.used(i)
        devs.append({
            "index": i,
            "uuid": region.uuid(i) or str(i),
            "memory_total_mib": limit // MIB,
            "memory_used_mib": used // MIB,
            "memory_used_pct": round(100.0 * used / limit, 1) if limit else 0.0,
            "core_limit_pct": region.sm_limit(i) or 100,
        })
    cls = getattr(region, "qos_class", -1)
    return {
        "devices": devs,
        "priority": region.priority,
        "throttled": bool(region.utilization_switch),
        "oversubscribe": bool(region.oversubscribe),
        "processes": region.proc_pids(),
        # SLO-tiered co-residency: class and the duty weight the
        # monitor's p99 feedback loop currently applies.
        "qos_class": QOS_CLASS_NAMES.get(cls),
        "qos_duty_weight_pct": (region.qos_weight if cls >= 0 else None),
        "qos_yield": bool(region.qos_yield) if cls >= 0 else False,
    }


def format_info(info: dict, title: str) -> str:
    lines = [
        f"+ {title}",
        "| idx  uuid                     HBM used / grant      cores  |",
    ]
    for d in info["devices"]:
        lines.append(
            "| {idx:<4d} {uuid:<24s} {used:>6d} / {total:<6d} MiB  {cores:>4d}%  |".format(
                idx=d["index"], uuid=d["uuid"][:24], used=d["memory_used_mib"],
                total=d["memory_total_mib"], cores=d["core_limit_pct"])
        )
    flags = []
    if info["throttled"]:
        flags.append("THROTTLED(priority sharer active)")
    if info["oversubscribe"]:
        flags.append("OVERSUBSCRIBED(host-RAM swap)")
    if info.get("qos_class"):
        flags.append(f"QOS({info['qos_class']} "
                     f"duty={info['qos_duty_weight_pct']}%"
                     + (" YIELD" if info.get("qos_yield") else "") + ")")
    lines.append(
        f"| prio={info['priority']} procs={len(info['processes'])} "
        + " ".join(flags)
    )
    return "\n".join(lines)


def _unescape_label(value: str) -> str:
    """Exposition-format label-value unescaping (``\\\\``, ``\\"``,
    ``\\n``) — returning the raw escapes would make a label value
    compare unequal to what the emitting collector stored."""
    out = []
    i = 0
    while i < len(value):
        c = value[i]
        if c == "\\" and i + 1 < len(value):
            nxt = value[i + 1]
            out.append("\n" if nxt == "n" else nxt)
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def parse_prom(text: str) -> dict:
    """Minimal Prometheus text-exposition parser: name → [(labels, value)].
    Only what the extender emits (gauges/counters/histogram series) — no
    client dependency in the CLI.  Hardened against adversarial label
    values: the label block is split off
    FIRST (on the LAST closing brace, so ``}`` inside a quoted value is
    fine), pairs are matched with a quote-aware regex instead of
    ``split(",")`` (values may contain ``,``, ``=``, spaces and escaped
    quotes), escapes are decoded, and the sample value is the first field
    AFTER the block — never a trailing timestamp."""
    out: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        labels: dict = {}
        if "{" in line:
            name, _, rest = line.partition("{")
            name = name.strip()
            block, brace, tail = rest.rpartition("}")
            if not brace:
                continue  # unclosed label block: not an exposition line
            # Pair-wise regex, not split(","): quoted label values may
            # legally contain commas, equals signs and spaces — e.g.
            # relabelled joined values or PromQL selectors copied into a
            # label on a federated endpoint.
            for m in re.finditer(r'([a-zA-Z_][a-zA-Z0-9_]*)\s*=\s*'
                                 r'"((?:[^"\\]|\\.)*)"', block):
                labels[m.group(1)] = _unescape_label(m.group(2))
            fields = tail.split()
        else:
            fields = line.split()
            name = fields[0] if fields else ""
            fields = fields[1:]
        if not name or not fields:
            continue
        try:
            out.setdefault(name, []).append((labels, float(fields[0])))
        except ValueError:
            continue
    return out


def cluster_info(metrics: dict) -> dict:
    """Regroup the extender's metric families into a per-node/per-chip +
    per-pod structure (names from scheduler/metrics.py)."""
    nodes: dict = {}

    def chip(labels):
        node = nodes.setdefault(labels.get("node", "?"), {"chips": {}})
        return node["chips"].setdefault(
            labels.get("deviceuuid", "?"),
            {"capacity_mib": 0, "granted_mib": 0, "sharers": 0, "cores": 0})

    for labels, v in metrics.get("tpu_device_memory_limit_mib", []):
        chip(labels)["capacity_mib"] = int(v)
    for labels, v in metrics.get("tpu_device_memory_allocated_mib", []):
        chip(labels)["granted_mib"] = int(v)
    for labels, v in metrics.get("tpu_device_shared_num", []):
        chip(labels)["sharers"] = int(v)
    for labels, v in metrics.get("tpu_device_core_allocated", []):
        chip(labels)["cores"] = int(v)
    for labels, v in metrics.get("node_tpu_memory_percentage", []):
        nodes.setdefault(labels.get("node", "?"), {"chips": {}})[
            "hbm_allocated_fraction"] = round(v, 4)

    pods: dict = {}
    for labels, v in metrics.get("vtpu_pod_device_allocated_mib", []):
        key = (labels.get("podnamespace", "?"), labels.get("podname", "?"))
        pods.setdefault(key, []).append(
            {"deviceuuid": labels.get("deviceuuid", "?"),
             "granted_mib": int(v), "cores": 0})
    for labels, v in metrics.get("vtpu_pod_core_allocated", []):
        key = (labels.get("podnamespace", "?"), labels.get("podname", "?"))
        for g in pods.get(key, []):
            if g["deviceuuid"] == labels.get("deviceuuid", "?"):
                g["cores"] = int(v)
    preempt = metrics.get("vtpu_preemption_requests_total", [({}, 0.0)])
    return {
        "nodes": nodes,
        "pods": [{"namespace": ns, "name": n, "grants": gs}
                 for (ns, n), gs in sorted(pods.items())],
        "preemption_requests": int(preempt[0][1]) if preempt else 0,
    }


# One staleness contract for both CLIs: threshold and marker wording
# come from vgpu_report so the two surfaces can never drift apart.
from .vgpu_report import DEFAULT_STALE_AFTER_S as STALE_AFTER_S  # noqa: E402
from .vgpu_report import stale_marker  # noqa: E402


def top_info(metrics: dict, stale_after_s: float = STALE_AFTER_S) -> dict:
    """Per-pod actual-vs-granted join from the extender's accounting
    metrics (scheduler/metrics.py) — the data behind ``vgpu-smi top``.
    ``waste_chips`` = granted chips × (1 - efficiency): the capacity the
    pod holds but does not use; None when the pod has no usage reports
    (node without a monitor — unknown is not the same as idle).  Rows
    whose newest ledger sample (vtpu_usage_series_age_seconds) is older
    than ``stale_after_s`` carry ``stale`` — frozen totals must not
    read as live ones."""
    pods: dict = {}

    def pod(labels):
        key = (labels.get("podnamespace", "?"), labels.get("podname", "?"))
        return pods.setdefault(key, {
            "chips": 0, "granted_mib": 0, "granted_cores": 0,
            "chip_seconds": 0.0, "hbm_byte_seconds": 0.0,
            "efficiency": None, "qos_class": None,
            "qos_duty_weight_pct": None, "series_age_s": None,
        })

    for labels, v in metrics.get("vtpu_pod_device_allocated_mib", []):
        p = pod(labels)
        p["chips"] += 1
        p["granted_mib"] += int(v)
    for labels, v in metrics.get("vtpu_pod_core_allocated", []):
        pod(labels)["granted_cores"] += int(v)
    for labels, v in metrics.get("vtpu_usage_chip_seconds_total", []):
        pod(labels)["chip_seconds"] = v
    for labels, v in metrics.get("vtpu_usage_hbm_byte_seconds_total", []):
        pod(labels)["hbm_byte_seconds"] = v
    for labels, v in metrics.get("vtpu_grant_efficiency_ratio", []):
        pod(labels)["efficiency"] = round(v, 4)
    for labels, v in metrics.get("vtpu_pod_qos_duty_weight", []):
        p = pod(labels)
        p["qos_class"] = labels.get("class")
        p["qos_duty_weight_pct"] = int(v)
    for labels, v in metrics.get("vtpu_usage_series_age_seconds", []):
        pod(labels)["series_age_s"] = round(v, 1)

    rows = []
    for (ns, name), p in pods.items():
        eff = p["efficiency"]
        waste = (round(p["chips"] * (1.0 - min(1.0, eff)), 3)
                 if eff is not None and p["chips"] else None)
        rows.append({"namespace": ns, "name": name, **p,
                     "waste_chips": waste,
                     "stale": (p["series_age_s"] is not None
                               and p["series_age_s"] > stale_after_s)})
    # Sorted by waste, worst first; pods with unknown efficiency sink to
    # the bottom (they may be fine — there is just no monitor data).
    rows.sort(key=lambda r: (r["waste_chips"] is None,
                             -(r["waste_chips"] or 0.0),
                             r["namespace"], r["name"]))
    idle = metrics.get("vtpu_idle_grants", [({}, 0.0)])
    return {"pods": rows,
            "idle_grants": int(idle[0][1]) if idle else 0}


def format_top(info: dict) -> str:
    lines = [
        f"+ fleet: {info['idle_grants']} idle grant(s)",
        "| pod                                chips  granted    eff%  "
        "waste  chip-s     qos           duty |",
    ]
    for r in info["pods"]:
        eff = (f"{100 * r['efficiency']:5.1f}"
               if r["efficiency"] is not None else "    -")
        waste = (f"{r['waste_chips']:5.2f}"
                 if r["waste_chips"] is not None else "    -")
        qos = (r.get("qos_class") or "-")[:16]
        duty = (f"{r['qos_duty_weight_pct']:>3d}%"
                if r.get("qos_duty_weight_pct") is not None else "   -")
        # The row's stale flag already applied the threshold (top_info);
        # -1 here just forces the shared marker text on.
        stale = (stale_marker(r["series_age_s"], -1.0)
                 if r.get("stale") else "")
        lines.append(
            "| {pn:<34s} {c:>5d} {g:>6d}MiB {e}% {w} {cs:>9.1f} "
            "{q:<13s} {d}{st} |".format(
                pn=f"{r['namespace']}/{r['name']}"[:34], c=r["chips"],
                g=r["granted_mib"], e=eff, w=waste,
                cs=r["chip_seconds"], q=qos, d=duty, st=stale))
    return "\n".join(lines)


def format_cluster(info: dict) -> str:
    lines = []
    for node, nd in sorted(info["nodes"].items()):
        pct = nd.get("hbm_allocated_fraction")
        lines.append(f"+ {node}"
                     + (f"  (HBM allocated: {pct:.0%})" if pct is not None
                        else ""))
        lines.append("| chip                     granted / capacity    "
                     "sharers  cores |")
        for uuid, c in sorted(nd["chips"].items()):
            lines.append(
                "| {u:<24s} {g:>6d} / {t:<6d} MiB  {s:>5d}  {co:>4d}% |"
                .format(u=uuid[:24], g=c["granted_mib"], t=c["capacity_mib"],
                        s=c["sharers"], co=c["cores"]))
    if info["pods"]:
        lines.append("+ pods")
        for p in info["pods"]:
            for g in p["grants"]:
                lines.append(
                    "| {pn:<34s} {u:<24s} {m:>6d} MiB {c:>4d}% |".format(
                        pn=f"{p['namespace']}/{p['name']}"[:34],
                        u=g["deviceuuid"][:24], m=g["granted_mib"],
                        c=g["cores"]))
    lines.append(f"| preemption requests: {info['preemption_requests']}")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser("vgpu-smi")
    p.add_argument("command", nargs="?", default="", choices=["", "top"],
                   help="'top': per-pod actual vs granted, sorted by "
                        "waste (requires --cluster)")
    p.add_argument("--region", default="",
                   help="region path (default: "
                        "$CUDA_DEVICE_MEMORY_SHARED_CACHE)")
    p.add_argument("--containers-dir", default="",
                   help="host mode: scan per-container region dirs")
    p.add_argument("--cluster", default="",
                   help="cluster mode: scheduler metrics URL "
                        "(http://<extender>:9395)")
    p.add_argument("--json", action="store_true", dest="as_json")
    p.add_argument("--library", default="",
                   help="a built libvgpu_torch.so (default: build "
                        "csrc/vgpu/ with g++ on first use)")
    args = p.parse_args(argv)

    if args.command == "top" and not args.cluster:
        print("vgpu-smi: top needs --cluster http://<extender>:9395",
              file=sys.stderr)
        return 2
    if args.cluster:
        import urllib.request

        url = args.cluster.rstrip("/")
        if "://" not in url:
            url = "http://" + url
        if not url.endswith("/metrics"):
            url += "/metrics"
        try:
            with urllib.request.urlopen(url, timeout=10) as r:
                text = r.read().decode()
        except (OSError, ValueError) as e:
            print(f"vgpu-smi: cannot fetch {url}: {e}", file=sys.stderr)
            return 2
        metrics = parse_prom(text)
        if args.command == "top":
            info = top_info(metrics)
            print(json.dumps(info, indent=1) if args.as_json
                  else format_top(info))
            return 0
        info = cluster_info(metrics)
        print(json.dumps(info, indent=1) if args.as_json
              else format_cluster(info))
        return 0

    from ..monitor.reader import RegionReader

    reader = RegionReader(args.library or None)
    targets: List[tuple] = []
    if args.containers_dir:
        # Same scan the node monitor runs (tolerates dirs vanishing
        # mid-scan, one region per container).
        targets = sorted(scan_container_dirs(args.containers_dir).items())
    else:
        path = args.region or os.environ.get(
            "CUDA_DEVICE_MEMORY_SHARED_CACHE", "")
        if not path:
            print("vgpu-smi: no region (not a vgpu container? set --region "
                  "or --containers-dir)", file=sys.stderr)
            return 2
        targets.append(("this container", path))

    out = {}
    for title, path in targets:
        region = reader.open(path)
        if region is None:
            print(f"vgpu-smi: cannot open region {path}", file=sys.stderr)
            continue
        try:
            out[title] = region_info(region)
        finally:
            region.close()
    if not out:
        return 1
    if args.as_json:
        print(json.dumps(out, indent=1))
    else:
        for title, info in out.items():
            print(format_info(info, title))
    return 0


if __name__ == "__main__":
    sys.exit(main())
