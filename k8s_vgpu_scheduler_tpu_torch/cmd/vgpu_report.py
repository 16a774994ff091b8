"""vgpu-report: per-namespace showback over a time window (the port's
counterpart of the JAX package's ``cmd/vtpu_report.py``).

Fetches the extender's ``GET /usagez`` export (``accounting/efficiency.py``
``showback``) and emits chargeback rows: GPU-seconds and memory
byte-seconds actually used per namespace, granted GPU-seconds for the same
window, the efficiency ratio and idle-grant counts; ``--pods`` adds a row
a pod.  JSON for pipelines, CSV for spreadsheets, text for people.

``GET /queuez`` (the capacity queues) is joined in: each governed
namespace's row gets its queue, nominal, held and borrowed cards, and the
text adds the queue table and the pending pods.  ``GET /capacityz`` (the
capacity forecast) adds the capacity section: the scale recommendation
and each queue's demand, forecast, upper band, starvation ETA and drift.
The JAX report also joins ``/auditz``, ``/sloz`` and ``/explainz``; the
port's extender serves none of them until ROADMAP A.5, and the report
degrades exactly as the JAX report does where they are absent (the audit
and slo lines as '-', every pending pod's reason '-').
``--explain`` renders decision provenance, which is A.5's: it exits 2 and
says so.  Standard library only.

Usage:
  vgpu-report --cluster http://sched:9443 [--window 3600] [--pods]
  vgpu-report --cluster ... --csv
"""

from __future__ import annotations

import argparse
import csv
import io
import json
import sys
from typing import List, Optional

NAMESPACE_COLUMNS = ["namespace", "pods", "chip_seconds",
                     "hbm_byte_seconds", "granted_chip_seconds",
                     "efficiency", "idle_grants",
                     "queue", "nominal_chips", "held_chips",
                     "borrowed_chips"]
POD_COLUMNS = ["namespace", "pod", "node", "granted_chips", "chip_seconds",
               "hbm_byte_seconds", "window_covered_s", "last_sample_age_s",
               "efficiency", "idle", "live"]
#: A ledger series older than this is reported with an explicit STALE
#: marker instead of silently presenting frozen totals (--stale-after).
DEFAULT_STALE_AFTER_S = 120.0


def _base_url(cluster: str) -> str:
    url = cluster.rstrip("/")
    if "://" not in url:
        url = "http://" + url
    return url


def fetch_usage(cluster: str, window: Optional[float]) -> dict:
    import urllib.request

    url = _base_url(cluster)
    if not url.endswith("/usagez"):
        url += "/usagez"
    if window is not None:
        url += f"?window={window:g}"
    with urllib.request.urlopen(url, timeout=15) as r:
        return json.load(r)


def fetch_queues(cluster: str) -> Optional[dict]:
    """GET /queuez, or None when the scheduler predates capacity queues
    or runs without them (the report degrades to plain showback)."""
    import urllib.request

    url = _base_url(cluster)
    if not url.endswith("/queuez"):
        url += "/queuez"
    try:
        with urllib.request.urlopen(url, timeout=15) as r:
            doc = json.load(r)
    except Exception:  # noqa: BLE001 — quota is optional
        return None
    return doc if doc.get("enabled") else None


def fetch_capacity(cluster: str) -> Optional[dict]:
    """GET /capacityz, or None when the scheduler predates the
    predictive-capacity surface (the report degrades gracefully)."""
    import urllib.request

    url = _base_url(cluster)
    if not url.endswith("/capacityz"):
        url += "/capacityz"
    try:
        with urllib.request.urlopen(url, timeout=15) as r:
            return json.load(r)
    except Exception:  # noqa: BLE001 — capacity surface is optional
        return None


def fetch_audit(cluster: str) -> Optional[dict]:
    """GET /auditz, or None when the scheduler predates the fleet
    auditor / runs --no-audit — the report then shows the audit line
    as '-' instead of a section (the --explain/capacity degradation
    pattern)."""
    import urllib.request

    url = _base_url(cluster)
    if not url.endswith("/auditz"):
        url += "/auditz"
    try:
        with urllib.request.urlopen(url, timeout=15) as r:
            doc = json.load(r)
    except Exception:  # noqa: BLE001 — audit surface is optional
        return None
    return doc if "open_total" in doc else None


def fetch_slo(cluster: str) -> Optional[dict]:
    """GET /sloz, or None when the scheduler predates the SLO engine /
    runs --no-slo / declares no objectives — the report then shows the
    slo line as '-' instead of a section (same degradation pattern as
    fetch_audit)."""
    import urllib.request

    url = _base_url(cluster)
    if not url.endswith("/sloz"):
        url += "/sloz"
    try:
        with urllib.request.urlopen(url, timeout=15) as r:
            doc = json.load(r)
    except Exception:  # noqa: BLE001 — SLO surface is optional
        return None
    return doc if "objectives" in doc else None


def fetch_explain(cluster: str, ref: str) -> Optional[dict]:
    """GET /explainz for one pod, or None when the scheduler predates
    decision provenance / runs --no-provenance / never saw the pod —
    the pending table then shows '-' instead of a dominant reason."""
    import urllib.parse
    import urllib.request

    url = _base_url(cluster)
    if not url.endswith("/explainz"):
        url += "/explainz"
    url += f"?pod={urllib.parse.quote(ref, safe='')}"
    try:
        with urllib.request.urlopen(url, timeout=15) as r:
            doc = json.load(r)
    except Exception:  # noqa: BLE001 — provenance surface is optional
        return None
    return doc if "records" in doc else None


def join_pending_reasons(export: dict, cluster: str,
                         fetch=fetch_explain) -> dict:
    """The pending-pods table: every held entry from the /queuez rows,
    annotated with its dominant rejection reason from /explainz —
    'why exactly is each of these pods waiting' in one view.  One
    /explainz fetch per pending pod (they are few by construction:
    position-ordered queue heads, not the fleet)."""
    rows = []
    for q in export.get("queues", []):
        for p in q.get("pending_pods", []):
            doc = fetch(cluster, p["pod"])
            reason = None
            if doc is not None:
                final = doc.get("final") or {}
                if final.get("stage") in ("resize-shrink",
                                          "resize-grow"):
                    # Mid-resize beats any stale rejection tally: the
                    # pod is pending BECAUSE its gang is restarting at
                    # a new mesh shape, and the transition says so.
                    det = final.get("detail") or {}
                    reason = (f"{final['stage']} "
                              f"{det.get('mesh_from', '?')}->"
                              f"{det.get('mesh_to', '?')}")
                else:
                    reason = doc.get("dominant_rejection")
                    if reason is None and final:
                        # Never rejected: the newest stage IS the story
                        # (quota-hold, rescue-queued, ...).
                        reason = final["stage"]
            rows.append({"pod": p["pod"], "queue": q["queue"],
                         "position": p["position"], "chips": p["chips"],
                         "gang": p.get("gang"),
                         "dominant_rejection": reason or "-"})
    if rows:
        export["pending_pods"] = rows
    return export


def join_quota(export: dict, queues: Optional[dict]) -> dict:
    """Annotate each namespace showback row with its governing queue's
    quota utilization (nominal vs held vs borrowed) — the 'measured'
    column is the row's own chip_seconds from the usage ledger."""
    if not queues:
        return export
    by_ns = {}
    for row in queues.get("queues", []):
        for ns in row.get("namespaces", ()):
            by_ns[ns] = row
    for row in export.get("namespaces", []):
        q = by_ns.get(row["namespace"])
        if q is None:
            continue
        row["queue"] = q["queue"]
        row["nominal_chips"] = q["nominal_chips"]
        row["held_chips"] = q["held_chips"]
        row["borrowed_chips"] = q["borrowed_chips"]
    export["queues"] = queues.get("queues", [])
    return export


def to_csv(rows: List[dict], columns: List[str]) -> str:
    buf = io.StringIO()
    w = csv.DictWriter(buf, fieldnames=columns, extrasaction="ignore")
    w.writeheader()
    for row in rows:
        w.writerow(row)
    return buf.getvalue()


def stale_marker(age_s: Optional[float],
                 stale_after_s: float) -> str:
    """`` STALE (last sample Xs ago)`` when the series age is over the
    threshold, else empty — the explicit freshness guard both CLIs
    print instead of silently reporting frozen totals."""
    if age_s is None or age_s <= stale_after_s:
        return ""
    return f" STALE (last sample {age_s:.0f}s ago)"


def format_capacity(cap: dict) -> str:
    """The ``vgpu-report`` capacity section: scale recommendation,
    per-queue starvation ETAs and forecast drift (GET /capacityz)."""
    lines = [
        "+ capacity ({} horizon {:.0f}s, buckets {:.0f}s)".format(
            cap.get("method", "analytic"), cap.get("horizon_s", 0.0),
            cap.get("bucket_s", 0.0)),
        "| scale: {} node(s) now, {} recommended (+{}); peak forecast "
        "demand {:.1f} chips".format(
            cap.get("nodes_current", 0), cap.get("nodes_recommended", 0),
            cap.get("nodes_to_add", 0),
            cap.get("peak_forecast_demand_chips", 0.0)),
        "| {:<14s} {:>7s} {:>9s} {:>9s} {:>12s} {:>7s} |".format(
            "queue", "demand", "forecast", "upper", "starves-in",
            "drift"),
    ]
    for q in cap.get("queues", []):
        eta = q.get("starvation_eta_s")
        err = q.get("forecast_error_ratio")
        lines.append(
            "| {:<14s} {:>7.1f} {:>9.1f} {:>9.1f} {:>12s} {:>7s} |"
            .format(q["queue"][:14], q["demand_chips"],
                    q["forecast_demand_chips"],
                    q["forecast_upper_chips"],
                    f"{eta:.0f}s" if eta is not None else "never",
                    f"{100 * err:.0f}%" if err is not None else "-"))
    return "\n".join(lines)


def format_audit(audit: Optional[dict]) -> str:
    """The ``vgpu-report`` audit section: open findings by type and the
    last-clean age (GET /auditz).  ``None`` (pre-audit scheduler, or
    --no-audit) degrades to a '-' line, mirroring how the pending table
    shows '-' for pre-provenance schedulers."""
    if audit is None:
        return "+ audit: - (no /auditz on this scheduler)"
    open_types = [(t, n) for t, n in
                  sorted(audit.get("open_by_type", {}).items()) if n]
    clean_age = audit.get("sweeps", {}).get("last_clean_age_s")
    clean = (f"last clean {clean_age:.0f}s ago"
             if clean_age is not None else "never verified clean")
    if not open_types:
        return f"+ audit: clean ({clean}; vtpu-audit for detail)"
    lines = [f"+ audit: {audit.get('open_total', 0)} OPEN finding(s) "
             f"({clean}; vtpu-audit for triage)"]
    for t, n in open_types:
        lines.append(f"|   {t:<24s} {n}")
    return "\n".join(lines)


def format_slo(slo: Optional[dict]) -> str:
    """The ``vgpu-report`` slo section: attainment and budget per
    objective plus any open burn signals (GET /sloz).  ``None``
    (pre-SLO scheduler, --no-slo, or no objectives declared) degrades
    to a '-' line, same as the audit section."""
    if slo is None:
        return "+ slo: - (no /sloz on this scheduler)"
    objectives = slo.get("objectives", [])
    open_sig = slo.get("signals_open", [])
    if not open_sig:
        head = (f"+ slo: {len(objectives)} objective(s), no burn "
                "signal open (vtpu-slo for detail)")
    else:
        by_sev = slo.get("signals_open_by_severity", {})
        head = (f"+ slo: {len(open_sig)} OPEN burn signal(s) "
                f"({by_sev.get('page', 0)} page, "
                f"{by_sev.get('ticket', 0)} ticket; vtpu-slo for "
                "triage)")
    lines = [head]
    for o in objectives:
        att = o.get("attainment")
        lines.append(
            "|   {:<34s} attained {:>9s}  budget {:>6.1%}".format(
                o["objective"][:34],
                f"{att:.4%}" if att is not None else "-",
                o.get("error_budget_remaining_ratio", 1.0)))
    return "\n".join(lines)


def format_report(export: dict, pods: bool = False,
                  stale_after_s: float = DEFAULT_STALE_AFTER_S) -> str:
    fleet = export.get("fleet", {})
    eff = fleet.get("efficiency")
    lines = [
        "showback over the last {:.0f}s — fleet efficiency: {}{}".format(
            export.get("window_s", 0.0),
            f"{eff:.1%}" if eff is not None else "n/a (no usage reports)",
            stale_marker(export.get("newest_sample_age_s"),
                         stale_after_s)),
        "| {:<20s} {:>5s} {:>12s} {:>16s} {:>12s} {:>6s} {:>5s} |".format(
            "namespace", "pods", "chip-s", "hbm-byte-s", "granted-s",
            "eff%", "idle"),
    ]
    for row in export.get("namespaces", []):
        e = row.get("efficiency")
        lines.append(
            "| {:<20s} {:>5d} {:>12.1f} {:>16.3g} {:>12.1f} {:>6s} "
            "{:>5d} |".format(
                row["namespace"][:20], row["pods"], row["chip_seconds"],
                row["hbm_byte_seconds"], row["granted_chip_seconds"],
                f"{100 * e:.1f}" if e is not None else "-",
                row["idle_grants"]))
    if export.get("queues"):
        lines.append("+ capacity queues (nominal vs held vs measured)")
        lines.append(
            "| {:<14s} {:>6s} {:>7s} {:>4s} {:>8s} {:>8s} {:>7s} "
            "{:>12s} |".format("queue", "weight", "nominal", "held",
                               "borrowed", "pending", "share", "chip-s"))
        ns_measured = {r["namespace"]: r["chip_seconds"]
                       for r in export.get("namespaces", [])}
        for q in export["queues"]:
            measured = sum(ns_measured.get(ns, 0.0)
                           for ns in q.get("namespaces", ()))
            over = " OVER" if q["borrowed_chips"] > 0 else ""
            lines.append(
                "| {:<14s} {:>6.1f} {:>7d} {:>4d} {:>8d} {:>8d} "
                "{:>7.3f} {:>12.1f} |{}".format(
                    q["queue"][:14], q["weight"], q["nominal_chips"],
                    q["held_chips"], q["borrowed_chips"], q["pending"],
                    q["fair_share"], measured, over))
    if export.get("pending_pods"):
        lines.append("+ pending pods (dominant rejection from /explainz"
                     "; vgpu-explain <ns/name> for the full timeline)")
        lines.append(
            "| {:<30s} {:<12s} {:>3s} {:>5s} {:<24s} |".format(
                "pod", "queue", "pos", "chips", "why pending"))
        for row in export["pending_pods"]:
            lines.append(
                "| {:<30s} {:<12s} {:>3d} {:>5d} {:<24s} |".format(
                    row["pod"][:30], row["queue"][:12], row["position"],
                    row["chips"], row["dominant_rejection"][:24]))
    if pods:
        lines.append("+ pods")
        for row in export.get("pods", []):
            e = row.get("efficiency")
            flags = "IDLE" if row.get("idle") else (
                "" if row.get("live") else "gone")
            lines.append(
                "| {:<34s} {:>2d} chips {:>10.1f} chip-s {:>6s}% {}{} |"
                .format(f"{row['namespace']}/{row['pod']}"[:34],
                        row["granted_chips"], row["chip_seconds"],
                        f"{100 * e:.1f}" if e is not None else "-",
                        flags,
                        stale_marker(row.get("last_sample_age_s"),
                                     stale_after_s)))
    idle = export.get("idle_grants", [])
    if idle:
        lines.append(f"IDLE GRANTS: {len(idle)} pod(s) holding unused "
                     "capacity")
        for p in idle:
            lines.append(
                "  {:<34s} {} chip(s) on {}, idle {:.0f}s".format(
                    f"{p['namespace']}/{p['name']}"[:34],
                    p["granted_chips"], p["node"], p["idle_for_s"]))
    if export.get("capacity"):
        lines.append(format_capacity(export["capacity"]))
    if "audit" in export:
        lines.append(format_audit(export["audit"]))
    if "slo" in export:
        lines.append(format_slo(export["slo"]))
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser("vgpu-report")
    p.add_argument("--cluster", required=True,
                   help="extender HTTP base URL (the /usagez endpoint), "
                        "e.g. http://sched:9443")
    p.add_argument("--window", type=float, default=None,
                   help="trailing window in seconds (default: the "
                        "scheduler's --efficiency-window)")
    p.add_argument("--pods", action="store_true",
                   help="include per-pod rows, not just namespaces")
    p.add_argument("--stale-after", type=float,
                   default=DEFAULT_STALE_AFTER_S,
                   help="mark rows whose newest ledger sample is older "
                        "than this many seconds STALE instead of "
                        "silently reporting frozen totals")
    p.add_argument("--no-capacity", action="store_true",
                   help="skip the GET /capacityz capacity section")
    p.add_argument("--no-audit", action="store_true",
                   help="skip the GET /auditz fleet-audit section")
    p.add_argument("--no-slo", action="store_true",
                   help="skip the GET /sloz SLO section")
    p.add_argument("--explain", default="", metavar="NS/NAME",
                   help="one pod's decision-provenance timeline (ROADMAP "
                        "A.5; exits 2 on the port)")
    p.add_argument("--no-explain", action="store_true",
                   help="skip the per-pending-pod GET /explainz joins "
                        "in the pending-pods table")
    fmt = p.add_mutually_exclusive_group()
    fmt.add_argument("--json", action="store_true", dest="as_json")
    fmt.add_argument("--csv", action="store_true", dest="as_csv")
    args = p.parse_args(argv)

    if args.explain:
        print("vgpu-report: --explain renders decision provenance "
              "(/explainz), which the port's extender serves once ROADMAP "
              "A.5's provenance store is ported", file=sys.stderr)
        return 2

    try:
        export = fetch_usage(args.cluster, args.window)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"vgpu-report: cannot fetch usage: {e}", file=sys.stderr)
        return 2
    export = join_quota(export, fetch_queues(args.cluster))
    if not args.no_explain:
        export = join_pending_reasons(export, args.cluster)
    if not args.no_capacity:
        cap = fetch_capacity(args.cluster)
        if cap is not None:
            export["capacity"] = cap
    if not args.no_audit:
        # None stays in the export: the section renders the '-'
        # degradation line instead of vanishing (an operator reading
        # the report should see that audit state is UNKNOWN, not
        # silently assume clean).
        export["audit"] = fetch_audit(args.cluster)
    if not args.no_slo:
        # Same None-stays-in-the-export rule as audit: '-' over
        # silently assuming every budget is healthy.
        export["slo"] = fetch_slo(args.cluster)
    if args.as_json:
        print(json.dumps(export, indent=1))
    elif args.as_csv:
        if args.pods:
            print(to_csv(export.get("pods", []), POD_COLUMNS), end="")
        else:
            print(to_csv(export.get("namespaces", []), NAMESPACE_COLUMNS),
                  end="")
    else:
        print(format_report(export, pods=args.pods,
                            stale_after_s=args.stale_after))
    return 0


if __name__ == "__main__":
    sys.exit(main())
