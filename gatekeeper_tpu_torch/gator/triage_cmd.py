"""``gator triage``: one command, one incident picture.

During a brownout the operator today opens five ``/debug`` endpoints in
five tabs and correlates by hand: which objective is burning, which
degradation maps fired, which template is eating the budget, what the
slowest request actually did, who got shed.  ``triage`` snapshots all
five (``/debug/slo`` + ``/debug/cost`` + ``/debug/overload`` +
``/debug/traces`` + ``/debug/decisions``) and cross-links them into a
single human-readable incident report — breaching objective → active
degradations → top cost templates → slowest exemplar trace → recent
shed decisions — plus a ``--json`` bundle for tooling.

Two modes:

* **live** (``--url http://host:port``): HTTP GET against a running
  webhook's debug endpoints.  ``--cluster`` scopes the SLO view and
  the decision filter to one fleet cluster.
* **offline** (``-f sink.jsonl [--spill DIR]``): the pod is gone; the
  flight-recorder sink (rotated sets read transparently) is the source
  of truth.  Degradations in force are reconstructed from the
  ``overload.degraded`` stamps on recorded decisions; ``--spill``
  inventories per-cluster audit snapshot spills so staleness triage
  has a footing without a live ``/debug/slo``.

    gator triage --url http://localhost:8443
    gator triage -f decisions.jsonl --spill /var/spill -o json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import urllib.error
import urllib.request
from datetime import datetime, timezone
from typing import Optional

# the five endpoints a triage snapshot covers, keyed by bundle section
ENDPOINTS = {
    "slo": "/debug/slo",
    "cost": "/debug/cost",
    "overload": "/debug/overload",
    "traces": "/debug/traces",
    "decisions": "/debug/decisions",
}


# --- collection -----------------------------------------------------------

def _fetch(url: str, timeout: float) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read().decode("utf-8", "replace"))


def collect_live(base_url: str, cluster: Optional[str] = None,
                 timeout: float = 5.0, fetch=_fetch) -> dict:
    """Snapshot the five debug endpoints of a live server into one
    bundle.  A failing endpoint becomes ``{"error": ...}`` — an
    incident report with four working sections beats no report (the
    exact failure mode triage runs during)."""
    base = base_url.rstrip("/")
    bundle: dict = {"mode": "live", "url": base}
    for key, path in ENDPOINTS.items():
        url = base + path
        if key == "slo" and cluster:
            url += f"?cluster={cluster}"
        elif key == "decisions" and cluster:
            url += f"?cluster={cluster}"
        try:
            bundle[key] = fetch(url, timeout)
        except (OSError, ValueError, urllib.error.URLError) as e:
            bundle[key] = {"error": f"{path}: {e}"}
    if cluster:
        bundle["cluster"] = cluster
    return bundle


def collect_offline(sink: str, spill: str = "",
                    cluster: Optional[str] = None,
                    limit: int = 500) -> dict:
    """Post-mortem bundle from the flight-recorder sink (+ optional
    snapshot-spill root).  Sections a dead pod can't serve (slo, cost,
    traces) are reconstructed as far as the black box allows: the
    ``overload.degraded`` stamps on decisions say which degradation
    maps were in force, decision ``cost``/``trace_id`` fields give a
    cost/exemplar footing, spill subdirs inventory per-cluster audit
    state."""
    from gatekeeper_tpu_torch.gator.decisions_cmd import read_decisions

    bundle: dict = {"mode": "offline", "sink": sink}
    try:
        bundle["decisions"] = read_decisions(
            sink, cluster=cluster, limit=max(0, limit))
    except OSError as e:
        bundle["decisions"] = {"error": f"{sink}: {e}"}
    if cluster:
        bundle["cluster"] = cluster
    # degradations in force, reconstructed newest-first from the
    # decision stamps ("this allow served a stale namespace")
    seen: dict = {}
    for e in bundle["decisions"].get("decisions", []):
        for name in (e.get("overload") or {}).get("degraded", []):
            if name not in seen:
                seen[name] = e.get("ts", 0.0)
    bundle["overload"] = {
        "reconstructed": True,
        "degraded": [{"action": n, "last_seen_ts": t}
                     for n, t in sorted(seen.items())],
    }
    if spill:
        inv = []
        try:
            for entry in sorted(os.listdir(spill)):
                p = os.path.join(spill, entry)
                if not os.path.isdir(p):
                    continue
                files = sorted(os.listdir(p))
                newest = 0.0
                for f in files:
                    try:
                        newest = max(newest,
                                     os.path.getmtime(os.path.join(p, f)))
                    except OSError:
                        pass
                inv.append({"cluster": entry, "files": len(files),
                            "newest_mtime": newest})
        except OSError as e:
            inv = [{"error": f"{spill}: {e}"}]
        bundle["spill"] = {"root": spill, "clusters": inv}
    return bundle


# --- cross-linking --------------------------------------------------------

def build_report(bundle: dict, top_n: int = 5) -> dict:
    """Cross-link the bundle's sections into the triage chain:
    breaching objective → its active degradations → top cost templates
    → slowest exemplar trace → recent shed decisions.  Pure over the
    bundle dict, so live and offline (and tests) share one path."""
    report: dict = {}

    slo = bundle.get("slo") or {}
    objectives = slo.get("objectives") or []
    breaching = [ev for ev in objectives if ev.get("breach")]
    non_compliant = [ev for ev in objectives
                     if not ev.get("compliant", True)
                     and not ev.get("breach")]
    report["objectives_total"] = len(objectives)
    report["breaching"] = breaching
    report["non_compliant"] = non_compliant

    # active degradations: prefer the authoritative overload view,
    # fall back to the per-objective SLO view / offline reconstruction
    ovl = bundle.get("overload") or {}
    degraded = ovl.get("degraded") or []
    if not degraded:
        degraded = [
            {"action": a, "objectives": [ev.get("name", "")]}
            for ev in objectives
            for a in ev.get("degradation_active", [])]
    report["degraded"] = degraded

    cost = bundle.get("cost") or {}
    report["top_templates"] = (cost.get("top") or [])[:top_n]
    report["top_tenants"] = (cost.get("tenants") or [])[:top_n]

    traces = (bundle.get("traces") or {}).get("traces") or []
    slowest = sorted(traces, key=lambda t: -t.get("duration_s", 0.0))
    report["slowest_traces"] = slowest[:top_n]

    decisions = (bundle.get("decisions") or {}).get("decisions") or []
    sheds = [e for e in decisions if e.get("decision") == "shed"]
    report["recent_sheds"] = sheds[:top_n]
    report["decision_counts"] = _count_by(decisions, "decision")

    # exemplar linkage: the slowest kept trace back to its decision(s)
    by_trace = {}
    for e in decisions:
        tid = e.get("trace_id", "")
        if tid:
            by_trace.setdefault(tid, []).append(e)
    report["exemplar"] = None
    for t in slowest:
        linked = by_trace.get(t.get("trace_id", ""))
        if linked:
            report["exemplar"] = {"trace": t, "decisions": linked}
            break
    if report["exemplar"] is None and slowest:
        report["exemplar"] = {"trace": slowest[0], "decisions": []}

    # the chain, one entry per breaching objective
    chains = []
    for ev in breaching:
        chains.append({
            "objective": ev.get("name", ""),
            "cluster": ev.get("cluster", ""),
            "tier": ev.get("breach_tier", ""),
            "burn": ev.get("burn"),
            "sli": ev.get("sli"),
            "target": ev.get("target"),
            "degradations": list(ev.get("degradation_active") or []),
            "next_degradation": _next_action(ev),
            "top_template": (report["top_templates"][0]["template"]
                             if report["top_templates"] else ""),
            "slowest_trace": (report["slowest_traces"][0]["trace_id"]
                              if report["slowest_traces"] else ""),
            "recent_sheds": len(sheds),
        })
    report["chains"] = chains
    return report


def _next_action(ev: dict) -> str:
    deg = ev.get("degradation") or []
    active = ev.get("degradation_active") or []
    return deg[len(active)] if len(active) < len(deg) else ""


def _count_by(entries: list, key: str) -> dict:
    out: dict = {}
    for e in entries:
        out[e.get(key, "")] = out.get(e.get(key, ""), 0) + 1
    return out


# --- rendering ------------------------------------------------------------

def _ts(t: float) -> str:
    try:
        return datetime.fromtimestamp(
            t, tz=timezone.utc).strftime("%H:%M:%S")
    except (OverflowError, OSError, ValueError):
        return str(t)


def render(bundle: dict, report: dict) -> str:
    """The human incident report."""
    lines = []
    src = bundle.get("url") or bundle.get("sink") or ""
    head = f"gatekeeper triage — {bundle.get('mode', '?')} {src}"
    if bundle.get("cluster"):
        head += f" [cluster {bundle['cluster']}]"
    lines += [head, "=" * len(head), ""]

    for key in ("slo", "cost", "overload", "traces", "decisions"):
        err = (bundle.get(key) or {}).get("error")
        if err:
            lines.append(f"!! {key}: unavailable ({err})")
    if any((bundle.get(k) or {}).get("error")
           for k in ("slo", "cost", "overload", "traces", "decisions")):
        lines.append("")

    n_breach = len(report["breaching"])
    if bundle.get("slo") is not None and "error" not in \
            (bundle.get("slo") or {}):
        lines.append(f"SLO: {n_breach}/{report['objectives_total']} "
                     f"objectives breaching"
                     + (f", {len(report['non_compliant'])} non-compliant"
                        if report["non_compliant"] else ""))
        for ev in report["breaching"]:
            lines.append(
                f"  ! {ev.get('name', '?')}  sli={ev.get('sli')}  "
                f"target={ev.get('target')}  burn={ev.get('burn')}"
                f"  tier={ev.get('breach_tier', '')}")
            active = ev.get("degradation_active") or []
            if active:
                lines.append("      degradations active: "
                             + " -> ".join(active))
            nxt = _next_action(ev)
            if nxt:
                lines.append(f"      next if sustained: {nxt}")
        lines.append("")

    if report["degraded"]:
        lines.append("Degradations in force:")
        for d in report["degraded"]:
            tag = d.get("action", "?")
            if d.get("cluster"):
                tag += f"@{d['cluster']}"
            holders = d.get("objectives") or []
            extra = f"  held by: {', '.join(holders)}" if holders else ""
            if d.get("last_seen_ts"):
                extra += f"  last seen {_ts(d['last_seen_ts'])}"
            lines.append(f"  {tag}{extra}")
        lines.append("")

    if report["top_templates"]:
        lines.append("Top cost templates:")
        for i, t in enumerate(report["top_templates"], 1):
            lines.append(f"  {i}. {t.get('template', '?')}  "
                         f"{t.get('seconds', 0.0)}s over "
                         f"{t.get('passes', 0)} passes")
        lines.append("")

    ex = report["exemplar"]
    if ex is not None:
        t = ex["trace"]
        lines.append(f"Slowest exemplar trace: {t.get('trace_id', '?')}  "
                     f"root={t.get('root', '?')}  "
                     f"{t.get('duration_s', 0.0):.3f}s  "
                     f"{t.get('n_spans', 0)} spans")
        for e in ex["decisions"][:3]:
            lines.append(f"  -> decision: {e.get('decision', '?')} "
                         f"uid={e.get('uid', '')} "
                         f"cost={e.get('cost', 0.0)}")
        lines.append("")

    decs = bundle.get("decisions") or {}
    if "error" not in decs:
        counts = report["decision_counts"]
        if counts:
            lines.append("Decisions ("
                         + ", ".join(f"{k}={v}" for k, v
                                     in sorted(counts.items())) + "):")
        if report["recent_sheds"]:
            for e in report["recent_sheds"]:
                tag = f"  {_ts(e.get('ts', 0.0))}  shed  " \
                      f"uid={e.get('uid', '')}"
                if e.get("tenant"):
                    tag += f"  tenant={e['tenant']}"
                if e.get("reason"):
                    tag += f"  reason={e['reason']}"
                deg = (e.get("overload") or {}).get("degraded")
                if deg:
                    tag += f"  [degraded: {', '.join(deg)}]"
                lines.append(tag)
        elif counts:
            lines.append("  (no recent sheds)")
        lines.append("")

    spill = bundle.get("spill")
    if spill:
        lines.append(f"Audit snapshot spills under {spill['root']}:")
        for c in spill["clusters"]:
            if "error" in c:
                lines.append(f"  !! {c['error']}")
            else:
                lines.append(f"  {c['cluster']}: {c['files']} files, "
                             f"newest {_ts(c['newest_mtime'])}")
        lines.append("")

    if report["chains"]:
        lines.append("Chain:")
        for c in report["chains"]:
            seg = [f"{c['objective']} breaching "
                   f"(burn {c['burn']}, {c['tier'] or 'n/a'})"]
            if c["degradations"]:
                seg.append("activated " + ", ".join(c["degradations"]))
            if c["top_template"]:
                seg.append(f"top template {c['top_template']}")
            if c["slowest_trace"]:
                seg.append(f"slowest trace {c['slowest_trace'][:16]}")
            seg.append(f"{c['recent_sheds']} recent sheds")
            lines.append("  " + " -> ".join(seg))
    elif bundle.get("slo") is not None and n_breach == 0 and \
            "error" not in (bundle.get("slo") or {}):
        lines.append("Chain: all objectives compliant — nothing to "
                     "triage.")
    elif bundle.get("slo") is None:
        lines.append("Chain: no SLO view in this bundle (offline "
                     "sink only) — see degradation stamps above.")
    return "\n".join(lines).rstrip() + "\n"


# --- CLI ------------------------------------------------------------------

def run_cli(argv: list) -> int:
    p = argparse.ArgumentParser(
        prog="gator triage",
        description="one-shot incident snapshot: /debug/slo + cost + "
                    "overload + traces + decisions, cross-linked into "
                    "a triage chain (live --url or offline -f sink)")
    p.add_argument("--url", default="",
                   help="live mode: base URL of a running webhook "
                        "(e.g. http://localhost:8443)")
    p.add_argument("--filename", "-f", default="",
                   help="offline mode: flight-recorder JSONL sink "
                        "(rotated sets read transparently)")
    p.add_argument("--spill", default="",
                   help="offline mode: snapshot-spill root to "
                        "inventory per-cluster audit state")
    p.add_argument("--cluster", default=None,
                   help="scope the SLO view + decision filter to one "
                        "fleet cluster")
    p.add_argument("--timeout", type=float, default=5.0,
                   help="live mode: per-endpoint HTTP timeout seconds")
    p.add_argument("--top", type=int, default=5,
                   help="entries per report section")
    p.add_argument("--output", "-o", default="",
                   choices=["", "json"],
                   help="json: the raw bundle + report (default: "
                        "human incident report)")
    args = p.parse_args(argv)
    if bool(args.url) == bool(args.filename):
        print("error: exactly one of --url (live) or -f (offline) "
              "is required", file=sys.stderr)
        return 2
    if args.url:
        bundle = collect_live(args.url, cluster=args.cluster,
                              timeout=args.timeout)
    else:
        bundle = collect_offline(args.filename, spill=args.spill,
                                 cluster=args.cluster)
    bundle["collected_at"] = time.time()
    report = build_report(bundle, top_n=max(1, args.top))
    if args.output == "json":
        print(json.dumps({"bundle": bundle, "report": report},
                         indent=2, default=str))
    else:
        print(render(bundle, report), end="")
    # exit 1 when something is breaching: triage in a script gates on it
    return 1 if report["chains"] else 0
