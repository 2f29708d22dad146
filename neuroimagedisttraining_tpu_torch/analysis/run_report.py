"""The run report (the reference package's ``analysis/run_report.py``):
one joined artifact of a finished run.

A run leaves its evidence in three places: the metrics JSONL sink
(``--metrics_out``: one registry snapshot a host boundary, keyed by the
monotonic ``round`` and ``seq`` fields), the flight recorder's dump (the
ring of ``--flight_events`` control-plane events, ``alert`` events
included: ``<log_dir>/<dataset>/<identity>.flight.json`` on a failure,
or ``obs/flight.py`` ``dump``) and the rules' end-of-run verdict
(``<log_dir>/<dataset>/<identity>.health.json``). This module joins them
into one ``run_report.json`` and a markdown summary:

- the round-by-round trajectory (train loss, evaluation metrics, the
  ``nidt_health_*`` update geometry, the epsilon spend);
- the alert timeline (the verdict's timeline merged with the flight
  ring's ``alert`` events, in round order);
- the epsilon ledger by source and silo;
- the fallbacks, captures and dispatches of the final snapshot.

Joins ride the ``round`` and ``seq`` keys, never timestamps. CLI::

    python -m neuroimagedisttraining_tpu_torch.analysis.run_report \\
        --metrics RUN.metrics.jsonl --flight RUN.flight.json \\
        --verdict LOG/.../RUN.health.json --out REPORT_DIR

Any input may be absent (a run without a failure has no flight dump);
the report records what it joined. Standard library only, with the metric
names of ``obs/names.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any

from neuroimagedisttraining_tpu_torch.obs import names as N

__all__ = ["read_metrics_jsonl", "build_report", "render_markdown",
           "main", "SCHEMA"]

SCHEMA = "nidt-run-report-v1"

#: snapshot gauges that become per-round trajectory columns:
#: column name -> (metric name, label subset)
_ROUND_COLUMNS: tuple[tuple[str, str, dict], ...] = (
    ("train_loss", N.EXP_METRIC, {"key": "train_loss"}),
    ("acc", N.EXP_METRIC, {"key": "acc"}),
    ("up_norm_med", N.HEALTH_UPDATE_NORM_MED, {}),
    ("up_norm_max", N.HEALTH_UPDATE_NORM_MAX, {}),
    ("cos_min", N.HEALTH_COSINE_MIN, {}),
    ("cos_mean", N.HEALTH_COSINE_MEAN, {}),
    ("dispersion", N.HEALTH_DIVERGENCE, {}),
    ("param_norm", N.HEALTH_PARAM_NORM, {}),
    ("agg_update_norm", N.HEALTH_AGG_UPDATE_NORM, {}),
    ("mask_density", N.HEALTH_MASK_DENSITY, {}),
    ("epsilon", N.DP_EPSILON, {}),
    ("epsilon_per_round", N.DP_EPSILON_PER_ROUND, {}),
)


def _cells(snap: dict, metric: str) -> list[dict]:
    m = snap.get(metric) or {}
    return list(m.get("values", ()))


def _gauge(snap: dict, metric: str, labels: dict) -> float | None:
    """First matching cell's value (label-subset match); health gauges
    are engine-labeled but single-engine per run, so first == the run's
    series."""
    for cell in _cells(snap, metric):
        lb = cell.get("labels", {})
        if all(lb.get(k) == v for k, v in labels.items()):
            v = cell.get("value")
            if isinstance(v, (int, float)):
                return float(v)
            return None
    return None


def read_metrics_jsonl(path: str) -> list[dict]:
    """The sink's records, sorted by the monotonic ``seq``. Records
    without a ``round`` field (older sinks) are dropped — the
    join key IS the contract."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # a torn final line must not kill the report
            if isinstance(rec, dict) and "round" in rec \
                    and "metrics" in rec:
                out.append(rec)
    out.sort(key=lambda r: r.get("seq", 0))
    return out


def _load(path: str | None) -> dict | None:
    if not path:
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def build_report(metrics_records: list[dict] | None,
                 flight_doc: dict | None,
                 verdict_doc: dict | None) -> dict:
    """Pure join: the three sources in, one report document out."""
    records = metrics_records or []
    rounds: list[dict] = []
    for rec in records:
        snap = rec.get("metrics", {})
        row: dict[str, Any] = {"round": int(rec["round"]),
                               "seq": int(rec.get("seq", 0))}
        for col, metric, labels in _ROUND_COLUMNS:
            v = _gauge(snap, metric, labels)
            if v is not None:
                row[col] = v
        rounds.append(row)

    # alert timeline: the verdict's (authoritative — debounced edges
    # with values) merged with flight `alert`/`alert_clear` events
    # (which survive even when the verdict was never written)
    timeline: list[dict] = []
    seen = set()
    for src, events in (
            ("verdict", (verdict_doc or {}).get("timeline", ())),
            ("flight", [e for e in (flight_doc or {}).get("events", ())
                        if e.get("kind") in ("alert", "alert_clear")])):
        for e in events:
            key = (e.get("kind"), e.get("rule"), e.get("round"))
            if key in seen:
                continue
            seen.add(key)
            timeline.append({"kind": e.get("kind"),
                             "rule": e.get("rule"),
                             "severity": e.get("severity"),
                             "round": e.get("round"),
                             "value": e.get("value"),
                             "source": src})
    timeline.sort(key=lambda e: (e["round"] if isinstance(e["round"],
                                                          int) else -1))

    final_snap = records[-1]["metrics"] if records else {}

    # epsilon ledger: running totals + burn rates per source, the
    # per-silo map when the cross-silo ledger published one
    ledger: dict[str, Any] = {"sources": {}, "per_silo": {}}
    for cell in _cells(final_snap, N.DP_EPSILON):
        src = cell.get("labels", {}).get("source", "")
        ledger["sources"][src] = {"epsilon": cell.get("value")}
    for cell in _cells(final_snap, N.DP_EPSILON_PER_ROUND):
        src = cell.get("labels", {}).get("source", "")
        ledger["sources"].setdefault(src, {})["epsilon_per_round"] = \
            cell.get("value")
    for cell in _cells(final_snap, N.DP_EPSILON_SILO):
        silo = cell.get("labels", {}).get("silo", "")
        ledger["per_silo"][silo] = cell.get("value")
    eps_rounds = [
        {"round": r["round"], "epsilon": r.get("epsilon"),
         "epsilon_per_round": r.get("epsilon_per_round")}
        for r in rounds if r.get("epsilon") is not None]
    ledger["trajectory"] = eps_rounds

    # fallback / dispatch accounting from the final snapshot
    fallbacks = [
        {"plane": c["labels"].get("plane"),
         "engine": c["labels"].get("engine"),
         "reason": c["labels"].get("reason"), "count": c["value"]}
        for c in _cells(final_snap, N.FALLBACK_TOTAL)]
    compiles = {
        f'{c["labels"].get("engine")}/{c["labels"].get("program")}':
        c["value"] for c in _cells(final_snap, N.COMPILES_TOTAL)}
    dispatch_count = sum(
        c["value"].get("count", 0)
        for c in _cells(final_snap, N.DISPATCH_MS)
        if isinstance(c.get("value"), dict))

    verdict = verdict_doc or {}
    alerts_total = int(verdict.get(
        "alerts_total",
        sum(1 for e in timeline if e["kind"] == "alert")))
    report = {
        "schema": SCHEMA,
        "summary": {
            "schema_ok": True,
            "rounds": len(rounds),
            "status": verdict.get("status", "unknown"),
            "worst_status": verdict.get("worst_status", "unknown"),
            "alerts_total": alerts_total,
            "first_round": rounds[0]["round"] if rounds else None,
            "last_round": rounds[-1]["round"] if rounds else None,
            "final": {k: rounds[-1].get(k)
                      for k in ("train_loss", "acc", "cos_min",
                                "dispersion")} if rounds else {},
            "joined": {"metrics": bool(records),
                       "flight": flight_doc is not None,
                       "verdict": verdict_doc is not None},
        },
        "rounds": rounds,
        "alerts": timeline,
        # the reflex actions: the verdict carries the action log
        # (timestamp-free, rule provenance on every entry) — lift it to
        # a top-level block so the report answers "what did the run DO
        # about its alerts" next to the alerts themselves
        "actions": (verdict_doc or {}).get("actions"),
        "epsilon_ledger": ledger,
        "dispatch": {"fallbacks": fallbacks, "compiles": compiles,
                     "dispatches": dispatch_count},
        "verdict": verdict,
        "flight": ({"capacity": flight_doc.get("capacity"),
                    "evicted": flight_doc.get("evicted"),
                    "events": len(flight_doc.get("events", ()))}
                   if flight_doc else None),
    }
    return report


def _fmt(v: Any) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def render_markdown(report: dict) -> str:
    """The human half: a summary header, the trajectory table (capped),
    the alert timeline, the epsilon ledger, fast-path accounting."""
    s = report["summary"]
    lines = [
        "# Run report",
        "",
        f"- **status**: {s['status']} (worst over run: "
        f"{s['worst_status']})",
        f"- **rounds joined**: {s['rounds']} "
        f"(rounds {_fmt(s['first_round'])}..{_fmt(s['last_round'])})",
        f"- **alerts**: {s['alerts_total']}",
        f"- **inputs joined**: " + ", ".join(
            k for k, v in s["joined"].items() if v) + (
            "" if all(s["joined"].values()) else
            " (missing: " + ", ".join(
                k for k, v in s["joined"].items() if not v) + ")"),
        "",
        "## Trajectory",
        "",
    ]
    cols = ("round", "train_loss", "acc", "up_norm_med", "cos_min",
            "dispersion", "epsilon")
    lines.append("| " + " | ".join(cols) + " |")
    lines.append("|" + "---|" * len(cols))
    rows = report["rounds"]
    shown = rows if len(rows) <= 60 else rows[:30] + rows[-30:]
    last_r = None
    for r in shown:
        if last_r is not None and r["round"] != last_r + 1 \
                and shown is not rows:
            lines.append("| ... |" + " |" * (len(cols) - 1))
        last_r = r["round"]
        lines.append("| " + " | ".join(_fmt(r.get(c)) for c in cols)
                     + " |")
    lines += ["", "## Alert timeline", ""]
    if report["alerts"]:
        for e in report["alerts"]:
            lines.append(
                f"- round {_fmt(e['round'])}: **{e['kind']}** "
                f"`{e['rule']}` ({e['severity']}, value "
                f"{_fmt(e['value'])})")
    else:
        lines.append("- none (a clean run)")
    acts = report.get("actions")
    if acts is not None and acts.get("mode", "unarmed") != "unarmed":
        lines += ["", "## Reflex actions", "",
                  f"- mode: `{acts['mode']}`; dispatches: "
                  f"{_fmt(acts.get('total'))}"]
        for e in acts.get("log", ()):
            tag = " (dry_run)" if e.get("dry_run") else ""
            lines.append(
                f"- round {_fmt(e.get('round'))}: **{e['action']}** "
                f"<- rule `{e['rule']}` [{e['status']}]{tag}"
                + (f" {e['detail']}" if e.get("detail") else ""))
    ledger = report["epsilon_ledger"]
    if ledger["sources"] or ledger["per_silo"]:
        lines += ["", "## Epsilon ledger", ""]
        for src, d in sorted(ledger["sources"].items()):
            lines.append(
                f"- source `{src}`: epsilon {_fmt(d.get('epsilon'))} "
                f"(last round burn "
                f"{_fmt(d.get('epsilon_per_round'))})")
        for silo, eps in sorted(ledger["per_silo"].items()):
            lines.append(f"- silo {silo}: epsilon {_fmt(eps)}")
    d = report["dispatch"]
    lines += ["", "## Fast-path accounting", "",
              f"- dispatches: {_fmt(d['dispatches'])}; program builds: "
              f"{_fmt(sum(d['compiles'].values()) if d['compiles'] else 0)}"]
    if d["fallbacks"]:
        for fb in d["fallbacks"]:
            lines.append(
                f"- fallback [{fb['plane']}] {fb['engine']}: "
                f"{fb['reason']} x{int(fb['count'])}")
    else:
        lines.append("- no fast-path fallbacks announced")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m neuroimagedisttraining_tpu_torch.analysis.run_report",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--metrics", type=str, default="",
                    help="metrics JSONL sink (--metrics_out)")
    ap.add_argument("--flight", type=str, default="",
                    help="flight-recorder dump (the LOG/... "
                         ".flight.json failure dump, or obs/flight.py "
                         "dump)")
    ap.add_argument("--verdict", type=str, default="",
                    help="health verdict JSON (LOG/... .health.json)")
    ap.add_argument("--out", type=str, required=True,
                    help="output directory (run_report.json + "
                         "run_report.md)")
    ap.add_argument("--name", type=str, default="run_report",
                    help="artifact basename (default run_report)")
    args = ap.parse_args(argv)
    if not (args.metrics or args.flight or args.verdict):
        print("run_report: need at least one of --metrics/--flight/"
              "--verdict", file=sys.stderr)
        return 2
    records = None
    if args.metrics:
        try:
            records = read_metrics_jsonl(args.metrics)
        except OSError as e:
            print(f"run_report: --metrics: {e}", file=sys.stderr)
            return 2
    report = build_report(records, _load(args.flight),
                          _load(args.verdict))
    os.makedirs(args.out, exist_ok=True)
    jpath = os.path.join(args.out, args.name + ".json")
    mpath = os.path.join(args.out, args.name + ".md")
    with open(jpath, "w") as f:
        json.dump(report, f, indent=1, sort_keys=True, default=str)
    with open(mpath, "w") as f:
        f.write(render_markdown(report))
    print(json.dumps({"report": jpath, "markdown": mpath,
                      "summary": report["summary"]}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
