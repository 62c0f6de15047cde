"""Render telemetry JSONL into a latency-breakdown tree + metric summary,
as ``repro/obs/report.py`` (the two packages write the same schema, and
render the same trace to the same text).

    PYTHONPATH=src python -m repro_torch.obs.report run.jsonl [more.jsonl ...]

Spans are aggregated by their full name path (root → leaf, resolved via
``parent_id``) across all input files; counters take the *last*
cumulative record per file and sum across files; gauges take the last
record overall; histograms take the last cumulative record per file and
merge, then print n / mean / p50 / p95 / p99 / max.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Tuple

from .metrics import Histogram


def fmt_s(v: float) -> str:
    """Human duration: 1.23us / 4.56ms / 7.89s."""
    a = abs(v)
    if a < 1e-3:
        return f"{v * 1e6:.2f}us"
    if a < 1.0:
        return f"{v * 1e3:.2f}ms"
    return f"{v:.3f}s"


def load_records(paths: List[str]) -> List[List[dict]]:
    """One list of parsed records per input file; bad lines are skipped."""
    out = []
    for p in paths:
        recs = []
        with open(p, encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    recs.append(json.loads(line))
                except ValueError:
                    continue
        out.append(recs)
    return out


def span_paths(per_file: List[List[dict]]
               ) -> Dict[Tuple[str, ...], List[float]]:
    """Aggregate spans by name path → [count, total_s, max_s]."""
    agg: Dict[Tuple[str, ...], List[float]] = {}
    for recs in per_file:
        spans = {r["span_id"]: r for r in recs if r.get("type") == "span"}
        for r in spans.values():
            path = [r["name"]]
            pid = r.get("parent_id")
            hops = 0
            while pid is not None and pid in spans and hops < 64:
                parent = spans[pid]
                path.append(parent["name"])
                pid = parent.get("parent_id")
                hops += 1
            key = tuple(reversed(path))
            ent = agg.setdefault(key, [0, 0.0, 0.0])
            ent[0] += 1
            ent[1] += r.get("dur_s", 0.0)
            ent[2] = max(ent[2], r.get("dur_s", 0.0))
    return agg


def render_span_tree(agg: Dict[Tuple[str, ...], List[float]]) -> List[str]:
    lines = [f"{'span':<44} {'count':>6} {'total':>10} "
             f"{'mean':>10} {'max':>10}"]

    def children_of(prefix: Tuple[str, ...]) -> List[Tuple[str, ...]]:
        kids = [k for k in agg
                if len(k) == len(prefix) + 1 and k[:len(prefix)] == prefix]
        return sorted(kids, key=lambda k: -agg[k][1])

    def walk(prefix: Tuple[str, ...], depth: int) -> None:
        for key in children_of(prefix):
            count, total, mx = agg[key]
            label = "  " * depth + key[-1]
            lines.append(f"{label:<44} {int(count):>6} {fmt_s(total):>10} "
                         f"{fmt_s(total / count):>10} {fmt_s(mx):>10}")
            walk(key, depth + 1)

    walk((), 0)
    return lines


def metric_summary(per_file: List[List[dict]]) -> Tuple[
        Dict[str, float], Dict[str, float], Dict[str, Histogram]]:
    counters: Dict[str, float] = {}
    gauges: Dict[str, float] = {}
    hists: Dict[str, Histogram] = {}
    for recs in per_file:
        last_c: Dict[str, float] = {}
        last_h: Dict[str, dict] = {}
        for r in recs:
            t = r.get("type")
            if t == "counter":
                last_c[r["name"]] = r["value"]
            elif t == "gauge":
                gauges[r["name"]] = r["value"]
            elif t == "hist":
                last_h[r["name"]] = r
        for name, v in last_c.items():
            counters[name] = counters.get(name, 0.0) + v
        for name, d in last_h.items():
            h = hists.setdefault(name, Histogram())
            h.merge(Histogram.from_dict(d))
    return counters, gauges, hists


def render(paths: List[str]) -> str:
    per_file = load_records(paths)
    out = [f"telemetry report — {len(paths)} file(s), "
           f"{sum(len(r) for r in per_file)} records", ""]

    agg = span_paths(per_file)
    if agg:
        out.append("== span tree ==")
        out.extend(render_span_tree(agg))
        out.append("")

    counters, gauges, hists = metric_summary(per_file)
    if counters:
        out.append("== counters ==")
        for name in sorted(counters):
            v = counters[name]
            out.append(f"{name:<44} {v:>12g}")
        out.append("")
    if gauges:
        out.append("== gauges ==")
        for name in sorted(gauges):
            out.append(f"{name:<44} {gauges[name]:>12g}")
        out.append("")
    if hists:
        out.append("== histograms ==")
        for name in sorted(hists):
            h = hists[name]
            out.append(
                f"{name:<36} n={h.n:<8d} mean={fmt_s(h.mean):<9} "
                f"p50={fmt_s(h.percentile(0.5)):<9} "
                f"p95={fmt_s(h.percentile(0.95)):<9} "
                f"p99={fmt_s(h.percentile(0.99)):<9} "
                f"max={fmt_s(h.max if h.n else 0.0)}")
        out.append("")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Render telemetry JSONL files.")
    ap.add_argument("paths", nargs="+", help="telemetry JSONL file(s)")
    args = ap.parse_args(argv)
    print(render(args.paths))
    return 0


if __name__ == "__main__":
    sys.exit(main())
