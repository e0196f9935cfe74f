"""Render a telemetry JSONL run artifact into summary tables. Port of
``repro/obs/report.py``: it renders the reference's artifacts and the
port's alike.

    PYTHONPATH=src python -m repro_torch.obs.report run.jsonl

Detects what the run contained and renders the matching sections:

* ``round`` events  -> federation/training round table (loss, bytes
  up/down, survivors/cohort, stragglers, estimator route)
* ``async_round`` events -> async federation table (loss, staleness,
  buffer occupancy, useful-vs-discarded compute, utilization) plus the
  staleness histogram from the final ``metrics`` snapshot
* ``request`` events -> serving table (TTFT, latency, tok/s per request)
  plus aggregate percentiles and the adapter-cache hit rate from the
  final ``metrics`` snapshot
* ``memory`` events  -> modeled-vs-measured residency lines
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional


def load_events(path: str) -> List[Dict]:
    events = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i + 1}: bad JSONL line ({e})")
    return events


def _fmt(v, nd=4):
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.{nd}g}"
    return str(v)


def _table(headers: List[str], rows: List[List]) -> str:
    cells = [headers] + [[_fmt(c) for c in r] for r in rows]
    widths = [max(len(row[i]) for row in cells) for i in range(len(headers))]
    out = ["  ".join(h.ljust(w) for h, w in zip(cells[0], widths))]
    out.append("  ".join("-" * w for w in widths))
    for r in cells[1:]:
        out.append("  ".join(c.rjust(w) for c, w in zip(r, widths)))
    return "\n".join(out)


def _last_metrics(events: List[Dict]) -> Dict:
    for e in reversed(events):
        if e.get("kind") == "metrics":
            return e.get("metrics", {})
    return {}


def round_summary(events: List[Dict]) -> Optional[str]:
    rounds = [e for e in events if e.get("kind") == "round"]
    if not rounds:
        return None
    evals = {e.get("round"): e for e in events if e.get("kind") == "eval"}
    rows = []
    for e in rounds:
        r = e.get("round")
        ev = evals.get(r, {})
        surv = e.get("survivors")
        coh = e.get("cohort")
        rows.append([
            r, e.get("loss"), e.get("jvp_abs_mean"), e.get("delta_norm"),
            e.get("bytes_up"), e.get("bytes_down"),
            (f"{surv}/{coh}" if surv is not None else "-"),
            e.get("stragglers"), e.get("surviving_mask_units"),
            ev.get("acc"),
        ])
    header = ["round", "loss", "jvp_abs", "delta_norm", "bytes_up",
              "bytes_down", "surv/cohort", "stragglers", "mask_units", "acc"]
    total_up = sum(e.get("bytes_up") or 0 for e in rounds)
    total_down = sum(e.get("bytes_down") or 0 for e in rounds)
    lines = [f"rounds: {len(rounds)}  "
             f"bytes_up_total={total_up}  bytes_down_total={total_down}",
             _table(header, rows)]
    return "\n".join(lines)


def async_summary(events: List[Dict]) -> Optional[str]:
    rounds = [e for e in events if e.get("kind") == "async_round"]
    if not rounds:
        return None
    rows = [[e.get("version"), e.get("sim_time_s"), e.get("loss"),
             e.get("staleness_mean"), e.get("buffer_occupancy"),
             e.get("in_flight"), e.get("bytes_up"),
             e.get("utilization")] for e in rounds]
    header = ["version", "sim_t", "loss", "stale_mean", "buffer",
              "in_flight", "bytes_up", "util"]
    last = rounds[-1]
    lines = [f"versions: {len(rounds)}  "
             f"sim_wall={_fmt(last.get('sim_time_s'))}s  "
             f"useful_compute={_fmt(last.get('useful_compute_s'))}s  "
             f"discarded={_fmt(last.get('discarded_compute_s'))}s  "
             f"utilization={_fmt(last.get('utilization'))}",
             _table(header, rows)]
    m = _last_metrics(events)
    h = m.get("histograms", {}).get("fl.async.staleness")
    if h and h.get("count"):
        lines.append(f"staleness: mean={_fmt(h['mean'])} "
                     f"p50={_fmt(h['p50'])} p95={_fmt(h['p95'])} "
                     f"max={_fmt(h.get('max'))}")
    counters = m.get("counters", {})
    used = counters.get("fl.async.updates_used")
    if used is not None:
        lines.append(f"updates: {int(used)} used / "
                     f"{int(counters.get('fl.async.updates_discarded', 0))} "
                     f"discarded")
    return "\n\n".join(lines)


def serving_summary(events: List[Dict]) -> Optional[str]:
    reqs = [e for e in events if e.get("kind") == "request"]
    if not reqs:
        return None
    rows = [[e.get("request_id"), e.get("adapter_id"), e.get("prompt_len"),
             e.get("gen_tokens"), e.get("ttft_s"), e.get("latency_s"),
             e.get("tok_per_sec")] for e in reqs]
    header = ["request", "adapter", "prompt", "tokens", "ttft_s",
              "latency_s", "tok/s"]
    lines = [f"requests: {len(reqs)}", _table(header, rows)]

    m = _last_metrics(events)
    hist = m.get("histograms", {})
    agg = []
    for name, label in (("serve.ttft_s", "TTFT"),
                        ("serve.request_latency_s", "latency")):
        h = hist.get(name)
        if h and h.get("count"):
            agg.append(f"{label}: mean={_fmt(h['mean'])}s "
                       f"p50={_fmt(h['p50'])}s p95={_fmt(h['p95'])}s "
                       f"p99={_fmt(h['p99'])}s")
    gauges = m.get("gauges", {})
    if "serve.decode_tok_per_sec" in gauges:
        agg.append("steady-state decode: "
                   f"{_fmt(gauges['serve.decode_tok_per_sec'])} tok/s")
    counters = m.get("counters", {})
    hits = counters.get("adapter_cache.hits", 0)
    misses = counters.get("adapter_cache.misses", 0)
    if hits or misses:
        agg.append(f"adapter cache: {int(hits)} hits / {int(misses)} misses "
                   f"/ {int(counters.get('adapter_cache.evictions', 0))} "
                   f"evictions (hit rate "
                   f"{hits / max(1, hits + misses):.3f})")
    if agg:
        lines.append("\n".join(agg))
    return "\n\n".join(lines)


def memory_summary(events: List[Dict]) -> Optional[str]:
    mems = [e for e in events if e.get("kind") == "memory"]
    if not mems:
        return None
    rows = [[e.get("label"), e.get("live_bytes"),
             e.get("device_bytes_in_use"), e.get("modeled_peak_bytes")]
            for e in mems]
    return _table(["probe", "live_bytes", "device_in_use", "modeled_peak"],
                  rows)


def render(path: str) -> str:
    events = load_events(path)
    meta = next((e for e in events if e.get("kind") == "run_meta"), {})
    sections = [f"telemetry report: {path}"]
    if meta:
        fields = {k: v for k, v in meta.items()
                  if k not in ("ts", "kind")}
        sections[0] += "\n" + "  ".join(f"{k}={v}"
                                        for k, v in sorted(fields.items()))
    for title, body in (("rounds", round_summary(events)),
                        ("async federation", async_summary(events)),
                        ("serving", serving_summary(events)),
                        ("memory", memory_summary(events))):
        if body:
            sections.append(f"== {title} ==\n{body}")
    if len(sections) == 1:
        sections.append(f"(no round/request/memory events in "
                        f"{len(events)} events)")
    return "\n\n".join(sections)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="summarize a telemetry JSONL run artifact")
    ap.add_argument("jsonl", help="path to the run's JSONL event log")
    args = ap.parse_args(argv)
    print(render(args.jsonl))
    return 0


if __name__ == "__main__":
    sys.exit(main())
