"""Trace report CLI — per-edge / per-collective latency tables from a trace.

The software analogue of the paper's Fig. 9 per-configuration breakdown:
load a Chrome ``trace_event`` JSON exported by :mod:`repro_torch.obs.trace`
(``REPRO_TRACE=chrome:trace.json``) and print, per collective and per torus
hop distance, the span statistics (count, mean, p50/p95, max).

::

    PYTHONPATH=src python -m repro_torch.obs.report trace.json
    PYTHONPATH=src python -m repro_torch.obs.report trace.json --cat wire
    PYTHONPATH=src python -m repro_torch.obs.report trace.json --json

Sections:

- **per-edge collectives** — ``cat=collective`` spans grouped by
  ``(name, args.hops)``: the per-edge latency table (hop distances match the
  :class:`~repro_torch.core.topology.TorusSpec` the run was placed on).
- **wire chunks** — ``cat=wire`` spans grouped by name.
- **wire slots** — the reliable wire's ``wire.slot`` spans (one per
  delivery-plan slot) grouped by action: ``deliver`` is the lossless
  minimum, ``lost``/``dup``/``hold`` are the recovery rounds a fault cost.
- **phases** — driver/step phase spans (``cat`` in phase/driver/sweep).
- **watchdog** — instant events (straggler marks) with a count per name.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from typing import Optional, Sequence


def load_trace(path: str) -> list[dict]:
    """Load and minimally validate a Chrome trace_event file; returns the
    event list (raises ValueError on a malformed payload)."""
    with open(path) as f:
        payload = json.load(f)
    if not isinstance(payload, dict) or "traceEvents" not in payload:
        raise ValueError(f"{path}: not a Chrome trace_event file "
                         f"(no traceEvents key)")
    evs = payload["traceEvents"]
    if not isinstance(evs, list):
        raise ValueError(f"{path}: traceEvents is not a list")
    for e in evs:
        if not isinstance(e, dict) or "ph" not in e or "name" not in e:
            raise ValueError(f"{path}: malformed event {e!r}")
    return evs


def _percentile(sorted_vals: Sequence[float], p: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = p / 100.0 * (len(sorted_vals) - 1)
    lo = int(idx)
    hi = min(lo + 1, len(sorted_vals) - 1)
    return sorted_vals[lo] + (idx - lo) * (sorted_vals[hi] - sorted_vals[lo])


def _stats_row(durs: list[float]) -> dict:
    s = sorted(durs)
    return {"count": len(s), "total_us": sum(s),
            "mean_us": sum(s) / len(s),
            "p50_us": _percentile(s, 50), "p95_us": _percentile(s, 95),
            "max_us": s[-1]}


def summarize(events: Sequence[dict], cat: Optional[str] = None) -> dict:
    """Aggregate complete spans (and count instants) into report tables."""
    spans = [e for e in events if e.get("ph") == "X"
             and (cat is None or e.get("cat") == cat)]
    instants = [e for e in events if e.get("ph") == "i"
                and (cat is None or e.get("cat") == cat)]

    per_edge: dict[tuple, list[float]] = defaultdict(list)
    per_name: dict[tuple, list[float]] = defaultdict(list)
    per_slot: dict[str, list[float]] = defaultdict(list)
    for e in spans:
        args = e.get("args", {}) or {}
        key = (e.get("cat", ""), e["name"])
        per_name[key].append(float(e.get("dur", 0.0)))
        if e["name"] == "wire.slot" and "action" in args:
            per_slot[str(args["action"])].append(float(e.get("dur", 0.0)))
        if e.get("cat") == "collective" and "hops" in args:
            per_edge[(e["name"], int(args["hops"]))].append(
                float(e.get("dur", 0.0)))

    inst_counts: dict[tuple, int] = defaultdict(int)
    for e in instants:
        inst_counts[(e.get("cat", ""), e["name"])] += 1

    return {
        "per_edge": {f"{name}@h{hops}": dict(_stats_row(d), hops=hops,
                                             collective=name)
                     for (name, hops), d in sorted(per_edge.items())},
        "per_name": {f"{c}:{n}": dict(_stats_row(d), cat=c, name=n)
                     for (c, n), d in sorted(per_name.items())},
        "wire_slots": {a: _stats_row(d) for a, d in sorted(per_slot.items())},
        "instants": {f"{c}:{n}": v
                     for (c, n), v in sorted(inst_counts.items())},
    }


def _print_table(title: str, rows: dict, key_header: str, out) -> None:
    if not rows:
        return
    print(f"\n{title}", file=out)
    width = max(len(k) for k in rows)
    width = max(width, len(key_header))
    print(f"{key_header:<{width}}  {'count':>6} {'mean us':>10} "
          f"{'p50 us':>10} {'p95 us':>10} {'max us':>10}", file=out)
    for k, r in rows.items():
        print(f"{k:<{width}}  {r['count']:>6d} {r['mean_us']:>10.1f} "
              f"{r['p50_us']:>10.1f} {r['p95_us']:>10.1f} "
              f"{r['max_us']:>10.1f}", file=out)


def report(events: Sequence[dict], cat: Optional[str] = None,
           out=None) -> dict:
    """Print the latency tables; returns the aggregated dict."""
    out = out if out is not None else sys.stdout
    agg = summarize(events, cat=cat)
    _print_table("per-edge collective latency (hop distances from the "
                 "virtual torus placement)", agg["per_edge"],
                 "collective@hops", out)
    coll = {k: v for k, v in agg["per_name"].items()
            if v["cat"] == "collective"}
    _print_table("collective spans", coll, "collective", out)
    wire = {k: v for k, v in agg["per_name"].items() if v["cat"] == "wire"}
    _print_table("wire chunk spans", wire, "wire", out)
    _print_table("reliable-wire slots by action (deliver = the lossless "
                 "minimum; lost/dup/hold = recovery rounds)",
                 agg["wire_slots"], "action", out)
    phase = {k: v for k, v in agg["per_name"].items()
             if v["cat"] in ("phase", "driver", "sweep", "train")}
    _print_table("driver / phase spans", phase, "phase", out)
    if agg["instants"]:
        print("\ninstant events", file=out)
        for k, v in agg["instants"].items():
            print(f"{k:<40s}  {v:>6d}", file=out)
    n_spans = sum(r["count"] for r in agg["per_name"].values())
    n_inst = sum(agg["instants"].values())
    cats = sorted({v["cat"] for v in agg["per_name"].values()}
                  | {k.split(":", 1)[0] for k in agg["instants"]})
    print(f"\n{n_spans} spans + {n_inst} instants across layers: "
          f"{', '.join(cats) if cats else '(none)'}", file=out)
    return agg


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Per-edge / per-collective latency tables from a "
                    "REPRO_TRACE=chrome:<path> export.")
    ap.add_argument("trace", help="Chrome trace_event JSON file")
    ap.add_argument("--cat", default=None,
                    help="restrict to one span category "
                    "(collective, wire, phase, driver, sweep, watchdog)")
    ap.add_argument("--json", action="store_true",
                    help="emit the aggregated tables as JSON instead")
    args = ap.parse_args(argv)
    try:
        events = load_trace(args.trace)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"repro_torch.obs.report: {e}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(summarize(events, cat=args.cat), indent=1,
                         sort_keys=True))
        return 0
    report(events, cat=args.cat)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
