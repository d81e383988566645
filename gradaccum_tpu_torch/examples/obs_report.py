"""Render a run summary from obs traces / flight-recorder dumps.

The port of ``tools/obs_report.py``: the same functions (``collect``,
``report``, ``render``, ``main``), flags and output, over the files the
port's ``obs/trace.py`` (``Tracer.export``) and ``obs/flight.py``
(``FlightRecorder.dump``) write, which have the JAX package's format.

Input is anything the obs layer writes: a Chrome trace-event JSON
(``Tracer.export``), a single flight dump
(``model_dir/flightrec/dump-*.json``), or a directory — every trace/dump
JSON under it is merged onto one timeline by logical sequence number.

The report answers the operator questions the raw timeline buries:

- **Serving latency**: queue-wait and service-time percentiles
  (p50/p90/p99) from the ``req/queue`` / ``req/decode`` spans, finish
  reasons, admission stalls.
- **Training health**: step/branch counts, guard skips
  (``train/nonfinite_skip`` / ``train/guard_verdict``), the loss-scale
  excursion (min/max/cycles).
- **Fault → effect correlation**: for every ``fault/injected`` event, the
  next downstream resilience event (recover, requeue, engine fault,
  watchdog fire, drain) — the "what did this fault actually do" view a
  chaos postmortem starts from.

Usage: python -m gradaccum_tpu_torch.examples.obs_report PATH [--json FILE]
(nothing is written without ``--json``).
"""

import argparse
import glob
import json
import os
import sys

# events that count as a fault's downstream EFFECT (ordered scan by seq)
EFFECT_NAMES = (
    "serve/recover", "serve/engine_fault", "req/requeue",
    "watchdog/stall", "preemption/drain", "drain/vote",
    "train/nonfinite_skip", "train/guard_verdict", "train/loss_scale",
)


def _load_events(path: str):
    """Event lists from one file: a Chrome trace ({"traceEvents": ...}) or
    a flight dump ({"events": ...}). Metadata ('M') records are dropped."""
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict) and "traceEvents" in data:
        events = data["traceEvents"]
    elif isinstance(data, dict) and "events" in data:
        events = data["events"]
    else:
        raise ValueError(f"{path}: neither a trace nor a flight dump")
    return [e for e in events if e.get("ph") != "M"]


def collect(path: str):
    """Merged, seq-ordered events from a file or a directory of files."""
    if os.path.isdir(path):
        files = sorted(
            set(glob.glob(os.path.join(path, "**", "*.json"), recursive=True))
        )
    else:
        files = [path]
    # Each distinct RUN forms a segment: a file joins a segment when it
    # shares an event with it verbatim (overlapping flight dumps of one
    # ring), and files sharing nothing (a resumed run's fresh tracer —
    # seq restarts at 0) start their own, so no run's events overwrite
    # another's and fault->effect correlation never pairs across runs.
    # (Two byte-identical deterministic runs are indistinguishable by
    # construction and collapse into one segment.)
    segments = []  # content-key -> event, one dict per run
    n_files = 0
    for f in files:
        try:
            file_events = _load_events(f)
        except (ValueError, json.JSONDecodeError, OSError):
            continue  # unrelated JSON (bench artifacts etc.)
        n_files += 1
        keyed = {json.dumps(ev, sort_keys=True): ev for ev in file_events}
        homes = [s for s in segments if keyed.keys() & s.keys()]
        if not homes:  # a new run
            segments.append(keyed)
            continue
        homes[0].update(keyed)
        for other in homes[1:]:  # this file bridges runs: merge them
            homes[0].update(other)
            segments.remove(other)
    events = []
    for run, seg in enumerate(segments):
        ordered = sorted(
            seg.values(),
            key=lambda e: (e.get("args", {}).get("seq", -1), e.get("ts", 0)),
        )
        for ev in ordered:
            ev["_run"] = run  # bounds report()'s fault->effect scan
        events.extend(ordered)
    return events, n_files


def _series(events, name, key="dur"):
    from gradaccum_tpu_torch.utils.timing import LatencySeries

    s = LatencySeries()
    s.extend(e.get(key, 0) / 1e6 for e in events if e.get("name") == name)
    return s


def _fmt(summary):
    if not summary["count"]:
        return "n=0"
    return (f"n={summary['count']} mean={summary['mean']:.4g} "
            f"p50={summary['p50']:.4g} p90={summary['p90']:.4g} "
            f"p99={summary['p99']:.4g}")


def report(events) -> dict:
    by_name = {}
    for ev in events:
        by_name[ev["name"]] = by_name.get(ev["name"], 0) + 1

    queue = _series(events, "req/queue").summary()
    decode = _series(events, "req/decode").summary()
    finishes = {}
    for ev in events:
        if ev["name"] == "req/decode":
            r = ev.get("args", {}).get("outcome", "?")
            finishes[r] = finishes.get(r, 0) + 1
    stalls = {}
    for ev in events:
        if ev["name"] == "serve/admission_stall":
            r = ev.get("args", {}).get("reason", "?")
            stalls[r] = stalls.get(r, 0) + 1

    steps = [e for e in events if e["name"] == "train/step"]
    branches = {}
    for ev in steps:
        b = ev.get("args", {}).get("branch", "?")
        branches[b] = branches.get(b, 0) + 1
    skips = sum(e.get("args", {}).get("skipped", 0)
                for e in events if e["name"] == "train/nonfinite_skip")
    scales = [e.get("args", {}).get("scale")
              for e in events if e["name"] == "train/loss_scale"]
    scales = [s for s in scales if s is not None]
    scale_cycles = sum(
        1 for i in range(1, len(scales)) if scales[i] < scales[i - 1]
    )

    # fault -> effect: the next known effect event after each injection,
    # within the same run segment (never a different run's recovery)
    faults = []
    for i, ev in enumerate(events):
        if ev["name"] != "fault/injected":
            continue
        effect = None
        for later in events[i + 1:]:
            if later.get("_run") != ev.get("_run"):
                break
            if later["name"] in EFFECT_NAMES:
                effect = {"name": later["name"], "args": later.get("args")}
                break
        faults.append({
            "fault": ev.get("args", {}),
            "effect": effect,
        })

    return {
        "events": len(events),
        "event_counts": dict(sorted(by_name.items())),
        "serving": {
            "queue_wait": queue,
            "service_time": decode,
            "finish_reasons": finishes,
            "admission_stalls": stalls,
            "ticks": by_name.get("serve/tick", 0),
        },
        "training": {
            "steps": len(steps),
            "branches": branches,
            "nonfinite_skips": skips,
            "loss_scale": (
                {"samples": len(scales), "min": min(scales),
                 "max": max(scales), "down_cycles": scale_cycles}
                if scales else None
            ),
        },
        "faults": faults,
    }


def render(rep: dict, log=print) -> None:
    log(f"obs report: {rep['events']} events")
    s = rep["serving"]
    if s["ticks"]:
        log(f"  serving: {s['ticks']} ticks, "
            f"finishes={s['finish_reasons']}, stalls={s['admission_stalls']}")
        log(f"    queue wait   {_fmt(s['queue_wait'])}")
        log(f"    service time {_fmt(s['service_time'])}")
    t = rep["training"]
    if t["steps"]:
        log(f"  training: {t['steps']} steps {t['branches']}, "
            f"{t['nonfinite_skips']} guard-skipped micro-batches")
        if t["loss_scale"]:
            ls = t["loss_scale"]
            log(f"    loss scale [{ls['min']:g}, {ls['max']:g}], "
                f"{ls['down_cycles']} halving(s)")
    if rep["faults"]:
        log(f"  faults: {len(rep['faults'])} injected")
        for fx in rep["faults"]:
            f_args = fx["fault"]
            eff = fx["effect"]
            eff_s = (f"-> {eff['name']}" if eff else "-> (no effect event)")
            log(f"    {f_args.get('kind')}@{f_args.get('point')}"
                f"[{f_args.get('index')}] {eff_s}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("path", help="trace JSON, flight dump, or directory")
    ap.add_argument("--json", default=None, help="also write the report here")
    args = ap.parse_args(argv)

    events, n_files = collect(args.path)
    if not events:
        print(f"no obs events found under {args.path}")
        return 1
    rep = report(events)
    rep["source_files"] = n_files
    render(rep)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rep, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
