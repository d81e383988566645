"""Replay recorded traces or flight dumps against an SLO spec.

The port of ``tools/slo_check.py``. The live SLO evaluator
(``obs/slo.py``) watches a running system; this command asks the same
question of a RECORDING: had these objectives been in force, would they
have paged? A run's trace, a bench artifact's or a flight dump can be
judged again against a new spec without running anything.

Input: a Chrome trace JSON (``Tracer.export``), a flight dump, or a
directory of either (rotated dump numbering may have gaps: the merge scans,
it never counts). Each objective with an ``event`` binding draws its
samples from that event stream: an "X" span's duration (exported µs →
clock units) when ``field`` is null, else ``args[field]``; samples feed the
burn-rate trackers the live evaluator uses, so replay and live agree by
construction.

Spec format (JSON; ``obs.slo.Objective`` has every field)::

    {"objectives": [
      {"name": "queue_wait_p99", "metric": "serving/queue_wait",
       "threshold": 6.0, "target": 0.9, "windows": [[64, 1.0], [16, 2.0]],
       "event": "req/queue"}
    ]}

Exit status: 0 when no objective ever fired, 1 when any did (or the input
had no usable samples). ``--selftest`` runs the built-in fire/no-fire
fixture and the spec round trip.

    python -m gradaccum_tpu_torch.examples.slo_check PATH --spec SPEC.json [--json OUT]
    python -m gradaccum_tpu_torch.examples.slo_check --selftest
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from pathlib import Path

if __package__ in (None, ""):  # run as a script: make the package importable
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def _load_events(path: str):
    """Event lists from one file: a Chrome trace (``{"traceEvents": ...}``)
    or a flight dump (``{"events": ...}``); metadata ('M') records dropped."""
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
    """Merged, seq-ordered events from a file or a directory of files, and
    the number of files read. Files that share an event verbatim (the
    overlapping flight dumps of one ring) merge into one run; a file sharing
    nothing starts its own (a resumed run's fresh tracer restarts ``seq``)."""
    if os.path.isdir(path):
        files = sorted(set(glob.glob(os.path.join(path, "**", "*.json"), recursive=True)))
    else:
        files = [path]
    segments = []  # one {content key: event} per run
    n_files = 0
    for f in files:
        try:
            file_events = _load_events(f)
        except (ValueError, json.JSONDecodeError, OSError):
            continue  # unrelated JSON (bench artifacts and the like)
        n_files += 1
        keyed = {json.dumps(ev, sort_keys=True): ev for ev in file_events}
        homes = [s for s in segments if keyed.keys() & s.keys()]
        if not homes:
            segments.append(keyed)
            continue
        homes[0].update(keyed)
        for other in homes[1:]:  # this file bridges runs: merge them
            homes[0].update(other)
            segments.remove(other)
    events = []
    for run, seg in enumerate(segments):
        ordered = sorted(seg.values(),
                         key=lambda e: (e.get("args", {}).get("seq", -1), e.get("ts", 0)))
        for ev in ordered:
            ev["_run"] = run
        events.extend(ordered)
    return events, n_files


def replay(events, objectives):
    """Feed ``events`` (seq-ordered trace-event dicts) through burn-rate
    trackers; returns ``{objective name: report dict}``."""
    from gradaccum_tpu_torch.obs.slo import BurnRateTracker

    out = {}
    for o in objectives:
        if o.event is None:
            out[o.name] = {"skipped": "objective has no event binding"}
            continue
        tracker = BurnRateTracker(o)
        alerts = []
        for ev in events:
            if ev.get("name") != o.event:
                continue
            if o.field is None:
                if ev.get("ph") != "X":
                    continue
                value = ev.get("dur", 0) / 1e6
            else:
                value = ev.get("args", {}).get(o.field)
                if value is None:
                    continue
            transition = tracker.observe(float(value), ev.get("ts", 0) / 1e6)
            if transition is not None:
                alerts.append(transition)
        out[o.name] = {
            "objective": f"{o.event or o.metric} {o.op} {o.threshold:g}",
            "samples": tracker.samples,
            "violations": tracker.violations,
            "alerts": alerts,
            "fired": any(a["state"] == "fire" for a in alerts),
            "firing_at_end": tracker.firing,
        }
    return out


def render(reports, log=print) -> None:
    for name, rep in reports.items():
        if "skipped" in rep:
            log(f"  {name}: skipped ({rep['skipped']})")
            continue
        verdict = "FIRED" if rep["fired"] else "ok" if rep["samples"] else "no samples"
        log(f"  {name}: {verdict} — {rep['violations']}/{rep['samples']} bad samples, "
            f"{len(rep['alerts'])} transition(s) [{rep['objective']}]")


def selftest(log=print) -> int:
    """A clean stream must not fire, a violating burst must fire AND
    resolve, the spec round-trips, and two replays serialize equal."""
    from gradaccum_tpu_torch.obs.slo import Objective, load_spec

    spec = {"objectives": [{
        "name": "queue_wait_p99", "metric": "serving/queue_wait", "threshold": 2.0,
        "target": 0.9, "windows": [[16.0, 1.0], [4.0, 1.0]], "event": "req/queue",
    }]}
    objectives = load_spec(spec)
    assert [o.to_dict() for o in objectives] == \
        [Objective.from_dict(d).to_dict() for d in spec["objectives"]]

    def span(t, dur):
        return {"name": "req/queue", "ph": "X", "ts": int(t * 1e6), "dur": int(dur * 1e6),
                "args": {}}

    rep = replay([span(t, 0.5) for t in range(32)], objectives)["queue_wait_p99"]
    assert rep["samples"] == 32 and not rep["fired"], rep
    burst = ([span(t, 0.5) for t in range(8)] + [span(8 + t, 50.0) for t in range(6)]
             + [span(14 + t, 0.5) for t in range(30)])
    rep = replay(burst, objectives)["queue_wait_p99"]
    assert rep["fired"] and not rep["firing_at_end"], rep
    states = [a["state"] for a in rep["alerts"]]
    assert states == ["fire", "resolve"], states
    a = json.dumps(replay(burst, objectives), sort_keys=True)
    assert a == json.dumps(replay(burst, objectives), sort_keys=True)
    log("[slo-check] selftest PASS (fire/resolve fixture, spec round-trip, "
        "deterministic replay)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", nargs="?", help="trace JSON, flight dump, or directory")
    ap.add_argument("--spec", default=None,
                    help="SLO spec JSON (default: the stock serving objectives)")
    ap.add_argument("--json", default=None, help="also write the report here")
    ap.add_argument("--selftest", action="store_true")
    args = ap.parse_args(argv)

    if args.selftest:
        return selftest()
    if not args.path:
        print("a PATH (or --selftest) is required")
        return 2

    from gradaccum_tpu_torch.obs.slo import default_serving_objectives, load_spec

    objectives = load_spec(args.spec) if args.spec else default_serving_objectives()
    events, n_files = collect(args.path)
    if not events:
        print(f"no obs events found under {args.path}")
        return 1
    reports = replay(events, objectives)
    checked = [r for r in reports.values() if "skipped" not in r]
    fired = [n for n, r in reports.items() if r.get("fired")]
    print(f"[slo-check] {len(events)} events from {n_files} file(s), "
          f"{len(checked)} objective(s) checked")
    render(reports)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"source_files": n_files, "objectives": reports}, f, indent=1,
                      sort_keys=True, default=str)
            f.write("\n")
        print(f"wrote {args.json}")
    if fired:
        print(f"[slo-check] FIRED: {', '.join(fired)}")
        return 1
    if not any(r.get("samples") for r in checked):
        print("[slo-check] no objective found any samples")
        return 1
    print("[slo-check] PASS: no objective fired")
    return 0


if __name__ == "__main__":
    sys.exit(main())
