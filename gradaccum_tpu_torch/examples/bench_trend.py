"""Aggregate every BENCH_*.json acceptance block into one table.

The port of ``tools/bench_trend.py``: the same functions (``collect``,
``main``), columns, flags and exit codes. It only reads: the port writes
no artifact by default, and ``chip_smoke.py`` gives its benches'
artifacts a directory of their own under ``chiprun_out/`` to run this
over (``--dir``).

Each perf PR leaves a ``BENCH_*.json`` artifact whose ``acceptance`` block
records the bar it had to clear and whether it did. This tool is the
machine-checked perf trajectory: it walks all artifacts, prints one row
per file, and exits nonzero if ANY recorded ``acceptance.passed`` is false
— so a regression committed into an artifact fails CI (wired as a
slow-lane test in the JAX package's tests) instead of rotting
silently. Artifacts without an acceptance block (raw measurement dumps
like BENCH_TPU.json) are listed for context but never gate; an
UNREADABLE artifact gates as a failure — a truncated file must not
silently retire the bar it used to carry.

Artifacts with a ``scaling`` list (BENCH_serving_mp.json's replica curve)
get a rendered 1→N column; ``MULTICHIP_r*.json`` dryrun artifacts are
folded in too (ok / skipped / FAILED — a failed dryrun gates like a
failed acceptance, a skipped one is listed but never gates).

Usage: python -m gradaccum_tpu_torch.examples.bench_trend [--dir DIR] [--json FILE]
"""

import argparse
import glob
import json
import os
import sys


def _scaling_column(data) -> str:
    """Render a ``scaling`` list ([{replicas, tokens_per_s}, ...]) as the
    1→N curve, ratios against the first point."""
    scaling = data.get("scaling")
    if not isinstance(scaling, list) or len(scaling) < 2:
        return ""
    try:
        base = scaling[0]
        parts = [
            f"{base['replicas']}→{s['replicas']}: "
            f"{s['tokens_per_s'] / base['tokens_per_s']:.2f}x"
            for s in scaling[1:]
        ]
    except (KeyError, TypeError, ZeroDivisionError):
        return ""
    return "scaling " + ", ".join(parts)


def _overhead_column(data) -> str:
    """Render an ``overhead`` dict ({path: ratio}, BENCH_slo.json's ops
    plane block) as e.g. ``overhead serve 1.02x``."""
    overhead = data.get("overhead")
    if not isinstance(overhead, dict) or not overhead:
        return ""
    try:
        parts = [f"{k} {float(v):.3f}x" for k, v in sorted(overhead.items())]
    except (TypeError, ValueError):
        return ""
    return "overhead " + ", ".join(parts)


def _spec_column(data) -> str:
    """Render an ``accept_sweep`` list (BENCH_spec.json) as the
    speedup-vs-accept-rate decay curve — the one number sweep operators
    tune k against."""
    sweep = data.get("accept_sweep")
    if not isinstance(sweep, list) or not sweep:
        return ""
    try:
        parts = [
            f"acc {float(s['accept_rate']):.2f}: "
            f"{float(s['speedup_vs_baseline']):.2f}x"
            for s in sweep
        ]
    except (KeyError, TypeError, ValueError):
        return ""
    return "accept sweep " + ", ".join(parts)


def _admission_column(data) -> str:
    """Render an admission ``legs`` list (BENCH_admission.json) as the
    reserve→policy requests-per-tick ladder with preemption counts."""
    legs = data.get("legs")
    if not isinstance(legs, list) or not legs:
        return ""
    try:
        parts = [
            f"{leg['admission']} {float(leg['requests_per_1k_ticks']):g}"
            f"/1k (peak {int(leg['peak_concurrency'])}, "
            f"{int(leg['preemptions'])} preempt)"
            for leg in legs
        ]
    except (KeyError, TypeError, ValueError):
        return ""
    return "admission " + " → ".join(parts)


def _cow_column(data) -> str:
    """Render a ``cow_legs`` ladder (BENCH_cow.json) as the paged →
    prefix → cow peak-concurrency/prefill progression plus the
    prefix-aware-resume token cut."""
    legs = data.get("cow_legs")
    if not isinstance(legs, list) or not legs:
        return ""
    try:
        parts = [
            f"{leg['leg']} peak {int(leg['peak_concurrency'])} "
            f"({int(leg['prefill_tokens_computed'])} prefill tok)"
            for leg in legs
        ]
    except (KeyError, TypeError, ValueError):
        return ""
    out = "cow " + " → ".join(parts)
    rx = data.get("resume_tokens_x")
    if isinstance(rx, (int, float)):
        out += f", resume tokens {rx:.1f}x fewer"
    return out


def _reconfig_column(data) -> str:
    """Render a ``transition`` dict (BENCH_reconfig.json) as the
    live-vs-stop-the-world availability ratios with recovery times."""
    transition = data.get("transition")
    if not isinstance(transition, dict) or not transition:
        return ""
    try:
        parts = [
            f"{kind} {float(t['availability_ratio']):.2f}x "
            f"(recover {t['live']['time_to_recover_ticks']} vs "
            f"{t['stw']['time_to_recover_ticks']} ticks)"
            for kind, t in sorted(transition.items())
        ]
    except (KeyError, TypeError, ValueError):
        return ""
    return "live-vs-stw " + ", ".join(parts)


def _mttr_column(data) -> str:
    """Render BENCH_heal.json's MTTR comparison: autonomous-ladder vs
    operator-stub recovery ticks, plus the flap leg's terminal verdict."""
    healer = data.get("healer")
    stub = data.get("operator_stub")
    if not isinstance(healer, dict) or not isinstance(stub, dict):
        return ""
    try:
        out = (f"MTTR healer {float(healer['mean_mttr_ticks']):g} vs "
               f"operator {float(stub['mean_mttr_ticks']):g} ticks "
               f"({float(data['mttr_ratio']):.2f}x)")
    except (KeyError, TypeError, ValueError):
        return ""
    flap = data.get("flap")
    if isinstance(flap, dict) and "terminal" in flap:
        out += (", flap-freeze terminal"
                if flap["terminal"] else ", flap-freeze NOT terminal")
    return out


def _fleet_column(data) -> str:
    """Render BENCH_fleet.json's availability comparison: supervised
    (lease -> DEAD -> excise -> rebind) vs the no-excision baseline at
    the shared tick budget, plus the kill-to-excise MTTR."""
    sup = data.get("supervised")
    base = data.get("no_excision")
    if not isinstance(sup, dict) or not isinstance(base, dict):
        return ""
    try:
        out = (f"availability supervised {float(sup['availability']):g} vs "
               f"no-excision {float(base['availability']):g} "
               f"({float(data['availability_ratio']):.2f}x)")
    except (KeyError, TypeError, ValueError):
        return ""
    mttr = sup.get("mttr_ticks")
    if isinstance(mttr, (int, float)):
        out += f", kill→excise {mttr:g} ticks"
    return out


def _memory_column(data) -> str:
    """Render a mixed-precision ``rows`` ladder (BENCH_mixed.json) as the
    per-replica optimizer+accumulator bytes/param progression."""
    rows = data.get("rows")
    if not isinstance(rows, list) or not rows:
        return ""
    try:
        parts = [
            f"{r['config']} {float(r['opt_plus_accum_bytes_per_param']):g}B"
            for r in rows
        ]
    except (KeyError, TypeError, ValueError):
        return ""
    return "opt+accum/param " + " → ".join(parts)


def _state_ladder_column(data) -> str:
    """Render BENCH_mem.json's ``optimizer_state_ladder`` as the
    f32 → q8 → adam_mini+q8 state-bytes/param progression."""
    rows = data.get("optimizer_state_ladder")
    if not isinstance(rows, list) or not rows:
        return ""
    try:
        parts = [
            f"{r['config']} {float(r['state_bytes_per_param']):g}B"
            for r in rows
        ]
        ladder = float(rows[-1]["ladder_vs_f32"])
    except (KeyError, TypeError, ValueError):
        return ""
    return "state/param " + " → ".join(parts) + f" ({ladder:.2f}x)"


def _kv_stream_column(data) -> str:
    """Render BENCH_mem.json's ``kv_stream_ladder`` as RAM bytes per
    drain-resumable stream, baseline → ladder."""
    rows = data.get("kv_stream_ladder")
    if not isinstance(rows, list) or len(rows) < 2:
        return ""
    try:
        parts = [
            f"{r['config']} {float(r['ram_bytes_per_resumable_stream']):g}B"
            for r in rows
        ]
        ladder = float(data.get("kv_ram_per_stream_ladder_vs_bf16", 0))
    except (KeyError, TypeError, ValueError):
        return ""
    out = "KV RAM/stream " + " → ".join(parts)
    if ladder:
        out += f" ({ladder:.2f}x)"
    return out


def collect(bench_dir: str):
    """One record per BENCH_*.json: name, headline, acceptance (or None).
    MULTICHIP_r*.json dryrun artifacts ride along: ok -> PASS, skipped ->
    listed without gating, anything else -> FAIL (a broken dryrun must
    not keep reading as covered)."""
    rows = []
    for path in sorted(glob.glob(os.path.join(bench_dir, "BENCH_*.json"))):
        name = os.path.basename(path)
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            rows.append({"file": name, "bench": f"<unreadable: {e}>",
                         "headline": None,
                         "acceptance": {"required": "artifact must parse",
                                        "passed": False},
                         "passed": False})
            continue
        acceptance = data.get("acceptance")
        if not isinstance(acceptance, dict):
            acceptance = None
        rows.append({
            "file": name,
            "bench": data.get("bench") or data.get("metric") or "-",
            # the one-line result an artifact chooses to lead with (e.g.
            # BENCH_obs.json's measured overhead ratios)
            "headline": data.get("headline"),
            "scaling": _scaling_column(data) or None,
            "overhead": _overhead_column(data) or None,
            "memory": _memory_column(data) or None,
            "state_ladder": _state_ladder_column(data) or None,
            "kv_stream": _kv_stream_column(data) or None,
            "spec": _spec_column(data) or None,
            "admission": _admission_column(data) or None,
            "cow": _cow_column(data) or None,
            "reconfig": _reconfig_column(data) or None,
            "mttr": _mttr_column(data) or None,
            "fleet": _fleet_column(data) or None,
            "acceptance": acceptance,
            "passed": None if acceptance is None
            else bool(acceptance.get("passed")),
        })
    for path in sorted(glob.glob(os.path.join(bench_dir,
                                              "MULTICHIP_r*.json"))):
        name = os.path.basename(path)
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            rows.append({"file": name, "bench": f"<unreadable: {e}>",
                         "headline": None, "scaling": None,
                         "acceptance": {"required": "artifact must parse",
                                        "passed": False},
                         "passed": False})
            continue
        skipped = bool(data.get("skipped"))
        ok = bool(data.get("ok"))
        rows.append({
            "file": name,
            "bench": "multichip dryrun "
                     + f"(n_devices={data.get('n_devices')})",
            "headline": "skipped" if skipped else ("ok" if ok else "failed"),
            "scaling": None,
            "acceptance": None if skipped
            else {"required": "dryrun ok", "passed": ok},
            "passed": None if skipped else ok,
        })
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), os.pardir, os.pardir),
        help="directory holding the BENCH_*.json artifacts (default: repo root)")
    ap.add_argument("--json", default=None,
                    help="also write the aggregated table to this file")
    args = ap.parse_args(argv)

    rows = collect(args.dir)
    if not rows:
        print(f"no BENCH_*.json artifacts under {args.dir}")
        return 1

    wf = max(len(r["file"]) for r in rows)
    print(f"{'artifact':<{wf}}  {'status':<8}  bench / required bar")
    failures = 0
    for r in rows:
        if r["passed"] is None:
            status = "-"
            detail = str(r["bench"])
        else:
            status = "PASS" if r["passed"] else "FAIL"
            required = r["acceptance"].get("required") or \
                r["acceptance"].get("required_speedup") or ""
            detail = f"{r['bench']}"
            if r["headline"]:
                detail += f" — {r['headline']}"
            if r.get("scaling"):
                detail += f" — {r['scaling']}"
            if r.get("overhead"):
                detail += f" — {r['overhead']}"
            if r.get("memory"):
                detail += f" — {r['memory']}"
            if r.get("state_ladder"):
                detail += f" — {r['state_ladder']}"
            if r.get("kv_stream"):
                detail += f" — {r['kv_stream']}"
            if r.get("spec"):
                detail += f" — {r['spec']}"
            if r.get("admission"):
                detail += f" — {r['admission']}"
            if r.get("cow"):
                detail += f" — {r['cow']}"
            if r.get("reconfig"):
                detail += f" — {r['reconfig']}"
            if r.get("mttr"):
                detail += f" — {r['mttr']}"
            if r.get("fleet"):
                detail += f" — {r['fleet']}"
            if required != "":
                detail += f" [{required}]"
            if not r["passed"]:
                failures += 1
        print(f"{r['file']:<{wf}}  {status:<8}  {detail}")
    gated = sum(1 for r in rows if r["passed"] is not None)
    print(f"\n{len(rows)} artifacts, {gated} with acceptance blocks, "
          f"{failures} failing")

    if args.json:
        with open(args.json, "w") as f:
            json.dump({"rows": rows, "failures": failures}, f, indent=1,
                      sort_keys=True)
            f.write("\n")
        print(f"wrote {args.json}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
