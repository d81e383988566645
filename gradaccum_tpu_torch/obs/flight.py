"""Flight recorder: every failure ships its own postmortem.

The port of ``gradaccum_tpu/obs/flight.py``. The :class:`FlightRecorder`
dumps the tracer's ring (``obs/trace.py``) plus a metrics snapshot to
``<out_dir>/flightrec/`` when something goes wrong: the Estimator's train
loop dumps on any crash out of the step loop and on a SIGTERM/preemption
drain.

Dump files are numbered (``dump-0001-<reason>.json``) past the highest
index already in the directory, so repeated crashes — or a resumed process
crashing again into the same ``model_dir`` — never overwrite an earlier
postmortem. The directory is rotated at ``max_dumps`` (oldest-numbered
evicted first), and the numbering keeps climbing over the gap.
"""

from __future__ import annotations

import json
import os
import re
from typing import List, Optional, Tuple

from gradaccum_tpu_torch.obs import trace as obs_trace

_SAFE_RE = re.compile(r"[^a-zA-Z0-9._-]+")
_DUMP_RE = re.compile(r"^dump-(\d+)-.*\.json$")


class FlightRecorder:
    """Dumps the tracer ring (+ optional registry snapshot) on demand.

    ``tracer=None`` re-resolves the global tracer AT DUMP TIME, so a
    recorder built before ``set_tracer`` still captures the ring that was
    actually recording. A disabled tracer or missing ``out_dir`` makes
    ``dump`` a no-op returning None — failure paths can call it
    unconditionally.

    ``max_dumps`` caps the dump directory: after each write the
    oldest-numbered dumps are evicted until at most ``max_dumps`` remain
    (``None`` disables rotation). Readers tolerate the resulting numbering
    gap — :func:`list_dumps` scans the
    directory rather than counting.
    """

    def __init__(self, out_dir: Optional[str], tracer=None, registry=None,
                 subdir: str = "flightrec", max_dumps: Optional[int] = 50):
        if max_dumps is not None and int(max_dumps) < 1:
            raise ValueError(f"max_dumps must be >= 1, got {max_dumps}")
        self.out_dir = out_dir
        self._tracer = tracer
        self.registry = registry
        self.subdir = subdir
        self.max_dumps = None if max_dumps is None else int(max_dumps)

    @property
    def tracer(self):
        return obs_trace.resolve(self._tracer)

    @staticmethod
    def _indexed(d: str) -> List[Tuple[int, str]]:
        """(index, filename) for every dump in ``d``, sorted by index."""
        out = []
        for f in os.listdir(d):
            m = _DUMP_RE.match(f)
            if m:
                out.append((int(m.group(1)), f))
        return sorted(out)

    def dump(self, reason: str, extra: Optional[dict] = None) -> Optional[str]:
        """Write one postmortem; returns its path (None when disabled)."""
        tracer = self.tracer
        if self.out_dir is None or not tracer.enabled:
            return None
        payload = {
            "reason": reason,
            "events": tracer.snapshot(),
            "dropped_events": getattr(tracer, "dropped", 0),
            "metrics": (self.registry.snapshot()
                        if self.registry is not None else None),
        }
        if extra:
            payload["extra"] = extra
        d = os.path.join(self.out_dir, self.subdir)
        os.makedirs(d, exist_ok=True)
        safe = _SAFE_RE.sub("-", reason) or "dump"
        # number past the HIGHEST existing index (not the first free slot):
        # rotation evicts low numbers, and reusing an evicted slot would
        # make dump order lie about event order
        existing = self._indexed(d)
        n = (existing[-1][0] + 1) if existing else 1
        path = os.path.join(d, f"dump-{n:04d}-{safe}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, sort_keys=True, separators=(",", ":"))
            f.write("\n")
        os.replace(tmp, path)  # a crash mid-dump never leaves a half file
        if self.max_dumps is not None:
            victims = (existing + [(n, os.path.basename(path))])
            for _, fname in victims[:max(0, len(victims) - self.max_dumps)]:
                try:
                    os.remove(os.path.join(d, fname))
                except OSError:
                    pass  # rotation is best-effort; the new dump landed
        return path


# -- dump readers -----------------------------------------------------------


def load_dump(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def list_dumps(out_dir: str, subdir: str = "flightrec") -> List[str]:
    d = os.path.join(out_dir, subdir)
    if not os.path.isdir(d):
        return []
    # numeric index order, not lexical: a rotated directory's indices keep
    # climbing (10000 sorts before 9999 as a string)
    return [os.path.join(d, f) for _, f in FlightRecorder._indexed(d)]


def fault_events(events: List[dict]) -> List[Tuple[str, int, str]]:
    """The injected-fault tuples recorded in a dump's event list — the
    exact shape of ``FaultInjector.fired``, so fault assertions are a set
    comparison."""
    out = []
    for ev in events:
        if ev.get("name") == "fault/injected":
            a = ev.get("args", {})
            out.append((a.get("point"), a.get("index"), a.get("kind")))
    return out
