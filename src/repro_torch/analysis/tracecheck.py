"""Schema validator for the committed benchmark traces (the port of
``repro/analysis/tracecheck.py``).

The cluster simulator and the serving benchmark replay JSON traces from
``benchmarks/traces/``; a malformed committed trace fails *silently* (an
unknown field is dropped by ``TraceEvent.from_json``, a mis-typed one
crashes replay long after checkout).  This pass validates every committed
trace against hand-rolled schemas (the container has no ``jsonschema`` —
the rules live here, next to the checks):

**Cluster trace v1** (``trace_*.json``, ``failure_storm_*.json``,
``heartbeat_loss_*.json``, ``lease_churn_*.json`` — any file with a
top-level ``events`` list):

  - top level: ``version == 1``, ``n_devices`` int >= 1, ``events`` list;
    optional ``seed`` (int) and ``horizon`` (number >= 0); nothing else;
  - every event: ``t`` number >= 0 and ``kind`` from the simulator's
    vocabulary, time-sorted, inside the horizon when one is declared;
  - kind-specific payloads: ``job_arrival`` carries job/priority/weight/
    quantum, ``job_departure`` carries job, the device events
    (``device_failure``/``device_join``/``heartbeat_loss``) carry
    ``device`` in ``[0, n_devices)``, and ``lease_churn`` carries no
    payload at all (the sim kills whichever worker holds the lease);
    fields from the wrong group are violations — ``from_json`` would
    accept and silently mis-replay them.

**Request trace** (``requests_smoke.json`` — any file with a top-level
``requests`` list): ``name``/``seed``/``qps``/``vocab_size`` plus rows of
``id``/``t``/``prompt_len``/``max_new``; ids dense from 0, arrival times
non-decreasing.

Run as ``python -m repro_torch.analysis.tracecheck benchmarks/traces``
(exit 1 on violations).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional, Sequence

from repro_torch.analysis.verify import Violation

EVENT_KINDS = frozenset({"job_arrival", "job_departure", "device_failure",
                         "device_join", "heartbeat_loss", "lease_churn"})
JOB_FIELDS = {"job", "priority", "weight", "quantum"}
# required payload fields per kind (beyond t/kind); everything else from
# the payload universe is forbidden for that kind
EVENT_FIELDS = {
    "job_arrival": {"job", "priority", "weight", "quantum"},
    "job_departure": {"job"},
    "device_failure": {"device"},
    "device_join": {"device"},
    "heartbeat_loss": {"device"},
    "lease_churn": set(),
}
PAYLOAD_UNIVERSE = JOB_FIELDS | {"device"}


def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _is_int(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)


def check_cluster_trace(doc: dict, where: str) -> List[Violation]:
    out: List[Violation] = []
    if doc.get("version") != 1:
        out.append(Violation("trace-version", where,
                             f"version {doc.get('version')!r}, want 1"))
    n_devices = doc.get("n_devices")
    if not (_is_int(n_devices) and n_devices >= 1):
        out.append(Violation("trace-top", where,
                             f"n_devices {n_devices!r} is not a positive int"))
        n_devices = None
    seed = doc.get("seed")
    if seed is not None and not _is_int(seed):
        out.append(Violation("trace-top", where,
                             f"seed {seed!r} is not an int"))
    horizon = doc.get("horizon", 0.0)
    if not (_is_num(horizon) and horizon >= 0):
        out.append(Violation("trace-top", where,
                             f"horizon {horizon!r} is not a number >= 0"))
        horizon = 0.0
    extra = set(doc) - {"version", "n_devices", "seed", "horizon", "events"}
    if extra:
        out.append(Violation("trace-top", where,
                             f"unknown top-level fields {sorted(extra)}"))
    events = doc.get("events")
    if not isinstance(events, list):
        out.append(Violation("trace-top", where,
                             f"events is {type(events).__name__}, want list"))
        return out

    prev_t = None
    for i, ev in enumerate(events):
        ew = f"{where} events[{i}]"
        if not isinstance(ev, dict):
            out.append(Violation("trace-event", ew,
                                 f"{type(ev).__name__}, want object"))
            continue
        t = ev.get("t")
        if not (_is_num(t) and t >= 0):
            out.append(Violation("trace-event", ew,
                                 f"t {t!r} is not a number >= 0"))
            t = None
        kind = ev.get("kind")
        if kind not in EVENT_KINDS:
            out.append(Violation("trace-event-kind", ew,
                                 f"unknown kind {kind!r} "
                                 f"(vocabulary: {sorted(EVENT_KINDS)})"))
            continue
        required = EVENT_FIELDS[kind]
        present = set(ev) & PAYLOAD_UNIVERSE
        missing = required - present
        forbidden = present - required
        if missing:
            out.append(Violation(
                "trace-field", ew,
                f"{kind} missing {sorted(missing)}"))
        if forbidden:
            out.append(Violation(
                "trace-field", ew,
                f"{kind} carries {sorted(forbidden)} — wrong payload group "
                f"(from_json would silently mis-replay it)"))
        extra = set(ev) - PAYLOAD_UNIVERSE - {"t", "kind"}
        if extra:
            out.append(Violation("trace-field", ew,
                                 f"unknown fields {sorted(extra)}"))
        if "job" in required and not isinstance(ev.get("job"), str):
            out.append(Violation("trace-field", ew,
                                 f"job {ev.get('job')!r} is not a string"))
        if kind == "job_arrival":
            if not _is_int(ev.get("priority")):
                out.append(Violation(
                    "trace-field", ew,
                    f"priority {ev.get('priority')!r} is not an int"))
            if not (_is_num(ev.get("weight")) and ev.get("weight") > 0):
                out.append(Violation(
                    "trace-field", ew,
                    f"weight {ev.get('weight')!r} is not a number > 0"))
            if not (_is_int(ev.get("quantum")) and ev.get("quantum") >= 1):
                out.append(Violation(
                    "trace-field", ew,
                    f"quantum {ev.get('quantum')!r} is not an int >= 1"))
        if "device" in required and "device" in ev:
            d = ev["device"]
            if not _is_int(d):
                out.append(Violation("trace-field", ew,
                                     f"device {d!r} is not an int"))
            elif n_devices is not None and not (0 <= d < n_devices):
                out.append(Violation(
                    "trace-device-range", ew,
                    f"device {d} outside [0, {n_devices})"))
        if t is not None:
            if prev_t is not None and t < prev_t:
                out.append(Violation(
                    "trace-order", ew,
                    f"t {t} before previous event at {prev_t} — replay "
                    f"requires time-sorted events"))
            prev_t = t
            if horizon and t > horizon:
                out.append(Violation(
                    "trace-horizon", ew,
                    f"t {t} beyond the declared horizon {horizon}"))
    return out


def check_request_trace(doc: dict, where: str) -> List[Violation]:
    out: List[Violation] = []
    if not isinstance(doc.get("name"), str):
        out.append(Violation("req-top", where,
                             f"name {doc.get('name')!r} is not a string"))
    if not _is_int(doc.get("seed")):
        out.append(Violation("req-top", where,
                             f"seed {doc.get('seed')!r} is not an int"))
    if not (_is_num(doc.get("qps")) and doc.get("qps") > 0):
        out.append(Violation("req-top", where,
                             f"qps {doc.get('qps')!r} is not a number > 0"))
    if not (_is_int(doc.get("vocab_size")) and doc.get("vocab_size") >= 2):
        out.append(Violation(
            "req-top", where,
            f"vocab_size {doc.get('vocab_size')!r} is not an int >= 2"))
    extra = set(doc) - {"name", "seed", "qps", "vocab_size", "requests"}
    if extra:
        out.append(Violation("req-top", where,
                             f"unknown top-level fields {sorted(extra)}"))
    rows = doc.get("requests")
    if not isinstance(rows, list):
        out.append(Violation("req-top", where,
                             f"requests is {type(rows).__name__}, want list"))
        return out
    prev_t = None
    for i, row in enumerate(rows):
        rw = f"{where} requests[{i}]"
        if not isinstance(row, dict):
            out.append(Violation("req-row", rw,
                                 f"{type(row).__name__}, want object"))
            continue
        extra = set(row) - {"id", "t", "prompt_len", "max_new"}
        if extra:
            out.append(Violation("req-row", rw,
                                 f"unknown fields {sorted(extra)}"))
        if row.get("id") != i:
            out.append(Violation(
                "req-id", rw,
                f"id {row.get('id')!r}, want dense ids from 0 (= {i})"))
        t = row.get("t")
        if not (_is_num(t) and t >= 0):
            out.append(Violation("req-row", rw,
                                 f"t {t!r} is not a number >= 0"))
        else:
            if prev_t is not None and t < prev_t:
                out.append(Violation(
                    "req-order", rw,
                    f"arrival t {t} before previous {prev_t}"))
            prev_t = t
        for f in ("prompt_len", "max_new"):
            if not (_is_int(row.get(f)) and row.get(f) >= 1):
                out.append(Violation(
                    "req-row", rw,
                    f"{f} {row.get(f)!r} is not an int >= 1"))
    return out


def check_trace_file(path: Path, display: Optional[str] = None,
                     ) -> List[Violation]:
    where = display or str(path)
    try:
        doc = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError) as e:
        return [Violation("trace-json", where, f"unreadable: {e}")]
    if not isinstance(doc, dict):
        return [Violation("trace-kind", where,
                          f"top level is {type(doc).__name__}, want object")]
    if "requests" in doc:
        return check_request_trace(doc, where)
    if "events" in doc:
        return check_cluster_trace(doc, where)
    return [Violation("trace-kind", where,
                      "neither 'events' (cluster trace) nor 'requests' "
                      "(request trace) at top level")]


def check_paths(paths: Sequence[str]) -> List[Violation]:
    files: List[Path] = []
    for p in paths:
        pp = Path(p)
        files.extend(sorted(pp.glob("*.json")) if pp.is_dir() else [pp])
    out: List[Violation] = []
    for f in files:
        out.extend(check_trace_file(f, display=f.as_posix()))
    if not files:
        out.append(Violation("trace-json", ", ".join(paths),
                             "no .json files found"))
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.tracecheck",
        description="schema validator for committed benchmark traces "
                    "(cluster trace v1 and request traces)")
    ap.add_argument("paths", nargs="+",
                    help="trace files or directories of *.json")
    args = ap.parse_args(argv)
    violations = check_paths(args.paths)
    for v in violations:
        print(v)
    n_files = sum(1 for p in args.paths for _ in (
        sorted(Path(p).glob('*.json')) if Path(p).is_dir() else [Path(p)]))
    print(f"tracecheck: {n_files} file(s), {len(violations)} violation(s)",
          file=sys.stderr)
    return 1 if violations else 0


if __name__ == "__main__":
    raise SystemExit(main())
