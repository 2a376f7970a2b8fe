"""Chrome trace-event recording and validation.

:class:`TraceRecorder` emits the JSON Array / ``traceEvents`` format
understood by Perfetto and ``chrome://tracing``:

* ``B``/``E`` duration spans — background jobs on per-lane tracks,
  commit-group rounds on the ``commit`` track, foreground stalls;
* ``X`` complete events — device I/O by ``IOClass`` (emitted with an
  explicit ``dur`` because simulated time may not advance between the
  begin and end of an enclosing job body);
* ``i`` instant events — GC-governor bandwidth decisions, placement
  retunes, rebalancer migration lifecycle;
* ``s``/``f`` flow events — causal arrows from the background job that
  blocked a foreground op to the op's stall (Perfetto draws these as
  arrows between tracks, answering "who delayed this put" visually);
* ``M`` metadata — process/thread names for the track labels.

Timestamps are the shared *simulated* clock in microseconds, so two
seeded runs produce identical event sequences.  Tracks ("threads") are
allocated deterministically in first-use order.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple


class TraceRecorder:
    def __init__(self, clock=None, pid: int = 1,
                 process_name: str = "repro") -> None:
        self.clock = clock
        self.pid = pid
        self.events: List[dict] = []
        self._meta: List[dict] = [{
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": process_name},
        }]
        self._tids: Dict[str, int] = {}
        self._next_flow = 1

    def _tid(self, track: str) -> int:
        tid = self._tids.get(track)
        if tid is None:
            tid = len(self._tids) + 1
            self._tids[track] = tid
            self._meta.append({
                "ph": "M", "name": "thread_name", "pid": self.pid,
                "tid": tid, "args": {"name": track},
            })
        return tid

    def _ts(self, ts: Optional[float]) -> float:
        if ts is None:
            ts = self.clock.now if self.clock is not None else 0.0
        return round(ts * 1e6, 3)

    # -- emitters (ts arguments are simulated seconds) ----------------
    def begin(self, track: str, name: str, ts: Optional[float] = None,
              args: Optional[dict] = None) -> None:
        ev = {"ph": "B", "name": name, "pid": self.pid,
              "tid": self._tid(track), "ts": self._ts(ts)}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def end(self, track: str, name: str, ts: Optional[float] = None) -> None:
        self.events.append({"ph": "E", "name": name, "pid": self.pid,
                            "tid": self._tid(track), "ts": self._ts(ts)})

    def span(self, track: str, name: str, t0: float, t1: float,
             args: Optional[dict] = None) -> None:
        """A ``B``/``E`` pair with both endpoints known up front."""
        self.begin(track, name, t0, args)
        self.end(track, name, t1)

    def complete(self, track: str, name: str, t0: float, dur_s: float,
                 args: Optional[dict] = None) -> None:
        ev = {"ph": "X", "name": name, "pid": self.pid,
              "tid": self._tid(track), "ts": self._ts(t0),
              "dur": round(dur_s * 1e6, 3)}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def instant(self, track: str, name: str, ts: Optional[float] = None,
                args: Optional[dict] = None) -> None:
        ev = {"ph": "i", "s": "t", "name": name, "pid": self.pid,
              "tid": self._tid(track), "ts": self._ts(ts)}
        if args:
            ev["args"] = args
        self.events.append(ev)

    # -- flow events (causal arrows between tracks) -------------------
    def next_flow_id(self) -> int:
        """Flow ids bind globally in the Chrome trace format, and bench
        runs merge several recorders into one file — namespace by pid so
        merged traces keep ids unique."""
        fid = self.pid * 1_000_000 + self._next_flow
        self._next_flow += 1
        return fid

    def flow_start(self, track: str, name: str, ts: float,
                   flow_id: int, args: Optional[dict] = None) -> None:
        """Flow origin (``s``), anchored on the *cause's* track."""
        ev = {"ph": "s", "cat": "causal", "name": name, "id": flow_id,
              "pid": self.pid, "tid": self._tid(track), "ts": self._ts(ts)}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def flow_end(self, track: str, name: str, ts: float,
                 flow_id: int, args: Optional[dict] = None) -> None:
        """Flow terminus (``f``), anchored on the *victim's* track;
        ``bt: "e"`` binds to the enclosing slice."""
        ev = {"ph": "f", "bt": "e", "cat": "causal", "name": name,
              "id": flow_id, "pid": self.pid, "tid": self._tid(track),
              "ts": self._ts(ts)}
        if args:
            ev["args"] = args
        self.events.append(ev)

    # -- output -------------------------------------------------------
    def sorted_events(self) -> List[dict]:
        """Metadata first, then events stable-sorted by timestamp.

        Stability matters: a span's ``E`` and the next span's ``B`` on
        one track may share a timestamp, and emission order (E before
        B) is what keeps the pairs balanced for the lint.
        """
        return self._meta + sorted(self.events, key=lambda e: e["ts"])

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"traceEvents": self.sorted_events()}, f)


def lint_events(events: List[dict]) -> List[str]:
    """Validate a Chrome trace-event list; return a list of problems.

    Checks: required fields per phase, non-negative numeric timestamps,
    per-track (pid, tid) timestamp monotonicity, ``X`` durations >= 0,
    balanced and properly nested ``B``/``E`` pairs per track, flow-event
    pairing (every flow id must have both an ``s`` origin and an ``f``
    terminus, with the terminus not preceding the origin), and strict
    span nesting on request tracks: ``op/...`` tracks carry one op at a
    time, so two overlapping ``X`` spans there are an error.
    """
    errors: List[str] = []
    # Pre-pass: thread names, so the main pass can tell request tracks
    # apart regardless of where the M records sit in the stream.
    tnames: Dict[Tuple[int, int], str] = {}
    for ev in events:
        if (isinstance(ev, dict) and ev.get("ph") == "M"
                and ev.get("name") == "thread_name"):
            name = (ev.get("args") or {}).get("name")
            if isinstance(name, str):
                tnames[(ev.get("pid"), ev.get("tid"))] = name
    last_ts: Dict[Tuple[int, int], float] = {}
    stacks: Dict[Tuple[int, int], List[str]] = {}
    op_span_end: Dict[Tuple[int, int], float] = {}
    flow_s: Dict[object, float] = {}
    flow_f: Dict[object, float] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errors.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph is None:
            errors.append(f"event {i}: missing ph")
            continue
        if "pid" not in ev or "tid" not in ev:
            errors.append(f"event {i}: missing pid/tid")
            continue
        if ph == "M":
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errors.append(f"event {i}: bad ts {ts!r}")
            continue
        key = (ev["pid"], ev["tid"])
        prev = last_ts.get(key)
        if prev is not None and ts < prev:
            errors.append(f"event {i}: ts {ts} < {prev} on track {key}")
        last_ts[key] = ts
        if ph == "B":
            stacks.setdefault(key, []).append(ev.get("name", ""))
        elif ph == "E":
            stack = stacks.setdefault(key, [])
            if not stack:
                errors.append(f"event {i}: E without B on track {key}")
            else:
                top = stack.pop()
                name = ev.get("name")
                if name is not None and name != top:
                    errors.append(
                        f"event {i}: E {name!r} does not match open "
                        f"B {top!r} on track {key}")
        elif ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"event {i}: X with bad dur {dur!r}")
            elif tnames.get(key, "").startswith("op/"):
                # Request tracks serialize ops: spans must not overlap.
                prev_end = op_span_end.get(key)
                if prev_end is not None and ts < prev_end - 1e-6:
                    errors.append(
                        f"event {i}: X {ev.get('name')!r} at {ts} overlaps "
                        f"previous span ending {prev_end} on op track {key}")
                end = ts + dur
                if prev_end is None or end > prev_end:
                    op_span_end[key] = end
        elif ph in ("s", "t", "f"):
            fid = ev.get("id")
            if fid is None:
                errors.append(f"event {i}: flow {ph!r} without id")
            elif ph == "s":
                if fid in flow_s:
                    errors.append(f"event {i}: duplicate flow start id "
                                  f"{fid!r}")
                flow_s.setdefault(fid, ts)
            elif ph == "f":
                if fid in flow_f:
                    errors.append(f"event {i}: duplicate flow end id "
                                  f"{fid!r}")
                flow_f.setdefault(fid, ts)
        elif ph not in ("i", "I", "C", "N", "O", "D"):
            errors.append(f"event {i}: unknown phase {ph!r}")
    for key, stack in stacks.items():
        if stack:
            errors.append(f"track {key}: {len(stack)} unclosed B "
                          f"event(s), first {stack[0]!r}")
    for fid, ts in flow_s.items():
        if fid not in flow_f:
            errors.append(f"flow {fid!r}: start without end")
        elif flow_f[fid] < ts:
            errors.append(f"flow {fid!r}: end ts {flow_f[fid]} precedes "
                          f"start ts {ts}")
    for fid in flow_f:
        if fid not in flow_s:
            errors.append(f"flow {fid!r}: end without start")
    return errors


__all__ = ["TraceRecorder", "lint_events"]
