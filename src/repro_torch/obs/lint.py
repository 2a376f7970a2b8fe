"""Trace-validity lint CLI: ``python -m repro.obs.lint trace.json``.

Exit status 0 iff every file parses as Chrome trace-event JSON (bare
array or ``{"traceEvents": [...]}``) with monotonic per-track
timestamps, balanced B/E span pairs, paired causal flow events (every
``s`` origin has an ``f`` terminus and vice versa), and strictly
non-overlapping op spans on request (``op/...``) tracks.  Used by CI
on the bench-smoke trace artifact.
"""

from __future__ import annotations

import json
import sys
from typing import List

from .trace import lint_events


def lint_file(path: str) -> List[str]:
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        return [f"{path}: unreadable or invalid JSON: {e}"]
    if isinstance(doc, dict):
        events = doc.get("traceEvents")
        if not isinstance(events, list):
            return [f"{path}: no traceEvents array"]
    elif isinstance(doc, list):
        events = doc
    else:
        return [f"{path}: top level must be an array or object"]
    return [f"{path}: {e}" for e in lint_events(events)]


def main(argv: List[str]) -> int:
    if not argv:
        print("usage: python -m repro.obs.lint TRACE.json [...]",
              file=sys.stderr)
        return 2
    failed = False
    for path in argv:
        errors = lint_file(path)
        if errors:
            failed = True
            for e in errors[:50]:
                print(e, file=sys.stderr)
            if len(errors) > 50:
                print(f"... and {len(errors) - 50} more", file=sys.stderr)
        else:
            with open(path) as f:
                doc = json.load(f)
            n = len(doc["traceEvents"] if isinstance(doc, dict) else doc)
            print(f"{path}: OK ({n} events)")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
