"""Validate Chrome trace-event files exported by ``repro_torch.obs.trace``
(the port's counterpart of ``scripts/check_trace.py``, same checks; the
two exporters share one schema, so either validates either's traces).

Structural checks (every file):
  * loads as Chrome trace JSON: ``traceEvents`` list + ``otherData.trace_id``;
  * every event has ``name``/``ph``/``ts``/``pid``/``tid`` and carries the
    tracer identity in ``args`` (``trace_id``, ``span_id``, ``lc``);
  * complete spans (``ph == "X"``) have a non-negative ``dur``;
  * span ids are unique and prefixed by their trace id;
  * logical clocks are unique within one trace (one counter per tracer);
  * every ``parent_id`` resolves to a span in one of the loaded files —
    cross-FILE references are the point: a serve-side steal parents a
    train-side preempt, so pass both traces together.

Causal-chain checks (``--expect-chain a,b,c``): require at least one
sequence of events named ``a`` -> ``b`` -> ``c`` where each link's
``parent_id`` equals the previous event's ``span_id``.  The two-tenant
gate (``scripts/torch_cluster_smoke.py``, ``chip_smoke.py`` phase 4p)
uses::

  python scripts/torch_check_trace.py serve.json train.json \
      --expect-chain rpc.steal,cluster.preempt,resize.shrink

It reads JSON files only: it imports neither torch nor jax.

Exit 0 = all checks pass; non-zero prints every violation.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Tuple

PHASES = {"X", "i", "M"}


def load_trace(path: str, errors: List[str]) -> List[dict]:
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        errors.append(f"{path}: unreadable ({e})")
        return []
    if not isinstance(doc.get("traceEvents"), list):
        errors.append(f"{path}: no traceEvents list")
        return []
    other = doc.get("otherData") or {}
    if not other.get("trace_id"):
        errors.append(f"{path}: otherData.trace_id missing")
    events = []
    for i, ev in enumerate(doc["traceEvents"]):
        where = f"{path}#{i}"
        for key in ("name", "ph", "ts", "pid", "tid"):
            if key not in ev:
                errors.append(f"{where}: missing {key!r}")
        if ev.get("ph") not in PHASES:
            errors.append(f"{where}: bad phase {ev.get('ph')!r}")
            continue
        if ev.get("ph") == "X" and ev.get("dur", -1) < 0:
            errors.append(f"{where}: span {ev.get('name')!r} has no dur")
        args = ev.get("args") or {}
        if not args.get("trace_id") or not args.get("span_id"):
            errors.append(f"{where}: args lack trace_id/span_id")
            continue
        if not isinstance(args.get("lc"), int):
            errors.append(f"{where}: args.lc not an int")
        if not str(args["span_id"]).startswith(str(args["trace_id"])):
            errors.append(f"{where}: span_id {args['span_id']!r} not "
                          f"prefixed by trace_id {args['trace_id']!r}")
        ev["_where"] = where
        events.append(ev)
    return events


def check_identity(events: List[dict], errors: List[str]) -> None:
    seen_span: Dict[str, str] = {}
    seen_lc: Dict[Tuple[str, int], str] = {}
    for ev in events:
        a = ev["args"]
        sid, where = a["span_id"], ev["_where"]
        if sid in seen_span:
            errors.append(f"{where}: duplicate span_id {sid!r} "
                          f"(first at {seen_span[sid]})")
        seen_span[sid] = where
        lc = a.get("lc")
        if isinstance(lc, int):
            key = (a["trace_id"], lc)
            if key in seen_lc:
                errors.append(f"{where}: duplicate lc {lc} in trace "
                              f"{a['trace_id']!r} (first at {seen_lc[key]})")
            seen_lc[key] = where


def check_parents(events: List[dict], errors: List[str]) -> None:
    ids = {ev["args"]["span_id"] for ev in events}
    for ev in events:
        parent = ev["args"].get("parent_id")
        if parent is not None and parent not in ids:
            errors.append(f"{ev['_where']}: parent_id {parent!r} resolves "
                          f"to no span in the loaded traces")


def check_chain(events: List[dict], names: List[str],
                errors: List[str]) -> None:
    """At least one causal path name[0] -> ... -> name[-1] via parent_id."""
    by_name: Dict[str, List[dict]] = {}
    for ev in events:
        by_name.setdefault(ev["name"], []).append(ev)
    if names[0] not in by_name:
        errors.append(f"chain: no event named {names[0]!r}")
        return
    frontier = {ev["args"]["span_id"] for ev in by_name[names[0]]}
    path = [names[0]]
    for name in names[1:]:
        nxt = {ev["args"]["span_id"] for ev in by_name.get(name, ())
               if ev["args"].get("parent_id") in frontier}
        if not nxt:
            errors.append(
                f"chain broken at {' -> '.join(path)} -> {name!r}: no "
                f"{name!r} event parents on a surviving "
                f"{path[-1]!r} span")
            return
        frontier, path = nxt, path + [name]
    print(f"chain OK: {' -> '.join(names)} "
          f"({len(frontier)} terminal span(s))")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("traces", nargs="+", help="Chrome trace JSON files")
    ap.add_argument("--expect-chain", action="append", default=[],
                    metavar="A,B,C",
                    help="require a parent-linked event chain A->B->C "
                         "(repeatable)")
    ap.add_argument("--expect-event", action="append", default=[],
                    metavar="NAME",
                    help="require at least one event named NAME "
                         "(repeatable)")
    args = ap.parse_args(argv)

    errors: List[str] = []
    events: List[dict] = []
    for path in args.traces:
        evs = load_trace(path, errors)
        print(f"{path}: {len(evs)} events")
        events.extend(evs)
    check_identity(events, errors)
    check_parents(events, errors)
    names_present = {ev["name"] for ev in events}
    for name in args.expect_event:
        if name not in names_present:
            errors.append(f"expected event {name!r}: absent")
    for chain in args.expect_chain:
        names = [n.strip() for n in chain.split(",") if n.strip()]
        if len(names) < 2:
            errors.append(f"--expect-chain needs >=2 names: {chain!r}")
        else:
            check_chain(events, names, errors)
    if errors:
        for e in errors:
            print(f"FAIL: {e}", file=sys.stderr)
        return 1
    print(f"trace OK: {len(events)} events across "
          f"{len(args.traces)} file(s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
