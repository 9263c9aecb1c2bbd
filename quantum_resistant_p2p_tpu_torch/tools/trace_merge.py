"""Merge N nodes' span dumps into ONE chrome://tracing document.

Counterpart of the JAX package's ``tools/trace_merge.py``: it reads the
span dumps of the port's ``obs.trace.span_dump`` (the same document).
The per-process exporter (``obs.trace.to_chrome_trace``) renders one
node's flame graph; a distributed handshake is only readable when BOTH
endpoints' spans sit on one timeline.  This tool takes span-dump
documents (``obs.trace.span_dump`` / ``export_spans``) — or bare record
lists — and emits a single trace-event JSON where:

* every NODE gets its own **process lane** (``pid`` + ``process_name``
  metadata), keyed by each record's ``node`` field (multi-node processes
  like the swarm benches attribute per record) falling back to the dump's
  own node name;
* every (node, thread) pair gets a **thread lane**;
* **cross-node parent edges** — a span whose parent lives on a different
  node, i.e. the propagated wire context (net/p2p_node.py ``_trace``) —
  are drawn as chrome flow arrows (``ph: s``/``f``) from the parent's
  span to the child's, so the responder's device dispatches hang visibly
  under the initiator's exchange;
* dumps from DIFFERENT processes are aligned onto one wall-clock
  timeline via each dump's (wall, mono) anchor pair; dumps without
  anchors (bare lists, same-process snapshots) share the raw timeline.

Load the output in chrome://tracing or https://ui.perfetto.dev.

Usage::

    python -m quantum_resistant_p2p_tpu_torch.tools.trace_merge --out merged.json \
        dump1.json dump2.json
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Any

_UNATTRIBUTED = "(unattributed)"


def _doc_records(doc: Any, default_node: str) -> list[tuple[dict, str, float]]:
    """-> (record, node, time_offset) triples for one input document."""
    if isinstance(doc, list):
        records, node, offset = doc, default_node, 0.0
    elif isinstance(doc, dict) and "spans" in doc:
        records = doc["spans"]
        node = str(doc.get("node") or default_node)
        # wall = mono + (wall_anchor - mono_anchor): shifts this dump's
        # tracer-relative timestamps onto the shared wall-clock timeline
        if doc.get("wall_anchor") is not None and doc.get("mono_anchor") is not None:
            offset = float(doc["wall_anchor"]) - float(doc["mono_anchor"])
        else:
            offset = 0.0
    else:
        raise ValueError(
            "input is neither a span-dump document nor a record list")
    return [(rec, str(rec.get("node") or node or _UNATTRIBUTED), offset)
            for rec in records]


def merge(docs: list[Any], node_names: list[str] | None = None) -> dict[str, Any]:
    """Merge span-dump documents into one chrome trace-event document."""
    triples: list[tuple[dict, str, float]] = []
    for i, doc in enumerate(docs):
        default = (node_names[i] if node_names and i < len(node_names)
                   else f"node{i}")
        triples.extend(_doc_records(doc, default))

    # stable lane assignment: process lanes in first-appearance order (the
    # initiator of the first span leads), thread lanes per node.  Assigned
    # up front so a flow arrow can target a parent lane that appears later
    # in record order than its child.
    pids: dict[str, int] = {}
    tids: dict[tuple[str, str], int] = {}
    for rec, node, _ in triples:
        pids.setdefault(node, len(pids) + 1)
        tkey = (node, rec["thread"])
        if tkey not in tids:
            tids[tkey] = sum(1 for k in tids if k[0] == node) + 1

    # span index for parent-edge resolution.  Keyed by (trace_id, span_id):
    # ids are tracer-tagged per process, so collisions mean the same span
    # exported twice — first occurrence wins.
    index: dict[tuple[str, str], tuple[str, float, dict]] = {}
    for rec, node, offset in triples:
        key = (rec["trace_id"], rec["span_id"])
        index.setdefault(key, (node, offset, rec))

    events: list[dict[str, Any]] = []
    t_min = min((rec["t0"] + off for rec, _, off in triples), default=0.0)
    flow_id = 0
    for rec, node, offset in triples:
        pid = pids[node]
        tid = tids[(node, rec["thread"])]
        ts = round((rec["t0"] + offset - t_min) * 1e6, 3)
        dur = round(rec["dur"] * 1e6, 3)
        events.append({
            "name": rec["name"],
            "ph": "X",
            "ts": ts,
            "dur": dur,
            "pid": pid,
            "tid": tid,
            "cat": rec["name"].split(".", 1)[0],
            "args": {
                "trace_id": rec["trace_id"],
                "span_id": rec["span_id"],
                "parent_id": rec["parent_id"],
                "node": node,
                **rec["attrs"],
            },
        })
        parent_id = rec.get("parent_id")
        if not parent_id:
            continue
        parent = index.get((rec["trace_id"], parent_id))
        if parent is None or parent[0] == node:
            continue  # same-lane nesting is visible without an arrow
        # cross-node edge (the propagated wire context): a flow arrow from
        # the remote parent span to this child span
        p_node, p_off, p_rec = parent
        flow_id += 1
        flow = {"name": "peer", "cat": "net", "id": flow_id}
        events.append({
            **flow, "ph": "s",
            "ts": round((p_rec["t0"] + p_off - t_min) * 1e6, 3),
            "pid": pids[p_node],
            "tid": tids[(p_node, p_rec["thread"])],
        })
        events.append({
            **flow, "ph": "f", "bp": "e", "ts": ts, "pid": pid, "tid": tid,
        })

    meta: list[dict[str, Any]] = []
    for node, pid in sorted(pids.items(), key=lambda kv: kv[1]):
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "args": {"name": node}})
    for (node, thread), tid in sorted(tids.items(),
                                      key=lambda kv: (pids[kv[0][0]], kv[1])):
        meta.append({"name": "thread_name", "ph": "M", "pid": pids[node],
                     "tid": tid, "args": {"name": thread}})
    return {
        "traceEvents": meta + events,
        "displayTimeUnit": "ms",
        "otherData": {
            "merged_nodes": sorted(pids, key=pids.get),
            "cross_node_edges": flow_id,
        },
    }


def merge_files(paths: list[str | Path]) -> dict[str, Any]:
    docs = [json.loads(Path(p).read_text()) for p in paths]
    names = [Path(p).stem for p in paths]
    return merge(docs, node_names=names)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("dumps", nargs="+",
                    help="span-dump JSON files (obs.trace.export_spans)")
    ap.add_argument("--out", default="merged_trace.json",
                    help="merged chrome://tracing output path")
    args = ap.parse_args(argv)
    doc = merge_files(args.dumps)
    Path(args.out).write_text(json.dumps(doc))
    other = doc["otherData"]
    print(f"merged {len(args.dumps)} dump(s): {len(other['merged_nodes'])} "
          f"node lane(s) ({', '.join(other['merged_nodes'])}), "
          f"{other['cross_node_edges']} cross-node edge(s) -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
