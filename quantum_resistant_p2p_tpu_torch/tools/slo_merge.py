"""Merge N per-node ``slo_report.json`` dumps into ONE fleet SLO report.

Counterpart of the JAX package's ``tools/slo_merge.py``, on the port's
:func:`obs.slo.merge_reports`.  The consumption-side twin of
:mod:`.trace_merge`: where trace_merge
joins N nodes' span dumps into one timeline, slo_merge folds N gateway
processes' SLO reports (``app.messaging.SecureMessaging.slo_report()``
documents, written by the port's ``fleet/gateway.py`` on shutdown as
``<gateway>_slo_report.json``) into one fleet document via
:func:`obs.slo.merge_reports`:

* per-SLO **fleet totals and burn** — cumulative good/bad summed by spec
  NAME across nodes, the offline twin of the fleet router's live windowed
  engine (``fleet/manager.py`` sums the same probe totals from
  heartbeats);
* **worst-node attribution** — each merged SLO names the gateway with the
  highest fast-window burn, so a fleet-level budget burn points at the
  process eating it;
* the **alerting roll-up** — every node whose local engine had latched an
  alert at dump time.

The fleet storm (``swarm_bench --storm --fleet N``) emits this
merge inline (``fleet_slo_report.json``); this CLI reproduces it from the
per-node files CI uploads, and accepts a directory (merging every
``*_slo_report.json`` inside — the fleet's ``report_dir`` layout).

Usage::

    python -m quantum_resistant_p2p_tpu_torch.tools.slo_merge --out fleet_slo.json \
        gw0_slo_report.json gw1_slo_report.json
    python -m quantum_resistant_p2p_tpu_torch.tools.slo_merge --out fleet_slo.json \
        torch_results/fleet_reports/
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Any

from ..obs.slo import merge_reports


def collect_paths(inputs: list[str | Path]) -> list[Path]:
    """Expand report files/directories into the per-node report list."""
    paths: list[Path] = []
    for raw in inputs:
        p = Path(raw)
        if p.is_dir():
            paths.extend(sorted(p.glob("*_slo_report.json")))
        else:
            paths.append(p)
    return paths


def merge_files(paths: list[str | Path]) -> dict[str, Any]:
    reports = []
    for p in collect_paths(paths):
        reports.append(json.loads(Path(p).read_text()))
    if not reports:
        raise ValueError("no slo_report.json inputs found")
    return merge_reports(reports)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("reports", nargs="+",
                    help="per-node slo_report.json files, or directories "
                         "holding *_slo_report.json (a fleet report_dir)")
    ap.add_argument("--out", default="fleet_slo_report.json",
                    help="merged fleet report output path")
    args = ap.parse_args(argv)
    try:
        doc = merge_files(args.reports)
    except ValueError as e:
        print(f"slo_merge: {e}", file=sys.stderr)
        return 2
    Path(args.out).write_text(json.dumps(doc, indent=2, sort_keys=True) + "\n")
    worst = doc.get("worst_node") or "-"
    alerting = doc.get("alerting") or []
    print(f"merged {len(doc['nodes'])} node report(s) "
          f"({', '.join(doc['nodes'])}): {len(doc['slos'])} SLO(s), "
          f"worst node {worst}, "
          f"{len(alerting)} alerting -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
