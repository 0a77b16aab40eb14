"""``python -m repro_torch.obs`` — render reports / dump Perfetto traces.

    python -m repro_torch.obs report  RECORDED.jsonl [--json]
    python -m repro_torch.obs trace   RECORDED.jsonl -o OUT.trace.json

``RECORDED.jsonl`` is a trace file written by
:func:`repro_torch.tune.trace.save_jsonl` (any recorder: simulator,
instrumented executor, stagewise).  ``report`` prints the aggregate
(text, or the JSON payload with ``--json``); ``trace`` converts the
recording to Chrome trace-event JSON loadable at ui.perfetto.dev.
Multi-trace files emit one report (or one process lane) per trace.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Render a recorded run, or dump its Perfetto timeline.")
    sub = ap.add_subparsers(dest="cmd", required=True)

    ap_rep = sub.add_parser("report", help="print the run report")
    ap_rep.add_argument("jsonl", help="trace file (tune.save_jsonl)")
    ap_rep.add_argument("--json", action="store_true",
                        help="emit the JSON payload instead of text")

    ap_tr = sub.add_parser("trace", help="write Chrome trace-event JSON")
    ap_tr.add_argument("jsonl", help="trace file (tune.save_jsonl)")
    ap_tr.add_argument("-o", "--out", default=None,
                       help="output path (default: <input>.trace.json)")

    args = ap.parse_args(argv)

    from repro_torch.obs import timeline
    from repro_torch.obs.report import RunReport
    from repro_torch.tune import trace as tune_trace

    try:
        traces = tune_trace.load_jsonl(args.jsonl)
    except (OSError, ValueError, KeyError) as e:
        print(f"{args.jsonl}: not a recording "
              f"(expected tune.save_jsonl output): {e}", file=sys.stderr)
        return 1
    if not traces:
        print(f"{args.jsonl}: no traces", file=sys.stderr)
        return 1

    if args.cmd == "report":
        payloads = []
        for tr in traces:
            rep = RunReport(tr)
            if args.json:
                payloads.append(rep.to_json())
            else:
                print(rep.text())
        if args.json:
            json.dump(payloads if len(payloads) > 1 else payloads[0],
                      sys.stdout, indent=2, sort_keys=True)
            print()
        return 0

    out = args.out or (args.jsonl + ".trace.json")
    if len(traces) == 1:
        timeline.save(out, traces[0])
    else:
        events: list[dict] = []
        for pid, tr in enumerate(traces):
            events += timeline.chrome_trace(tr, pid=pid)["traceEvents"]
        timeline.save(out, {"traceEvents": events,
                            "displayTimeUnit": "ms"})
    print(f"wrote {out} ({sum(len(t.stages) for t in traces)} stage "
          f"spans from {len(traces)} trace(s))", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
