"""Roofline report generator: a dry run's JSON records → markdown tables.

    PYTHONPATH=src python -m repro_torch.roofline.report results/dryrun_torch

The port of :mod:`repro.roofline.report`: the same §Dry-run and
§Roofline tables from :mod:`repro_torch.launch.dryrun`'s records.  The
roofline's terms are the cost model's against one H100's published
peaks (:mod:`repro_torch.roofline.analysis`), not times on a card; the
dry-run table's seconds are the meta-device build's.
"""

from __future__ import annotations

import json
import os
import sys

ARCH_ORDER = ["nemotron-4-15b", "granite-8b", "qwen3-8b", "granite-3-8b",
              "qwen2-moe-a2.7b", "deepseek-v2-236b", "recurrentgemma-9b",
              "rwkv6-1.6b", "whisper-small", "llama-3.2-vision-11b"]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(out_dir: str) -> list[dict]:
    rows = []
    summary = os.path.join(out_dir, "summary.json")
    seen = set()
    for f in sorted(os.listdir(out_dir)):
        if not f.endswith(".json") or f == "summary.json":
            continue
        with open(os.path.join(out_dir, f)) as fh:
            r = json.load(fh)
        rows.append(r)
        seen.add((r["arch"], r["shape"], r.get("multi_pod", False)))
    if os.path.exists(summary):
        with open(summary) as fh:
            for r in json.load(fh):
                key = (r.get("arch"), r.get("shape"), r.get("multi_pod"))
                if key not in seen and r.get("status") != "ok":
                    rows.append(r)
                    seen.add(key)
    return rows


def fmt_bytes(b):
    if b is None:
        return "—"
    return f"{b / 2 ** 30:.2f}"


def fmt_t(t):
    if t is None:
        return "—"
    if t >= 1:
        return f"{t:.2f}s"
    return f"{t * 1e3:.1f}ms"


def dryrun_table(rows: list[dict]) -> str:
    out = ["| arch | shape | mesh | status | per-rank temp GiB | build s |",
           "|---|---|---|---|---|---|"]
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            for mp in (False, True):
                r = _find(rows, arch, shape, mp)
                if r is None:
                    continue
                mesh = "2×16×16" if mp else "16×16"
                st = r.get("status", "?")
                mem = r.get("memory_analysis", {}).get("temp_bytes") \
                    if st == "ok" else None
                out.append(
                    f"| {arch} | {shape} | {mesh} | {st} | "
                    f"{fmt_bytes(mem)} | {r.get('build_s', '—')} |")
    return "\n".join(out)


def roofline_table(rows: list[dict]) -> str:
    out = ["| arch | shape | t_comp | t_mem⁺ | t_coll | dominant | "
           "useful | frac(cc) | note |",
           "|---|---|---|---|---|---|---|---|---|"]
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            r = _find(rows, arch, shape, False)
            if r is None:
                continue
            st = r.get("status", "?")
            if st != "ok" or "t_compute_s" not in r:
                out.append(f"| {arch} | {shape} | — | — | — | — | — | — "
                           f"| {st} |")
                continue
            fcc = r.get("roofline_fraction_cc")
            if fcc is None:
                fcc = r["roofline_fraction"]
            bcc = r.get("bottleneck_cc") or r["bottleneck"]
            out.append(
                f"| {arch} | {shape} | {fmt_t(r['t_compute_s'])} | "
                f"{fmt_t(r['t_memory_s'])} | {fmt_t(r['t_collective_s'])} | "
                f"{bcc} | {r['useful_flops_ratio']:.2f} | "
                f"{fcc:.3f} | |")
    return "\n".join(out)


def _find(rows, arch, shape, mp):
    for r in rows:
        if r.get("arch") == arch and r.get("shape") == shape \
                and bool(r.get("multi_pod", False)) == mp:
            return r
    return None


def main():
    out_dir = sys.argv[1] if len(sys.argv) > 1 else "results/dryrun_torch"
    rows = load(out_dir)
    print("## §Dry-run\n")
    print(dryrun_table(rows))
    print("\n## §Roofline (single-pod 16×16, 256 ranks; the cost model "
          "against one H100's published peaks)\n")
    print(roofline_table(rows))
    ok = sum(1 for r in rows if r.get("status") == "ok")
    print(f"\n{ok} ok / {len(rows)} records")


if __name__ == "__main__":
    main()
