"""Roofline report generator (port of ``repro/launch/roofline.py``).

Reads the dry-run JSONL (``launch/dryrun.py --out``) and emits the
roofline table: per (arch x shape x mesh) the three terms, with one
NVIDIA H100 SXM's constants (``launch/mesh.py``)
    compute    = analytic_FLOPs/dev / 989 TFLOP/s (dense bf16)
    memory     = analytic_HBM_bytes/dev / 3.35 TB/s (HBM3)
    collective = traced collective bytes/dev / 50 GB/s (one 400 Gb/s NIC
                 per GPU: every axis of both meshes spans nodes)
plus the dominant term, MODEL_FLOPS/analytic ratio ("useful fraction"),
the traced peak against the card's 80 GB, and a one-line "what would
move the dominant term" suggestion.  A pair whose trace resharded views
DTensor's strict rule refuses (the record's ``relaxed_views``: on real
ranks each raises) is marked in its row and listed under the summary.

Usage: python -m repro_torch.launch.roofline --in dryrun_results.jsonl
[--md]
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional

SUGGEST = {
    ("compute",): "raise arithmetic intensity: bigger per-device batch or "
                  "reduce remat recompute; already near the right regime for "
                  "training",
    ("memory",): "cut HBM traffic: fuse elementwise chains (flash kernel), "
                 "quantize KV cache to int8, or larger decode batch to "
                 "amortize weight reads",
    ("collective",): "cut bytes on the wire: avoid FSDP regathers "
                     "(weight-stationary layout), overlap collectives with "
                     "compute, or int8-compress the FL round all-reduce",
}


def load(path: str) -> List[Dict]:
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    last = {}
    for r in recs:               # keep the LAST record per key (post-fix runs)
        last[(r["arch"], r["shape"], r["mesh"], r.get("fl_round", False))] = r
    return [last[k] for k in sorted(last)]


def fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-6:
        return f"{x*1e9:.1f}ns"
    if x < 1e-3:
        return f"{x*1e6:.1f}us"
    if x < 1.0:
        return f"{x*1e3:.2f}ms"
    return f"{x:.2f}s"


def _relaxed(r: Dict) -> int:
    return sum(r.get("relaxed_views", {}).values())


def _relaxed_mark(r: Dict) -> str:
    n = _relaxed(r)
    return f" (relaxed views: {n})" if n else ""


def make_table(recs: List[Dict], md: bool = True) -> str:
    head = ["arch", "shape", "mesh", "t_compute", "t_memory", "t_collective",
            "dominant", "useful", "peakGB", "fits80GB"]
    rows = []
    for r in recs:
        if r["status"] == "skipped":
            rows.append([r["arch"], r["shape"], r["mesh"], "-", "-", "-",
                         f"SKIP: {r['skip_reason'][:36]}", "-", "-", "-"])
            continue
        if r["status"] != "ok":
            rows.append([r["arch"], r["shape"], r["mesh"], "-", "-", "-",
                         "FAILED", "-", "-", "-"])
            continue
        t = r["roofline"]
        pd = r["per_device"]
        uf = r.get("useful_flops_frac")
        rows.append([
            r["arch"], r["shape"], r["mesh"],
            fmt_s(t["t_compute_s"]), fmt_s(t["t_memory_s"]),
            fmt_s(t["t_collective_s"]), t["dominant"],
            f"{uf:.2f}" if uf else "-",
            f"{pd['peak_bytes_est']/1e9:.1f}",
            ("Y" if pd.get("fits_80GB") else "N") + _relaxed_mark(r),
        ])
    if md:
        out = ["| " + " | ".join(head) + " |",
               "|" + "---|" * len(head)]
        out += ["| " + " | ".join(str(c) for c in row) + " |" for row in rows]
        return "\n".join(out)
    w = [max(len(str(r[i])) for r in rows + [head]) for i in range(len(head))]
    lines = ["  ".join(str(h).ljust(w[i]) for i, h in enumerate(head))]
    lines += ["  ".join(str(c).ljust(w[i]) for i, c in enumerate(row))
              for row in rows]
    return "\n".join(lines)


def summarize(recs: List[Dict]) -> str:
    out = []
    ok = [r for r in recs if r["status"] == "ok"]
    for dom in ("compute", "memory", "collective"):
        sub = [r for r in ok if r["roofline"]["dominant"] == dom]
        out.append(f"{dom}-bound: {len(sub)} pairs")
    worst = sorted(ok, key=lambda r: (r.get("useful_flops_frac") or 1.0))[:3]
    out.append("lowest useful-FLOPs fraction: " + ", ".join(
        f"{r['arch']}x{r['shape']}x{r['mesh']}"
        f"({(r.get('useful_flops_frac') or 0):.2f})" for r in worst))
    collbound = sorted(ok, key=lambda r: -r["roofline"]["t_collective_s"])[:3]
    out.append("largest collective term: " + ", ".join(
        f"{r['arch']}x{r['shape']}x{r['mesh']}"
        f"({fmt_s(r['roofline']['t_collective_s'])})" for r in collbound))
    relaxed = [r for r in recs if r["status"] != "skipped" and _relaxed(r)]
    if relaxed:
        out.append("relaxed views (resharded by the trace; each raises on "
                   "real ranks): " + "; ".join(
                       f"{r['arch']}x{r['shape']}x{r['mesh']} " + ", ".join(
                           f"{site} x{n}"
                           for site, n in r["relaxed_views"].items())
                       for r in relaxed))
    return "\n".join(out)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--in", dest="inp", default="dryrun_results.jsonl")
    ap.add_argument("--md", action="store_true")
    ap.add_argument("--mesh", default=None, help="filter: 16x16 or 2x16x16")
    args = ap.parse_args(argv)
    recs = load(args.inp)
    if args.mesh:
        recs = [r for r in recs if r["mesh"] == args.mesh]
    print(make_table(recs, md=args.md))
    print()
    print(summarize(recs))


if __name__ == "__main__":
    main()
