"""Aggregate dry-run JSONs into the EXPERIMENTS.md roofline table.

    PYTHONPATH=src python -m repro_torch.launch.report [--dir experiments/dryrun]
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def fmt_s(x):
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.2f}ms"
    return f"{x*1e6:.1f}us"


def load(dir_):
    rows = []
    for p in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(p) as f:
            rows.append(json.load(f))
    return rows


def table(rows, mesh="single"):
    rows = [r for r in rows if r.get("mesh") == mesh and r.get("compiled")]
    hdr = ("| arch | shape | compute | memory | collective | dominant | "
           "MODEL/HLO flops | bytes/chip | AG | AR | A2A |")
    sep = "|" + "---|" * 11
    out = [hdr, sep]
    order = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2,
             "long_500k": 3}
    rows.sort(key=lambda r: (r["arch"], order.get(r["shape"], 9)))
    for r in rows:
        c = r["collectives"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(r['compute_term_s'])} | "
            f"{fmt_s(r['memory_term_s'])} | {fmt_s(r['collective_term_s'])} | "
            f"**{r['dominant']}** | {r['useful_flops_ratio']:.2f} | "
            f"{r['hbm_bytes_per_chip']/1e9:.1f}GB | "
            f"{c.get('all-gather', 0)/1e9:.2f}GB | "
            f"{c.get('all-reduce', 0)/1e9:.2f}GB | "
            f"{c.get('all-to-all', 0)/1e9:.2f}GB |")
    return "\n".join(out)


def interesting(rows):
    """Rank hillclimb candidates: worst collective/compute ratio etc."""
    rows = [r for r in rows if r.get("mesh") == "single" and r["compiled"]]
    scored = []
    for r in rows:
        terms = {"compute": r["compute_term_s"], "memory": r["memory_term_s"],
                 "collective": r["collective_term_s"]}
        dom = max(terms, key=terms.get)
        useful = max(terms["compute"], 1e-12)
        overhead = terms[dom] / useful if dom != "compute" else 1.0
        scored.append((overhead, dom, r["arch"], r["shape"]))
    scored.sort(reverse=True)
    return scored


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun")
    ap.add_argument("--mesh", default="single")
    args = ap.parse_args()
    rows = load(args.dir)
    print(table(rows, args.mesh))
    print("\nhillclimb candidates (dominant-term / compute-term ratio):")
    for ov, dom, arch, shape in interesting(rows)[:10]:
        print(f"  {arch:20s} {shape:12s} {dom:10s} overhead x{ov:9.1f}")


if __name__ == "__main__":
    main()
