"""Render EXPERIMENTS.md §Dry-run / §Roofline tables from dryrun.jsonl.

    PYTHONPATH=src python -m repro.launch.report results/dryrun.jsonl
"""
from __future__ import annotations

import json
import pathlib
import sys


def load(path):
    recs = []
    for line in pathlib.Path(path).read_text().splitlines():
        try:
            recs.append(json.loads(line))
        except json.JSONDecodeError:
            pass
    # dedupe: keep the latest record per cell key
    by_key = {}
    for r in recs:
        by_key[(r.get("arch"), r.get("shape"), r.get("mesh"),
                r.get("moe_ep", False))] = r
    return list(by_key.values())


def fmt_bytes(b):
    return f"{b/2**30:.2f}"


def roofline_table(recs, mesh="single"):
    rows = []
    hdr = ("| arch | shape | compute s | memory s | collective s | dominant "
           "| peak GiB | MODEL/HLO | roofline frac |")
    sep = "|" + "---|" * 9
    rows.append(hdr)
    rows.append(sep)
    for r in sorted(recs, key=lambda r: (r.get("arch", ""), r.get("shape", ""))):
        if not r.get("ok") or r.get("mesh") != mesh or r.get("moe_ep"):
            continue
        rt = r["roofline"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {rt['compute_s']:.3e} "
            f"| {rt['memory_s']:.3e} | {rt['collective_s']:.3e} "
            f"| **{rt['dominant']}** | {r['memory']['peak_gib']:.1f} "
            f"| {rt['useful_ratio']:.2f} | {rt['roofline_fraction']:.2f} |")
    return "\n".join(rows)


def dryrun_table(recs):
    rows = ["| arch | shape | mesh | ok | compile s | peak GiB | flops/dev "
            "| coll B/dev | collective mix |", "|" + "---|" * 9]
    for r in sorted(recs, key=lambda r: (r.get("arch", ""), r.get("shape", ""),
                                         r.get("mesh", ""))):
        if r.get("moe_ep"):
            continue
        if not r.get("ok"):
            rows.append(f"| {r.get('arch')} | {r.get('shape')} "
                        f"| {r.get('mesh')} | FAIL | - | - | - | - | "
                        f"{str(r.get('error'))[:60]} |")
            continue
        mix = ",".join(f"{k.split('-')[-1]}:{v:.1e}" for k, v in
                       sorted(r["collectives"]["bytes_by_kind"].items()))
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok "
            f"| {r['compile_s']} | {r['memory']['peak_gib']:.1f} "
            f"| {r['cost']['flops_per_device']:.2e} "
            f"| {r['collectives']['total_bytes']:.2e} | {mix} |")
    return "\n".join(rows)


def pick_hillclimb(recs):
    """worst roofline fraction / most collective-bound / paper-representative."""
    ok = [r for r in recs if r.get("ok") and r["mesh"] == "single"
          and not r.get("moe_ep")]
    if not ok:
        return {}
    worst = min(ok, key=lambda r: r["roofline"]["roofline_fraction"])
    coll = max(ok, key=lambda r: r["roofline"]["collective_s"])
    return {"worst_roofline": (worst["arch"], worst["shape"]),
            "most_collective": (coll["arch"], coll["shape"])}


def main():
    path = sys.argv[1] if len(sys.argv) > 1 else "results/dryrun.jsonl"
    recs = load(path)
    n_ok = sum(1 for r in recs if r.get("ok"))
    print(f"## §Dry-run ({n_ok}/{len(recs)} cells ok)\n")
    print(dryrun_table(recs))
    print("\n## §Roofline (single-pod 16x16, per device)\n")
    print(roofline_table(recs, "single"))
    print("\n## §Roofline (multi-pod 2x16x16)\n")
    print(roofline_table(recs, "multi"))
    print("\nhillclimb candidates:", pick_hillclimb(recs))


if __name__ == "__main__":
    main()