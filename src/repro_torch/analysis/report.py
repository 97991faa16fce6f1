"""Roofline / dry-run tables from the dry run's JSON records (port of
``repro.analysis.report``).

    PYTHONPATH=src python -m repro_torch.analysis.report \\
        [--dir experiments/dryrun_torch]

The reference's TPU-projection column becomes the share of one H100's
80 GB that the per-device peak takes, and its MXU note the tensor
cores'.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

HBM_BYTES = 80e9             # one H100 SXM5


def fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x * 1e6:.0f}us"
    if x < 1:
        return f"{x * 1e3:.1f}ms"
    return f"{x:.2f}s"


def fmt_b(x: float) -> str:
    if x >= 1e9:
        return f"{x / 1e9:.2f}GB"
    if x >= 1e6:
        return f"{x / 1e6:.1f}MB"
    return f"{x / 1e3:.0f}KB"


def load(dirpath: str):
    recs = []
    for f in sorted(glob.glob(os.path.join(dirpath, "*.json"))):
        with open(f) as fh:
            recs.append(json.load(fh))
    return recs


def dryrun_table(recs, mesh: str) -> str:
    rows = ["| arch | shape | status | peak/dev | of H100 | lower | compile |",
            "|---|---|---|---|---|---|---|"]
    for r in recs:
        if r.get("mesh") != mesh and not (
                r.get("status") == "skip"):
            continue
        if r.get("mesh") != mesh and r.get("status") == "skip":
            # skips recorded per-mesh too; keep only matching tag
            continue
        st = r["status"]
        shape_lbl = r["shape"] + (" **(opt)**" if r.get("variant") == "opt"
                                  else "")
        if st == "ok":
            m = r["memory"]
            rows.append(
                f"| {r['arch']} | {shape_lbl} | ok | "
                f"{fmt_b(m['peak_bytes_est'])} | "
                f"{m['peak_bytes_est'] / HBM_BYTES:.2f}x | "
                f"{r.get('lower_s', '?')}s | {r.get('compile_s', '?')}s |")
        elif st == "skip":
            rows.append(f"| {r['arch']} | {r['shape']} | skip | — | — | — "
                        f"| {r['reason'][:40]} |")
        else:
            rows.append(f"| {r['arch']} | {r['shape']} | FAIL | — | — | — "
                        f"| {r.get('error', '')[:40]} |")
    return "\n".join(rows)


def roofline_table(recs, mesh: str = "pod16x16") -> str:
    rows = ["| arch | shape | compute | memory | collective | bottleneck |"
            " MODEL_FLOPS/HLO | note |",
            "|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r.get("status") != "ok" or r.get("mesh") != mesh:
            continue
        rf = r["roofline"]
        note = _note(rf)
        shape_lbl = r["shape"] + (" **(opt)**" if r.get("variant") == "opt"
                                  else "")
        rows.append(
            f"| {r['arch']} | {shape_lbl} | {fmt_s(rf['compute_s'])} | "
            f"{fmt_s(rf['memory_s'])} | {fmt_s(rf['collective_s'])} | "
            f"{rf['bottleneck']} | {rf['useful_flops_ratio']:.2f} | "
            f"{note} |")
    return "\n".join(rows)


def _note(rf) -> str:
    bn = rf["bottleneck"]
    if bn == "collective":
        return "reduce cross-shard resharding / overlap collectives"
    if bn == "memory":
        return "KV/weight streaming bound; quantize or batch more"
    return "tensor-core-bound; increase per-GPU batch only if mem allows"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    args = ap.parse_args()
    recs = load(args.dir)
    for mesh in ["pod16x16", "pod2x16x16"]:
        sub = [r for r in recs if r.get("mesh") == mesh]
        ok = sum(r["status"] == "ok" for r in sub)
        sk = sum(r["status"] == "skip" for r in sub)
        fl = sum(r["status"] == "fail" for r in sub)
        print(f"\n### Mesh {mesh}: ok={ok} skip={sk} fail={fl}\n")
        print(dryrun_table(recs, mesh))
    print("\n### Roofline (single-pod)\n")
    print(roofline_table(recs))


if __name__ == "__main__":
    main()
