"""A variant of one cell, for a question the cells do not answer (what a
larger backlog in flight does to a metric's spread, say): a root that
holds a copy of the benchmark's folder, a link to the checkout's program
(``src``) and a BENCHMARK.json whose one cell is the given cell with
some of its traffic mix's parameters changed.

    python3 etsbench/tools/variant.py --workload <cell> --out <dir> \\
        --set max_live=32 --set pool_pages=5120

then, from ``<dir>``, ``python3 etsbench/tools/series.py`` as for any
cell; the variant's name there is ``<cell>.variant``.
"""
import argparse
import json
import os
import shutil
from pathlib import Path


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--set", action="append", default=[],
                    help="key=value, the value read as JSON")
    a = ap.parse_args()
    root, out = Path.cwd(), Path(a.out).resolve()
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(root / "etsbench", out / "etsbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(root / "src", out / "src")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == a.workload)
    base = out / "etsbench"
    mix = json.loads((base / "traffic" / f"{cell['traffic']}.json")
                     .read_text())
    for kv in a.set:
        k, v = kv.split("=", 1)
        mix[k] = json.loads(v)
    name = f"{a.workload}.variant"
    (base / "traffic" / f"{cell['traffic']}.variant.json").write_text(
        json.dumps(mix, indent=1))
    shutil.copy(base / "limits" / f"{a.workload}.json",
                base / "limits" / f"{name}.json")
    bench["workloads"] = [dict(cell, name=name,
                               traffic=f"{cell['traffic']}.variant",
                               why="variant: " + " ".join(a.set))]
    (out / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    print(name)


if __name__ == "__main__":
    main()
