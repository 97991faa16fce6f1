"""Run a series of benchmark runs, one process each, and report them.

    python3 etsbench/tools/series.py --out results/x.jsonl \\
        --workload <cell> --seconds 50 --seeds 11 12 13 [--trace 1] \\
        [--repeat 2] [--control]

Each run is ``etsbench/run.py`` (or, with ``--control``,
``etsbench/tools/control.py``) in a fresh process, as the benchmark's
command runs.  Every run's last stdout line, its return code, its wall seconds
and the last lines of its stderr go to ``--out`` (JSON lines); a summary
per metric (median, and the spread: the quartiles' distance over the
median, Python's ``statistics.quantiles``) goes to stdout.  With
``--repeat 2`` the seeds run twice, as two sets.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def spread(vals):
    if len(vals) < 2:
        return None
    q1, _, q3 = statistics.quantiles(vals, n=4)
    med = statistics.median(vals)
    return (q3 - q1) / abs(med) if med else None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--timeout", type=float, default=600)
    a = ap.parse_args()
    script = "etsbench/tools/control.py" if a.control else "etsbench/run.py"
    sets = []
    os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
    with open(a.out, "a") as f:
        for rep in range(a.repeat):
            runs = []
            for seed in a.seeds:
                cmd = [sys.executable, script, "--workload", a.workload,
                       "--seed", str(seed), "--seconds", str(a.seconds),
                       "--trace", str(a.trace)]
                t0 = time.time()
                p = subprocess.run(cmd, capture_output=True, text=True,
                                   timeout=a.timeout)
                wall = time.time() - t0
                lines = p.stdout.strip().splitlines()
                res = None
                if p.returncode == 0 and lines:
                    res = json.loads(lines[-1])
                rec = {"workload": a.workload, "seed": seed, "set": rep,
                       "trace": a.trace, "control": a.control,
                       "rc": p.returncode, "wall_s": wall, "result": res,
                       "stderr": p.stderr[-3000:]}
                f.write(json.dumps(rec) + "\n")
                f.flush()
                runs.append(rec)
                short = {k: round(v["value"], 6) for k, v in
                         (res or {}).get("metrics", {}).items()}
                chk = {k: round(v["value"], 6) for k, v in
                       (res or {}).get("checks", {}).items()}
                print(json.dumps({"seed": seed, "set": rep,
                                  "rc": p.returncode, "wall_s": round(wall, 1),
                                  "correct": (res or {}).get("correct"),
                                  "metrics": short, "checks": chk}),
                      flush=True)
                if p.returncode != 0:
                    print(p.stderr[-2500:], flush=True)
            sets.append(runs)
    for i, runs in enumerate(sets):
        names = sorted({k for r in runs if r["result"]
                        for k in r["result"]["metrics"]})
        summ = {}
        for n in names:
            vals = [r["result"]["metrics"][n]["value"] for r in runs
                    if r["result"] and n in r["result"]["metrics"]]
            summ[n] = {"median": statistics.median(vals),
                       "spread": spread(vals), "n": len(vals)}
        print(json.dumps({"set": i, "summary": summ}), flush=True)


if __name__ == "__main__":
    main()
