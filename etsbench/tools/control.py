"""The control of the correctness check: a run of a cell whose checks
also read the reference computed in the precision below the one each
model's configuration states (fp8 products for the bfloat16 LM and
PRM, TF32 for the float32 embedder), put in the served outputs' place.

    python3 etsbench/tools/control.py --workload <cell> --seed <n> \\
        --seconds <s> --trace 0 [--lm bf16]

Prints the run's result line; each check carries ``control`` beside its
``value`` (the served search's reading).  A limit sits between the two:
above what sound runs read, below what the control reads.  ``--lm``
and ``--prm`` read another precision instead (``bf16``: what a decode
in the configuration's own precision would read).
"""
import os
import sys
import time

T_START = time.perf_counter()

if __name__ == "__main__":
    import argparse
    import json
    root = os.getcwd()
    sys.path[:0] = [root, os.path.join(root, "src")]
    from etsbench import harness
    ap = argparse.ArgumentParser()
    ap.add_argument("--lm", default="fp8")
    ap.add_argument("--prm", default="fp8")
    ap.add_argument("--embedder", default="tf32")
    a, rest = ap.parse_known_args()
    try:
        res = harness.run(rest, root=__import__("pathlib").Path(root),
                          t_start=T_START,
                          control={"lm": a.lm, "prm": a.prm,
                                   "embedder": a.embedder})
    except harness.Fail as e:
        print(f"etsbench: {e}", file=sys.stderr)
        sys.exit(2)
    print(json.dumps(res), flush=True)
