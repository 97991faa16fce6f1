# The program tracer on one card, one cell: (1) untraced runs of this
# checkout against an older one (<parent>, a checkout of the parent
# commit with this benchmark folder), in turns: parent then this on seed
# B+1, this then parent on B+2 — the cost of the tracer's call sites
# when it is off (skipped where <parent> is -); (2) three traced runs read through the program's
# tracer (tools/program.py) on seeds B+11..B+13; (3) with "cost", a
# traced run with the tracer off on seed B+11 — the tracer's cost when
# on.  Records go to chiprun_out/<out>_*.jsonl.
#   bash etsbench/tools/program_sets.sh <cell> <seed base> <parent> <out> [cost]
set -x
CELL=$1; B=$2; PARENT=$3; OUT=$PWD/chiprun_out/$4; COST=$5
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
mkdir -p "$(dirname "$OUT")"
HERE=$PWD
S=$HERE/etsbench/tools/series.py
ab() {  # <dir> <seed> <side>
    (cd "$1" && python3 "$S" --out "${OUT}_ab_$3.jsonl" --workload "$CELL" \
        --seconds 50 --seeds "$2")
}
if [ "$PARENT" != - ]; then
    ab "$PARENT" $((B+1)) parent
    ab "$HERE" $((B+1)) change
    ab "$HERE" $((B+2)) change
    ab "$PARENT" $((B+2)) parent
fi
for s in $((B+11)) $((B+12)) $((B+13)); do
    timeout 900 python3 etsbench/tools/program.py --workload "$CELL" \
        --seed $s --seconds 50 --trace 1 --tracer 1 \
        2> "${OUT}_traced_$s.err" | tail -n 1 >> "${OUT}_traced.jsonl"
    tail -n 3 "${OUT}_traced_$s.err"
done
if [ "$COST" = cost ]; then
    timeout 900 python3 etsbench/tools/program.py --workload "$CELL" \
        --seed $((B+11)) --seconds 50 --trace 1 --tracer 0 \
        2> "${OUT}_off_$((B+11)).err" | tail -n 1 >> "${OUT}_traced.jsonl"
    tail -n 3 "${OUT}_off_$((B+11)).err"
fi
python3 - "$OUT" <<'EOF'
import json, sys
out = sys.argv[1]
import os
for side in ("parent", "change"):
    if not os.path.exists(f"{out}_ab_{side}.jsonl"):
        continue
    for ln in open(f"{out}_ab_{side}.jsonl"):
        r = json.loads(ln)
        m = {k: v["value"] for k, v in
             ((r["result"] or {}).get("metrics") or {}).items()}
        print(side, r["seed"], r["rc"], (r["result"] or {}).get("correct"), m)
for ln in open(f"{out}_traced.jsonl"):
    r = json.loads(ln)
    p = r["program"] or {}
    print("traced tracer=%s" % r["tracer"], r["result"]["correct"],
          json.dumps(r["e2e"]), json.dumps(
              {k: p.get(k) for k in ("decode.host_ms", "decode.idle_ms",
                                     "step.decode_share",
                                     "moe.prm_drop_share",
                                     "kv.cow_pages_per_step", "dropped")}))
    print("  program idle:", json.dumps((p.get("idle_gaps") or [])[:12]))
    print("  idle overlap:", json.dumps((p.get("idle_overlap") or [])[:14]))
    print("  phase ms:", json.dumps(p.get("decode.phase_ms")))
    print("  harness idle:", json.dumps(
        r["result"].get("breakdown", {}).get("idle_gaps")))
    print("  layers:", json.dumps(
        {k: v["value"] for k, v in r["result"]["metrics"].items()}))
EOF
nvidia-smi --query-gpu=name,power.limit,clocks.sm,temperature.gpu --format=csv,noheader
