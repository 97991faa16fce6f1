# The full measurement of one cell on one card: two sets of six runs on
# the same six seeds (the spreads the bounds rest on), then three traced
# runs on three more seeds; every run's result goes to <out>.jsonl.
#   bash etsbench/tools/full_sets.sh <cell> <seed base> <out>
set -x
CELL=$1; B=$2; OUT=$3
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
mkdir -p "$(dirname "$OUT")"
S=etsbench/tools/series.py
python3 $S --out "$OUT.jsonl" --workload $CELL --seconds 50 \
    --seeds $((B+1)) $((B+2)) $((B+3)) $((B+4)) $((B+5)) $((B+6)) --repeat 2
python3 $S --out "$OUT.jsonl" --workload $CELL --seconds 50 \
    --seeds $((B+11)) $((B+12)) $((B+13)) --trace 1
nvidia-smi --query-gpu=name,power.limit,clocks.sm,temperature.gpu --format=csv,noheader
