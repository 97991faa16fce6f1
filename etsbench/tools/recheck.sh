# Each cell on two seeds of its full sets (the KV count must read as it
# did there) and two fresh seeds, then cell 3 with twice the problems in
# flight on the six seeds of its full sets: what a larger backlog in
# flight does to the spread of kv_mib_per_problem and to the number of
# step gaps.  Every run's record goes to chiprun_out/<name>.jsonl.
#   bash etsbench/tools/recheck.sh
set -x
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
O=$PWD/chiprun_out
S=etsbench/tools/series.py
mkdir -p "$O"
python3 $S --out $O/r_short.jsonl --workload qwen2-vl-7b.short-w16 \
    --seconds 50 --seeds 3300000001 3300000002 3300000021 3300000022
python3 $S --out $O/r_fewshot.jsonl --workload qwen2-vl-7b.fewshot-w16 \
    --seconds 50 --seeds 3100000001 3100000002 3100000021 3100000022
python3 $S --out $O/r_deepseek.jsonl --workload deepseek-moe-16b.short-w16 \
    --seconds 50 --seeds 3200000001 3200000002 3200000021 3200000022
V=$O/variant_root
python3 etsbench/tools/variant.py --workload qwen2-vl-7b.short-w16 \
    --out $V --set max_live=32 --set pool_pages=5120
(cd $V && python3 $S --out $O/r_short_l32.jsonl \
    --workload qwen2-vl-7b.short-w16.variant --seconds 50 \
    --seeds 3300000001 3300000002 3300000003 3300000004 3300000005 \
    3300000006)
rm -rf $V
nvidia-smi --query-gpu=name,power.limit,clocks.sm,temperature.gpu --format=csv,noheader
