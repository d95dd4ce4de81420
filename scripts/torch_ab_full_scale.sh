#!/usr/bin/env bash
# The JAX repo's A/B benches and recipe studies on the port at their full
# scale, on one card, in two parts that each fit one 45-minute run:
#
#   ab    the reference recipe's 15 000 steps at float32 and at bfloat16
#         (scripts/torch_r3_session.py ab_f32,ab_bf16: about 25 minutes),
#         then on the bfloat16 checkpoint the detector post-processing
#         sweep (torch_school_postproc_sweep.py), evaluation by transfer
#         dtype (torch_eval_quant_bench.py) and live school detection
#         (torch_school_serving_bench.py), then the pooled metadata steps
#         (torch_pooled_meta_bench.py) and the static grid's cold arms
#         (torch_static_grid.py, run twice);
#   detect  the reference recipe's 15 000 steps at bfloat16 alone, then on
#         its checkpoint live school detection beside prediction alone in
#         one process (the detector's share), then the static grid's cold
#         arms in both orders, twice each (what a first process pays
#         against what an arm costs): about 12 minutes;
#   arms  the fast recipe's arms b16, b16_sqrt and b32
#         (torch_fast_recipe.py), then the metadata recipe early and late
#         (torch_meta_recipe.py): about 30 minutes.
#
# Nothing trained outlives the run but the JSON under OUT (a checkpoint
# is over what a chip call brings back).
#
#   bash scripts/torch_ab_full_scale.sh [WORK] [OUT] [ab|detect|arms|all]
set -euo pipefail
cd "$(dirname "$0")/.."
WORK=${1:-build/torch_ab_full}
OUT=${2:-$WORK/results}
PART=${3:-all}
mkdir -p "$WORK" "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
if [[ $PART == ab || $PART == all ]]; then
    python3 scripts/torch_r3_session.py --stages ab_f32,ab_bf16 \
        --work "$WORK" --out "$OUT/r3_results.json"
    CKPT="$WORK/ckpt_bfloat16/best.msgpack"
    python3 scripts/torch_school_postproc_sweep.py --ckpt "$CKPT" \
        --work "$WORK" --out "$OUT/sweep.json" > "$OUT/sweep.log"
    tail -n 1 "$OUT/sweep.log" > "$OUT/sweep_summary.json"
    python3 scripts/torch_eval_quant_bench.py --ckpt "$CKPT" --work "$WORK" \
        --out "$OUT/eval_quant_bench.json"
    python3 scripts/torch_school_serving_bench.py --ckpt "$CKPT" \
        --work "$WORK" --out "$OUT/school_serving_bench.json"
    python3 scripts/torch_pooled_meta_bench.py \
        --out "$OUT/pooled_meta_bench.json"
    # twice: whether a cold arm's wall depends on what ran before it
    for run in 1 2; do
        python3 scripts/torch_static_grid.py --work "$WORK" \
            --out "$OUT/static_grid_$run.json"
    done
fi
if [[ $PART == detect ]]; then
    python3 scripts/torch_r3_session.py --stages ab_bf16 \
        --work "$WORK" --out "$OUT/r3_results.json"
    python3 scripts/torch_school_serving_bench.py \
        --ckpt "$WORK/ckpt_bfloat16/best.msgpack" --work "$WORK" \
        --out "$OUT/school_serving_bench.json"
    for run in 1 2; do
        for order in dynamic,static static,dynamic; do
            python3 scripts/torch_static_grid.py --work "$WORK" \
                --order "$order" --out "$OUT/static_grid_${order/,/_}_$run.json"
        done
    done
fi
if [[ $PART == arms || $PART == all ]]; then
    python3 scripts/torch_fast_recipe.py --arms b16,b16_sqrt,b32 \
        --work "$WORK" --out "$OUT/fast_results.json"
    python3 scripts/torch_meta_recipe.py --work "$WORK" \
        --out "$OUT/meta_results.json"
    python3 scripts/torch_meta_recipe.py --late --work "$WORK" \
        --out "$OUT/meta_results.json"
fi
