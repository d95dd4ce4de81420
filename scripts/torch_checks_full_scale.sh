#!/usr/bin/env bash
# The JAX package's trained-weight and survey-scale checks on the port at
# their full scale, on one card: the reference recipe's 15 000 steps
# (scripts/torch_school_ap_trained.py, school AP on the big held-out
# fixture), then the uint8, evaluation and geometry checks on its best
# checkpoint, the 50 000-ping soaks (patch, slab, eval uint8) and the
# 50 000-ping detector soak.  About 30 minutes on an H100; nothing of it
# outlives the run but the JSON lines under OUT.
#
#   bash scripts/torch_checks_full_scale.sh [WORK] [OUT]
set -euo pipefail
cd "$(dirname "$0")/.."
WORK=${1:-build/torch_checks_full}
OUT=${2:-$WORK/results}
PINGS=50000
mkdir -p "$WORK" "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
# the soak survey is written while the recipe trains
python3 scripts/torch_soak50k.py --build-fixture \
    "$WORK/soak_${PINGS}x1000" "$PINGS" 1000 &
FIXTURE=$!
trap 'kill "$FIXTURE" 2>/dev/null || true' EXIT
python3 scripts/torch_school_ap_trained.py --iterations 15000 --big-val \
    --work "$WORK" --out "$OUT/school_ap_trained.json"
CKPT="$WORK/ckpt/best.msgpack"
for check in u8_bound eval_u8_bound serving_geometry_ab; do
    python3 "scripts/torch_$check.py" --ckpt "$CKPT" --work "$WORK" \
        --out "$OUT/$check.json"
done
wait "$FIXTURE"
for mode in patch slab eval; do
    python3 scripts/torch_soak50k.py "$mode" --pings "$PINGS" --ckpt "$CKPT" \
        --work "$WORK" --out "$OUT/soak50k_$mode.json"
done
python3 scripts/torch_school_eval_soak.py --pings "$PINGS" \
    --out "$OUT/school_eval_soak.json"
