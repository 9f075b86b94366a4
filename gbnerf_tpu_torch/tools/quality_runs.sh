#!/usr/bin/env bash
# The ablation's quality runs on one card, side by side (each run is
# host-bound and leaves the card idle most of a step):
#   c4_torch  run_ablation --combine sds --arms s1,nog,rand,prior,priorNL
#             (the port's torch draws)
#   c4_jax    run_ablation --combine sds --arms s1,priorNL --draws jax
#             (the JAX package's draws: its s1, prior, scene LoRA, arm)
#   c3_plain  s1 with --draws jax and K1-K5, K3 off (tools/plain_path.py)
# Each run's logs, metrics and ablation.json go to RESULTS/<run>/.
#
#   bash gbnerf_tpu_torch/tools/quality_runs.sh OUT RESULTS RUN [RUN ...]
set -u
OUT=$1; RES=$2; shift 2
PY=${PYTHON:-python3}
mkdir -p "$OUT" "$RES"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader \
    > "$RES/card.txt" 2>&1
ABL="$PY -m gbnerf_tpu_torch.tools.run_ablation"

collect() {                  # what a run has so far, into RES/<run>/
    local d=$1 r=$2 m
    cp "$d"/*.log "$d"/ablation.json "$r/" 2>/dev/null
    for m in "$d"/logs/*/metrics.jsonl; do
        [ -f "$m" ] && cp "$m" "$r/$(basename "$(dirname "$m")").metrics.jsonl"
    done
}

run_one() {
    local name=$1 d="$OUT/$1" r="$RES/$1"
    mkdir -p "$d" "$r"
    # every minute, so that a run cut by a time limit leaves its finished
    # arms' results
    (while sleep 60; do collect "$d" "$r"; done) &
    local copier=$!
    case $name in
    c4_torch) $ABL "$d" --combine sds --arms s1,nog,rand,prior,priorNL ;;
    c4_jax) $ABL "$d" --combine sds --arms s1,priorNL --draws jax ;;
    c3_plain)
        $ABL "$d" --arms s1 --draws jax --check &&
        $PY -m gbnerf_tpu_torch.tools.make_synthetic_scene "$d/scene" \
            --task inpaint --H 189 --W 252 --n_train 16 --n_test 3 \
            --seed 0 --colmap_sparse > "$d/scene.log" 2>&1 &&
        $PY -m gbnerf_tpu_torch.tools.plain_path --config "$d/cfg_s1.txt" \
            --device cuda --draws jax > "$d/s1.log" 2>&1 ;;
    esac
    echo "$name exit $?" > "$r/exit.txt"
    kill "$copier" 2>/dev/null
    collect "$d" "$r"
}

for name in "$@"; do
    run_one "$name" > "$RES/$name.out" 2>&1 &
done
wait
cat "$RES"/*/exit.txt
