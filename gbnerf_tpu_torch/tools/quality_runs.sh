#!/usr/bin/env bash
# The ablation's quality runs on one card, side by side (each run is
# host-bound and leaves the card idle most of a step). A RUN is a name,
# optionally with the arms to run now (r2:s1,nog,rand); by default its
# row's arms:
#   r1    round 5 (--production --colmap --lindisp --combine sds), scene
#         seed 0: s1, priorNL
#   r2    round 3 (--production, csd), scene seed 0: s1, nog, rand, prior
#   r3    round 3, scene seed 1: s1, nog, rand, prior
#   r4s0  r2 with --draws jax: s1      r4s1  r3 with --draws jax: s1
#   r5    r1 with --draws jax: s1, priorNL
#   prior, prior_jax  the --production spheres prior that the rows of
#         torch's draws (r1-r3), and of the JAX package's (r4, r5), share:
#         one prior serves every scene, and each row takes a copy with
#         --skip_prior; the first run to need it trains it (run_ablation's
#         prepare), the others wait for it
#   c3_plain  r5's s1 with K1-K5, K3 off (tools/plain_path.py)
# OUT/<run>/ is run_ablation's OUT: an arm whose ckpt/ exists counts as
# run, so a rerun (another call, with OUT carried) takes up what is left;
# an arm a time limit cut is deleted first. Each run's logs, metrics,
# eval maps and ablation.json go to RESULTS/<run>/, and under
# RESULTS/<run>/carry/ what a later call needs: s1's last checkpoint, the
# prior and the LoRA. Copy it back before the next call:
#   for c in RESULTS/*/carry; do r=$(basename "$(dirname "$c")")
#       mkdir -p OUT/$r && cp -r "$c"/. OUT/$r/; done
#
#   bash gbnerf_tpu_torch/tools/quality_runs.sh OUT RESULTS RUN [RUN ...]
# A rehearsal at small sizes: DEVICE=cpu, SIZES (flags added to every
# run_ablation command, e.g. "--iters1 2 --iters2 2 --H 24 --W 32
# --n_train 4 --n_test 2 --latent 64 --prior_steps 2 --lora_steps 2"),
# and PRIOR_EXTRA, flags for the shared prior's trainer (e.g.
# "--n_domain 4 --steps_vae 2 --batch 2").
set -u
OUT=$(realpath -m "$1"); RES=$2; shift 2
PY=${PYTHON:-python3}
DEV=${DEVICE:-cuda}
mkdir -p "$OUT" "$RES"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader \
    > "$RES/card.txt" 2>&1
ABL="$PY -m gbnerf_tpu_torch.tools.run_ablation --device $DEV ${SIZES:-}"
R5="--production --colmap --lindisp --combine sds"
R3="--production"

collect() {                  # what a run has so far, into RES/<run>/
    local d=$1 r=$2 m e
    cp "$d"/*.log "$d"/ablation.json "$r/" 2>/dev/null
    for m in "$d"/logs/*/metrics.jsonl; do
        [ -f "$m" ] && cp "$m" "$r/$(basename "$(dirname "$m")").metrics.jsonl"
    done
    for e in "$d"/logs/*/eval_images_*/rgb.npy; do
        [ -f "$e" ] && cp "$e" "$r/$(basename "$(dirname "$(dirname "$e")")").rgb.npy"
    done
}

carry() {                    # what a later call needs, into RES/<run>/carry/
    local d=$1 c=$2/carry f last    # (the rows' prior: the prior runs')
    mkdir -p "$c"
    if [ -d "$d/logs/s1/ckpt" ]; then
        last=$(ls "$d/logs/s1/ckpt" | sort -n | tail -1)
        mkdir -p "$c/logs/s1/ckpt"
        cp "$d/logs/s1/ckpt/$last" "$c/logs/s1/ckpt/"
        cp "$d/logs/s1/metrics.jsonl" "$c/logs/s1/" 2>/dev/null
    fi
    case $(basename "$d") in prior | prior_jax)
        for f in "$d"/prior.msgpack "$d"/prior.msgpack.meta.json; do
            [ -f "$f" ] && cp "$f" "$c/"
        done ;;
    esac
    [ -d "$d/lora" ] && mkdir -p "$c/lora" && cp "$d"/lora/*.safetensors* "$c/lora/" 2>/dev/null
}

drop_cut() {                 # an arm cut by a time limit: ckpt/ but no eval
    local e
    for e in "$1"/logs/*/; do
        [ -d "$e/ckpt" ] || continue
        grep -q '"eval_psnr"' "$e/metrics.jsonl" 2>/dev/null && continue
        echo "deleting $e: cut before its eval"
        rm -rf "$e"
    done
}

prior_dir() {                # the shared prior's dir for DRAWS
    if [ "$1" = jax ]; then echo "$OUT/prior_jax"; else echo "$OUT/prior"; fi
}

prepare() {                  # run_ablation's prepare: scene|prior OUT FLAGS
    $PY -c 'import sys
from gbnerf_tpu_torch.tools.run_ablation import prepare
prepare(sys.argv[1:])' "$@"
}

shared_prior() {             # shared_prior DRAWS: trained once, others wait
    local d p
    d=$(prior_dir "$1"); p=$d/prior.msgpack
    [ -f "$p.meta.json" ] && return 0
    mkdir -p "$d"
    if mkdir "$p.lock" 2>/dev/null; then
        prepare prior "$d" $R3 --draws "$1" --device "$DEV" ${SIZES:-} \
            -- ${PRIOR_EXTRA:-} || touch "$p.failed"
    fi
    until [ -f "$p.meta.json" ]; do
        [ -f "$p.failed" ] && return 1
        sleep 15
    done
}

row() {                      # row DIR "FLAGS" ARMS: run_ablation's arms,
    local d=$1 flags=$2 arms=$3 a rest="" guided="" pid= draws=torch p
    drop_cut "$d"             # the prior shared
    case $flags in *"--draws jax"*) draws=jax ;; esac
    p=$(prior_dir $draws)/prior.msgpack
    for a in ${arms//,/ }; do
        case $a in
        s1) ;;
        prior*) guided=$guided,$a ;;
        *) rest=$rest,$a ;;
        esac
    done
    $ABL "$d" $flags --arms s1 || return
    carry "$d" "$r"           # s1's checkpoint, whatever cuts the rest
    if [ -n "$rest" ]; then
        $ABL "$d" $flags --arms "s1$rest" &
        pid=$!
    fi
    if [ -n "$guided" ]; then
        shared_prior $draws && cp "$p" "$p.meta.json" "$d/" &&
            $ABL "$d" $flags --arms "s1$guided" --skip_prior
        a=$?
    else a=0; fi
    [ -n "$pid" ] && { wait "$pid" || a=1; }
    # the merged table of every arm this OUT holds
    [ $a = 0 ] && $ABL "$d" $flags --arms "s1$rest$guided" --skip_prior
}

run_one() {
    local name=${1%%:*} arms=${1#*:} d r
    [ "$arms" = "$1" ] && arms=
    d="$OUT/$name"; r="$RES/$name"
    mkdir -p "$d" "$r"
    # every minute, so that a run cut by a time limit leaves its finished
    # arms' results
    (while sleep 60; do collect "$d" "$r"; done) &
    local copier=$!
    case $name in
    prior) shared_prior torch ;;
    prior_jax) shared_prior jax ;;
    r1) row "$d" "$R5 --seed 0" "${arms:-s1,priorNL}" ;;
    r2) row "$d" "$R3 --seed 0" "${arms:-s1,nog,rand,prior}" ;;
    r3) row "$d" "$R3 --seed 1" "${arms:-s1,nog,rand,prior}" ;;
    r4s0) row "$d" "$R3 --seed 0 --draws jax" "${arms:-s1}" ;;
    r4s1) row "$d" "$R3 --seed 1 --draws jax" "${arms:-s1}" ;;
    r5) row "$d" "$R5 --seed 0 --draws jax" "${arms:-s1,priorNL}" ;;
    c3_plain)
        $ABL "$d" $R5 --arms s1 --draws jax --check &&
        prepare scene "$d" $R5 --draws jax --device "$DEV" ${SIZES:-} &&
        $PY -m gbnerf_tpu_torch.tools.plain_path --config "$d/cfg_s1.txt" \
            --device "$DEV" --draws jax > "$d/s1.log" 2>&1 ;;
    *) echo "unknown run $name"; false ;;
    esac
    echo "$name exit $?" > "$r/exit.txt"
    pkill -P "$copier" 2>/dev/null; kill "$copier" 2>/dev/null
    collect "$d" "$r"
    carry "$d" "$r"
}

for name in "$@"; do
    run_one "$name" > "$RES/${name%%:*}.out" 2>&1 &
done
wait
cat "$RES"/*/exit.txt
