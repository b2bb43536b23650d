#!/bin/bash
# The flagship reproduction through the PyTorch + CUDA port
# (unetseg_tpu_torch), step for step the JAX package's
# tools/reproduce_flagship.sh:
#   1. stage a writable dataset root from REF (a copy, idempotent)
#   2. preprocess seq-02 weight maps (reference mode; seq-01's ship with
#      the dataset)
#   3. train 3 flagship members on the card (the recipe: 80-epoch cosine
#      + EMA), after writing the card's name and power limit to
#      $EVAL/device.txt
#   4. pipeline-eval the vote x vote + bidi ensemble (the recipe's infer
#      section carries the flagship settings)
#   5. publish the row: tools/collect_results_torch.py --ship flagship
#      into $LATEST, which `python -m unetseg_tpu_torch bench` reads
#
# Idempotent: every step keys on a .done / summary.json marker, so the
# script can be fired again after a failure and goes on where it stopped.
# Every step runs under timeout, and any failed step (no card included)
# exits non-zero: nothing falls back to the CPU.
#
#   REF=/path/to/DIC-C2DH-HeLa bash tools/reproduce_flagship_torch.sh
#
# Environment: REF (the dataset, read only), DATA (its writable copy), RUN
# (the members' checkpoints), EVAL (logs, summaries, device.txt), CONFIG
# (the recipe) and LATEST (the record written at step 5); relative paths
# are taken from the repository root.
set -u
cd "$(dirname "$0")/.."
REF=${REF:-data/raw/train/DIC-C2DH-HeLa}
DATA=${DATA:-flagship_torch/data/DIC-C2DH-HeLa}
RUN=${RUN:-flagship_torch/run}
EVAL=${EVAL:-flagship_torch/eval}
CONFIG=${CONFIG:-configs/best_recipe.json}
LATEST=${LATEST:-docs/results_torch_latest.json}
mkdir -p "$RUN" "$EVAL"
log() { echo "[reproduce $(date +%H:%M:%S)] $*"; }

# ---- 1. writable dataset root ----
if [ ! -d "$DATA" ]; then
  log "staging dataset from $REF"
  [ -d "$REF" ] || { log "no dataset at REF=$REF"; exit 1; }
  mkdir -p "$(dirname "$DATA")"
  cp -r "$REF" "$DATA"
  chmod -R u+w "$DATA"
fi

# ---- 2. seq-02 weight maps (reference mode: scipy on the host) ----
if [ ! -f "$DATA/02_ST/WEIGHT_MAPS/.done" ]; then
  log "preprocess seq-02 weight maps"
  timeout 3600 python -m unetseg_tpu_torch preprocess \
    --data-root "$DATA" --sequence 02 \
    && touch "$DATA/02_ST/WEIGHT_MAPS/.done" \
    || { log "preprocess FAILED rc=$?"; exit 1; }
fi

# ---- 3. three flagship members, on the card ----
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader > "$EVAL/device.txt" \
  || { log "no card: nvidia-smi FAILED rc=$?"; exit 1; }
log "card: $(head -n 1 "$EVAL/device.txt")"
for s in 0 1 2; do
  [ -f "$RUN/f$s/.done" ] && continue
  log "train member f$s (seed $s, recipe epochs)"
  timeout 3600 python -m unetseg_tpu_torch train --config "$CONFIG" \
    --data-root "$DATA" --sequences 01 02 --seed $s \
    --checkpoint-dir "$RUN/f$s" --metrics-jsonl "$EVAL/train_f$s.jsonl" \
    > "$EVAL/train_f$s.log" 2>&1 \
    && touch "$RUN/f$s/.done" || { log "train f$s FAILED rc=$?"; exit 1; }
done

# ---- 4. flagship eval row ----
ENS="$RUN/f0,$RUN/f1,$RUN/f2"
if [ ! -f "$EVAL/flagship/summary.json" ]; then
  log "pipeline eval (vote x vote + bidi from the recipe)"
  mkdir -p "$EVAL/flagship"
  timeout 2400 python -m unetseg_tpu_torch pipeline --config "$CONFIG" \
    --data-root "$DATA" --sequences 01 02 --skip-preprocess --skip-train \
    --checkpoint-dir "$ENS" --output-dir "$EVAL/flagship" \
    > "$EVAL/flagship/log.txt" 2>&1 || { log "eval FAILED rc=$?"; exit 1; }
fi
cat "$EVAL/flagship/summary.json"; echo

# ---- 5. publish ----
log "publishing flagship row -> $LATEST"
python tools/collect_results_torch.py "$EVAL" --latest "$LATEST" \
  --ship flagship --run-dirs "$ENS" --config "$CONFIG" \
  || { log "publish FAILED rc=$?"; exit 1; }
log "done; see $LATEST"
