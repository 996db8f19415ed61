#!/bin/bash
# MAE-vs-JEPA representation-ranking study on the TEXTURE synthetic dataset,
# through the PyTorch port's CLIs on the card (SSRL_TORCH_DEVICE=cpu asks
# them for the CPU). The protocol of tools/rank_study.sh: matched
# pretraining budgets (20 epochs at batch 2000 on 30k unlabeled images),
# then frozen-feature evals with floor/ceiling baselines:
#   raw pixels + random init (floor -- near chance on texture data),
#   MAE / JEPA pretrained encoders (the ranking under test).
# After the cls-pool k-NN it runs the ridge probe (lambda 1000 on pixels,
# 10 on the encoders) and the mean-pool k-NN, each CLI call one eval, then
# the weak frozen probes. It stops at the first stage that exits non-zero.
# SSRL_RANK_SCALE=cpu takes the sizes of tools/rank_study_cpu.sh (batch
# 200, 8 epochs on 8k images; tools/torch_rank_study_cpu.sh sets it).
# SSRL_RANK_SEED=N adds `seed: N` to the config (the pretrainings' init,
# split and shuffle, and the probes'); SSRL_TORCH_ATTN_IMPL=xla trains
# every stage as plain PyTorch (scripts/utils.py::attn_impl).
# Results + logs land in $SSRL_RANK_OUT (default outputs/torch_rank_study),
# which must not hold a study.log yet: the log and each metrics.jsonl are
# appended to, so a second run would mix into the first. Summarize with
# python3 tools/torch_summarize_rank_study.py <that dir>.
set -euo pipefail
cd "$(dirname "$0")/.."
SCALE=${SSRL_RANK_SCALE:-card}
case "$SCALE" in
  card) OUT=${SSRL_RANK_OUT:-outputs/torch_rank_study}
        EPOCHS=${SSRL_RANK_EPOCHS:-20}; UNLAB=${SSRL_RANK_UNLABELED:-30000}
        BATCH=2000; WARMUP=2; VAL_SPLIT=0.06; PROBE_BATCH=1000; TEST_BATCH=2000
        EVAL_ARGS=(--samples_per_class 400) ;;
  cpu)  OUT=${SSRL_RANK_OUT:-outputs/torch_rank_study_cpu}
        EPOCHS=${SSRL_RANK_EPOCHS:-8}; UNLAB=${SSRL_RANK_UNLABELED:-8000}
        BATCH=200; WARMUP=1; VAL_SPLIT=0.05; PROBE_BATCH=200; TEST_BATCH=500
        EVAL_ARGS=(--samples_per_class 200 --batch_size 200) ;;
  *) echo "SSRL_RANK_SCALE=$SCALE: expected card or cpu" >&2; exit 2 ;;
esac
DATA=${SSRL_RANK_DATA:-$OUT/data}
LOG="$OUT/study.log"
CFG="$OUT/study_cfg.yaml"
if [ -e "$LOG" ]; then
  echo "$LOG exists: give SSRL_RANK_OUT a directory of its own" >&2
  exit 2
fi
mkdir -p "$OUT"
# the CPU copy's evals read the study config (its test batch), as the JAX one's do
if [ "$SCALE" = cpu ]; then EVAL_ARGS=(--config "$CFG" "${EVAL_ARGS[@]}"); fi
trap 'echo "=== stage failed (exit $?) $(date -u) ===" | tee -a "$LOG" >&2' ERR

if [ ! -f "$DATA/stl10_binary/unlabeled_X.bin" ]; then
  echo "=== generating texture dataset ($UNLAB unlabeled) $(date -u) ===" >> "$LOG"
  python -m ssrl_vit_mae_jepa_torch.scripts.data \
    --synthetic --signal texture --data_dir "$DATA" \
    --synthetic_train 5000 --synthetic_test 2000 \
    --synthetic_unlabeled "$UNLAB" >> "$LOG" 2>&1
fi

cat > "$CFG" <<EOF
pretrain:
  mask_ratio_start: 0.75
  mask_ratio_end: 0.75
  mask_ramp_epochs: 5
  total_epochs: $EPOCHS
  warmup_epochs: $WARMUP
  batch_size: $BATCH
  base_learning_rate: 0.00015
  data_fraction: 1.0
  val_split: $VAL_SPLIT
jepa:
  total_epochs: $EPOCHS
  warmup_epochs: $WARMUP
  batch_size: $BATCH
  base_learning_rate: 0.00015
train:
  samples_per_class: 40
  total_epochs: 10
  warmup_epochs: 1
  batch_size: $PROBE_BATCH
  learning_rate: 0.001
  freeze_encoder: true
test: {batch_size: $TEST_BATCH}
logging: {output_dir_base: $OUT/outputs}
EOF
if [ -n "${SSRL_RANK_SEED:-}" ]; then echo "seed: $SSRL_RANK_SEED" >> "$CFG"; fi

export SSRL_DATA_DIR="$DATA"
echo "=== pretrain MAE ($EPOCHS ep, batch $BATCH) $(date -u) ===" >> "$LOG"
timeout 14400 python -m ssrl_vit_mae_jepa_torch.scripts.training.pretrain_mae \
  --config "$CFG" --output_dir_suffix rank_mae >> "$LOG" 2>&1
echo "=== pretrain JEPA ($EPOCHS ep, batch $BATCH) $(date -u) ===" >> "$LOG"
timeout 14400 python -m ssrl_vit_mae_jepa_torch.scripts.training.pretrain_jepa \
  --config "$CFG" --output_dir_suffix rank_jepa >> "$LOG" 2>&1

MAE_CKPT="$OUT/outputs/pretrain/rank_mae/checkpoints/best.ckpt"
JEPA_CKPT="$OUT/outputs/pretrain/rank_jepa/checkpoints/best.ckpt"

for row in "pixels:pixels" "random:random" "mae:$MAE_CKPT" "jepa:$JEPA_CKPT"; do
  name="${row%%:*}"; ckpt="${row#*:}"
  echo "=== kNN $name $(date -u) ===" >> "$LOG"
  timeout 3600 python -m ssrl_vit_mae_jepa_torch.scripts.evaluation.knn_eval \
    --checkpoint "$ckpt" --data_dir "$DATA" "${EVAL_ARGS[@]}" >> "$LOG" 2>&1
done

# closed-form ridge probes (the JAX study's round-5 settings)
for row in "pixels:pixels:1000" "random:random:10" "mae:$MAE_CKPT:10" \
           "jepa:$JEPA_CKPT:10"; do
  name="${row%%:*}"; rest="${row#*:}"; ckpt="${rest%:*}"; lam="${rest##*:}"
  echo "=== ridge $name $(date -u) ===" >> "$LOG"
  timeout 3600 python -m ssrl_vit_mae_jepa_torch.scripts.evaluation.knn_eval \
    --checkpoint "$ckpt" --data_dir "$DATA" "${EVAL_ARGS[@]}" \
    --eval ridge --ridge_lam "$lam" >> "$LOG" 2>&1
done

# mean-pool k-NN for the three encoders
for row in "random:random" "mae:$MAE_CKPT" "jepa:$JEPA_CKPT"; do
  name="${row%%:*}"; ckpt="${row#*:}"
  echo "=== kNN-mean $name $(date -u) ===" >> "$LOG"
  timeout 3600 python -m ssrl_vit_mae_jepa_torch.scripts.evaluation.knn_eval \
    --checkpoint "$ckpt" --data_dir "$DATA" "${EVAL_ARGS[@]}" \
    --pool mean >> "$LOG" 2>&1
done

# weak frozen probes (10 epochs, 40 labels/class) for random/MAE/JEPA
echo "=== probe random $(date -u) ===" >> "$LOG"
timeout 7200 python -m ssrl_vit_mae_jepa_torch.scripts.training.train_mae \
  --config "$CFG" --output_dir_suffix rank_probe_random >> "$LOG" 2>&1
for row in "mae:$MAE_CKPT" "jepa:$JEPA_CKPT"; do
  name="${row%%:*}"; ckpt="${row#*:}"
  echo "=== probe $name $(date -u) ===" >> "$LOG"
  timeout 7200 python -m ssrl_vit_mae_jepa_torch.scripts.training.train_mae \
    --config "$CFG" --encoder_ckpt "$ckpt" \
    --output_dir_suffix "rank_probe_$name" >> "$LOG" 2>&1
done
echo "=== rank study done ($SCALE scale) $(date -u) ===" >> "$LOG"
