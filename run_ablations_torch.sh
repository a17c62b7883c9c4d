#!/bin/bash
# n-sample ablation sweeps with the PyTorch/CUDA port: run_ablations.sh's
# sweeps over the _torch recipes beside this file.
#
#   MODE=train MODALITIES=ct ./run_ablations_torch.sh          # baselines
#   MODE=finetune PRETRAINED=... ./run_ablations_torch.sh      # limited-label CT
#   MODE=distill TEACHER=... ./run_ablations_torch.sh
#   MODE=dann ./run_ablations_torch.sh                         # add-n sweep
set -e
HERE=$(dirname "$0")

MODE=${MODE:-train}
NS=${NS:-"1 5 10 25 50 100"}
DATA_ROOT=${DATA_ROOT:-datasets/resampled}
EXPERIMENT_DIR=${EXPERIMENT_DIR:-experiments/ablations}

for N in $NS; do
  echo "=== $MODE ablation n=$N ==="
  case "$MODE" in
    train)
      N_SAMPLES=$N DATA_ROOT="$DATA_ROOT" \
        EXPERIMENT_DIR="$EXPERIMENT_DIR/${MODE}_n${N}" "$HERE/run_training_torch.sh" ;;
    finetune)
      N_SAMPLES=$N DATA_ROOT="$DATA_ROOT" PRETRAINED="$PRETRAINED" \
        EXPERIMENT_DIR="$EXPERIMENT_DIR/${MODE}_n${N}" "$HERE/run_finetune_ct_torch.sh" ;;
    distill)
      N_SAMPLES=$N DATA_ROOT="$DATA_ROOT" TEACHER="$TEACHER" \
        EXPERIMENT_DIR="$EXPERIMENT_DIR/${MODE}_n${N}" "$HERE/run_distillation_torch.sh" ;;
    dann)
      N_ADD=$N DATA_ROOT="$DATA_ROOT" \
        EXPERIMENT_DIR="$EXPERIMENT_DIR/${MODE}_add${N}" "$HERE/run_dann_torch.sh" ;;
    *) echo "unknown MODE=$MODE"; exit 1 ;;
  esac
done
