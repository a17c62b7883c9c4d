#!/bin/bash
# Baseline supervised training on one GPU or several, with the PyTorch/CUDA port
# (run_training.sh's recipe: batch 1, grad-accum 8, lr 1e-3, wd 1e-4,
# ce_tversky, bf16, 100 epochs).
# The flags and variables are its JAX twin's; the entry is the port's
# orchestrator, on the GPU.
set -e
# NPROC_PER_NODE: processes (one per GPU; default: the visible GPUs)
source "$(dirname "$0")/scripts/torch_launch.sh"

DATA_ROOT=${DATA_ROOT:-datasets/resampled}
EXPERIMENT_DIR=${EXPERIMENT_DIR:-experiments}
BATCH_SIZE=${BATCH_SIZE:-1}
EPOCHS=${EPOCHS:-100}
LR=${LR:-1e-3}
WEIGHT_DECAY=${WEIGHT_DECAY:-1e-4}
GRAD_ACCUM=${GRAD_ACCUM:-8}
MODALITIES=${MODALITIES:-mri}
LOSS=${LOSS:-ce_tversky}
N_SAMPLES=${N_SAMPLES:-}

EXTRA=()
[ -n "$N_SAMPLES" ] && EXTRA+=(--n_samples "$N_SAMPLES")

python -m multimodal_segmentation_project_tpu_torch.workloads.main \
  --experiment train \
  --data_root "$DATA_ROOT" \
  --experiment_dir "$EXPERIMENT_DIR" \
  --batch_size "$BATCH_SIZE" \
  --epochs "$EPOCHS" \
  --lr "$LR" \
  --weight_decay "$WEIGHT_DECAY" \
  --gradient_accumulation_steps "$GRAD_ACCUM" \
  --mixed_precision bf16 \
  --modalities "$MODALITIES" \
  --loss "$LOSS" \
  --early_stopping --patience 10 \
  --seed 42 \
  "${EXTRA[@]}"
