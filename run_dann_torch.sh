#!/bin/bash
# DANN domain-adversarial adaptation MRI -> CT with the PyTorch/CUDA port
# (run_dann.sh's recipe: lambda 0.2, add-n / ns ablations).
# The flags and variables are its JAX twin's; the entry is the port's
# orchestrator, on the GPU.
set -e
# NPROC_PER_NODE: processes (one per GPU; default: the visible GPUs)
source "$(dirname "$0")/scripts/torch_launch.sh"
DATA_ROOT=${DATA_ROOT:-datasets/resampled_dann}
EXPERIMENT_DIR=${EXPERIMENT_DIR:-experiments/dann}
LAMBDA=${LAMBDA:-0.2}
N_ADD=${N_ADD:-}
N_SAMPLES=${N_SAMPLES:-}
PRETRAINED=${PRETRAINED:-}
EPOCHS=${EPOCHS:-100}

EXTRA=()
[ -n "$N_ADD" ] && EXTRA+=(--n_add_source "$N_ADD")
[ -n "$N_SAMPLES" ] && EXTRA+=(--n_samples "$N_SAMPLES")
[ -n "$PRETRAINED" ] && EXTRA+=(--pretrained_model "$PRETRAINED")

python -m multimodal_segmentation_project_tpu_torch.workloads.main \
  --experiment dann \
  --source_modality mri \
  --target_modality ct \
  --data_root "$DATA_ROOT" \
  --experiment_dir "$EXPERIMENT_DIR" \
  --batch_size 1 \
  --epochs "$EPOCHS" \
  --lr 1e-3 \
  --weight_decay 1e-4 \
  --lambda_domain "$LAMBDA" \
  --gradient_accumulation_steps 8 \
  --mixed_precision bf16 \
  --loss ce_tversky \
  --early_stopping --patience 10 \
  --seed 42 \
  "${EXTRA[@]}"
