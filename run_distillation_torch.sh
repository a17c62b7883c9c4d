#!/bin/bash
# Knowledge distillation with the PyTorch/CUDA port (run_distillation.sh's
# recipe: alpha 0.7, T 2.0, n-sample ablation).
# The flags and variables are its JAX twin's; the entry is the port's
# orchestrator, on the GPU.
set -e
# NPROC_PER_NODE: processes (one per GPU; default: the visible GPUs)
source "$(dirname "$0")/scripts/torch_launch.sh"
TEACHER=${TEACHER:?set TEACHER to the teacher .msgpack checkpoint}
DATA_ROOT=${DATA_ROOT:-datasets/resampled}
EXPERIMENT_DIR=${EXPERIMENT_DIR:-experiments/distill}
N_SAMPLES=${N_SAMPLES:-5}
EPOCHS=${EPOCHS:-100}

python -m multimodal_segmentation_project_tpu_torch.workloads.main \
  --experiment distill \
  --teacher_model "$TEACHER" \
  --data_root "$DATA_ROOT" \
  --experiment_dir "$EXPERIMENT_DIR" \
  --batch_size 1 \
  --epochs "$EPOCHS" \
  --lr 1e-3 \
  --weight_decay 1e-4 \
  --gradient_accumulation_steps 8 \
  --mixed_precision bf16 \
  --modalities ct \
  --alpha 0.7 --temperature 2.0 \
  --n_samples "$N_SAMPLES" \
  --early_stopping --patience 10 \
  --seed 42
