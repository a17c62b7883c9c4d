#!/bin/bash
# Fine-tune a pretrained model on limited CT labels with the PyTorch/CUDA
# port (run_finetune_ct.sh's recipe: lr 1e-4, n-sample ablation).
# The flags and variables are its JAX twin's; the entry is the port's
# orchestrator, on the GPU.
set -e
# NPROC_PER_NODE: processes (one per GPU; default: the visible GPUs)
source "$(dirname "$0")/scripts/torch_launch.sh"
PRETRAINED=${PRETRAINED:?set PRETRAINED to the pretrained .msgpack checkpoint}
DATA_ROOT=${DATA_ROOT:-datasets/resampled}
EXPERIMENT_DIR=${EXPERIMENT_DIR:-experiments/finetune}
N_SAMPLES=${N_SAMPLES:-5}
EPOCHS=${EPOCHS:-50}
LR=${LR:-1e-4}

python -m multimodal_segmentation_project_tpu_torch.workloads.main \
  --experiment finetune \
  --pretrained_model "$PRETRAINED" \
  --data_root "$DATA_ROOT" \
  --experiment_dir "$EXPERIMENT_DIR" \
  --batch_size 1 \
  --epochs "$EPOCHS" \
  --lr "$LR" \
  --weight_decay 1e-4 \
  --gradient_accumulation_steps 8 \
  --mixed_precision bf16 \
  --modalities ct \
  --n_samples "$N_SAMPLES" \
  --early_stopping --patience 10 \
  --seed 42
