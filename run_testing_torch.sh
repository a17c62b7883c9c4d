#!/bin/bash
# Full-volume evaluation with the PyTorch/CUDA port (run_testing.sh's recipe);
# MODEL_PATH takes the port's .pth or a .msgpack of either package.
# The flags and variables are its JAX twin's; the entry is the port's
# orchestrator, on the GPU.
set -e
# NPROC_PER_NODE: processes (one per GPU; default: the visible GPUs)
source "$(dirname "$0")/scripts/torch_launch.sh"
MODEL_PATH=${MODEL_PATH:?set MODEL_PATH to a .msgpack checkpoint}
DATA_ROOT=${DATA_ROOT:-datasets/resampled}
EXPERIMENT_DIR=${EXPERIMENT_DIR:-experiments}
MODEL_NAME=${MODEL_NAME:-unet}
MODALITIES=${MODALITIES:-all}

python -m multimodal_segmentation_project_tpu_torch.workloads.main \
  --experiment eval \
  --model_path "$MODEL_PATH" \
  --data_root "$DATA_ROOT" \
  --experiment_dir "$EXPERIMENT_DIR" \
  --model_name "$MODEL_NAME" \
  --modalities "$MODALITIES" \
  --seed 42
