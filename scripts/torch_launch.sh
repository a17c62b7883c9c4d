# Sourced by the run_*_torch.sh recipes: how many processes their
# `python -m <CLI>` line starts. NPROC_PER_NODE, by default one per visible
# GPU (the devices in CUDA_VISIBLE_DEVICES where it is set, else
# nvidia-smi's list; 1 where there is none), as the JAX recipes use every
# local chip. Above 1, `python` is this function: the same line under
# torchrun, one rank per GPU over NCCL. At 1 it is the interpreter.
if [ -z "${NPROC_PER_NODE:-}" ]; then
  if [ "${CUDA_VISIBLE_DEVICES+set}" = set ]; then
    NPROC_PER_NODE=$(echo "$CUDA_VISIBLE_DEVICES" | tr ',' '\n' | grep -c . || true)
  else
    NPROC_PER_NODE=$(nvidia-smi -L 2>/dev/null | grep -c '^GPU' || true)
  fi
fi
[ "${NPROC_PER_NODE:-0}" -ge 1 ] 2>/dev/null || NPROC_PER_NODE=1
if [ "$NPROC_PER_NODE" -gt 1 ]; then
  python() { torchrun --standalone --nproc_per_node "$NPROC_PER_NODE" "$@"; }
fi
