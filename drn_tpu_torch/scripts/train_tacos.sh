#!/usr/bin/env bash
# Two-stage TACoS training with the PyTorch port (fine-grained moments,
# 512-clip grid). Runs on the GPU; DEVICE=cpu runs it on the CPU.
set -euo pipefail

FEATURES=${FEATURES:?feature dir/.h5}
ANNOTATIONS=${ANNOTATIONS:?"TACoS JSON path template ({split})"}
CKPT=${CKPT:-/tmp/drn_tpu_torch_ckpt}

common=(--config tacos_c3d --feature-dir "$FEATURES"
        --annotation-path "$ANNOTATIONS" --checkpoint-dir "$CKPT")

python -m drn_tpu_torch.train "${common[@]}" --stage 1 \
    ${DEVICE:+--device "$DEVICE"}
python -m drn_tpu_torch.train "${common[@]}" --stage 2 \
    --init-from "$CKPT/tacos_c3d/stage1" ${DEVICE:+--device "$DEVICE"}
python -m drn_tpu_torch.evaluate --config tacos_c3d \
    --feature-dir "$FEATURES" --annotation-path "$ANNOTATIONS" \
    --checkpoint-dir "$CKPT/tacos_c3d/stage2" ${DEVICE:+--device "$DEVICE"}
