#!/usr/bin/env bash
# Two-stage ActivityNet-Captions training with the PyTorch port (I3D by
# default; set CONFIG for C3D). Runs on the GPU; DEVICE=cpu runs it on the
# CPU.
set -euo pipefail

FEATURES=${FEATURES:?feature dir/.h5}
ANNOTATIONS=${ANNOTATIONS:?"ActivityNet-Captions JSON path template ({split})"}
CONFIG=${CONFIG:-activitynet_i3d}   # or activitynet_c3d
CKPT=${CKPT:-/tmp/drn_tpu_torch_ckpt}

common=(--config "$CONFIG" --feature-dir "$FEATURES"
        --annotation-path "$ANNOTATIONS" --checkpoint-dir "$CKPT")

python -m drn_tpu_torch.train "${common[@]}" --stage 1 \
    ${DEVICE:+--device "$DEVICE"}
python -m drn_tpu_torch.train "${common[@]}" --stage 2 \
    --init-from "$CKPT/$CONFIG/stage1" ${DEVICE:+--device "$DEVICE"}
python -m drn_tpu_torch.evaluate --config "$CONFIG" \
    --feature-dir "$FEATURES" --annotation-path "$ANNOTATIONS" \
    --checkpoint-dir "$CKPT/$CONFIG/stage2" ${DEVICE:+--device "$DEVICE"}
