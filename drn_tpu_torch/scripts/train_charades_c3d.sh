#!/usr/bin/env bash
# Two-stage Charades-STA (C3D) training with the PyTorch port: the
# reference's canonical recipe (SURVEY.md §4.1/§4.2). Point the env vars at
# the dataset release. Runs on the GPU; DEVICE=cpu runs it on the CPU.
set -euo pipefail

FEATURES=${FEATURES:?dir of per-video .npy or a single .h5 of C3D features}
ANNOTATIONS=${ANNOTATIONS:?"charades_sta_{split}.txt path template"}
GLOVE=${GLOVE:-}            # optional glove.840B.300d.txt; hashed fallback if unset
CKPT=${CKPT:-/tmp/drn_tpu_torch_ckpt}

common=(--config charades_c3d
        --feature-dir "$FEATURES"
        --annotation-path "$ANNOTATIONS"
        --checkpoint-dir "$CKPT")
[[ -n "$GLOVE" ]] && common+=(--glove-path "$GLOVE")

# Stage 1: matching + boundary regression.
python -m drn_tpu_torch.train "${common[@]}" --stage 1 \
    ${DEVICE:+--device "$DEVICE"}

# Stage 2: IoU-rescoring head, initialized from stage 1.
python -m drn_tpu_torch.train "${common[@]}" --stage 2 \
    --init-from "$CKPT/charades_c3d/stage1" ${DEVICE:+--device "$DEVICE"}

# Final eval on the test split (with the run's GloVe file, which fixes the
# embedding's shape).
python -m drn_tpu_torch.evaluate --config charades_c3d \
    --feature-dir "$FEATURES" --annotation-path "$ANNOTATIONS" \
    ${GLOVE:+--glove-path "$GLOVE"} \
    --checkpoint-dir "$CKPT/charades_c3d/stage2" ${DEVICE:+--device "$DEVICE"}
