#!/usr/bin/env bash
# Offline end-to-end smoke of the PyTorch port: two-stage training + eval
# on the synthetic fixture, no dataset downloads. Runs on the GPU; set
# DEVICE=cpu to run it on the CPU (the port's CLIs default to cuda).
set -euo pipefail
CKPT=$(mktemp -d)

python -m drn_tpu_torch.train --config synthetic_tiny --stage 1 --max-steps 10 \
    --checkpoint-dir "$CKPT" ${DEVICE:+--device "$DEVICE"}
python -m drn_tpu_torch.train --config synthetic_tiny --stage 2 --max-steps 5 \
    --checkpoint-dir "$CKPT" --init-from "$CKPT/synthetic_tiny/stage1" \
    ${DEVICE:+--device "$DEVICE"}
python -m drn_tpu_torch.evaluate --config synthetic_tiny \
    --checkpoint-dir "$CKPT/synthetic_tiny/stage2" ${DEVICE:+--device "$DEVICE"}
echo "smoke ok"
