#!/usr/bin/env bash
# Time-series batch inference with the PyTorch port (the counterpart of
# Batch_infer.sh): flood masks for several scene roots from one warm model,
# on the card. A thin wrapper over inference/batch_infer.py.
set -euo pipefail

CKPT="${1:?usage: Batch_infer_torch.sh <checkpoint_dir> <scene_root>...}"
shift

python -m floodplanet_code_tpu_torch.inference.batch_infer "$CKPT" floodplanet --roots "$@" --split all
