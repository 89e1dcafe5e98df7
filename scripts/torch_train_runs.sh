#!/bin/bash
# The PyTorch port's full-length training runs on one NVIDIA GPU, no
# download (the procedural synthetic scene):
#   (a) the training demo at tools/run_protocol_r5.sh's arguments, 300
#       steps (4 stages 88^3 -> 704^3, 5 views of 480x640, 512 rays, bf16
#       matching volume, warmup-cosine), evaluated every 100 steps at 256^3,
#       with its per-step JSONL log and its summary;
#   (b) python -m surf_tpu_torch.main on confs/surf_synthetic_full.conf with
#       no --mode (it trains: 16 epochs of 2 scenes x 8 views, a validate
#       every 4 epochs), then every epoch's train_avg/* and val_img_avg/*
#       read back from its TensorBoard event file.
# Usage, from anywhere: bash scripts/torch_train_runs.sh [out_dir]
# (default exp/torch_train_runs).  Each log starts with the card's name
# and power limit.
set -eo pipefail
cd "$(dirname "$0")/.."
OUT=${1:-exp/torch_train_runs}
mkdir -p "$OUT" exp
CARD=$(nvidia-smi --query-gpu=name,power.limit --format=csv,noheader)
export PYTHONUNBUFFERED=1

LOG_A="$OUT/torch_train_protocol_r16.log"
JSONL_A="$OUT/torch_train_protocol_r16.jsonl"
CKPT_A=exp/torch_synth_protocol.ckpt.npz
rm -f "$JSONL_A" "$CKPT_A"
echo "card: $CARD" > "$LOG_A"
R5_ARGS=$(python -c "from surf_tpu_torch.train_synthetic import R5_ARGS; print(*R5_ARGS)")
python -m surf_tpu_torch.train_synthetic $R5_ARGS --save_ckpt "$CKPT_A" \
    --log_jsonl "$JSONL_A" --mesh_out "$OUT/torch_train_protocol_r16_mesh.ply" \
    2>&1 | tee -a "$LOG_A"
echo "=== summarize_run ===" | tee -a "$LOG_A"
python -m surf_tpu_torch.summarize_run "$JSONL_A" 2>&1 | tee -a "$LOG_A"

LOG_B="$OUT/torch_main_train_r16.log"
EXP_B=exp/torch_main_train_r16
rm -rf "$EXP_B"
echo "card: $CARD" > "$LOG_B"
python -m surf_tpu_torch.main --conf confs/surf_synthetic_full.conf --out "$EXP_B" \
    2>&1 | tee -a "$LOG_B"
echo "=== event file: train_avg/* and val_img_avg/* by epoch ===" | tee -a "$LOG_B"
python3 scripts/tb_scalars.py "$EXP_B/logs" 2>&1 | tee -a "$LOG_B"
