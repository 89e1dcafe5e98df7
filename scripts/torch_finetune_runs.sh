#!/bin/bash
# The PyTorch port's per-scene finetune chains on one NVIDIA GPU, no
# download (the procedural synthetic scene): the counterparts of
# tools/finetune_protocol_r5.sh (chain r5) and tools/finetune_hw_chain.sh
# (chain mid).  Each chain runs four stages:
#   A  the training demo's checkpoint: r5 at train_synthetic.R5_ARGS (300
#      steps, 4 stages 88^3 -> 704^3), reusing exp/torch_synth_protocol.ckpt.npz
#      when scripts/torch_train_runs.sh has made it; mid at
#      train_synthetic.MID_ARGS (150 steps, 3 stages 48^3 -> 192^3);
#   B  python -m surf_tpu_torch.main --mode finetune --resume <A> on the
#      shipped conf, uncut: r5 confs/surf_synthetic_finetune.conf (5000
#      steps, meshes at 512^3 at steps -1, 999, ..., 4999), mid
#      confs/surf_synthetic_finetune_mid.conf (1500 steps, meshes at 192^3
#      at steps -1, 499, 999, 1499); a checkpoint every 500 steps;
#   C  a 60-step --load_vol resume from B's last checkpoint, on a conf
#      derived from the shipped one by surf_tpu_torch.derive_conf (no
#      baseline validate, a validate at its end), in its own directory;
#   D  every mesh of B and of C cleaned and scored against the scene's
#      sphere (python -m surf_tpu_torch.evaluation.synthetic), then B's
#      [ft N] lines (loss, PSNR, the running mean s/it) at its validates.
# Usage, from anywhere: bash scripts/torch_finetune_runs.sh [out_dir] [r5|mid|both]
# (default exp/torch_finetune_runs, both).  Logs:
# <out_dir>/torch_finetune_{r5,mid}_r17.log, each headed by the card's name
# and power limit, with each stage's wall time; the experiments go to
# exp/torch_finetune_{r5,mid}/.  A missing checkpoint or a failed stage
# ends the script with a non-zero code.
set -eo pipefail
cd "$(dirname "$0")/.."
OUT=${1:-exp/torch_finetune_runs}
WHICH=${2:-both}
case "$WHICH" in
    r5 | mid | both) ;;
    *) echo "usage: $0 [out_dir] [r5|mid|both]" >&2; exit 2 ;;
esac
mkdir -p "$OUT" exp
CARD=$(nvidia-smi --query-gpu=name,power.limit --format=csv,noheader)
export PYTHONUNBUFFERED=1

# stage <name> <command...>: the command's output into the chain's log and
# into $EXP/<name>.log, then its wall time
stage() {
    local name=$1 t0 t1
    shift
    echo "=== stage $name: $* ===" | tee -a "$LOG"
    t0=$(date +%s.%N)
    "$@" 2>&1 | tee -a "$LOG" "$EXP/$name.log"
    t1=$(date +%s.%N)
    echo "=== stage $name: $(python3 -c "print(f'{$t1 - $t0:.1f}')") s wall ===" | tee -a "$LOG"
}

py_list() {
    python3 -c "from surf_tpu_torch import train_synthetic; print(*train_synthetic.$1)"
}

# chain <name> <conf> <mesh resolution> <A's checkpoint> <reuse A: 0|1> <A's arguments...>
chain() {
    local name=$1 conf=$2 res=$3 ckpt=$4 reuse=$5 last_step last
    shift 5
    LOG="$OUT/torch_finetune_${name}_r17.log"
    EXP="exp/torch_finetune_$name"
    rm -rf "$EXP"
    mkdir -p "$EXP"
    echo "card: $CARD" > "$LOG"
    if [ "$reuse" = 1 ] && [ -f "$ckpt" ]; then
        echo "=== stage A: the demo's checkpoint $ckpt, kept from an earlier run ===" | tee -a "$LOG"
    else
        rm -f "$ckpt"
        stage A python -m surf_tpu_torch.train_synthetic "$@" --save_ckpt "$ckpt" \
            --mesh_out "$EXP/A_mesh.ply"
    fi
    if [ ! -f "$ckpt" ]; then
        echo "no checkpoint $ckpt" | tee -a "$LOG"
        exit 1
    fi

    stage B python -m surf_tpu_torch.main --conf "$conf" --mode finetune --resume "$ckpt" \
        --mesh_resolution "$res" --out "$EXP/B"
    last_step=$(python3 -c "from surf_tpu_torch.config import parse_file
print(parse_file('$conf').get_int('train.epochs') - 1)")
    last=$(printf "%s/B/synthetic/view0/checkpoints/model_%03d.ckpt.npz" "$EXP" "$last_step")
    if [ ! -f "$last" ]; then
        echo "stage B left no checkpoint $last" | tee -a "$LOG"
        exit 1
    fi

    python -m surf_tpu_torch.derive_conf "$conf" "$EXP/C.conf" train.epochs=60 \
        train.val_before_finetune=false train.val_freq=60 train.save_freq=60 | tee -a "$LOG"
    stage C python -m surf_tpu_torch.main --conf "$EXP/C.conf" --mode finetune \
        --resume "$last" --load_vol --mesh_resolution "$res" --out "$EXP/C"

    stage D python -m surf_tpu_torch.evaluation.synthetic "$EXP/B/synthetic/view0" \
        --conf "$conf"
    stage D_resumed python -m surf_tpu_torch.evaluation.synthetic \
        "$EXP/C/synthetic/view0" --conf "$conf"
    echo "=== stage B's [ft N] lines at its validates ===" | tee -a "$LOG"
    python3 - "$EXP/B.log" "$conf" <<'EOF' 2>&1 | tee -a "$LOG"
import re
import sys
from surf_tpu_torch.config import parse_file
conf = parse_file(sys.argv[2])
n, val = conf.get_int("train.epochs"), conf.get_int("train.val_freq")
at = set(range(val - 1, n, val)) | {n - 1}
lines = [line.rstrip() for line in open(sys.argv[1])
         if re.match(r"\[ft (\d+)\]", line) and int(re.match(r"\[ft (\d+)\]", line)[1]) in at]
if len(lines) != len(at):
    sys.exit(f"B's log holds {len(lines)} [ft N] lines at the {len(at)} validate steps")
print("\n".join(lines))
EOF
}

if [ "$WHICH" != mid ]; then
    # shellcheck disable=SC2046
    chain r5 confs/surf_synthetic_finetune.conf 512 exp/torch_synth_protocol.ckpt.npz 1 \
        $(py_list R5_ARGS)
fi
if [ "$WHICH" != r5 ]; then
    # shellcheck disable=SC2046
    chain mid confs/surf_synthetic_finetune_mid.conf 192 exp/torch_synth_mid.ckpt.npz 0 \
        $(py_list MID_ARGS)
fi
