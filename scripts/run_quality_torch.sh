#!/usr/bin/env bash
# The port's run of the reference README's zero-shot table (README.md:13-20),
# the counterpart of scripts/run_quality.sh: the dense, GRASP and GRASP* rows
# (compress -> recover -> lm-eval tasks + PPL) through grasp_tpu_torch on
# DEVICE (default cuda), given locally mounted weights and datasets. Nothing
# is fetched.
#
# Expected mount layout (relative to the repo root, overridable via env):
#   models/llama2-7b/            HF checkpoint dir (config.json + safetensors
#                                or pytorch_model*.bin; models/hf_io.py)
#   datasets/wikitext2/...       calibration + PPL corpus (data/loader.py)
#   datasets/alpaca.json         recovery data (alpaca-format JSON/JSONL, or
#                                a datasets.save_to_disk dir)
#   datasets/<task>/<split>/     one datasets.save_to_disk dir per eval task
#                                (boolq, piqa, hellaswag, winogrande,
#                                arc_easy, arc_challenge, openbookqa)
#
# Rows (paper config, reference scripts/params_script.sh:10-27):
#   dense   - evaluate the uncompressed model
#   GRASP   - compress (7 layers, ratio 0.9, taylor, 512x512 wikitext2
#             calibration), evaluate
#   GRASP*  - the same compressed model + alpaca recovery training, evaluate
# The compression runs ONCE: the GRASP* row resumes the finished compression
# from its crash-resume snapshot and proceeds straight to recovery.
#
# Smoke mode (no weights or data; tests/test_torch_run_quality.py runs it
# with DEVICE=cpu):
#   GRASP_QUALITY_TINY=1 DEVICE=cpu scripts/run_quality_torch.sh
# takes the random-init tiny preset, the synthetic corpus, a generated
# alpaca sample and tiny sample counts: every step of the real run executes,
# only the data is fake.
set -euo pipefail
cd "$(dirname "$0")/.."

if [ "${GRASP_QUALITY_TINY:-0}" = "1" ]; then
  MODEL=${MODEL:-tiny}
  DATASET=${DATASET:-synthetic}
  EVAL_PPL=${EVAL_PPL:-synthetic}
  EVAL_TASKS=${EVAL_TASKS:-}
  RECOVERY_DATA=${RECOVERY_DATA:-}
  NUM_PRUNE_LAYERS=${NUM_PRUNE_LAYERS:-1}
  NUM_SAMPLES=${NUM_SAMPLES:-4}
  SEQ_LEN=${SEQ_LEN:-32}
  BATCH_SIZE=${BATCH_SIZE:-2}
  DTYPE=${DTYPE:-float32}
  EPOCHS=${EPOCHS:-1}
  LIMIT=${LIMIT:-8}
else
  MODEL=${MODEL:-models/llama2-7b}
  DATASET=${DATASET:-wikitext2}
  EVAL_PPL=${EVAL_PPL:-wikitext2}
  EVAL_TASKS=${EVAL_TASKS:-boolq,piqa,hellaswag,winogrande,arc_easy,arc_challenge,openbookqa}
  RECOVERY_DATA=${RECOVERY_DATA:-datasets/alpaca.json}
  NUM_PRUNE_LAYERS=${NUM_PRUNE_LAYERS:-7}
  NUM_SAMPLES=${NUM_SAMPLES:-512}
  SEQ_LEN=${SEQ_LEN:-512}
  BATCH_SIZE=${BATCH_SIZE:-8}
  DTYPE=${DTYPE:-bfloat16}
  EPOCHS=${EPOCHS:-2}
  LIMIT=${LIMIT:--1}
fi
COMPRESSION_RATIO=${COMPRESSION_RATIO:-0.9}
DATA_ROOT=${DATA_ROOT:-.}
DEVICE=${DEVICE:-cuda}
OUT=${OUT:-quality_runs/$(date +%Y%m%d_%H%M%S)}
SWEEP=${SWEEP:-sequential}
mkdir -p "$OUT"
echo "== run_quality_torch: MODEL=$MODEL DEVICE=$DEVICE OUT=$OUT =="

eval_args=(--eval_ppl "$EVAL_PPL" --data_root "$DATA_ROOT" --limit "$LIMIT" --device "$DEVICE")
[ -n "$EVAL_TASKS" ] && eval_args+=(--eval_tasks "$EVAL_TASKS")

# ---- row 1: dense baseline --------------------------------------------
python -c "import sys; from grasp_tpu_torch.cli import evaluate_main; sys.exit(evaluate_main())" \
  --model_path "$MODEL" "${eval_args[@]}" \
  --log_file "$OUT/dense.log" --results_json "$OUT/dense.json"

# ---- row 2: GRASP (compress once, snapshot for row 3, evaluate) --------
compress_args=(
  --model_name_or_path "$MODEL" --dataset_name "$DATASET"
  --num_prune_layers "$NUM_PRUNE_LAYERS" --compression_ratio "$COMPRESSION_RATIO"
  --metric taylor --num_samples "$NUM_SAMPLES" --seq_len "$SEQ_LEN"
  --batch_size "$BATCH_SIZE" --dtype "$DTYPE" --sweep "$SWEEP" --remat
  --data_root "$DATA_ROOT" --compress_resume_dir "$OUT/compress_resume"
  --num_fewshot 0 --limit "$LIMIT" --device "$DEVICE"
)
grasp_eval=(--evaluate --eval_ppl "$EVAL_PPL")
[ -n "$EVAL_TASKS" ] && grasp_eval+=(--eval_tasks "$EVAL_TASKS")

python -m grasp_tpu_torch.cli "${compress_args[@]}" "${grasp_eval[@]}" \
  --save_path "$OUT/grasp_ckpt" \
  --log_file "$OUT/grasp.log" --results_json "$OUT/grasp.json"

# ---- row 3: GRASP* (resume the finished compression, recover, evaluate) -
recover_args=(--recovery --num_epochs "$EPOCHS")
[ -n "$RECOVERY_DATA" ] && recover_args+=(--data_path "$RECOVERY_DATA")
if [ "${GRASP_QUALITY_TINY:-0}" = "1" ]; then
  recover_args+=(--val_set_size 2 --micro_batch_size 2 --train_batch_size 4
                 --max_length 32)
fi

python -m grasp_tpu_torch.cli "${compress_args[@]}" "${grasp_eval[@]}" \
  "${recover_args[@]}" \
  --save_path "$OUT/grasp_star_ckpt" \
  --log_file "$OUT/grasp_star.log" --results_json "$OUT/grasp_star.json"

# ---- assemble the table --------------------------------------------------
python - "$OUT" <<'EOF'
import json, os, sys
out = sys.argv[1]
rows = {}
for row in ("dense", "grasp", "grasp_star"):
    p = os.path.join(out, row + ".json")
    rows[row] = json.load(open(p)) if os.path.exists(p) else None
with open(os.path.join(out, "table.json"), "w") as f:
    json.dump(rows, f, indent=1)
print(json.dumps(rows, indent=1))
EOF
echo "== run_quality_torch: wrote $OUT/table.json =="
