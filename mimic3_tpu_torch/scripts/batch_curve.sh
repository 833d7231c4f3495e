#!/bin/sh
# Batch-shape curve of the port: sequential bench runs at several batch
# sizes on one card, each in a fresh process (the port's counterpart of
# scripts/batch_curve.sh).
#
#   sh mimic3_tpu_torch/scripts/batch_curve.sh [OUT]
#
# Appends each run's output (its result line last) to OUT, by default
# build/batch_curve.jsonl in the checkout; stderr goes beside it.
set -u
cd "$(dirname "$0")/../.."
OUT=${1:-build/batch_curve.jsonl}
mkdir -p "$(dirname "$OUT")"
: > "$OUT"
for B in 32 8; do
    echo "=== batch=$B start $(date -u +%H:%M:%S) ===" >> "$OUT"
    timeout 2400 python -u -m mimic3_tpu_torch.scripts.bench --batch "$B" \
        --iters 10 --watchdog-sec 2100 >> "$OUT" 2>"${OUT%.jsonl}_b$B.err"
    echo "=== batch=$B exit=$? $(date -u +%H:%M:%S) ===" >> "$OUT"
done
echo "=== sweep done $(date -u +%H:%M:%S) ===" >> "$OUT"
