#!/usr/bin/env bash
# CI entry of the PyTorch/CUDA port (the counterpart of scripts/ci.sh): the
# port's tests on the CPU, the native ingest's ThreadSanitizer check, and
# the bench harness at --quick where a card is present. Every step is
# fatal: with a card, a failed bench fails the script.
set -euo pipefail
cd "$(dirname "$0")/.."

echo "=== port tests (CPU) ==="
JAX_PLATFORMS=cpu python -m pytest tests/test_torch_*.py -q

echo "=== native ingest TSAN ==="
python -m eagleeverything_tpu_torch.io.native.tsan_check

if python -c 'import sys, torch; sys.exit(0 if torch.cuda.is_available() else 1)'; then
    echo "=== bench smoke (the card) ==="
    python bench_cuda.py --quick
else
    echo "=== bench smoke skipped: no CUDA device ==="
fi

echo "CI OK"
