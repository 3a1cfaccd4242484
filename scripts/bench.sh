#!/usr/bin/env bash
# Run the full benchmark sweep and keep its raw output.
# The analog of the reference's scripts/bench.sh: run -> tee raw output.
# Each step runs in its own process, one after another, so only one process
# holds the device at a time.
#
# Usage: scripts/bench.sh [--quick]
set -euo pipefail
cd "$(dirname "$0")/.."

mkdir -p bench-results
python scripts/bench_sweep.py "$@" | tee bench-results/last_run.log
echo "raw results: bench-results/raw_*.json"
