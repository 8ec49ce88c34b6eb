#!/usr/bin/env bash
# Full (nightly) test suite on the CPU: every test including slow-marked
# sampler pipeline / parity / multi-process tests, with a log.
#
#   bash scripts/run_full_suite.sh [extra pytest args]
#
# Writes test_logs/full_suite_$(date +%Y%m%d).log (not tracked)
set -uo pipefail
cd "$(dirname "$0")/.."
mkdir -p test_logs
LOG="test_logs/full_suite_$(date +%Y%m%d).log"
{
  echo "== full suite: $(date -u +%Y-%m-%dT%H:%M:%SZ) =="
  echo "== git: $(git rev-parse --short HEAD) =="
  JAX_PLATFORMS=cpu python -m pytest tests/ -q -m "" --durations=20 "$@" 2>&1
  echo "== exit: $? =="
} | tee "$LOG"
