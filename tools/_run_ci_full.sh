#!/bin/bash
# Full 1944-case CI matrix via the oracle-sharing resumable runner
# (tools/ci_full_runner.py): one long-double oracle pass scores all nine
# modes per operand set.  Runs on JAX's default backend (the GPU where
# there is one).  Logs: .ci_logs/ci_full_{real,complex}_runner.log
cd "$(dirname "$0")/.." || exit 1
mkdir -p .ci_logs
nice -n 10 python tools/ci_full_runner.py real .ci_logs/ci_full_real_runner.log
nice -n 10 python tools/ci_full_runner.py complex .ci_logs/ci_full_complex_runner.log
