#!/usr/bin/env bash
# CI for the PyTorch port, mrs_optic_flow_tpu_torch: build the native
# runtime, run the port's CPU lane (tests/test_torch_*.py, the node
# executable's flights through the stand-in ROS included) and the CLI's
# flight gate on the CPU.  With --card it also runs chip_smoke.py, which
# needs one CUDA card: without one it fails, it never skips.
#
#   scripts/ci_torch.sh           # CPU lane
#   scripts/ci_torch.sh --card    # CPU lane, then chip_smoke.py on the card
set -euo pipefail
cd "$(dirname "$0")/.."

card=0
for arg in "$@"; do
  case "$arg" in
    --card) card=1 ;;
    *) echo "usage: $0 [--card]" >&2; exit 2 ;;
  esac
done

if [ "$card" = 1 ] && ! python3 -c 'import sys, torch; sys.exit(0 if torch.cuda.is_available() else 1)'; then
  echo "--card: no CUDA device here; chip_smoke.py needs one" >&2
  exit 1
fi

echo "== native build =="
make -C native

echo "== the port's CPU lane =="
python -m pytest tests/test_torch_*.py -q

echo "== entry check: the level flight on the CPU =="
python -m mrs_optic_flow_tpu_torch --flight level --quiet --device cpu

if [ "$card" = 1 ]; then
  echo "== chip_smoke.py on the card =="
  python3 chip_smoke.py
fi

echo "CI PASSED"
