#!/bin/bash
# Run a shipped recipe command on the port: builds the native tools
# (lstm_ctc_tpu_torch/_native.py), then runs the command with PYTHON set to
# the port's shim (recipe_python.py) and FSTBIN and PATH to the native
# build, and prints the command's wall seconds at the end.
#
# usage: with_port.sh [--device cuda|cpu] <command> [arguments]
#   e.g. with_port.sh --device cuda bash egs/synthetic/run.sh --work /tmp/w
#        (the multi-seed protocol through scripts/run_parity.sh: README.md)
set -euo pipefail
PKG="$(cd "$(dirname "${BASH_SOURCE[0]}")/.." && pwd)"
REPO="$(dirname "$PKG")"
device=cuda
if [ "${1:-}" = "--device" ]; then device=$2; shift 2; fi
[ $# -ge 1 ] || { echo "usage: with_port.sh [--device cuda|cpu] <command> [args]" >&2; exit 1; }
FSTBIN=$(cd "$REPO" && python3 -m lstm_ctc_tpu_torch._native)
export FSTBIN
export PATH="$FSTBIN:$PATH"
export PYTHON="python3 $PKG/recipe_python.py --device $device"
start=$(date +%s.%N)
"$@"
echo "with_port.sh: $(awk -v s="$start" -v e="$(date +%s.%N)" 'BEGIN{printf "%.1f", e - s}') s for: $*"
