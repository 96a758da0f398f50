#!/usr/bin/env bash
# Multi-process evaluation of the port (reference tools/dist_test.sh):
# one process per local GPU, each predicting a strided shard of the val
# frames; every rank reports the metrics of the whole set, and rank 0
# writes --out.  The environment is dist_train.sh's (COORD_ADDR,
# NUM_HOSTS, HOST_ID, NPROC, BACKEND, PYTHON).
#
# Usage: ./srfdet3d_torch/tools/dist_test.sh <config> <checkpoint> [args...]
set -euo pipefail
CONFIG=$1
CKPT=$2
shift 2
PYTHON=${PYTHON:-python3}
NPROC=${NPROC:-$("$PYTHON" -c 'import torch; print(torch.cuda.device_count())')}
if [ -n "${BACKEND:-}" ]; then
    export SRFDET_DIST_BACKEND=$BACKEND
fi
if [ -n "${COORD_ADDR:-}" ]; then
    RDZV=(--nnodes "${NUM_HOSTS:-1}" --node_rank "${HOST_ID:-0}"
          --master_addr "${COORD_ADDR%:*}" --master_port "${COORD_ADDR##*:}")
else
    RDZV=(--standalone --nnodes 1)
fi
ROOT=$(cd "$(dirname "$0")/../.." && pwd)
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
exec "$PYTHON" -m torch.distributed.run "${RDZV[@]}" \
    --nproc_per_node "$NPROC" -m srfdet3d_torch.tools.test "$CONFIG" \
    "$CKPT" "$@"
