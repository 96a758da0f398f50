#!/usr/bin/env bash
# Data-parallel training of the port: one process per local GPU, started
# with torchrun (reference tools/dist_train.sh; the JAX package's
# tools/dist_train.sh contract).
#
# One host:     ./srfdet3d_torch/tools/dist_train.sh <config> [train args...]
# Many hosts:   COORD_ADDR=host0:29500 NUM_HOSTS=2 HOST_ID=0 \
#                   ./srfdet3d_torch/tools/dist_train.sh <config> [args...]
#               (the same COORD_ADDR and NUM_HOSTS on every host, a
#               distinct HOST_ID)
#
# NPROC: processes on this host (default: its GPU count).  BACKEND: nccl
# (the default on GPUs) or gloo (SRFDET_DIST_BACKEND).  PYTHON: the
# interpreter (default python3).  The global batch is --batch-size, or
# the config's batch_size_per_device times NUM_HOSTS x NPROC.
set -euo pipefail
CONFIG=$1
shift
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
    --nproc_per_node "$NPROC" -m srfdet3d_torch.tools.train "$CONFIG" "$@"
