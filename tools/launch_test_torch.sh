#!/usr/bin/env bash
# Multi-node evaluation launch of the PyTorch port (the reference's
# dist_test.sh; tools/launch_test.sh is the JAX package's). Run the same
# command on every node: torch.distributed.run starts one process per card
# there, each rank of cli/test.py --multihost serves its `idx % world`
# shard, and rank 0 merges the results (shard files under --tmpdir, a
# directory every node sees, or an all-gather without it) and alone writes
# --out and the metrics. NNODES, NODE_RANK, MASTER_ADDR, MASTER_PORT and
# NPROC_PER_NODE as in tools/launch_train_torch.sh.
#
#   ./tools/launch_test_torch.sh CONFIG CKPT INFO_PKL DATA_ROOT [extra args...]
set -euo pipefail
CONFIG=$1; CKPT=$2; INFO=$3; ROOT=$4; shift 4
REPO="$(cd "$(dirname "$0")/.." && pwd)"
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
exec python -m torch.distributed.run --nnodes "${NNODES:-1}" --node-rank "${NODE_RANK:-0}" \
    --master-addr "${MASTER_ADDR:-localhost}" --master-port "${MASTER_PORT:-29500}" \
    --nproc-per-node "${NPROC_PER_NODE:-gpu}" \
    -m fullysparsefusion_tpu_torch.cli.test --multihost \
    --config "$CONFIG" --checkpoint "$CKPT" \
    --info-pkl "$INFO" --data-root "$ROOT" --eval "$@"
