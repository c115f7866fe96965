#!/usr/bin/env bash
# Multi-node training launch of the PyTorch port (the reference's
# dist_train.sh; tools/launch_train.sh is the JAX package's). Run the same
# command on every node: torch.distributed.run starts one process per card
# there, and each process joins the group through env:// as one rank of
# cli/train.py --multihost. The node's place in the job comes from the
# environment:
#
#   NNODES       nodes in the job                    (default 1)
#   NODE_RANK    this node's index, 0 on the master  (default 0)
#   MASTER_ADDR  the master node's address           (default localhost)
#   MASTER_PORT  a free port on the master           (default 29500)
#   NPROC_PER_NODE  processes per node               (default gpu: one per card)
#
#   NNODES=2 NODE_RANK=1 MASTER_ADDR=node0 \
#       ./tools/launch_train_torch.sh CONFIG INFO_PKL DATA_ROOT [extra args...]
#
# --batch-size is the global batch over all nodes' ranks; --work-dir must be
# a directory every node sees for --resume.
set -euo pipefail
CONFIG=$1; INFO=$2; ROOT=$3; shift 3
REPO="$(cd "$(dirname "$0")/.." && pwd)"
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
exec python -m torch.distributed.run --nnodes "${NNODES:-1}" --node-rank "${NODE_RANK:-0}" \
    --master-addr "${MASTER_ADDR:-localhost}" --master-port "${MASTER_PORT:-29500}" \
    --nproc-per-node "${NPROC_PER_NODE:-gpu}" \
    -m fullysparsefusion_tpu_torch.cli.train --multihost \
    --config "$CONFIG" --info-pkl "$INFO" --data-root "$ROOT" "$@"
