#!/usr/bin/env bash
# Launch the PyTorch/CUDA port's trainer under torchrun: the counterpart of
# deploy/tpu_job.sh for NVIDIA cards.
#
# Usage:
#   deploy/torch_job.sh <data path> [config] [-- extra trainer args]
#
# It runs, from the repository root,
#   torchrun --standalone --nproc_per_node=${NPROC:-gpu} -m hopvae_torch.train \
#     --config <config> --data <data path> --out outputs/<config> --production [extra args]
# one process per card (torchrun's "gpu" is every card of the node; set NPROC
# to use fewer). Each process joins the NCCL group that torchrun's environment
# names and trains data parallel (hopvae_torch/parallel/mesh.py); rank 0
# writes outputs/<config>/<DATA>-<size>.pt. The config defaults to ffhq_64.
# Arguments after "--" go to the trainer as they are, and a flag given there
# again wins over the script's (e.g. -- --epochs 1 --out /tmp/run).
#
# Many nodes: run the script on every node with the same NNODES, each node's
# NODE_RANK (0 to NNODES-1), and RDZV_ENDPOINT=<host>:<port> of node 0
# (torchrun's static rendezvous). The trainer runs as one data-parallel group
# over every card of every node.
#
# DRY_RUN=1 prints the command instead of running it (no card needed).
set -euo pipefail

DATA="${1:?usage: deploy/torch_job.sh <data path> [config] [-- extra trainer args]}"
shift
CONFIG="ffhq_64"
if [[ $# -gt 0 && "$1" != "--" ]]; then
  CONFIG="$1"
  shift
fi
if [[ $# -gt 0 && "$1" == "--" ]]; then
  shift
fi
if [[ -d "${DATA}" ]]; then
  DATA="$(cd "${DATA}" && pwd)"  # the trainer runs from the repository root
fi

if [[ "${NNODES:-1}" != "1" ]]; then
  NODES="--nnodes=${NNODES} --node_rank=${NODE_RANK:?NODE_RANK is needed with NNODES} --rdzv_endpoint=${RDZV_ENDPOINT:?RDZV_ENDPOINT (host:port of node 0) is needed with NNODES}"
else
  NODES="--standalone"
fi
TORCHRUN="torchrun"
if [[ "${DRY_RUN:-0}" == "1" ]]; then
  TORCHRUN="echo torchrun"
fi

cd "$(dirname "${BASH_SOURCE[0]}")/.."
${TORCHRUN} ${NODES} --nproc_per_node="${NPROC:-gpu}" -m hopvae_torch.train \
  --config "${CONFIG}" \
  --data "${DATA}" \
  --out "outputs/${CONFIG}" \
  --production \
  "$@"
