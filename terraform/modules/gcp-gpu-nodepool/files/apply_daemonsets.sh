#!/bin/bash
# local-exec: render the GPU host-software DaemonSets (torch/CUDA runtime,
# NVIDIA device plugin, health probe) with the in-repo renderer (one
# source of truth with the in-process path) and kubectl-apply them into
# the GKE cluster.
set -euo pipefail

: "${GCP_CREDENTIALS:?}" "${GCP_PROJECT:?}" "${GCP_REGION:?}"
: "${GKE_CLUSTER:?}" "${GPU_ACCELERATOR:?}"

export KUBECONFIG=$(mktemp)
trap 'rm -f "$KUBECONFIG"' EXIT

gcloud auth activate-service-account --key-file="$GCP_CREDENTIALS" --quiet
gcloud container clusters get-credentials "$GKE_CLUSTER" \
  --region "$GCP_REGION" --project "$GCP_PROJECT" --quiet

args=(daemonsets --accelerator "$GPU_ACCELERATOR")
[ -n "${RUNTIME_IMAGE:-}" ] && args+=(--image "$RUNTIME_IMAGE")

python -m triton_kubernetes_tpu_torch.topology "${args[@]}" | kubectl apply -f -
