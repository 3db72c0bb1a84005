#!/bin/bash
# local-exec: render the GPU JobSet + headless Service with the in-repo
# renderer and kubectl-apply them into the pool's cluster.
set -euo pipefail

: "${GCP_CREDENTIALS:?}" "${GCP_PROJECT:?}" "${GCP_REGION:?}" "${GKE_CLUSTER:?}"
: "${JOB_NAME:?}" "${GPU_ACCELERATOR:?}" "${SLICE_ID:?}"

export KUBECONFIG=$(mktemp)
trap 'rm -f "$KUBECONFIG"' EXIT

gcloud auth activate-service-account --key-file="$GCP_CREDENTIALS" --quiet
gcloud container clusters get-credentials "$GKE_CLUSTER" \
  --region "$GCP_REGION" --project "$GCP_PROJECT" --quiet

args=(jobset --name "$JOB_NAME" --accelerator "$GPU_ACCELERATOR"
      --slice-id "$SLICE_ID" --image "$IMAGE" --namespace "$NAMESPACE")
# ENV_FLAGS is a space-joined "--env K=V ..." list built by HCL.
# shellcheck disable=SC2086
python -m triton_kubernetes_tpu_torch.topology "${args[@]}" $ENV_FLAGS \
  --command $JOB_COMMAND | kubectl apply -f -
