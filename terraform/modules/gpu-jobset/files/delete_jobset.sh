#!/bin/bash
# destroy-time local-exec: remove the Job and its headless Service.
set -euo pipefail

: "${GCP_CREDENTIALS:?}" "${GCP_PROJECT:?}" "${GCP_REGION:?}" "${GKE_CLUSTER:?}"
: "${JOB_NAME:?}"

export KUBECONFIG=$(mktemp)
trap 'rm -f "$KUBECONFIG"' EXIT

gcloud auth activate-service-account --key-file="$GCP_CREDENTIALS" --quiet
gcloud container clusters get-credentials "$GKE_CLUSTER" \
  --region "$GCP_REGION" --project "$GCP_PROJECT" --quiet

kubectl -n "${NAMESPACE:-default}" delete job "$JOB_NAME" --ignore-not-found
kubectl -n "${NAMESPACE:-default}" delete service "$JOB_NAME" --ignore-not-found
