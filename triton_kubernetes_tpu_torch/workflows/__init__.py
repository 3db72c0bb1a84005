"""Workflow configs of GPU pools: the H100 twins of the reference's
TPU-bound workflow provider (``providers.gcp_gpu``)."""
