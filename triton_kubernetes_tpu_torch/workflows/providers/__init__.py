"""Provider configs of GPU pools (``gcp_gpu``)."""
