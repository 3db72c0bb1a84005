"""Provisioning modules of GPU pools: the H100 twins of the reference's
TPU-bound modules, as plain render functions (``gcp_gpu``). The rest of
the reference's module registry holds no accelerator and stays the
reference's."""
