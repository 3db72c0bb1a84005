"""Entry points of the port that the JAX package keeps in its CLI
(``tk8s trace merge``, ``tk8s goodput report``): one module each, run with
``python -m triton_kubernetes_tpu_torch.tools.<name>``."""
