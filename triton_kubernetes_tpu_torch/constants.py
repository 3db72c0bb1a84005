"""Pinned serving constants, copied from the JAX package's
``constants.py`` (the port imports nothing of that package).

``KV_DTYPES``, ``WEIGHT_DTYPES`` and ``MATMUL_DTYPES`` are the choices of the
serving quantization knobs; the port's engine serves every choice.
"""

from __future__ import annotations

# The serving endpoint port, and the router's beside it.
SERVE_PORT = 8000
ROUTE_PORT = 8001

KV_DTYPES = ("auto", "bf16", "int8", "fp8")
WEIGHT_DTYPES = ("auto", "int8", "fp8")
MATMUL_DTYPES = ("auto", "f32", "int8", "fp8")
