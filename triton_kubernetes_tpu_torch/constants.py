"""Pinned constants, copied from the JAX package's ``constants.py`` (the
port imports nothing of that package): the ports the workload stack
listens on or dials, the trainer's process exit codes, and the choices of
the serving quantization knobs.

``KV_DTYPES``, ``WEIGHT_DTYPES`` and ``MATMUL_DTYPES`` are the choices of the
serving quantization knobs; the port's engine serves every choice.
"""

from __future__ import annotations

# The distributed coordinator port every worker dials (worker 0 listens).
# The port trains on one card and dials nothing; the value is kept so a
# manifest rendered for either package carries the same port.
COORDINATOR_PORT = 8476

# The serving endpoint port, and the router's beside it.
SERVE_PORT = 8000
ROUTE_PORT = 8001

# The operator endpoint port (`tk8s operate --operator-port`), distinct
# from the serving/router ports so all three can share a pod's network
# namespace during local runs.
OPERATOR_PORT = 8002

# Process exit codes -- bounded and machine-readable so launchers, the
# JobSet podFailurePolicy, and CI classify terminations without parsing
# logs:
#
# EXIT_CONFIG       (2)  bad/unsupported invocation: malformed CLI args,
#                        or a checkpoint whose recorded mesh the fleet
#                        cannot hold (train/__main__.py).
# EXIT_ANOMALY      (4)  the loss-anomaly guard gave up after
#                        max_rollbacks consecutive trips
#                        (train/resilience.py AnomalyAbortedError).
# EXIT_UNSUPPORTED  (69) EX_UNAVAILABLE: the environment cannot host
#                        this run -- a loud skip, never a failure.
# EXIT_RESUME       (75) EX_TEMPFAIL: "resume me" -- a preemption-warned
#                        trainer saved an emergency checkpoint; the
#                        podFailurePolicy restarts it with --resume
#                        (train/resilience.py).
EXIT_CONFIG = 2
EXIT_ANOMALY = 4
EXIT_UNSUPPORTED = 69
EXIT_RESUME = 75

KV_DTYPES = ("auto", "bf16", "int8", "fp8")
WEIGHT_DTYPES = ("auto", "int8", "fp8")
MATMUL_DTYPES = ("auto", "f32", "int8", "fp8")
