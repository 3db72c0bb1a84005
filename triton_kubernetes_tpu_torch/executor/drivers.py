"""The document's cloud driver (the port's copy of the reference's
``executor/drivers.py``).

A state document may carry a top-level ``driver`` block::

    {"driver": {"name": "sim", "fault_plan": {...}}}

The port has one driver, the in-process
:class:`~..executor.cloudsim.CloudSimulator` (absent block or ``name:
sim``): its operator drives GPU pools on the simulated cloud. The
reference's driver registry and its ``local-k8s`` (kind/k3d) driver are
not ported.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from .cloudsim import CloudSimulator


def make_driver(doc, cloud_state: Optional[Dict[str, Any]] = None
                ) -> CloudSimulator:
    """Build the driver for a document + its persisted cloud state. An
    optional ``fault_plan`` in the driver block arms deterministic fault
    injection; once armed, the plan's live state (remaining fire-counts)
    rides the persisted cloud dict and wins over the block's spec, so
    fault sequences survive state round-trips."""
    raw = doc.get("driver")
    cfg = {"name": raw} if isinstance(raw, str) else dict(raw or {})
    name = cfg.get("name") or "sim"
    if name != "sim":
        raise ValueError(f"unknown driver {name!r} (choices: ['sim'])")
    return CloudSimulator(cloud_state or {},
                          fault_plan=cfg.get("fault_plan"))
