"""The document's cloud driver (the port's copy of the reference's
``executor/drivers.py``).

A document may carry a driver block::

    {"driver": {"name": "sim", "fault_plan": {...}, "op_latency": 0.5}}

The port has one driver, the in-process
:class:`~..executor.cloudsim.CloudSimulator` (absent block or ``name:
sim``): its operator drives GPU pools on the simulated cloud. The
reference's driver registry and its ``local-k8s`` (kind/k3d) driver are
not ported; :class:`~.engine.LocalExecutor`'s ``driver_factory`` is the
seam that hands the engine another one.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from .cloudsim import CloudSimulator


def driver_config(doc) -> Dict[str, Any]:
    """The document's driver block as a mapping (the string shorthand
    ``driver: sim`` becomes ``{"name": "sim"}``); ``fault_plan`` and
    ``op_latency`` ride in it."""
    raw = doc.get("driver")
    if raw is None:
        return {}
    if isinstance(raw, str):
        return {"name": raw}
    if isinstance(raw, dict):
        return dict(raw)
    raise ValueError(f"driver must be a name or a mapping, got {raw!r}")


def make_driver(doc, cloud_state: Optional[Dict[str, Any]] = None
                ) -> CloudSimulator:
    """Build the driver for a document + its persisted cloud state. An
    optional ``fault_plan`` in the driver block arms deterministic fault
    injection; once armed, the plan's live state (remaining fire-counts)
    rides the persisted cloud dict and wins over the block's spec, so
    fault sequences survive state round-trips. ``op_latency`` (seconds a
    mutating op, or an ``{op: seconds}`` map with ``"*"`` as the default)
    arms the simulator's deterministic latency model."""
    cfg = driver_config(doc)
    name = cfg.get("name") or "sim"
    if name != "sim":
        raise ValueError(f"unknown driver {name!r} (choices: ['sim'])")
    return CloudSimulator(cloud_state or {},
                          fault_plan=cfg.get("fault_plan"),
                          op_latency=cfg.get("op_latency"))
