"""The manager control-plane semantic core the simulated cloud needs: the
port's copy of three names of the reference's ``manager/protocol.py``
(``mint_credentials``, ``create_or_get_cluster``, ``register_node``) and
the helpers they call.

Pure functions over plain state dicts — no I/O, no clocks, no randomness
(callers supply a ``salt``; the simulator uses the empty salt so tests
are deterministic). The reference's HTTP manager server and its other
routes are not ported: the port's operator drives the simulator only.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Optional


class ProtocolError(RuntimeError):
    """A control-plane contract violation (bad token, unknown cluster...)."""


def _h(*parts: str) -> str:
    return hashlib.sha256("|".join(parts).encode()).hexdigest()


def mint_credentials(name: str, salt: str = "") -> Dict[str, str]:
    """Admin API credentials for a manager — create-or-get semantics are the
    caller's job (rerunning the provisioner must not rotate credentials,
    install_manager.sh.tpl contract)."""
    return {
        "access_key": f"token-{_h(name, salt, 'access')[:8]}",
        "secret_key": _h(name, salt, "secret")[:40],
    }


def cacerts_pem(name: str, salt: str = "") -> str:
    """The manager's CA material as served at /v3/settings/cacerts. A
    deterministic stand-in body (the fingerprint contract is what matters:
    agents pin sha256(cacerts), register_cluster script computes the same)."""
    return (
        "-----BEGIN CERTIFICATE-----\n"
        f"tk8s-manager:{name}:{_h(name, salt, 'ca')}\n"
        "-----END CERTIFICATE-----\n"
    )


def ca_checksum(name: str, salt: str = "",
                cacerts: Optional[str] = None) -> str:
    """sha256 over the exact cacerts body — what agents pass as
    ``--ca-checksum`` and register_cluster emits (rancher_cluster.sh:94-97
    analog). ``cacerts`` overrides the deterministic stand-in with the real
    TLS certificate when the manager serves HTTPS (manager/tls.py)."""
    body = cacerts if cacerts is not None else cacerts_pem(name, salt)
    return hashlib.sha256(body.encode()).hexdigest()


def cluster_id(manager_name: str, cluster_name: str) -> str:
    return f"c-{_h(manager_name, cluster_name)[:8]}"


def create_or_get_cluster(clusters: Dict[str, Dict[str, Any]],
                          manager_name: str, cluster_name: str,
                          salt: str = "", cacerts: Optional[str] = None,
                          **attrs: Any) -> Dict[str, Any]:
    """Idempotent create-or-get by (manager, name) — rancher_cluster.sh:17-28
    contract. Existing records absorb attr updates (k8s_version bumps) but
    keep identity, token, and nodes. ``cacerts`` is the served CA body the
    checksum pins (the real TLS cert on HTTPS managers)."""
    for c in clusters.values():
        if c["manager"] == manager_name and c["name"] == cluster_name:
            c.update(attrs)
            if cacerts is not None:
                # The served CA can change legitimately (a plain-HTTP
                # manager upgraded to TLS mints a real cert); the pin must
                # track what /v3/settings/cacerts actually serves or every
                # later agent join fails the checksum.
                c["ca_checksum"] = ca_checksum(manager_name, salt, cacerts)
            return c
    cid = cluster_id(manager_name, cluster_name)
    cluster = {
        "id": cid,
        "name": cluster_name,
        "manager": manager_name,
        "registration_token": _h(cid, salt, "reg")[:40],
        "ca_checksum": ca_checksum(manager_name, salt, cacerts),
        "nodes": {},
        **attrs,
    }
    clusters[cid] = cluster
    return cluster


def register_node(clusters: Dict[str, Dict[str, Any]], token: str,
                  hostname: str, roles: List[str],
                  labels: Optional[Dict[str, str]] = None,
                  ca_checksum_pin: str = "") -> Dict[str, Any]:
    """Agent self-registration: resolve the cluster by token, verify the CA
    pin, upsert the node (install_rancher_agent.sh.tpl:44 analog)."""
    for c in clusters.values():
        if c["registration_token"] == token:
            if ca_checksum_pin and ca_checksum_pin != c["ca_checksum"]:
                raise ProtocolError(f"CA checksum mismatch for {hostname}")
            # Merge, don't replace: heartbeats re-register and must not wipe
            # fields other writers own (e.g. the simulator's 'health' entry).
            node = c["nodes"].setdefault(hostname, {})
            node.update({
                "hostname": hostname,
                "roles": sorted(roles),
                "labels": dict(labels or {}),
            })
            return node
    raise ProtocolError(f"invalid registration token for {hostname}")
