"""Path-addressed JSON state document (the Terraform-JSON config doc): the
port's copy of ``triton_kubernetes_tpu/state/document.py``.

The document *is* the cluster topology: one ``module.cluster-manager`` entry,
``module.cluster_{provider}_{name}`` entries per cluster,
``module.node_{provider}_{cluster}_{hostname}`` entries per node, and
``module.backup_{clusterKey}`` per backup. Mutations are made here, applied by
the executor (L2), and only persisted to the backend after a successful apply
(commit-after-success discipline; reference: create/manager.go:139-151).

Reference analog: state/state.go:10-186 (gabs container with dotted-path ops).
Unlike gabs, freshly-added children are immediately visible to ``clusters()`` /
``nodes()`` — the reference needed a re-parse workaround for this
(create/cluster.go:150-154) that this implementation makes unnecessary.
"""

from __future__ import annotations

import copy
import json
from typing import Any, Dict, Iterator, List, Optional, Tuple

import re

MANAGER_KEY = "cluster-manager"
_CLUSTER_PREFIX = "cluster_"
_NODE_PREFIX = "node_"
_BACKUP_PREFIX = "backup_"

# Module-key segments travel through dotted paths, so '.' (and whitespace)
# would corrupt the document — and '_' is the key-scheme *delimiter*, so
# allowing it inside cluster names or hostnames would make keys ambiguous
# (cluster 'prod' + host 'db_1' vs cluster 'prod_db' + host '1' would
# collide on 'node_gcp_prod_db_1'). Dashes only, like the reference examples.
_SEGMENT_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9-]*$")
_PROVIDER_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9-]*$")


class ClusterKeyError(ValueError):
    """A module key does not follow the {kind}_{provider}_{name} convention.

    Reference analog: the malformed-key error from state/state.go
    ``getClusterKeyParts`` (covered by state/state_test.go).
    """


def _check_segment(kind: str, value: str, pattern: re.Pattern = _SEGMENT_RE) -> str:
    if not pattern.match(value):
        raise ClusterKeyError(
            f"invalid {kind} {value!r}: must match {pattern.pattern}"
        )
    return value


def cluster_key(provider: str, name: str) -> str:
    """``cluster_{provider}_{name}`` (reference: state/state.go:55-78)."""
    _check_segment("provider", provider, _PROVIDER_RE)
    _check_segment("cluster name", name)
    return f"{_CLUSTER_PREFIX}{provider}_{name}"


def node_key(cluster: str, hostname: str) -> str:
    """``node_{provider}_{cluster}_{hostname}`` derived from the cluster key."""
    provider, cluster_name = parse_cluster_key(cluster)
    _check_segment("hostname", hostname)
    return f"{_NODE_PREFIX}{provider}_{cluster_name}_{hostname}"


def parse_cluster_key(key: str) -> Tuple[str, str]:
    """Split ``cluster_{provider}_{name}`` -> (provider, name).

    Provider names never contain ``_`` in the key scheme; everything after the
    second underscore is the (user-chosen, possibly underscored) cluster name.
    """
    if not key.startswith(_CLUSTER_PREFIX):
        raise ClusterKeyError(f"Could not determine cluster provider: {key!r}")
    rest = key[len(_CLUSTER_PREFIX):]
    provider, sep, name = rest.partition("_")
    if not sep or not provider or not name:
        raise ClusterKeyError(f"Could not determine cluster name: {key!r}")
    return provider, name


def parse_node_key(key: str) -> Tuple[str, str]:
    """Split ``node_{provider}_{rest}`` -> (provider, rest)."""
    if not key.startswith(_NODE_PREFIX):
        raise ClusterKeyError(f"Not a node key: {key!r}")
    rest = key[len(_NODE_PREFIX):]
    provider, sep, tail = rest.partition("_")
    if not sep or not provider or not tail:
        raise ClusterKeyError(f"Could not determine node provider: {key!r}")
    return provider, tail


class StateDocument:
    """A named, path-addressed JSON document holding the full desired topology."""

    def __init__(self, name: str, raw: bytes | str | Dict[str, Any] | None = None):
        self.name = name
        if raw is None or raw == b"" or raw == "":
            self._doc: Dict[str, Any] = {}
        elif isinstance(raw, dict):
            self._doc = copy.deepcopy(raw)
        else:
            if isinstance(raw, bytes):
                raw = raw.decode("utf-8")
            self._doc = json.loads(raw) if raw.strip() else {}
        if not isinstance(self._doc, dict):
            raise ValueError("state document must be a JSON object")

    # ------------------------------------------------------------------ paths
    @staticmethod
    def _split(path: str) -> List[str]:
        return [p for p in path.split(".") if p]

    def get(self, path: str, default: Any = None) -> Any:
        """Dotted-path read, e.g. ``module.cluster-manager.name``."""
        node: Any = self._doc
        for part in self._split(path):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def exists(self, path: str) -> bool:
        sentinel = object()
        return self.get(path, sentinel) is not sentinel

    def set(self, path: str, value: Any) -> None:
        parts = self._split(path)
        if not parts:
            raise ValueError("empty path")
        node = self._doc
        for part in parts[:-1]:
            nxt = node.get(part)
            if not isinstance(nxt, dict):
                nxt = {}
                node[part] = nxt
            node = nxt
        node[parts[-1]] = copy.deepcopy(value)

    def delete(self, path: str) -> bool:
        """Delete a path; returns True if something was removed.

        Reference analog: state/state.go ``Delete`` (used by destroy/cluster.go:151-172
        to prune ``module.*`` entries after a targeted destroy).
        """
        parts = self._split(path)
        node: Any = self._doc
        for part in parts[:-1]:
            if not isinstance(node, dict) or part not in node:
                return False
            node = node[part]
        if isinstance(node, dict) and parts and parts[-1] in node:
            del node[parts[-1]]
            return True
        return False

    # --------------------------------------------------------------- topology
    def set_manager(self, config: Dict[str, Any]) -> None:
        """Write ``module.cluster-manager`` (reference: state/state.go:36)."""
        self.set(f"module.{MANAGER_KEY}", config)

    def manager(self) -> Optional[Dict[str, Any]]:
        return self.get(f"module.{MANAGER_KEY}")

    def set_backend_config(self, config: Dict[str, Any]) -> None:
        """Write ``terraform.backend`` so the executor's own state is persisted
        where the document is (reference: state/state.go SetTerraformBackendConfig,
        backend/manta/backend.go:196-205)."""
        self.set("terraform.backend", config)

    def add_cluster(self, provider: str, name: str, config: Dict[str, Any]) -> str:
        key = cluster_key(provider, name)
        # Cluster names are unique per manager regardless of provider: the
        # control plane's create-or-get is keyed by name, so a same-named
        # cluster under another provider would silently share a registration
        # (and the name->key map would shadow one of them).
        existing = self.clusters().get(name)
        if existing is not None and existing != key:
            raise ClusterKeyError(
                f"cluster name {name!r} already used by module {existing!r}")
        self.set(f"module.{key}", config)
        return key

    def add_node(self, cluster: str, hostname: str, config: Dict[str, Any]) -> str:
        key = node_key(cluster, hostname)
        self.set(f"module.{key}", config)
        return key

    def add_backup(self, cluster: str, config: Dict[str, Any]) -> str:
        parse_cluster_key(cluster)  # validate
        key = f"{_BACKUP_PREFIX}{cluster}"
        self.set(f"module.{key}", config)
        return key

    def _modules(self) -> Dict[str, Any]:
        mods = self.get("module")
        return mods if isinstance(mods, dict) else {}

    def clusters(self) -> Dict[str, str]:
        """Map cluster name -> module key, scanning ``cluster_*`` keys.

        Raises ClusterKeyError on malformed keys (reference behavior pinned by
        state/state_test.go's malformed-key case).
        """
        out: Dict[str, str] = {}
        for key in self._modules():
            if key == MANAGER_KEY or not key.startswith(_CLUSTER_PREFIX):
                continue
            _, name = parse_cluster_key(key)
            out[name] = key
        return out

    def nodes(self, cluster: str) -> Dict[str, str]:
        """Map hostname -> module key for one cluster's ``node_*`` entries."""
        provider, cluster_name = parse_cluster_key(cluster)
        prefix = f"{_NODE_PREFIX}{provider}_{cluster_name}_"
        out: Dict[str, str] = {}
        for key in self._modules():
            if key.startswith(prefix):
                out[key[len(prefix):]] = key
        return out

    def backup(self, cluster: str) -> Optional[str]:
        """The backup module key for a cluster, if one exists (at most one per
        cluster; enforced at create time, reference: create/backup.go:119-123)."""
        key = f"{_BACKUP_PREFIX}{cluster}"
        return key if key in self._modules() else None

    def module_keys(self) -> Iterator[str]:
        yield from self._modules()

    # ------------------------------------------------------------ serialization
    def to_dict(self) -> Dict[str, Any]:
        return copy.deepcopy(self._doc)

    def to_bytes(self) -> bytes:
        """Canonical serialized form (reference: state/state.go Bytes)."""
        return json.dumps(self._doc, indent=2, sort_keys=True).encode("utf-8")

    def copy(self) -> "StateDocument":
        return StateDocument(self.name, self._doc)

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, StateDocument)
            and other.name == self.name
            and other._doc == self._doc
        )

    def __repr__(self) -> str:  # pragma: no cover
        return f"StateDocument(name={self.name!r}, modules={list(self._modules())})"
