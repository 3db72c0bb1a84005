"""The declarative cluster-topology document: the port's copy of the
reference's ``state`` package (``module.cluster-manager``,
``module.cluster_{provider}_{name}``, ``module.node_{provider}_{cluster}_{host}``
keys; a GPU pool takes the host's slot, ``node_gcp-gpu_<cluster>_<pool>``).
"""

from .document import (
    MANAGER_KEY,
    ClusterKeyError,
    StateDocument,
    cluster_key,
    node_key,
    parse_cluster_key,
    parse_node_key,
)

__all__ = [
    "MANAGER_KEY",
    "ClusterKeyError",
    "StateDocument",
    "cluster_key",
    "node_key",
    "parse_cluster_key",
    "parse_node_key",
]
