"""Module registry: source string -> Module class (the port's copy of the
reference's ``modules/registry.py``).

Workflows write fully-qualified source URLs into the doc exactly like the
reference (``github.com/<repo>//terraform/modules/<name>?ref=<ref>``,
create/cluster.go:20-22 and the source_url/source_ref local-dev redirect,
docs/guide/README.md:104-118). The in-process executor resolves only the
trailing module name, so redirected sources keep working.
"""

from __future__ import annotations

import re
from typing import Dict, Type

from .base import Module, ModuleError

REGISTRY: Dict[str, Type[Module]] = {}

_SOURCE_RE = re.compile(r"(?:.*//)?(?:terraform/)?modules/(?P<name>[A-Za-z0-9._-]+?)(?:\?.*)?$")


def register(cls: Type[Module]) -> Type[Module]:
    name = module_name_from_source(cls.SOURCE)
    REGISTRY[name] = cls
    # Reference-compatible aliases (e.g. "triton-rancher") so docs generated
    # against the reference's module names resolve here too.
    for alias in getattr(cls, "ALIASES", ()):
        REGISTRY[alias] = cls
    return cls


def module_name_from_source(source: str) -> str:
    m = _SOURCE_RE.match(source)
    if not m:
        raise ModuleError(f"cannot parse module source: {source!r}")
    return m.group("name")


def get_module(source: str) -> Module:
    name = module_name_from_source(source)
    if name not in REGISTRY:
        raise ModuleError(f"unknown module {name!r} (source {source!r})")
    return REGISTRY[name]()
