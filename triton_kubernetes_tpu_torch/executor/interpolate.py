"""Terraform-style ``${module.x.y}`` interpolation resolution (the port's
copy of the reference's ``executor/interpolate.py``).

This is the deferred-resolution contract at the heart of the reference's
design: workflows write strings like ``"${module.cluster-manager.rancher_url}"``
into the doc (create/cluster.go:297-300) and *terraform* resolves them at apply
time against module outputs. The in-process executor must honor the same
contract so generated configs are byte-compatible with the reference's scheme.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Set

_INTERP = re.compile(r"\$\{([^}]+)\}")


class InterpolationError(KeyError):
    pass


def extract_dependencies(value: Any) -> Set[str]:
    """All module names referenced by ``${module.<name>.<attr>}`` anywhere in a
    config value (recursing into dicts/lists)."""
    deps: Set[str] = set()

    def walk(v: Any) -> None:
        if isinstance(v, str):
            for expr in _INTERP.findall(v):
                parts = expr.strip().split(".")
                if len(parts) >= 3 and parts[0] == "module":
                    deps.add(parts[1])
        elif isinstance(v, dict):
            for item in v.values():
                walk(item)
        elif isinstance(v, (list, tuple)):
            for item in v:
                walk(item)

    walk(value)
    return deps


def module_dependencies(doc_modules: Dict[str, Any]) -> Dict[str, Set[str]]:
    """Per-module dependency sets restricted to modules present in the doc."""
    present = set(doc_modules)
    return {
        name: extract_dependencies(cfg) & present
        for name, cfg in doc_modules.items()
    }


def topo_order(doc_modules: Dict[str, Any]) -> List[str]:
    """Dependency-ordered module names; raises on cycles."""
    deps = module_dependencies(doc_modules)
    order: List[str] = []
    seen: Dict[str, int] = {}  # 0=visiting, 1=done

    for name, dset in deps.items():
        if name in dset:
            raise InterpolationError(
                f"module {name!r} references its own output")

    def visit(name: str, chain: List[str]) -> None:
        mark = seen.get(name)
        if mark == 1:
            return
        if mark == 0:
            raise InterpolationError(
                f"interpolation cycle: {' -> '.join(chain + [name])}"
            )
        seen[name] = 0
        for dep in sorted(deps[name]):
            visit(dep, chain + [name])
        seen[name] = 1
        order.append(name)

    for name in sorted(doc_modules):
        visit(name, [])
    return order


def _lookup(expr: str, outputs: Dict[str, Dict[str, Any]]) -> Any:
    parts = expr.strip().split(".")
    if len(parts) < 3 or parts[0] != "module":
        raise InterpolationError(f"unsupported interpolation: ${{{expr}}}")
    module, attr = parts[1], ".".join(parts[2:])
    if module not in outputs:
        raise InterpolationError(f"unknown module in ${{{expr}}}")
    mod_out = outputs[module]
    if attr not in mod_out:
        raise InterpolationError(f"module {module!r} has no output {attr!r}")
    return mod_out[attr]


def resolve(value: Any, outputs: Dict[str, Dict[str, Any]]) -> Any:
    """Substitute every ``${module.x.y}`` with the named module output.

    A string that is *exactly* one interpolation resolves to the output value
    with its type preserved (lists, ints); interpolations embedded in longer
    strings are stringified in place — both match terraform semantics.
    """
    if isinstance(value, str):
        m = _INTERP.fullmatch(value)
        if m:
            return _lookup(m.group(1), outputs)
        return _INTERP.sub(lambda mm: str(_lookup(mm.group(1), outputs)), value)
    if isinstance(value, dict):
        return {k: resolve(v, outputs) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [resolve(v, outputs) for v in value]
    return value
