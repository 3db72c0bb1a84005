"""Plan computation: desired document vs applied executor state (the
port's copy of the reference's ``executor/plan.py``).

The reference had no plan stage of its own — it delegated to ``terraform plan``
implicitly inside apply. Surfacing the diff as a first-class object makes
workflows testable (golden plan assertions, SURVEY.md §4 rebuild note) and
gives destroy targeting (``-target=module.x`` fan-out,
destroy/cluster.go:126-143) a precise semantic: a plan restricted to a subset
of modules.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


class PlanAction(enum.Enum):
    CREATE = "create"
    UPDATE = "update"
    DELETE = "delete"
    NOOP = "noop"


@dataclass
class Plan:
    """Per-module actions, in no particular order (apply orders topologically)."""

    actions: Dict[str, PlanAction] = field(default_factory=dict)

    def by_action(self, action: PlanAction) -> List[str]:
        return sorted(k for k, a in self.actions.items() if a is action)

    @property
    def changes(self) -> int:
        return sum(1 for a in self.actions.values() if a is not PlanAction.NOOP)

    def summary(self) -> str:
        c = len(self.by_action(PlanAction.CREATE))
        u = len(self.by_action(PlanAction.UPDATE))
        d = len(self.by_action(PlanAction.DELETE))
        return f"Plan: {c} to add, {u} to change, {d} to destroy."


def diff_states(
    desired: Dict[str, Any],
    applied: Dict[str, Any],
    targets: Optional[List[str]] = None,
) -> Plan:
    """Compare desired module configs against applied ones.

    ``targets`` restricts the plan to the named modules (the ``-target``
    semantic); with targets set, unlisted modules are NOOP regardless of drift.
    """
    plan = Plan()
    names = set(desired) | set(applied)
    tset = set(targets) if targets is not None else None
    for name in names:
        if tset is not None and name not in tset:
            plan.actions[name] = PlanAction.NOOP
        elif name not in applied:
            plan.actions[name] = PlanAction.CREATE
        elif name not in desired:
            plan.actions[name] = PlanAction.DELETE
        elif desired[name] != applied[name].get("config"):
            plan.actions[name] = PlanAction.UPDATE
        else:
            plan.actions[name] = PlanAction.NOOP
    return plan
