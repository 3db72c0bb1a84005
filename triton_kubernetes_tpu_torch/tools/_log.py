"""The error lines of the tools, as the reference CLI's logger writes them
to standard error: ``error: <msg>  (kind=<kind>)``, or with ``--json`` one
JSON object a line."""

from __future__ import annotations

import json
import sys
import time


def error(msg: str, kind: str, json_mode: bool) -> None:
    if json_mode:
        line = json.dumps({"ts": round(time.time(), 3), "level": "error",
                           "msg": msg, "kind": kind}, sort_keys=True,
                          default=str)
    else:
        line = f"error: {msg}  (kind={kind})"
    print(line, file=sys.stderr)
