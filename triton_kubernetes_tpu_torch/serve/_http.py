"""Shared stdlib-HTTP plumbing for the serving and router endpoints -- the
port's copy of ``triton_kubernetes_tpu/serve/_http.py``.

torch-free on purpose: ``serve/server.py`` (which pulls the engine and
therefore torch) and ``serve/router.py`` (which must import on a box with
no accelerator stack at all) both build on this, so a fix to the JSON
response shape, the debug-log gate, or the route labeling lands in both
surfaces at once instead of drifting apart.
"""

from __future__ import annotations

import json
import os
from http.server import BaseHTTPRequestHandler
from typing import Any, Dict
from urllib.parse import parse_qs

# Both endpoints expose the same wire surface; unknown paths are
# bucketed as "other" in the HTTP counters so label cardinality cannot
# be driven by scanners.
ROUTES = ("/healthz", "/metrics", "/stats", "/generate",
          "/migrate/out", "/migrate/in", "/await", "/resume")


def route_label(path: str) -> str:
    return path if path in ROUTES else "other"


def wants_openmetrics(query: str) -> bool:
    """True when ``/metrics?format=openmetrics`` asks for the exemplar-
    carrying exposition (the plain scrape stays 0.0.4 — the operator's
    strict parser never sees exemplar syntax unless it asks)."""
    return "openmetrics" in parse_qs(query).get("format", [])


class JSONHandler(BaseHTTPRequestHandler):
    """Request-handler base: JSON responses, Prometheus text responses,
    and per-request logging gated behind TK8S_SERVE_DEBUG (stdlib's
    default stderr line per request would swamp serving logs)."""

    def log_message(self, fmt: str, *args: Any) -> None:
        if os.environ.get("TK8S_SERVE_DEBUG"):
            super().log_message(fmt, *args)

    def _json(self, code: int, payload: Dict[str, Any]) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _text(self, text: str, content_type: str) -> None:
        body = text.encode()
        self.send_response(200)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _prometheus(self, text: str) -> None:
        self._text(text, "text/plain; version=0.0.4; charset=utf-8")

    def _metrics_response(self, registry: Any, query: str) -> None:
        """The shared ``/metrics`` surface: plain 0.0.4 exposition by
        default, the exemplar-carrying OpenMetrics rendering behind
        ``?format=openmetrics`` — one dispatch for every endpoint that
        serves a registry."""
        if wants_openmetrics(query):
            self._text(registry.render_openmetrics(),
                       "application/openmetrics-text; version=1.0.0; "
                       "charset=utf-8")
        else:
            self._prometheus(registry.render_prometheus())
