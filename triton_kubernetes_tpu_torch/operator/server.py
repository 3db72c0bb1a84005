"""The operator's own observability endpoint (the port's copy of the
reference's ``operator/server.py``).

``tools.operate --operator-port N`` binds a tiny standard-library HTTP
surface next to the loop (the plumbing the serving/router endpoints
share, ``serve/_http.py``):

* ``GET /metrics`` — the process registry's Prometheus text, which is
  where every ``tk8s_operator_*`` family lands (so the operator is
  scraped exactly like the fleet it scrapes);
* ``GET /healthz`` — 200 while the reconcile loop is alive, 503 once it
  died (the liveness contract the serving engine established: a k8s
  probe must restart a dead loop, not keep a zombie);
* ``GET /stats`` — the journal tail as JSON (the quick "what did it
  just decide" console).
"""

from __future__ import annotations

import threading
from http.server import ThreadingHTTPServer
from typing import Optional, Tuple

from ..constants import OPERATOR_PORT
from ..serve._http import JSONHandler, route_label
from ..utils import metrics


class _Handler(JSONHandler):
    server: "OperatorHTTPServer"

    def do_GET(self) -> None:  # noqa: N802 - stdlib handler contract
        route = route_label(self.path)
        code = 200
        try:
            if self.path == "/healthz":
                if self.server.owner.alive():
                    self._json(200, {"status": "ok"})
                else:
                    code = 503
                    self._json(503, {"status": "reconcile loop dead"})
            elif self.path == "/metrics":
                self._prometheus(
                    metrics.get_registry().render_prometheus())
            elif self.path == "/stats":
                self._json(200, self.server.owner.stats())
            else:
                code = 404
                self._json(404, {"error": f"no route {self.path}"})
        finally:
            metrics.counter("tk8s_serve_http_requests_total").inc(
                route=route, method="GET", code=str(code))


class OperatorHTTPServer:
    """Serve /metrics /healthz /stats for a running reconciler."""

    def __init__(self, reconciler, host: str = "127.0.0.1",
                 port: int = OPERATOR_PORT):
        self.reconciler = reconciler
        self._alive = lambda: True
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.owner = self  # type: ignore[attr-defined]
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> Tuple[str, int]:
        return self._httpd.server_address[:2]

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def set_liveness(self, probe) -> None:
        """Install the loop-liveness probe (a zero-arg callable; the CLI
        wires the loop thread's ``is_alive``)."""
        self._alive = probe

    def alive(self) -> bool:
        try:
            return bool(self._alive())
        except Exception:
            return False

    def stats(self) -> dict:
        tail = [t.to_dict() for t in self.reconciler.journal[-20:]]
        return {"ticks": len(self.reconciler.journal),
                "converged": self.reconciler.converged,
                "journal_tail": tail}

    def start(self) -> "OperatorHTTPServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="tk8s-operator-http",
            daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def __enter__(self) -> "OperatorHTTPServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()
