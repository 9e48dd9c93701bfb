"""The keep-alive HTTP handler base of the port's front ends.

:class:`DrainAwareHandler` is shared by the server's handler
(:mod:`~dwt_tpu_torch.serve.server`) and the fleet's front door
(:mod:`~dwt_tpu_torch.fleet.balancer`).  It lives apart from the server
because the balancer must not import torch: the fleet process routes
requests and holds no CUDA context, only its replicas do.  This module
imports the standard library only.
"""

from __future__ import annotations

import json
import logging
import select
import threading
import time
from http.server import BaseHTTPRequestHandler

log = logging.getLogger(__name__)


class DrainAwareHandler(BaseHTTPRequestHandler):
    """Keep-alive JSON-line handler base: HTTP/1.1 persistent
    connections, a drain-aware idle wait, and a body read on every POST
    branch (a keep-alive error reply that left the body unread would
    desynchronize the connection — the leftover bytes would parse as the
    next request line)."""

    draining: threading.Event = None  # type: ignore[assignment]  # set by the maker
    # Socket read timeout: handler threads are non-daemon and joined at
    # shutdown, so a stalled client must not hold exit hostage.
    timeout = 120.0
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # route through logging, not stderr
        log.debug("http: " + fmt, *args)

    def handle_one_request(self):
        # Idle keep-alive wait in short select slices, so a parked
        # connection neither blocks the drain nor outlives the timeout.
        idle_deadline = time.monotonic() + self.timeout
        while True:
            try:
                ready, _, _ = select.select([self.connection], [], [], 0.5)
            except (OSError, ValueError):  # connection torn down
                self.close_connection = True
                return
            if ready:
                break
            if self.draining.is_set() or time.monotonic() > idle_deadline:
                self.close_connection = True
                return
        super().handle_one_request()

    def read_body(self) -> bytes:
        """Read the request body.  EVERY POST branch calls this before
        replying — error replies included."""
        length = int(self.headers.get("Content-Length", "0"))
        return self.rfile.read(length) if length > 0 else b""

    def _reply(self, code: int, payload: dict, headers=()) -> None:
        body = (json.dumps(payload) + "\n").encode()  # one JSON line
        self.send_response(code)
        self.send_header("Content-Type", "application/jsonl")
        self.send_header("Content-Length", str(len(body)))
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _reply_text(self, code: int, body: str, content_type: str) -> None:
        """Non-JSON reply (the /metrics Prometheus exposition)."""
        data = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)
