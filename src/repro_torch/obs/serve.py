"""Live observability endpoint over stdlib `http.server`:

    python -m repro_torch.obs.serve [--host H] [--port P] [--rule NAME=EXPR ...]

Endpoint map (all GET):

    /metrics        Prometheus text exposition of the registry
    /snapshot.json  full export.snapshot() + live latency + alert state
    /trace.json     Chrome-trace JSON (load in chrome://tracing/Perfetto)
    /healthz        200 {"status": "ok"} — 503 while any alert fires
    /               plain-text index

The handler reads process-global state (registry / tracer / journal /
alert engine) — run it in the serving process, embedded via
`start(port=0)` on a daemon thread, and scrape from outside.  Each
`/metrics` and `/healthz` hit also runs one alert-engine evaluation, so
a scraper always sees freshly-evaluated firing state even when the
store's own fold points are idle.

Same kill-switch as the rest of `repro_torch.obs`: the module touches no
store code, and nothing here runs unless something calls `start()` /
`main()` — the disabled serving path stays bit-exact.  `main()` arms
observability for the process it runs in (an endpoint over a disarmed
registry would serve empty scrapes forever)."""
from __future__ import annotations

import argparse
import json
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

from . import _flags, export
from . import latency as _latency
from . import rules as _rules
from . import trace as _trace

_INDEX = """repro_torch.obs endpoints:
  /metrics        Prometheus text exposition
  /snapshot.json  metrics + journal + live latency + alerts
  /trace.json     Chrome trace (chrome://tracing)
  /healthz        200 ok / 503 alerting
"""


def render(path: str) -> Optional[Tuple[int, str, bytes]]:
    """Pure endpoint dispatch: path -> (status, content-type, body), or
    None for unknown paths.  Exposed separately so tests can hit the
    endpoints without a socket."""
    if path == "/metrics":
        _rules.maybe_evaluate()
        return (200, "text/plain; version=0.0.4; charset=utf-8",
                export.prometheus_text().encode())
    if path == "/snapshot.json":
        _rules.maybe_evaluate()
        snap = export.snapshot()
        snap["live_latency"] = _latency.live_summary()
        return (200, "application/json",
                json.dumps(snap, indent=2, default=str).encode())
    if path == "/trace.json":
        return (200, "application/json",
                json.dumps(_trace.TRACER.snapshot()).encode())
    if path in ("/healthz", "/health"):
        _rules.maybe_evaluate()
        firing = _rules.ENGINE.firing()
        body = {"status": "alerting" if firing else "ok",
                "firing": [r["name"] for r in firing],
                "enabled": bool(_flags.ENABLED)}
        return (503 if firing else 200, "application/json",
                json.dumps(body).encode())
    if path == "/":
        return 200, "text/plain; charset=utf-8", _INDEX.encode()
    return None


class ObsRequestHandler(BaseHTTPRequestHandler):
    server_version = "repro-torch-obs/1"

    def do_GET(self):          # noqa: N802  (http.server's naming)
        out = render(self.path.split("?", 1)[0])
        if out is None:
            out = 404, "text/plain; charset=utf-8", b"not found\n"
        code, ctype, body = out
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):
        pass                    # scrapes should not spam the serving logs


def make_server(host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    """Bind (port=0 picks a free one; read `server_address[1]`)."""
    return ThreadingHTTPServer((host, port), ObsRequestHandler)


def start(host: str = "127.0.0.1", port: int = 0):
    """Serve on a daemon thread; returns (server, thread).  Shut down
    with `server.shutdown()`."""
    srv = make_server(host, port)
    thread = threading.Thread(target=srv.serve_forever,
                              name="repro-torch-obs-serve", daemon=True)
    thread.start()
    return srv, thread


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.serve",
        description="Serve the live observability endpoints.")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=9464)
    ap.add_argument("--rule", action="append", default=[],
                    metavar="NAME=EXPR",
                    help="register an alert rule, e.g. "
                         "'tail=p99(f2_latency_seconds{phase=e2e}) > 0.5'")
    args = ap.parse_args(argv)
    _flags.ENABLED = True       # an endpoint over a disarmed registry is
    for spec in args.rule:      # an empty scrape forever
        if "=" not in spec:
            ap.error(f"--rule wants NAME=EXPR, got {spec!r}")
        name, expr = spec.split("=", 1)
        _rules.add_rule(name.strip(), expr.strip())
    srv = make_server(args.host, args.port)
    host, port = srv.server_address[:2]
    print(f"repro_torch.obs.serve on http://{host}:{port}/ "
          f"({len(args.rule)} rules)")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
