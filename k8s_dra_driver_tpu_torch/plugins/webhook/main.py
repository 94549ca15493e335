"""Validating webhook entrypoint.

The counterpart of the JAX package's ``plugins/webhook/main.py`` (the
analogue of ``cmd/webhook/main.go:56-123``): an HTTP(S) server exposing
``POST /validate-resource-claim-parameters`` (AdmissionReview in/out) and
``GET /readyz``. TLS is required in a real cluster (the reference demands
``--tls-cert-file``/``--tls-private-key-file``); here it is optional so the
webhook can run in local multi-process clusters without a CA.

Run standalone::

    python -m k8s_dra_driver_tpu_torch.plugins.webhook --port 0
"""

from __future__ import annotations

import argparse
import http.server
import json
import logging
import ssl
import threading
from typing import Optional

from k8s_dra_driver_tpu_torch.internal.common import start_debug_signal_handlers
from k8s_dra_driver_tpu_torch.internal.info import version_string
from k8s_dra_driver_tpu_torch.pkg import flags
from k8s_dra_driver_tpu_torch.pkg.process import (
    ProcessHandle,
    block_until_signaled,
)
from k8s_dra_driver_tpu_torch.plugins.webhook.admission import review_response

logger = logging.getLogger(__name__)

BINARY = "webhook"

#: Largest AdmissionReview body accepted. The apiserver caps admission
#: request payloads well below this (objects are limited to ~1.5 MiB in
#: etcd; 3 MiB gives headroom for the review envelope) — anything larger
#: is not a legitimate review and must not be buffered wholesale.
MAX_BODY_BYTES = 3 << 20

#: Socket-level timeout for one request's reads/writes: a client that
#: stalls mid-body cannot pin a handler thread forever.
HANDLER_TIMEOUT_SECONDS = 10.0


class WebhookServer:
    """The serve mux (``newMux``, main.go:114-123)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 cert_file: str = "", key_file: str = ""):
        class Handler(http.server.BaseHTTPRequestHandler):
            timeout = HANDLER_TIMEOUT_SECONDS  # per-read socket timeout

            def log_message(self, *args) -> None:
                logger.debug("webhook http: %s", args)

            def _send(self, code: int, body: bytes,
                      content_type: str = "application/json") -> None:
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_error_text(self, code: int, msg: str) -> None:
                logger.error("webhook: %s", msg)
                self._send(code, msg.encode(), "text/plain")

            def do_GET(self) -> None:  # noqa: N802
                if self.path == "/readyz":
                    self._send(200, b"ok", "text/plain")
                else:
                    self._send_error_text(404, f"not found: {self.path}")

            def do_POST(self) -> None:  # noqa: N802
                if self.path != "/validate-resource-claim-parameters":
                    self._send_error_text(404, f"not found: {self.path}")
                    return
                ctype = self.headers.get("Content-Type", "")
                if ctype != "application/json":
                    # main.go:143-149: reject non-JSON outright.
                    self._send_error_text(
                        415, f"contentType={ctype}, expected application/json")
                    return
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                except (ValueError, TypeError):
                    self._send_error_text(400, "malformed Content-Length")
                    return
                if length <= 0:
                    self._send_error_text(411, "Content-Length required")
                    return
                if length > MAX_BODY_BYTES:
                    # Trust-boundary cap: never buffer a multi-GB "review".
                    self._send_error_text(
                        413, f"body of {length} bytes exceeds admission "
                             f"limit of {MAX_BODY_BYTES}")
                    return
                try:
                    review = json.loads(self.rfile.read(length))
                    resp = review_response(review)
                except (ValueError, TypeError) as e:
                    self._send_error_text(
                        400, f"failed to read AdmissionReview from request "
                             f"body: {e}")
                    return
                except Exception as e:  # noqa: BLE001 — a crashed handler
                    # thread returns NO response; the apiserver must see a
                    # clean 500 instead (serve(), main.go:130-177).
                    logger.exception("webhook admit failed")
                    self._send_error_text(500, f"admission failed: {e}")
                    return
                self._send(200, json.dumps(resp).encode())

        self._httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.tls = bool(cert_file)
        if cert_file:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(cert_file, key_file or None)
            self._httpd.socket = ctx.wrap_socket(
                self._httpd.socket, server_side=True)
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="webhook", daemon=True)

    @property
    def endpoint(self) -> str:
        scheme = "https" if self.tls else "http"
        return f"{scheme}://{self.host}:{self.port}"

    def start(self) -> "WebhookServer":
        self._thread.start()
        logger.info("webhook server on %s", self.endpoint)
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=BINARY,
        description="validating admission webhook for GPU DRA opaque configs")
    flags.add_logging_flags(p)
    flags.add_feature_gate_flags(p)
    p.add_argument("--host", action=flags.EnvDefault,
                   env="GPU_DRA_WEBHOOK_HOST", default="127.0.0.1")
    p.add_argument("--port", action=flags.EnvDefault,
                   env="GPU_DRA_WEBHOOK_PORT", type=int, default=443,
                   help="port the webhook listens on (0 = ephemeral)")
    p.add_argument("--tls-cert-file", action=flags.EnvDefault,
                   env="GPU_DRA_WEBHOOK_TLS_CERT", default="",
                   help="x509 certificate for HTTPS (empty = plain HTTP)")
    p.add_argument("--tls-private-key-file", action=flags.EnvDefault,
                   env="GPU_DRA_WEBHOOK_TLS_KEY", default="",
                   help="x509 private key matching --tls-cert-file")
    p.add_argument("--version", action="version", version=version_string())
    return p


def validate_flags(args: argparse.Namespace) -> None:
    if bool(args.tls_cert_file) != bool(args.tls_private_key_file):
        raise SystemExit(
            "--tls-cert-file and --tls-private-key-file must be given "
            "together")


def run_webhook(args: argparse.Namespace, block: bool = True) -> ProcessHandle:
    """Assemble and start the webhook — same run_*(args, block=) contract
    as the other binaries."""
    gates = flags.parse_feature_gates(args)
    flags.log_startup_config(BINARY, args, gates)
    server = WebhookServer(
        host=args.host, port=args.port,
        cert_file=args.tls_cert_file, key_file=args.tls_private_key_file,
    ).start()
    handle = ProcessHandle(BINARY, driver=server, servers=[server])
    handle.on_stop(server.stop)
    if not block:
        return handle
    block_until_signaled(handle, f"{BINARY} serving on {server.endpoint}")
    return handle


def main(argv: Optional[list[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    flags.setup_logging(args, component=BINARY)
    validate_flags(args)
    start_debug_signal_handlers()
    run_webhook(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
