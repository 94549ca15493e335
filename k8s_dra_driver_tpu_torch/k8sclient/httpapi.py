"""HTTP transport for the API substrate: serve a FakeClient over REST,
consume it with a drop-in client.

The reference's processes all talk to a real kube-apiserver through
generated clientsets (SURVEY.md §2.6); this repo's substrate is the
in-memory ``FakeClient``. To make every component *runnable as a separate
process* (reference ``cmd/*`` binaries), this module adds:

- ``ApiServer`` — exposes one FakeClient over HTTP (CRUD + label-filtered
  list + streaming watch), so N plugin/controller/daemon processes share
  one cluster state;
- ``HttpClient`` — implements the FakeClient method surface over that HTTP
  API (including ``watch`` with the same ``next(timeout)`` contract, so
  ``Informer`` works unchanged);
- ``python -m k8s_dra_driver_tpu_torch.k8sclient.httpapi`` — standalone
  API server process.

The counterpart of the JAX package's ``k8sclient/httpapi.py``, speaking
its wire format: the paths, the status codes, the ``continue`` tokens and
the watch frames are the same, so either package's client works against
either package's server.

Error mapping is status-code based: 404 → NotFoundError, 409 with
``reason=AlreadyExists`` → AlreadyExistsError, 409 with ``reason=Conflict``
→ ConflictError, 410 (``reason=Expired``) → ExpiredError — mirroring how
client-go maps Status objects.

Serve path: LISTs chunk with ``limit``/``continue`` and
carry their snapshot resourceVersion; watches accept ``resourceVersion``
for backlog resume (too-old → 410 before the stream opens) and forward
server-side BOOKMARK events; each committed event is serialized to its
JSON wire form ONCE (`WatchEvent.wire`) and the same bytes are written
to every connected watcher — N remote watchers of one kind cost ONE
serialization and zero deep copies. Every response body is produced by
the :mod:`wirecodec` encoder; LIST pages are served straight from
``FakeClient.list_page_wire``, encoded without a copy of the page.
Per-watch queues are bounded server-side, so a stalled consumer is
disconnected and its informer resyncs cleanly instead of growing server
memory.
"""

from __future__ import annotations

import http.client
import http.server
import json
import logging
import queue
import socket
import threading
import urllib.error
import urllib.parse
import urllib.request
import uuid
from typing import Any, Optional

from k8s_dra_driver_tpu_torch.k8sclient import wirecodec
from k8s_dra_driver_tpu_torch.k8sclient.client import (
    DEFAULT_BOOKMARK_INTERVAL,
    DEFAULT_WATCH_QUEUE,
    AlreadyExistsError,
    ConflictError,
    ExpiredError,
    FakeClient,
    NotFoundError,
    Obj,
    WatchEvent,
    meta,
)
from k8s_dra_driver_tpu_torch.pkg import faultpoints

logger = logging.getLogger(__name__)


class TooManyRequestsError(RuntimeError):
    """HTTP 429 from the API server — retryable by construction."""


# Fault points (docs/fault-injection.md): the client side observes
# transport failures per verb; the server side injects the Status
# responses a throttled/flaky kube-apiserver emits (409/429/500).
FP_HTTP = {
    "GET": faultpoints.register(
        "k8sclient.http.get", "HttpClient GET fails in transport",
        errors={"oserror": OSError}),
    "POST": faultpoints.register(
        "k8sclient.http.post", "HttpClient POST fails in transport",
        errors={"oserror": OSError}),
    "PUT": faultpoints.register(
        "k8sclient.http.put", "HttpClient PUT fails in transport",
        errors={"oserror": OSError}),
    "DELETE": faultpoints.register(
        "k8sclient.http.delete", "HttpClient DELETE fails in transport",
        errors={"oserror": OSError}),
}
FP_APISERVER = faultpoints.register(
    "k8sclient.apiserver.response",
    "ApiServer answers a request with an injected 409/429/500 Status",
    errors={"conflict": ConflictError,
            "toomany": TooManyRequestsError,
            "internal": RuntimeError})


# -- server ------------------------------------------------------------------

class ApiServer:
    """Serves a FakeClient over HTTP. Paths:

    - ``POST /apis/{kind}``                      create (body = object)
    - ``GET  /apis/{kind}/object?name=&namespace=``   get
    - ``PUT  /apis/{kind}/object?name=&namespace=``   update
    - ``PUT  /apis/{kind}/status?name=&namespace=``   update_status
    - ``DELETE /apis/{kind}/object?name=&namespace=`` delete
    - ``GET  /apis/{kind}?namespace=&labels=k%3Dv,...``  list
    - ``GET  /watch/{kind}?namespace=``          streaming JSON lines
    """

    #: kinds the admission hook reviews, mapped to their k8s resource name
    ADMITTED_KINDS = {"ResourceClaim": "resourceclaims",
                      "ResourceClaimTemplate": "resourceclaimtemplates"}

    def __init__(self, client: Optional[FakeClient] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 admission_webhook: str = ""):
        """``admission_webhook``: endpoint of a validating webhook (the
        ``plugins.webhook`` binary). When set, ResourceClaim/Template
        create/update is POSTed there as an AdmissionReview first and a
        denial rejects the write with 422 — the apiserver-side half of the
        ValidatingWebhookConfiguration contract, so bare-process clusters
        exercise the real admission data path."""
        self.client = client if client is not None else FakeClient()
        self.admission_webhook = admission_webhook.rstrip("/")
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # Keep-alive clients write headers and body as separate
            # segments; with Nagle on, the second segment waits out the
            # peer's delayed ACK (~40 ms) — fatal on a hot serve path.
            disable_nagle_algorithm = True

            def log_message(self, *args) -> None:
                pass

            def _send_json(self, code: int, payload: Any) -> None:
                self._send_body(code, wirecodec.encode_doc(payload))

            def _send_body(self, code: int, body: bytes) -> None:
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_error_obj(self, code: int, reason: str, msg: str,
                                injected: bool = False) -> None:
                doc = {"kind": "Status", "reason": reason, "message": msg}
                if injected:
                    # Provenance across the wire: the client re-applies
                    # the faultpoints marker to the exception it raises,
                    # so is_injected() keeps working over HTTP stacks.
                    doc["injected"] = True
                self._send_json(code, doc)

            def _body(self) -> Any:
                n = int(self.headers.get("Content-Length", 0))
                return json.loads(self.rfile.read(n) or b"{}")

            def _route(self):
                parsed = urllib.parse.urlparse(self.path)
                parts = [p for p in parsed.path.split("/") if p]
                q = urllib.parse.parse_qs(parsed.query)

                def qp(key: str, default: str = "") -> str:
                    return q.get(key, [default])[0]
                return parts, qp

            def _dispatch(self, fn) -> None:
                try:
                    faultpoints.maybe_fail(FP_APISERVER)
                    fn()
                except NotFoundError as e:
                    self._send_error_obj(404, "NotFound", str(e),
                                         injected=faultpoints.is_injected(e))
                except AlreadyExistsError as e:
                    self._send_error_obj(409, "AlreadyExists", str(e),
                                         injected=faultpoints.is_injected(e))
                except ConflictError as e:
                    self._send_error_obj(409, "Conflict", str(e),
                                         injected=faultpoints.is_injected(e))
                except ExpiredError as e:
                    # "resourceVersion too old": the kube status for a
                    # watch/continue point past the event backlog.
                    self._send_error_obj(410, "Expired", str(e),
                                         injected=faultpoints.is_injected(e))
                except TooManyRequestsError as e:
                    self._send_error_obj(429, "TooManyRequests", str(e),
                                         injected=faultpoints.is_injected(e))
                except (BrokenPipeError, ConnectionResetError):
                    raise
                except Exception as e:  # noqa: BLE001 — 500 with message
                    if not faultpoints.is_injected(e):
                        logger.exception("api server handler error")
                    self._send_error_obj(500, "InternalError", str(e),
                                         injected=faultpoints.is_injected(e))

            def do_GET(self) -> None:  # noqa: N802
                parts, qp = self._route()
                if len(parts) >= 2 and parts[0] == "watch":
                    self._serve_watch(parts[1], qp)
                    return

                def run():
                    if len(parts) == 3 and parts[0] == "apis" and \
                            parts[2] == "object":
                        obj = outer.client.get(
                            parts[1], qp("name"), qp("namespace"))
                        self._send_json(200, obj)
                    elif len(parts) == 2 and parts[0] == "apis":
                        ns = qp("namespace", "\x00")
                        namespace = None if ns == "\x00" else ns
                        labels = None
                        raw = qp("labels")
                        if raw:
                            labels = dict(
                                p.split("=", 1) for p in raw.split(","))
                        # FakeClient-backed servers serve LIST already
                        # encoded; clients without list_page_wire fall
                        # back to dict + encode.
                        lpw = getattr(outer.client, "list_page_wire", None)
                        if lpw is not None:
                            self._send_body(200, lpw(
                                parts[1], namespace, labels,
                                limit=int(qp("limit", "0") or 0),
                                continue_token=qp("continue")))
                        else:
                            page = outer.client.list_page(
                                parts[1], namespace, labels,
                                limit=int(qp("limit", "0") or 0),
                                continue_token=qp("continue"))
                            self._send_json(200, page)
                    else:
                        self._send_error_obj(404, "NotFound", self.path)
                self._dispatch(run)

            def _admission_denial(self, obj: Any, operation: str,
                                  old_obj: Optional[Obj] = None
                                  ) -> Optional[str]:
                """Run the configured validating webhook over a write.
                Returns the denial message, or None for allow. Webhook
                unreachable = fail CLOSED for reviewed kinds (the
                failurePolicy: Fail stance the chart defaults to).

                The synthesized AdmissionReview matches the real
                apiserver's contract: ``request.uid`` is unique per
                review (webhooks may key dedup/audit on it),
                ``request.operation`` says CREATE vs UPDATE, and updates
                carry the prior object as ``request.oldObject``."""
                if not outer.admission_webhook or not isinstance(obj, dict):
                    return None
                resource = ApiServer.ADMITTED_KINDS.get(obj.get("kind", ""))
                if resource is None:
                    return None
                group, _, version = obj.get(
                    "apiVersion", "resource.k8s.io/v1").partition("/")
                request: dict[str, Any] = {
                    "uid": str(uuid.uuid4()),
                    "operation": operation,
                    "resource": {"group": group,
                                 "version": version or "v1",
                                 "resource": resource},
                    "object": obj,
                }
                if old_obj is not None:
                    request["oldObject"] = old_obj
                review = {
                    "apiVersion": "admission.k8s.io/v1",
                    "kind": "AdmissionReview",
                    "request": request,
                }
                req = urllib.request.Request(
                    outer.admission_webhook +
                    "/validate-resource-claim-parameters",
                    data=wirecodec.encode_doc(review), method="POST",
                    headers={"Content-Type": "application/json"})
                try:
                    with urllib.request.urlopen(req, timeout=10) as resp:  # noqa: S310
                        out = json.loads(resp.read())
                except (urllib.error.URLError, ValueError, OSError) as e:
                    return f"admission webhook unreachable: {e}"
                response = out.get("response") or {}
                if response.get("allowed"):
                    return None
                return (response.get("status") or {}).get(
                    "message", "denied by admission webhook")

            def do_POST(self) -> None:  # noqa: N802
                parts, _ = self._route()

                def run():
                    if len(parts) == 2 and parts[0] == "apis":
                        obj = self._body()
                        denial = self._admission_denial(obj, "CREATE")
                        if denial is not None:
                            self._send_error_obj(422, "Invalid", denial)
                            return
                        self._send_json(201, outer.client.create(obj))
                    else:
                        self._send_error_obj(404, "NotFound", self.path)
                self._dispatch(run)

            def do_PUT(self) -> None:  # noqa: N802
                parts, _ = self._route()

                def run():
                    if len(parts) == 3 and parts[0] == "apis":
                        if parts[2] == "object":
                            obj = self._body()
                            old_obj = None
                            if isinstance(obj, dict) and obj.get(
                                    "kind") in ApiServer.ADMITTED_KINDS:
                                m = obj.get("metadata") or {}
                                old_obj = outer.client.try_get(
                                    obj.get("kind", ""), m.get("name", ""),
                                    m.get("namespace", ""))
                            denial = self._admission_denial(
                                obj, "UPDATE", old_obj=old_obj)
                            if denial is not None:
                                self._send_error_obj(422, "Invalid", denial)
                                return
                            self._send_json(200, outer.client.update(obj))
                        elif parts[2] == "status":
                            self._send_json(
                                200, outer.client.update_status(self._body()))
                        else:
                            self._send_error_obj(404, "NotFound", self.path)
                    else:
                        self._send_error_obj(404, "NotFound", self.path)
                self._dispatch(run)

            def do_DELETE(self) -> None:  # noqa: N802
                parts, qp = self._route()

                def run():
                    if len(parts) == 3 and parts[0] == "apis" and \
                            parts[2] == "object":
                        outer.client.delete(
                            parts[1], qp("name"), qp("namespace"))
                        self._send_json(200, {})
                    else:
                        self._send_error_obj(404, "NotFound", self.path)
                self._dispatch(run)

            def _serve_watch(self, kind: str, qp) -> None:
                """Chunked stream: one JSON line per event, with periodic
                empty-line heartbeats so dead clients are detected.

                ``sendInitial=true`` emits the initial-list ADDED events ON
                the stream itself — FakeClient.watch() snapshots the store
                and subscribes under one lock, so a live event can never
                arrive before (or be shadowed by) its own initial ADDED
                (the atomic list-then-watch contract).

                ``resourceVersion=N`` resumes from the per-kind backlog
                (missed events replayed in order on the stream); a resume
                point past the backlog window answers 410 Gone BEFORE any
                stream bytes, so the client can relist. BOOKMARK events
                the backing watch synthesizes while idle are forwarded."""
                ns = qp("namespace", "\x00")
                namespace = None if ns == "\x00" else ns
                rv_raw = qp("resourceVersion")
                try:
                    w = outer.client.watch(
                        kind, namespace,
                        send_initial=qp("sendInitial", "") == "true",
                        resource_version=int(rv_raw) if rv_raw else None,
                        max_queue=int(qp("maxQueue", "")
                                      or DEFAULT_WATCH_QUEUE),
                        bookmark_interval=float(
                            qp("bookmarkSeconds", "")
                            or DEFAULT_BOOKMARK_INTERVAL))
                except ExpiredError as e:
                    self._send_error_obj(410, "Expired", str(e),
                                         injected=faultpoints.is_injected(e))
                    return
                except ValueError as e:
                    self._send_error_obj(400, "BadRequest", str(e))
                    return
                try:
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json-stream")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()

                    def write_chunk(data: bytes) -> None:
                        self.wfile.write(
                            f"{len(data):x}\r\n".encode() + data + b"\r\n")
                        self.wfile.flush()

                    while not outer._stopping.is_set():
                        ev = w.next(timeout=1.0)
                        if ev is None:
                            if not w.alive:
                                # The backing watch died (the injected
                                # k8sclient.watch.drop lands in Watch.next,
                                # the single consumption site). Close the
                                # connection rather than heartbeating over
                                # a deaf stream: the client's reader must
                                # see EOF so the Informer resyncs.
                                self.close_connection = True
                                break
                            write_chunk(b"\n")  # heartbeat
                            continue
                        # ev.object is the SHARED single-copy fan-out
                        # snapshot (client.py), and ev.wire() memoizes its
                        # serialized form ON the shared event — so N remote
                        # watchers of one kind cost one deep copy plus ONE
                        # serialization; every connection writes the same
                        # bytes object (encode-once fan-out).
                        write_chunk(ev.wire())
                except (BrokenPipeError, ConnectionResetError, OSError):
                    pass
                finally:
                    w.stop()

        self._stopping = threading.Event()
        self._httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="api-server", daemon=True)

    @property
    def endpoint(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "ApiServer":
        self._thread.start()
        logger.info("api server on %s", self.endpoint)
        return self

    def stop(self) -> None:
        self._stopping.set()
        self._httpd.shutdown()
        self._httpd.server_close()


# -- client ------------------------------------------------------------------

class _ApiError(RuntimeError):
    pass


class HttpWatch:
    """Client-side watch: a reader thread pulls JSON lines off the chunked
    response into a queue; ``next(timeout)`` matches the FakeClient Watch."""

    def __init__(self, base: str, kind: str, namespace: Optional[str],
                 send_initial: bool = False,
                 resource_version: Optional[int] = None,
                 bookmark_interval: float = DEFAULT_BOOKMARK_INTERVAL,
                 max_queue: int = DEFAULT_WATCH_QUEUE):
        q: dict[str, str] = {}
        if namespace is not None:
            q["namespace"] = namespace
        if send_initial:
            q["sendInitial"] = "true"
        if resource_version is not None:
            q["resourceVersion"] = str(resource_version)
        if bookmark_interval != DEFAULT_BOOKMARK_INTERVAL:
            q["bookmarkSeconds"] = str(bookmark_interval)
        if max_queue != DEFAULT_WATCH_QUEUE:
            q["maxQueue"] = str(max_queue)
        url = f"{base}/watch/{urllib.parse.quote(kind)}"
        if q:
            url += "?" + urllib.parse.urlencode(q)
        try:
            self._resp = urllib.request.urlopen(url, timeout=30)  # noqa: S310 — local http
        except urllib.error.HTTPError as e:
            # The server rejects too-old resume points BEFORE streaming;
            # surface the same exception the in-process client raises so
            # the informer's relist fallback works over HTTP unchanged.
            if e.code == 410:
                try:
                    msg = (json.loads(e.read() or b"{}")).get(
                        "message", str(e))
                except ValueError:
                    msg = str(e)
                raise ExpiredError(msg) from None
            raise
        self.events: "queue.Queue[WatchEvent]" = queue.Queue()
        self._stopped = threading.Event()
        self._dead = threading.Event()
        self._thread = threading.Thread(
            target=self._read, name=f"httpwatch-{kind}", daemon=True)
        self._thread.start()

    def _read(self) -> None:
        try:
            while not self._stopped.is_set():
                line = self._resp.readline()
                if not line:
                    return  # server closed
                line = line.strip()
                if not line:
                    continue  # heartbeat
                doc = json.loads(line)
                self.events.put(WatchEvent(doc["type"], doc["object"]))
        except (OSError, ValueError, AttributeError, http.client.HTTPException):
            # OSError/ValueError: disconnect or shutdown mid-read;
            # AttributeError: http.client race when close() nulls the
            # underlying fp while readline is in flight; HTTPException
            # covers IncompleteRead when the server dies mid-chunk.
            pass
        finally:
            # Consumers (the Informer) poll this to detect a dropped stream
            # and re-establish the watch instead of going silently deaf.
            self._dead.set()

    @property
    def alive(self) -> bool:
        return not self._dead.is_set() and not self._stopped.is_set()

    def next(self, timeout: Optional[float] = 5.0) -> Optional[WatchEvent]:
        try:
            return self.events.get(timeout=timeout)
        except queue.Empty:
            return None

    def stop(self) -> None:
        self._stopped.set()
        try:
            self._resp.close()
        except OSError:
            pass


class HttpClient:
    """FakeClient-compatible client over the ApiServer HTTP API.

    Requests ride a persistent per-thread HTTP/1.1 keep-alive
    connection: a fresh TCP connect (and, with the threading server, a
    fresh handler thread) per verb dominated the claim→ready wire cost,
    so the connection is minted once per client thread and reused. A
    request that dies on a stale keep-alive socket (the server restarted
    or closed an idle connection) is retried ONCE on a fresh connection;
    a create replayed that way can surface as ``AlreadyExistsError``,
    the same signal every caller already handles for genuine duplicates.
    """

    def __init__(self, endpoint: str, timeout: float = 10.0):
        self.endpoint = endpoint.rstrip("/")
        self.timeout = timeout
        parsed = urllib.parse.urlparse(self.endpoint)
        self._host = parsed.hostname or "127.0.0.1"
        self._port = parsed.port or 80
        self._local = threading.local()

    # -- plumbing -------------------------------------------------------------

    def _conn(self) -> http.client.HTTPConnection:
        c = getattr(self._local, "conn", None)
        if c is None:
            c = http.client.HTTPConnection(self._host, self._port,
                                           timeout=self.timeout)
            c.connect()
            # Headers and body go out as separate writes; without
            # NODELAY the body write stalls behind the server's delayed
            # ACK (the 40 ms Nagle trap).
            c.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._local.conn = c
        return c

    def _drop_conn(self) -> None:
        c = getattr(self._local, "conn", None)
        self._local.conn = None
        if c is not None:
            try:
                c.close()
            except OSError:
                pass

    def _request(self, method: str, path: str,
                 params: Optional[dict[str, str]] = None,
                 body: Optional[Any] = None) -> Any:
        faultpoints.maybe_fail(FP_HTTP[method])
        url = path
        if params:
            url += "?" + urllib.parse.urlencode(params)
        data = wirecodec.encode_doc(body) if body is not None else None
        for attempt in (0, 1):
            conn = self._conn()
            try:
                conn.request(method, url, body=data,
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                payload = resp.read()
                status = resp.status
            except (http.client.HTTPException, OSError):
                # Stale keep-alive (or a dead server): one clean retry on
                # a fresh connection, then surface the transport error.
                self._drop_conn()
                if attempt:
                    raise
                continue
            if status < 400:
                return json.loads(payload or b"{}")
            try:
                doc = json.loads(payload or b"{}")
            except ValueError:
                doc = {}
            reason = doc.get("reason", "")
            msg = doc.get("message", f"HTTP {status}")
            if status == 404 or reason == "NotFound":
                err: Exception = NotFoundError(msg)
            elif reason == "AlreadyExists":
                err = AlreadyExistsError(msg)
            elif reason == "Conflict":
                err = ConflictError(msg)
            elif status == 410 or reason == "Expired":
                err = ExpiredError(msg)
            elif status == 429 or reason == "TooManyRequests":
                err = TooManyRequestsError(msg)
            else:
                err = _ApiError(f"{method} {path}: {status} {msg}")
            if doc.get("injected"):
                # Server-side injection: re-apply the faultpoints
                # provenance marker the wire format carried over, so
                # is_injected() works across the HTTP boundary.
                err._gpu_dra_injected = True  # type: ignore[attr-defined]
            raise err from None

    # -- CRUD -----------------------------------------------------------------

    def create(self, obj: Obj) -> Obj:
        return self._request("POST", f"/apis/{obj['kind']}", body=obj)

    def get(self, kind: str, name: str, namespace: str = "") -> Obj:
        return self._request("GET", f"/apis/{kind}/object",
                             params={"name": name, "namespace": namespace})

    def try_get(self, kind: str, name: str, namespace: str = "") -> Optional[Obj]:
        try:
            return self.get(kind, name, namespace)
        except NotFoundError:
            return None

    def update(self, obj: Obj) -> Obj:
        m = meta(obj)
        return self._request(
            "PUT", f"/apis/{obj['kind']}/object",
            params={"name": m["name"], "namespace": m.get("namespace", "")},
            body=obj)

    def update_status(self, obj: Obj) -> Obj:
        m = meta(obj)
        return self._request(
            "PUT", f"/apis/{obj['kind']}/status",
            params={"name": m["name"], "namespace": m.get("namespace", "")},
            body=obj)

    def delete(self, kind: str, name: str, namespace: str = "") -> None:
        self._request("DELETE", f"/apis/{kind}/object",
                      params={"name": name, "namespace": namespace})

    def list(self, kind: str, namespace: Optional[str] = None,
             label_selector: Optional[dict[str, str]] = None) -> list[Obj]:
        return self.list_page(kind, namespace, label_selector)["items"]

    def list_page(self, kind: str, namespace: Optional[str] = None,
                  label_selector: Optional[dict[str, str]] = None,
                  limit: int = 0, continue_token: str = "") -> dict[str, Any]:
        """Chunked LIST — same contract as ``FakeClient.list_page``
        (snapshot-consistent pages, ``continue`` token, ExpiredError when
        the snapshot outruns the server's backlog)."""
        params: dict[str, str] = {}
        if namespace is not None:
            params["namespace"] = namespace
        if label_selector:
            params["labels"] = ",".join(
                f"{k}={v}" for k, v in label_selector.items())
        if limit:
            params["limit"] = str(limit)
        if continue_token:
            params["continue"] = continue_token
        page = self._request("GET", f"/apis/{kind}", params=params)
        page.setdefault("metadata", {})
        return page

    def watch(self, kind: str, namespace: Optional[str] = None,
              send_initial: bool = False,
              resource_version: Optional[int] = None,
              bookmark_interval: float = DEFAULT_BOOKMARK_INTERVAL,
              max_queue: int = DEFAULT_WATCH_QUEUE) -> HttpWatch:
        """``send_initial`` is served by the API server ON the stream (the
        store snapshot + subscription happen under one lock server-side), so
        initial ADDED events and live events arrive in true order — a
        client-side list() after opening the stream could deliver a live
        event before, and then shadow it with, its own snapshot ADDED.

        ``resource_version`` resumes from the server's per-kind backlog
        (raises :class:`ExpiredError` when too old — relist). ``max_queue``
        bounds the SERVER-side per-connection queue: a consumer that
        stalls past it is disconnected (clean resync) instead of growing
        server memory."""
        return HttpWatch(self.endpoint, kind, namespace,
                         send_initial=send_initial,
                         resource_version=resource_version,
                         bookmark_interval=bookmark_interval,
                         max_queue=max_queue)

    # -- conveniences (same retry loops as FakeClient) ------------------------

    def add_finalizer(self, kind: str, name: str, finalizer: str,
                      namespace: str = "") -> Obj:
        while True:
            obj = self.get(kind, name, namespace)
            fins = meta(obj).setdefault("finalizers", [])
            if finalizer in fins:
                return obj
            fins.append(finalizer)
            try:
                return self.update(obj)
            except ConflictError:
                continue

    def remove_finalizer(self, kind: str, name: str, finalizer: str,
                         namespace: str = "") -> Optional[Obj]:
        while True:
            obj = self.try_get(kind, name, namespace)
            if obj is None:
                return None
            fins = meta(obj).get("finalizers") or []
            if finalizer not in fins:
                return obj
            fins.remove(finalizer)
            try:
                return self.update(obj)
            except ConflictError:
                continue

    def patch_labels(self, kind: str, name: str,
                     labels: dict[str, Optional[str]],
                     namespace: str = "") -> Obj:
        while True:
            obj = self.get(kind, name, namespace)
            lbls = meta(obj).setdefault("labels", {})
            for k, v in labels.items():
                if v is None:
                    lbls.pop(k, None)
                else:
                    lbls[k] = v
            try:
                return self.update(obj)
            except ConflictError:
                continue


def new_client(endpoint: str = "") -> Any:
    """Endpoint set → HttpClient; empty → a fresh in-process FakeClient
    (single-process/test mode)."""
    if endpoint:
        return HttpClient(endpoint)
    return FakeClient()


def main(argv: Optional[list[str]] = None) -> int:
    """``python -m k8s_dra_driver_tpu_torch.k8sclient.httpapi``: standalone API
    server — the substrate the runnable plugin/controller/daemon processes
    point their ``--api-endpoint`` at."""
    import argparse
    import signal

    from k8s_dra_driver_tpu_torch.internal.common import start_debug_signal_handlers

    p = argparse.ArgumentParser(description="GPU DRA fake API server")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8700)
    p.add_argument("--admission-webhook", default="",
                   help="endpoint of a plugins.webhook process; claim/"
                        "template writes are AdmissionReview'd there first "
                        "(denial or unreachable = write rejected)")
    p.add_argument("-v", "--verbose", action="store_true")
    args = p.parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    start_debug_signal_handlers()
    server = ApiServer(host=args.host, port=args.port,
                       admission_webhook=args.admission_webhook).start()
    # The handlers go in before the banner (JAX installs them after it):
    # a caller that stops the server as soon as it reads the banner
    # always reaches them.
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    print(f"api server listening on {server.endpoint}", flush=True)
    stop.wait()
    server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
