"""Builtin HTTP KV store for rendezvous (port of
``paddle_tpu/distributed/launch/kv_server.py``; framework-free, so copied).

Reference parity: ``python/paddle/distributed/launch/utils/kv_server.py``
(``KVServer`` used by ``Master.sync_peers``) and the C++ ``TCPStore``
(``paddle/fluid/distributed/store/tcp_store.h``) — wait/barrier semantics
over a tiny KV namespace. In the port its user is ``distributed.rpc``'s
rendezvous (worker endpoints, barriers).
"""
from __future__ import annotations

import json
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

from ..resilience import RetryPolicy, fault_point


class _Handler(BaseHTTPRequestHandler):
    server_version = "paddle_tpu_kv/1"

    def log_message(self, *a):  # quiet
        pass

    def _store(self) -> Dict[str, bytes]:
        return self.server.kv  # type: ignore[attr-defined]

    def _purge(self) -> None:
        """Drop expired lease keys (caller holds the lock)."""
        now = time.monotonic()
        expiry = self.server.expiry  # type: ignore[attr-defined]
        for k in [k for k, t in expiry.items() if t <= now]:
            expiry.pop(k, None)
            self._store().pop(k, None)

    def do_PUT(self):
        length = int(self.headers.get("Content-Length", 0))
        value = self.rfile.read(length)
        ttl = self.headers.get("X-TTL")  # lease: expires unless re-PUT
        with self.server.lock:  # type: ignore[attr-defined]
            self._store()[self.path] = value
            if ttl is not None:
                self.server.expiry[self.path] = (  # type: ignore[attr-defined]
                    time.monotonic() + float(ttl))
            else:
                self.server.expiry.pop(self.path, None)  # type: ignore[attr-defined]
        self.send_response(200)
        self.end_headers()

    def do_GET(self):
        with self.server.lock:  # type: ignore[attr-defined]
            self._purge()
            if self.path == "/" or self.path.startswith("/?prefix="):
                prefix = (self.path.split("=", 1)[1]
                          if "=" in self.path else "")
                body = json.dumps(
                    {k: v.decode("utf-8", "replace")
                     for k, v in self._store().items()
                     if k.lstrip("/").startswith(prefix)}).encode()
                self.send_response(200)
                self.end_headers()
                self.wfile.write(body)
                return
            value = self._store().get(self.path)
        if value is None:
            self.send_response(404)
            self.end_headers()
        else:
            self.send_response(200)
            self.end_headers()
            self.wfile.write(value)

    def do_DELETE(self):
        with self.server.lock:  # type: ignore[attr-defined]
            self._store().pop(self.path, None)
        self.send_response(200)
        self.end_headers()


class KVServer:
    """Threaded HTTP KV server; ``with KVServer(port) as s: ...``."""

    def __init__(self, port: int = 0, host: str = "0.0.0.0"):
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.kv = {}          # type: ignore[attr-defined]
        self._httpd.expiry = {}      # type: ignore[attr-defined]
        self._httpd.lock = threading.Lock()  # type: ignore[attr-defined]
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


class KVClient:
    """Client with the TCPStore-style wait/barrier helpers.

    ``retry``: optional :class:`~paddle_tpu_torch.distributed.resilience.
    RetryPolicy` applied to every single-shot operation (put/get/list/
    delete) — transport failures and injected faults back off through it.
    ``retry=None`` (the default) keeps one-attempt semantics for callers
    that run their own policy around the client. Every operation passes a
    ``fault_point`` (``kv.put``/``kv.get``/``kv.list``/``kv.delete``), so a
    :class:`~paddle_tpu_torch.distributed.resilience.FaultPlan` can drop, delay
    or crash any KV touch deterministically.

    ``timeout`` bounds each HTTP request — deadline-sensitive callers
    (elastic heartbeats, whose lease expires in seconds) pass a short one
    so a slow-but-alive store cannot stall an attempt past its budget.
    """

    def __init__(self, endpoint: str, retry: Optional[RetryPolicy] = None,
                 timeout: float = 10.0):
        if not endpoint.startswith("http"):
            endpoint = "http://" + endpoint
        self.endpoint = endpoint.rstrip("/")
        self.retry = retry
        self.timeout = float(timeout)

    def _op(self, fn, what: str):
        if self.retry is None:
            return fn()
        return self.retry.call(fn, what=what)

    def put(self, key: str, value: str, ttl: Optional[float] = None) -> None:
        """``ttl``: lease seconds — the key vanishes unless re-PUT within
        that window (etcd-lease analogue for elastic membership)."""
        def once():
            fault_point("kv.put")
            req = urllib.request.Request(
                f"{self.endpoint}/{key.lstrip('/')}",
                data=value.encode(), method="PUT")
            if ttl is not None:
                req.add_header("X-TTL", str(ttl))
            urllib.request.urlopen(req, timeout=self.timeout).read()
        self._op(once, f"kv put {key!r}")

    def list(self, prefix: str = "") -> Dict[str, str]:
        """Live keys under ``prefix`` (expired leases excluded)."""
        def once():
            fault_point("kv.list")
            with urllib.request.urlopen(
                    f"{self.endpoint}/?prefix={prefix.lstrip('/')}",
                    timeout=self.timeout) as r:
                return {k.lstrip("/"): v
                        for k, v in json.loads(r.read()).items()}
        return self._op(once, f"kv list {prefix!r}")

    def get(self, key: str) -> Optional[str]:
        def once():
            fault_point("kv.get")
            try:
                with urllib.request.urlopen(
                        f"{self.endpoint}/{key.lstrip('/')}",
                        timeout=self.timeout) as r:
                    return r.read().decode()
            except urllib.error.HTTPError as e:
                if e.code == 404:
                    return None
                raise
        return self._op(once, f"kv get {key!r}")

    def delete(self, key: str) -> None:
        def once():
            fault_point("kv.delete")
            req = urllib.request.Request(
                f"{self.endpoint}/{key.lstrip('/')}", method="DELETE")
            urllib.request.urlopen(req, timeout=self.timeout).read()
        self._op(once, f"kv delete {key!r}")

    def wait(self, key: str, timeout: float = 300.0,
             interval: float = 0.2) -> str:
        """Poll until ``key`` exists (transport failures retry too — the
        server may still be coming up on the other side of rendezvous)."""
        policy = RetryPolicy(deadline=timeout, base_delay=interval,
                             multiplier=1.0, max_delay=interval)
        try:
            return policy.until(lambda: self.get(key), what=f"kv key {key!r}")
        except TimeoutError:
            raise TimeoutError(f"kv wait timed out on {key!r}") from None

    def barrier(self, name: str, rank: int, world: int,
                timeout: float = 300.0, gen: int = 0) -> None:
        """All ranks put their mark, then wait for everyone. ``gen`` must
        differ across reuses of the same name (e.g. elastic restart
        attempts) so stale marks from a previous generation can't satisfy
        the new barrier."""
        self.put(f"barrier/{name}/{gen}/{rank}", "1")

        def arrived():
            ok = all(self.get(f"barrier/{name}/{gen}/{r}") is not None
                     for r in range(world))
            return True if ok else None

        policy = RetryPolicy(deadline=timeout, base_delay=0.2,
                             multiplier=1.0, max_delay=0.2)
        try:
            policy.until(arrived, what=f"barrier {name!r}")
        except TimeoutError:
            raise TimeoutError(
                f"barrier {name!r} (gen {gen}) timed out") from None
