"""RPC agent (port of ``paddle_tpu/distributed/rpc/rpc.py``; framework-free,
so copied).

Reference parity: ``python/paddle/distributed/rpc/rpc.py`` — ``init_rpc``
rendezvous through a master store, every worker runs a service that
executes submitted python callables, ``rpc_sync``/``rpc_async`` address
workers by NAME, and ``shutdown`` barriers before teardown.

Shape: the master store is the launch KV server
(``kv_server.py``, the TCPStore analogue) and the per-worker service is a
small threaded TCP server executing pickled ``(fn, args, kwargs)``. As in
the reference (which pickles python functions over brpc), this trusts the
cluster: only run it on networks where every peer is trusted.
"""
from __future__ import annotations

import ipaddress
import os
import pickle
import socket
import struct
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, Optional

from ..launch.kv_server import KVClient, KVServer
from ..resilience import Deadline, RetryPolicy, fault_point, with_timeout


class RpcTransportError(ConnectionError):
    """A transport-level failure talking to a named peer: connect retries
    exhausted, a connection dropped mid-request, or a truncated/garbled
    frame. Subclasses ``ConnectionError`` so every caller's
    ``resilience.RetryPolicy`` classifies it as retryable, and carries
    ``peer`` so failure detectors can attribute the miss WITHOUT parsing
    the message. Application exceptions raised by the remote fn are
    re-raised as themselves, never wrapped — only the transport is ours
    to classify."""

    def __init__(self, peer: str, message: str):
        super().__init__(f"rpc peer {peer!r}: {message}")
        self.peer = peer


_DEFAULT_RPC_TIMEOUT = 120.0
# transport-level retries for connection establishment to a peer service
# (the peer may be mid-restart); the request itself is never re-sent — an
# rpc'd fn is arbitrary python and re-execution is not ours to decide
_CONNECT_RETRY = RetryPolicy(deadline=5.0, base_delay=0.1, max_delay=1.0,
                             retryable=(ConnectionError, OSError))
# rendezvous/barrier keys are leased: a crashed incarnation's stale entries
# must not satisfy the next rendezvous on a long-lived KV store forever
_KEY_TTL = 600.0


def _namespace(endpoint: Optional[str] = None) -> str:
    """KV namespace scoped by job, pod incarnation (PADDLE_MASTER is unique
    per pod generation and identical across its ranks — same trick as
    fleet.metrics), and the init/shutdown cycles this process completed
    against the same store (``endpoint``, default the live world's)."""
    job = os.environ.get("PADDLE_JOB_ID", "default")
    gen = os.environ.get("PADDLE_MASTER", "0")
    gen = gen.replace("/", "_").replace(":", "_")
    endpoint = endpoint or _state["endpoint"]
    return f"rpc/{job}/{gen}/c{_cycles.get(endpoint, 0)}"


@dataclass(frozen=True)
class WorkerInfo:
    name: str
    rank: int
    ip: str
    port: int


_state: Dict[str, object] = {
    "server": None, "workers": None, "self": None, "kv": None,
    "kv_server": None, "pool": None, "world": 0, "endpoint": None,
}
# namespaces each incarnation's KV keys so a fast re-init never sees the
# previous cycle's rendezvous/barrier keys; advanced in shutdown() so a
# retry after a FAILED init stays in the same namespace as its peers.
# Counted per store endpoint: a process whose earlier worlds used other
# stores must still meet a fresh process (cycle 0) at a new store, where
# one process-wide count would put the two in different namespaces and
# leave both waiting out the rendezvous deadline.
_cycles: Dict[str, int] = {}


def _kv_retry(fn, deadline, what):
    """Run a KV-store operation, retrying transport failures (server not up
    yet / transient refusal) until ``deadline`` (an absolute time.time())."""
    remaining = max(0.01, deadline - time.time())
    policy = RetryPolicy(deadline=remaining, base_delay=0.2, multiplier=1.0,
                         max_delay=0.2)
    try:
        return policy.call(fn, what=f"rpc {what}")
    except TimeoutError as e:
        raise TimeoutError(
            f"rpc {what}: master store unreachable: {e.__cause__}") from e


def _read_full(sock, n):
    buf = b""
    while len(buf) < n:
        c = sock.recv(n - len(buf))
        if not c:
            raise ConnectionError("rpc peer closed")
        buf += c
    return buf


class _Service(threading.Thread):
    """Executes incoming ``(fn, args, kwargs)``; one thread per request.

    The socket binds (fixing the advertised port) at construction, but the
    accept loop only runs once ``start()`` is called — init_rpc starts it
    AFTER the worker registry is populated, so a remote fn can never
    observe half-initialized rpc state (early connects sit in the listen
    backlog)."""

    def __init__(self):
        super().__init__(daemon=True)
        self.sock = socket.socket()
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind(("0.0.0.0", 0))
        self.sock.listen(64)
        self.port = self.sock.getsockname()[1]
        self._stopping = threading.Event()

    def run(self):
        while not self._stopping.is_set():
            try:
                conn, _ = self.sock.accept()
            except OSError:
                break
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn):
        try:
            with conn:
                (size,) = struct.unpack("<Q", _read_full(conn, 8))
                fn, args, kwargs = pickle.loads(_read_full(conn, size))
                try:
                    result = (True, fn(*args, **kwargs))
                except BaseException as e:  # ship the failure back
                    result = (False, e)
                try:
                    payload = pickle.dumps(result)
                except Exception as e:  # unpicklable result/exception
                    payload = pickle.dumps((False, RuntimeError(repr(e))))
                conn.sendall(struct.pack("<Q", len(payload)) + payload)
        except (ConnectionError, OSError):
            pass

    def stop(self):
        self._stopping.set()
        try:
            self.sock.close()
        except OSError:
            pass


def _advertised_ip(master_endpoint: str) -> str:
    """The address this worker gives its peers: its host name's. A host
    whose own name does not resolve may still run a world on loopback,
    when the master is there too; any other world raises, since its peers
    could not reach a loopback address."""
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError as e:
        host = master_endpoint.rsplit(":", 1)[0].strip("[]")
        try:
            loopback = (host == "localhost"
                        or ipaddress.ip_address(host).is_loopback)
        except ValueError:
            loopback = False
        if not loopback:
            raise OSError(
                f"rpc: this host's name {socket.gethostname()!r} does not "
                f"resolve, and the master {master_endpoint!r} is not on "
                f"loopback: peers could not reach this worker") from e
        return "127.0.0.1"


def init_rpc(name: str, rank: Optional[int] = None,
             world_size: Optional[int] = None,
             master_endpoint: Optional[str] = None) -> None:
    """Start this worker's service and rendezvous with the others.

    Reference ``init_rpc``: rank/world/master default from the launch env
    (``PADDLE_TRAINER_ID``/``PADDLE_TRAINERS_NUM``/``PADDLE_MASTER``);
    rank 0 hosts the master store.
    """
    rank = int(os.environ.get("PADDLE_TRAINER_ID", 0)) if rank is None else rank
    world_size = (int(os.environ.get("PADDLE_TRAINERS_NUM", 1))
                  if world_size is None else world_size)
    master_endpoint = master_endpoint or os.environ.get(
        "PADDLE_MASTER_ENDPOINT", os.environ.get("PADDLE_KV_ENDPOINT"))
    if master_endpoint is None:
        raise ValueError("init_rpc needs master_endpoint (host:port)")
    ip = _advertised_ip(master_endpoint)   # before anything binds a port

    if rank == 0:
        host, port = master_endpoint.rsplit(":", 1)
        try:
            _state["kv_server"] = KVServer(int(port)).start()
        except OSError:
            _state["kv_server"] = None  # an external store already serves
    kv = KVClient(master_endpoint)
    service = _Service()  # bound (port known) but NOT accepting yet
    ns = _namespace(master_endpoint)
    deadline = time.time() + _DEFAULT_RPC_TIMEOUT
    # non-zero ranks commonly start BEFORE rank 0 has its store up (the
    # launch CLI spawns all pods at once), so every KV touch during
    # rendezvous retries connection failures until the shared deadline —
    # the TCPStore-client behavior of the reference
    workers: Dict[str, WorkerInfo] = {}
    try:
        _kv_retry(lambda: kv.put(
            f"{ns}/worker/{rank}",
            pickle.dumps(WorkerInfo(name, rank, ip, service.port)).hex(),
            ttl=_KEY_TTL), deadline, "register")
        for r in range(world_size):
            raw = None
            while raw is None:
                raw = _kv_retry(lambda: kv.get(f"{ns}/worker/{r}"),
                                deadline, f"rendezvous rank {r}")
                if raw is None:
                    if time.time() > deadline:
                        raise TimeoutError(
                            f"rpc rendezvous: rank {r} missing")
                    time.sleep(0.1)
            info = pickle.loads(bytes.fromhex(raw))
            workers[info.name] = info
    except Exception:
        # failed init must not leak the listening socket — nor, on rank 0,
        # the KV server this attempt started (a retry would see its own
        # orphan holding the port and mistake it for an external store)
        service.stop()
        if _state["kv_server"] is not None:
            _state["kv_server"].stop()
            _state["kv_server"] = None
        raise
    _state.update(server=service, workers=workers,
                  self=next(w for w in workers.values() if w.rank == rank),
                  kv=kv, pool=ThreadPoolExecutor(max_workers=16),
                  world=world_size, endpoint=master_endpoint)
    service.start()  # accept only now that state is fully visible


def _invoke(to: str, fn, args, kwargs, timeout, connect_deadline=None):
    workers = _state["workers"]
    if workers is None:
        raise RuntimeError("rpc not initialized; call init_rpc first")
    if to not in workers:
        raise ValueError(f"unknown rpc worker {to!r}; known: {sorted(workers)}")
    info: WorkerInfo = workers[to]
    payload = pickle.dumps((fn, tuple(args or ()), dict(kwargs or {})))

    # the per-ATTEMPT connect timeout must also respect connect_deadline:
    # the retry loop only checks elapsed time AFTER an attempt returns,
    # so a SYN-blackholed peer would otherwise hold each attempt for the
    # full request timeout and blow the caller's classification budget
    connect_timeout = timeout
    if connect_deadline is not None:
        connect_timeout = (min(timeout, connect_deadline) if timeout
                           else connect_deadline)

    def connect():
        # retried: nothing has been sent yet, so a drop/refusal here is
        # always safe to re-attempt (incl. injected rpc.connect faults)
        fault_point(f"rpc.connect.{to}")
        return socket.create_connection((info.ip, info.port),
                                        timeout=connect_timeout or None)

    retry = _CONNECT_RETRY
    if connect_deadline is not None:
        # callers with their own failure budget (health probes, bounded
        # drains) shrink the default 5s connect-retry window so a dead
        # peer is classified at THEIR deadline, not ours
        retry = RetryPolicy(deadline=max(0.05, float(connect_deadline)),
                            base_delay=0.05, max_delay=0.5,
                            retryable=(ConnectionError, OSError))
    # every failure below is a transport failure: the request either never
    # reached the peer (connect), died on the wire (send/recv), or came
    # back torn (short/garbled frame). All of them re-raise as the
    # retryable RpcTransportError carrying the peer's name; only the
    # remote fn's own exception (the ``not ok`` path) stays unwrapped.
    try:
        with retry.call(connect, what=f"rpc connect {to}") as conn:
            # connected: restore the full REQUEST timeout for the
            # send/recv phase (create_connection left the tighter
            # connect budget installed on the socket)
            conn.settimeout(timeout or None)
            conn.sendall(struct.pack("<Q", len(payload)) + payload)
            (size,) = struct.unpack("<Q", _read_full(conn, 8))
            ok, result = pickle.loads(_read_full(conn, size))
    except (TimeoutError, ConnectionError, OSError, EOFError,
            struct.error, pickle.UnpicklingError) as e:
        raise RpcTransportError(to, f"{type(e).__name__}: {e}") from e
    if not ok:
        raise result
    return result


def rpc_sync(to: str, fn, args=None, kwargs=None,
             timeout=_DEFAULT_RPC_TIMEOUT, connect_deadline=None):
    """Blocking call of ``fn(*args, **kwargs)`` on worker ``to``.

    Transport failures raise :class:`RpcTransportError` (a retryable
    ``ConnectionError`` naming the peer); exceptions raised by ``fn``
    itself propagate unwrapped. ``connect_deadline`` bounds the
    connection-establishment retry window (default: the module's 5s
    policy) — failure detectors pass a sub-second budget here."""
    return _invoke(to, fn, args, kwargs, timeout, connect_deadline)


def rpc_async(to: str, fn, args=None, kwargs=None,
              timeout=_DEFAULT_RPC_TIMEOUT) -> Future:
    """Non-blocking flavor; returns a Future (reference returns a
    ``FutureWrapper`` with ``wait()`` — ``Future.result`` is the analogue,
    and a ``wait`` alias is attached for ported scripts)."""
    if _state["pool"] is None:
        raise RuntimeError("rpc not initialized; call init_rpc first")
    fut = _state["pool"].submit(_invoke, to, fn, args, kwargs, timeout)
    fut.wait = fut.result  # paddle API compat
    return fut


def _wait_keys(kv, keys, timeout, what, deadline: Optional[Deadline] = None):
    """Poll until every key exists. The wait is bounded by ``timeout``
    AND, when given, the caller's own :class:`resilience.Deadline` —
    whichever budget runs out first ends the poll, so a caller mid-way
    through its shutdown window never re-grants a full ``timeout`` to
    each successive wait."""
    if deadline is not None:
        timeout = min(float(timeout), max(0.01, deadline.remaining()))
    local = time.monotonic() + timeout
    for key in keys:
        remaining = max(0.01, local - time.monotonic())
        policy = RetryPolicy(deadline=remaining, base_delay=0.05,
                             multiplier=1.0, max_delay=0.05)
        try:
            policy.until(lambda: kv.get(key), what=f"rpc {what}")
        except TimeoutError:
            raise TimeoutError(
                f"rpc {what} timed out waiting {key}") from None


def _barrier(timeout=_DEFAULT_RPC_TIMEOUT,
             deadline: Optional[Deadline] = None):
    kv: KVClient = _state["kv"]
    me: WorkerInfo = _state["self"]
    ns = _namespace()
    kv.put(f"{ns}/barrier/{me.rank}", "1", ttl=_KEY_TTL)
    _wait_keys(kv, [f"{ns}/barrier/{r}" for r in range(_state["world"])],
               timeout, "shutdown barrier", deadline=deadline)


def shutdown(timeout: float = _DEFAULT_RPC_TIMEOUT) -> None:
    """Barrier (so no in-flight request loses its executor), then stop.

    Idempotent (a second call is a no-op) and bounded: every phase —
    arrival barrier, executor drain, departure wait — fits inside
    ``timeout``, so a DEAD peer degrades the exit into a timed-out barrier
    plus local teardown instead of hanging this process forever.

    Two-phase: after the arrival barrier every rank posts a ``departed``
    key; the store host (rank 0) keeps the KV server alive until ALL peers
    have departed, so a peer descheduled mid-poll never sees the store
    vanish under it. Keys are leased — nothing needs deleting for the TTL
    to clean up, and deleting barrier keys early would strand slow pollers.
    """
    if _state["workers"] is None:
        return
    budget = Deadline(timeout)   # ONE budget across every phase below
    deadline = budget.expires_at
    peers_alive = True
    try:
        _barrier(timeout=max(0.1, timeout / 2), deadline=budget)
    except (TimeoutError, OSError) as e:
        # a crashed peer can't arrive; tear down locally instead of raising
        # (the caller is exiting — there is nothing better it could do)
        peers_alive = False
        print(f"[rpc] shutdown barrier abandoned: {e}", flush=True)
    if peers_alive:
        time.sleep(0.2)  # grace for requests accepted during the barrier
    _state["server"].stop()
    pool = _state["pool"]
    try:
        with_timeout(lambda: pool.shutdown(wait=True),
                     max(0.1, deadline - time.monotonic()),
                     "rpc executor drain")
    except TimeoutError:
        pool.shutdown(wait=False)  # in-flight calls to dead peers: abandon
    kv: KVClient = _state["kv"]
    me: WorkerInfo = _state["self"]
    ns = _namespace()
    try:
        kv.put(f"{ns}/departed/{me.rank}", "1", ttl=_KEY_TTL)
        kv.delete(f"{ns}/worker/{me.rank}")
    except OSError:
        pass
    if _state["kv_server"] is not None:
        if peers_alive:
            try:
                _wait_keys(kv, [f"{ns}/departed/{r}"
                                for r in range(_state["world"])],
                           max(0.1, deadline - time.monotonic()),
                           "departure", deadline=budget)
            except TimeoutError:
                pass  # a crashed peer shouldn't wedge the host's exit
        _state["kv_server"].stop()
    endpoint = _state["endpoint"]
    _state.update(server=None, workers=None, self=None, kv=None,
                  kv_server=None, pool=None, world=0, endpoint=None)
    # bump the cycle only on a COMPLETED shutdown: a rank retrying a failed
    # init must land in the same namespace as its peers, and shutdown is
    # collective (barriered), so all ranks advance together
    _cycles[endpoint] = _cycles.get(endpoint, 0) + 1


def get_worker_info(name: str) -> WorkerInfo:
    return _state["workers"][name]


def get_all_worker_infos():
    return sorted(_state["workers"].values(), key=lambda w: w.rank)


def get_current_worker_info() -> WorkerInfo:
    return _state["self"]
