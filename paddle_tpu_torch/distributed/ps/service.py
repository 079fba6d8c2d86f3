"""Multi-host parameter-server service: servers, client, communicator
(port of ``paddle_tpu/distributed/ps/service.py``).

Reference parity: ``paddle/fluid/distributed/ps/service/brpc_ps_server.cc``
(request dispatch into tables), ``brpc_ps_client.cc`` (client stubs with
key->shard routing and request batching), and the communicator modes of
``ps/service/communicator/communicator.h`` (``AsyncCommunicator:426``
background send queue, ``HalfAsyncCommunicator:519`` barriered batches,
``GeoCommunicator:596`` delta pushes every k steps).

Each server process owns one C++ :class:`MemorySparseTable`
(a shard of the global key space) behind the plain-TCP framed protocol of
``native/src/ps_service.cc``; the client partitions keys by splitmix64 hash —
the same router the C++ shards use internally — batches per-server requests,
and exposes the exact ``MemorySparseTable`` interface, so
:class:`~paddle_tpu_torch.distributed.ps.SparseEmbedding` works over the
network unchanged (its lookup calls ``client.pull``/``push``). The wire is
the reference's: a port client talks to a reference server and back.
"""
from __future__ import annotations

import queue
import select
import socket
import struct
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ... import native
from ..resilience import RetryPolicy, fault_point
from .table import MemorySparseTable, SparseAccessorConfig

__all__ = ["PsServer", "PsClient", "Communicator", "launch_servers"]

_OP_PULL = 1
_OP_PUSH = 2
_OP_SIZE = 3
_OP_SAVE = 4
_OP_LOAD = 5
_OP_SHRINK = 6
_OP_SET_LR = 7
_OP_BARRIER = 8
_OP_KEYS = 9
_OP_STOP = 10
_OP_PUSH_RAW = 11
_OP_PUSH_SHOW_CLICK = 12
_OP_DENSE_INIT = 13
_OP_DENSE_PULL = 14
_OP_DENSE_PUSH = 15
_OP_DENSE_SET = 16


class PsRpcError(RuntimeError):
    """Server replied with an error status (application error — NOT a
    transport failure, so the client does not retry it)."""


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 over uint64 — MUST match ``ptn::splitmix64``
    (native/src/common.h) bit for bit; it is the canonical key router."""
    x = x.astype(np.uint64, copy=True)
    x += np.uint64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def shard_of(keys: np.ndarray, num_servers: int) -> np.ndarray:
    """Server index per key (client-side partitioning, brpc_ps_client.cc's
    key->shard routing).

    Routes on the UPPER 32 bits of the hash while the C++ table's internal
    16-way sharding uses the full hash mod 16 (ps_table.cc shard_of): with a
    shared low-bit router and power-of-two server counts, each server would
    only ever see keys with hash ≡ s (mod num_servers), funnelling them into
    a fraction of its internal shards and serializing behind shard mutexes.
    """
    return ((_splitmix64(np.asarray(keys, np.int64).view(np.uint64))
             >> np.uint64(32)) % np.uint64(num_servers)).astype(np.int64)


class PsServer:
    """One PS shard: a C++ table + the native TCP service.

    In-process flavor (tests, single-host multi-shard); for real deployments
    run one per host via
    ``python -m paddle_tpu_torch.distributed.ps.server``.
    """

    def __init__(self, accessor: Optional[SparseAccessorConfig] = None,
                 port: int = 0, **accessor_kw):
        self.table = MemorySparseTable(accessor, **accessor_kw)
        self._lib = native.get_lib()
        self._h = self._lib.pt_ps_server_start(self.table._h, int(port))
        if not self._h:
            raise OSError(f"failed to bind PS server on port {port}")

    @property
    def port(self) -> int:
        return int(self._lib.pt_ps_server_port(self._h))

    def wait(self) -> None:
        self._lib.pt_ps_server_wait(self._h)

    def load_dense(self, path: str) -> None:
        """Restore the dense sidecar saved next to ``path`` (server
        restart flow); a missing sidecar is fine."""
        rc = self._lib.pt_ps_server_load_dense(self._h, path.encode())
        if rc != 0:
            raise IOError(f"dense sidecar restore failed ({rc}): {path}")

    def stop(self) -> None:
        h, self._h = self._h, None
        if h:
            self._lib.pt_ps_server_stop(h)
            self._lib.pt_ps_server_destroy(h)

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass


class _Conn:
    """One framed-protocol connection (thread-unsafe; callers lock)."""

    def __init__(self, host: str, port: int, timeout: float = 30.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def request(self, op: int, body: bytes = b"") -> bytes:
        self.send(op, body)
        return self.recv(op)

    def send(self, op: int, body: bytes = b"") -> None:
        """Write one framed request without waiting for the reply — the
        scatter half of scatter-gather; the framed protocol serves
        pipelined requests strictly in order, so N sends followed by N
        recvs on one connection are well-defined."""
        self.sock.sendall(struct.pack("<IB", len(body), op) + body)

    def recv(self, op: int = -1) -> bytes:
        hdr = self._read(8)
        status, blen = struct.unpack("<iI", hdr)
        payload = self._read(blen) if blen else b""
        if status != 0:
            raise PsRpcError(f"PS rpc op={op} failed with status {status}")
        return payload

    def _read(self, n: int) -> bytes:
        chunks = []
        while n > 0:
            c = self.sock.recv(n)
            if not c:
                raise ConnectionError("PS server closed connection")
            chunks.append(c)
            n -= len(c)
        return b"".join(chunks)

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


class PsClient:
    """Sharded-table client: same interface as :class:`MemorySparseTable`,
    keys routed to ``endpoints[shard_of(key)]``. Thread-safe (one lock per
    server connection, so concurrent requests to different shards overlap —
    the brpc client's per-channel concurrency).

    Transport failures reconnect and retry with exponential backoff (the
    reference's ``brpc_ps_client.cc`` retry loop): a server that dies and
    comes back on the same endpoint resumes serving this client without a
    restart. Semantics are at-least-once — a PUSH whose reply was lost may
    be applied twice after retry, the same tolerance the reference's async
    SGD accepts. Application errors (:class:`PsRpcError`) never retry.
    """

    def __init__(self, endpoints: Sequence[Tuple[str, int]], embed_dim: int,
                 retries: int = 4, retry_delay: float = 0.25):
        if not endpoints:
            raise ValueError("need at least one PS endpoint")
        self.endpoints = list(endpoints)
        self.embed_dim = int(embed_dim)
        self.retries = int(retries)
        self.retry_delay = float(retry_delay)
        # the brpc-client reconnect loop, expressed as the shared policy
        # (resilience.RetryPolicy): retries+1 attempts, doubling delay
        # capped at 2s — identical schedule to the previous inline loop
        self._retry_policy = RetryPolicy(
            max_attempts=self.retries + 1, base_delay=self.retry_delay,
            max_delay=2.0, multiplier=2.0,
            retryable=(ConnectionError, socket.timeout, OSError))
        self._conns: List[Optional[_Conn]] = [
            _Conn(h, p) for h, p in self.endpoints]
        self._locks = [threading.Lock() for _ in self._conns]
        # persistent fan-out pool: pull+push run every training step, so
        # per-call thread spawn/teardown would be pure hot-path overhead
        self._pool = (ThreadPoolExecutor(max_workers=len(self._conns))
                      if len(self._conns) > 1 else None)
        self._dense_len = 0
        self._dense_bounds: Optional[np.ndarray] = None

    def _request(self, s: int, op: int, body: bytes = b"",
                 retry: bool = True) -> bytes:
        """One RPC to server ``s`` with reconnect + backoff on transport
        errors (through the shared :class:`RetryPolicy`). PsRpcError
        (status<0 reply) is an application error — it is not in the
        policy's retryable set and passes through unretried.
        ``retry=False`` for non-idempotent control ops (shrink): a lost
        reply must surface instead of silently re-applying the op."""
        def attempt() -> bytes:
            # the fault point sits BEFORE any bytes hit the wire, so an
            # injected drop/delay/crash models a connect-time fault and a
            # retry is always protocol-safe
            fault_point(f"ps.request.{s}")
            try:
                with self._locks[s]:
                    if self._conns[s] is None:
                        self._conns[s] = _Conn(*self.endpoints[s])
                    return self._conns[s].request(op, body)
            except PsRpcError:
                raise
            except (ConnectionError, socket.timeout, OSError):
                with self._locks[s]:
                    if self._conns[s] is not None:
                        self._conns[s].close()
                        self._conns[s] = None
                raise
        if not retry:
            return attempt()
        return self._retry_policy.call(attempt, what=f"ps request srv{s}")

    # -- partitioned data plane -------------------------------------------
    def _scatter(self, keys: np.ndarray):
        keys = np.ascontiguousarray(np.asarray(keys).reshape(-1), np.int64)
        sid = shard_of(keys, len(self._conns))
        order = np.argsort(sid, kind="stable")
        sorted_keys = keys[order]
        counts = np.bincount(sid, minlength=len(self._conns))
        return keys, sid, order, sorted_keys, counts

    def pull(self, keys) -> np.ndarray:
        keys, sid, order, sorted_keys, counts = self._scatter(keys)
        out = np.empty((keys.size, self.embed_dim), np.float32)
        offs = np.concatenate([[0], np.cumsum(counts)])

        def one(s):
            part = sorted_keys[offs[s]:offs[s + 1]]
            if part.size == 0:
                return
            body = struct.pack("<I", part.size) + part.tobytes()
            payload = self._request(s, _OP_PULL, body)
            rows = np.frombuffer(payload, np.float32).reshape(
                part.size, self.embed_dim)
            out[order[offs[s]:offs[s + 1]]] = rows

        self._fanout(one)
        return out

    def push(self, keys, grads) -> None:
        """Apply the optimizer rule once per key occurrence on each key's
        server, duplicates in batch order: one request per server."""
        self._push_rows(keys, grads, _OP_PUSH)

    def push_raw(self, keys, deltas) -> None:
        """Additively merge parameter deltas, bypassing the optimizer rule
        (the geo communicator's delta merge)."""
        self._push_rows(keys, deltas, _OP_PUSH_RAW)

    def _push_rows(self, keys, rows, op: int) -> None:
        keys, sid, order, sorted_keys, counts = self._scatter(keys)
        rows = np.ascontiguousarray(
            np.asarray(rows, np.float32).reshape(keys.size, self.embed_dim))
        sorted_rows = rows[order]
        offs = np.concatenate([[0], np.cumsum(counts)])

        def one(s):
            part = sorted_keys[offs[s]:offs[s + 1]]
            if part.size == 0:
                return
            g = sorted_rows[offs[s]:offs[s + 1]]
            body = struct.pack("<I", part.size) + part.tobytes() + g.tobytes()
            self._request(s, op, body)

        self._fanout(one)

    def push_show_click(self, keys, shows, clicks) -> None:
        """Accumulate CTR usage statistics on each key's owner server."""
        keys, sid, order, sorted_keys, counts = self._scatter(keys)
        sc = np.empty((keys.size, 2), np.float32)
        sc[:, 0] = np.asarray(shows, np.float32).reshape(-1)
        sc[:, 1] = np.asarray(clicks, np.float32).reshape(-1)
        sorted_sc = sc[order]
        offs = np.concatenate([[0], np.cumsum(counts)])

        def one(s):
            part = sorted_keys[offs[s]:offs[s + 1]]
            if part.size == 0:
                return
            g = np.ascontiguousarray(sorted_sc[offs[s]:offs[s + 1]])
            body = struct.pack("<I", part.size) + part.tobytes() + g.tobytes()
            self._request(s, _OP_PUSH_SHOW_CLICK, body)

        self._fanout(one)

    def _fanout(self, fn) -> None:
        n = len(self._conns)
        if n == 1:
            fn(0)
            return
        futures = [self._pool.submit(fn, s) for s in range(n)]
        for f in futures:
            f.result()  # re-raises the first shard failure

    # -- dense parameter plane (MemoryDenseTable over the wire) -----------
    def dense_init(self, length: int, optimizer: str = "sgd",
                   learning_rate: float = 0.05) -> None:
        """Create (idempotently) the dense parameter vector, split in
        contiguous blocks across servers — the reference's dense-table
        sharding. Must run before the other ``dense_*`` calls."""
        from .table import _DENSE_OPTIMIZERS

        self._dense_len = int(length)
        bounds = np.linspace(0, length, len(self._conns) + 1).astype(np.int64)
        self._dense_bounds = bounds
        opt = _DENSE_OPTIMIZERS[optimizer]
        for s in range(len(self._conns)):
            blk = int(bounds[s + 1] - bounds[s])
            body = struct.pack("<qif", blk, opt, float(learning_rate))
            self._request(s, _OP_DENSE_INIT, body)

    def _block(self, s: int):
        return int(self._dense_bounds[s]), int(self._dense_bounds[s + 1])

    def dense_pull(self) -> np.ndarray:
        out = np.empty(self._dense_len, np.float32)

        def one(s):
            lo, hi = self._block(s)
            if hi == lo:
                return
            body = struct.pack("<qq", 0, hi - lo)
            out[lo:hi] = np.frombuffer(
                self._request(s, _OP_DENSE_PULL, body), np.float32)

        self._fanout(one)
        return out

    def dense_push(self, grads: np.ndarray) -> None:
        self._dense_scatter(grads, _OP_DENSE_PUSH)

    def dense_set(self, values: np.ndarray) -> None:
        self._dense_scatter(values, _OP_DENSE_SET)

    def _dense_scatter(self, arr: np.ndarray, op: int) -> None:
        arr = np.ascontiguousarray(np.asarray(arr, np.float32).reshape(-1))
        assert arr.size == self._dense_len

        def one(s):
            lo, hi = self._block(s)
            if hi == lo:
                return
            body = struct.pack("<qq", 0, hi - lo) + \
                np.ascontiguousarray(arr[lo:hi]).tobytes()
            self._request(s, op, body)

        self._fanout(one)

    # -- control plane (all servers) --------------------------------------
    def __len__(self) -> int:
        total = 0
        for s in range(len(self._conns)):
            total += struct.unpack("<q", self._request(s, _OP_SIZE))[0]
        return total

    def keys(self) -> np.ndarray:
        parts = []
        for s in range(len(self._conns)):
            parts.append(np.frombuffer(self._request(s, _OP_KEYS), np.int64))
        return np.concatenate(parts) if parts else np.empty(0, np.int64)

    def shrink(self, threshold: float = 1.0) -> int:
        dropped = 0
        for s in range(len(self._conns)):
            body = struct.pack("<f", float(threshold))
            # no retry: shrink decays counters/evicts — re-applying on a
            # lost reply would decay twice
            dropped += struct.unpack(
                "<q", self._request(s, _OP_SHRINK, body, retry=False))[0]
        return dropped

    def set_learning_rate(self, lr: float) -> None:
        for s in range(len(self._conns)):
            self._request(s, _OP_SET_LR, struct.pack("<f", float(lr)))

    def save(self, path: str) -> None:
        """Each server snapshots its shard to ``<path>.shard<i>``."""
        for s in range(len(self._conns)):
            self._request(s, _OP_SAVE, f"{path}.shard{s}".encode())

    def load(self, path: str, merge: bool = False) -> None:
        for s in range(len(self._conns)):
            body = struct.pack("<B", 1 if merge else 0) + \
                f"{path}.shard{s}".encode()
            self._request(s, _OP_LOAD, body)

    def barrier(self, world: int, timeout: Optional[float] = 600.0) -> None:
        """Block until ``world`` clients reach the barrier (server 0
        coordinates, cf. the reference's Gloo/brpc worker barrier).

        Uses a dedicated connection: a barrier blocks server-side until the
        world arrives, and holding the shared channel's lock for that long
        would deadlock concurrent callers on this client."""
        conn = _Conn(*self.endpoints[0], timeout=timeout)
        try:
            conn.request(_OP_BARRIER, struct.pack("<I", int(world)))
        finally:
            conn.close()

    def stop_servers(self) -> None:
        for s in range(len(self._conns)):
            try:
                with self._locks[s]:
                    if self._conns[s] is None:
                        self._conns[s] = _Conn(*self.endpoints[s])
                    self._conns[s].request(_OP_STOP)
            except (PsRpcError, OSError):
                pass  # server exits as it acks; a dropped ack is fine

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False)
        for conn in self._conns:
            if conn is not None:
                conn.close()


def _merge_grads(keys: np.ndarray, grads: np.ndarray):
    """Sum grads of duplicate keys (the communicator's merge-before-send,
    ``communicator.h`` MergeVars)."""
    uniq, inv = np.unique(keys, return_inverse=True)
    merged = np.zeros((uniq.size, grads.shape[1]), np.float32)
    np.add.at(merged, inv, grads)
    return uniq, merged


class Communicator:
    """Background gradient sender over a :class:`PsClient`.

    Modes (reference ``communicator.h``):
      - ``"sync"``: ``push`` sends immediately (blocking), one RPC per call.
      - ``"async"``: ``push`` enqueues; a background thread drains the queue,
        merging duplicate keys per batch (``AsyncCommunicator::Start``).
      - ``"geo"``: the DELTA-TRAIN trick (``GeoCommunicator``,
        ``communicator.h:596``): gradients apply to a local SGD shadow copy
        immediately (lr = ``geo_lr``); every ``k_steps`` pushes, the
        parameter deltas (shadow − base) are shipped and merged additively
        on the server (``push_raw``), then the shadow re-bases on the fresh
        server values — so other workers' deltas fold in. Training sees
        zero push latency; the cost is k steps of parameter lag.

    ``flush()`` drains everything (end of epoch / before save/eval).
    """

    def __init__(self, client: PsClient, mode: str = "async",
                 k_steps: int = 4, max_queue: int = 64, geo_lr: float = 1.0):
        if mode not in ("sync", "async", "geo"):
            raise ValueError(f"unknown communicator mode {mode!r}")
        self.client = client
        self.mode = mode
        self.k_steps = int(k_steps)
        self.geo_lr = float(geo_lr)
        self._queue: "queue.Queue" = queue.Queue(maxsize=max_queue)
        # geo state: key -> [base_row, shadow_row]
        self._geo_base: Dict[int, np.ndarray] = {}
        self._geo_shadow: Dict[int, np.ndarray] = {}
        self._geo_count = 0
        self._err: Optional[BaseException] = None
        self._running = mode == "async"
        self._thread = None
        if self._running:
            self._thread = threading.Thread(target=self._drain, daemon=True)
            self._thread.start()

    def push(self, keys, grads) -> None:
        if self._err is not None:
            raise self._err
        keys = np.asarray(keys, np.int64).reshape(-1)
        grads = np.asarray(grads, np.float32).reshape(
            keys.size, self.client.embed_dim)
        if self.mode == "sync":
            self.client.push(keys, grads)
        elif self.mode == "async":
            self._queue.put((keys, grads))
        else:  # geo: local apply now, deltas shipped every k steps
            self._geo_apply(keys, grads)
            self._geo_count += 1
            if self._geo_count >= self.k_steps:
                self._send_geo()

    def pull(self, keys) -> np.ndarray:
        """Geo-aware pull: in geo mode, locally-trained shadow rows win over
        (lagged) server rows, so the worker trains on its own freshest
        parameters — the reference's local-first lookup."""
        keys = np.asarray(keys, np.int64).reshape(-1)
        rows = self.client.pull(keys)
        if self.mode == "geo":
            for i, k in enumerate(keys.tolist()):
                sh = self._geo_shadow.get(k)
                if sh is not None:
                    rows[i] = sh
        return rows

    def _geo_apply(self, keys: np.ndarray, grads: np.ndarray) -> None:
        # first touch pulls base rows from the server in one batch
        fresh = [k for k in np.unique(keys).tolist()
                 if k not in self._geo_base]
        if fresh:
            rows = self.client.pull(np.asarray(fresh, np.int64))
            for k, r in zip(fresh, rows):
                self._geo_base[k] = r.copy()
                self._geo_shadow[k] = r.copy()
        for i, k in enumerate(keys.tolist()):
            self._geo_shadow[k] -= self.geo_lr * grads[i]

    def _send_geo(self) -> None:
        """Ship deltas for the keys touched this window, then EVICT the
        whole local state: per-window cost and worker memory stay bounded
        by the window's working set, not the epoch's (a CTR epoch touches
        millions of distinct keys). The next window's first touch re-pulls
        fresh server rows — which by then include this worker's deltas and
        everyone else's."""
        self._geo_count = 0
        if not self._geo_shadow:
            return
        keys = np.asarray(list(self._geo_shadow.keys()), np.int64)
        deltas = np.stack([self._geo_shadow[k] - self._geo_base[k]
                           for k in keys.tolist()])
        moved = np.abs(deltas).max(axis=1) > 0
        if moved.any():
            self.client.push_raw(keys[moved], deltas[moved])
        self._geo_base.clear()
        self._geo_shadow.clear()

    def _drain(self) -> None:
        while self._running or not self._queue.empty():
            batch = []
            try:
                batch.append(self._queue.get(timeout=0.05))
            except queue.Empty:
                continue
            # opportunistically coalesce whatever is queued
            while True:
                try:
                    batch.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            try:
                keys = np.concatenate([k for k, _ in batch])
                grads = np.concatenate([g for _, g in batch])
                uniq, merged = _merge_grads(keys, grads)
                self.client.push(uniq, merged)
            except BaseException as e:
                self._err = e
                # account for everything queued so flush()'s join() can't
                # hang on items this dead thread will never process
                for _ in batch:
                    self._queue.task_done()
                while True:
                    try:
                        self._queue.get_nowait()
                        self._queue.task_done()
                    except queue.Empty:
                        break
                return
            for _ in batch:
                self._queue.task_done()

    def flush(self) -> None:
        if self._err is not None:
            raise self._err
        if self.mode == "geo":
            self._send_geo()
        elif self.mode == "async":
            # join() with an escape hatch: if the drain thread died, items
            # enqueued after its final sweep would never be task_done'd
            with self._queue.all_tasks_done:
                while self._queue.unfinished_tasks:
                    if self._err is not None:
                        raise self._err
                    self._queue.all_tasks_done.wait(timeout=0.1)
        if self._err is not None:
            raise self._err

    def stop(self) -> None:
        self.flush()
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


def launch_servers(num_servers: int, embed_dim: int, optimizer: str = "adagrad",
                   learning_rate: float = 0.05, seed: int = 0,
                   timeout: float = 30.0):
    """Spawn ``num_servers`` PS server subprocesses on ephemeral ports.

    Returns ``(procs, endpoints)``; each server prints ``PORT <p>`` on stdout
    once bound (the rendezvous handshake — the reference publishes endpoints
    through gloo/etcd instead). The native library is built first, so
    the servers load this process's build instead of racing to make one.
    """
    native.build()
    argv = [sys.executable, "-m", "paddle_tpu_torch.distributed.ps.server",
            "--port", "0", "--embed-dim", str(embed_dim),
            "--optimizer", optimizer, "--lr", str(learning_rate),
            "--seed", str(seed)]
    return launch_port_subprocesses([argv] * num_servers, timeout=timeout)


def launch_port_subprocesses(argvs, timeout: float = 30.0):
    """Spawn one subprocess per argv; each must print ``PORT <p>`` on stdout
    once its server socket is bound. Returns ``(procs, endpoints)``."""
    from ...utils.procutil import pdeathsig_preexec

    procs, endpoints = [], []
    for argv in argvs:
        # servers die with the client (PDEATHSIG): an aborted test/bench
        # run must not leave shard servers running for hours
        procs.append(subprocess.Popen(argv, stdout=subprocess.PIPE,
                                      preexec_fn=pdeathsig_preexec()))
    deadline = time.time() + timeout

    def fail(exc):
        for q in procs:
            q.kill()
        raise exc

    for p in procs:
        buf = b""
        while True:
            remaining = deadline - time.time()
            if remaining <= 0:
                fail(TimeoutError("PS server startup timed out"))
            # select, not readline: readline would block past the deadline
            # if the server hangs before printing its PORT line
            ready, _, _ = select.select([p.stdout], [], [], remaining)
            if not ready:
                fail(TimeoutError("PS server startup timed out"))
            chunk = p.stdout.read1(4096)
            if not chunk:
                fail(RuntimeError("PS server failed to start"))
            buf += chunk
            # only parse newline-terminated lines: read1 can split "PORT
            # 12345\n" mid-number, and a truncated int would be a wrong port
            complete, _, _ = buf.rpartition(b"\n")
            for line in complete.decode(errors="replace").splitlines():
                if line.startswith("PORT "):
                    endpoints.append(("127.0.0.1", int(line.split()[1])))
                    break
            else:
                continue
            break
    return procs, endpoints
