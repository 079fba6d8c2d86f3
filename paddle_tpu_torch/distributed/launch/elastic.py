"""Elastic membership over the launch KV store (port of
``paddle_tpu/distributed/launch/elastic.py``).

Reference parity: ``python/paddle/distributed/fleet/elastic/manager.py:127``
(``ElasticManager``: etcd lease per node, watch on the node directory,
world resize between ``--nnodes min:max``). As in the JAX package, the
builtin HTTP KV store grows etcd-style TTL leases (``kv_server.py``), each
launcher heartbeats its node key, and membership IS the set of live lease
keys — no etcd dependency, same semantics:

- node loss    -> lease expires -> watchers see a smaller membership,
  terminate their pods and re-rendezvous at the new world size;
- node arrival -> new lease key -> watchers see a larger membership and
  resize up (scale-up), as long as max_nodes allows.

Workers resume from the latest AutoCheckpoint
(:mod:`paddle_tpu_torch.distributed.checkpoint`), whose
``load_state(shardings=)`` re-slices sharded state onto the new topology
— the part the reference delegates to ``fleet.save/load`` + program
re-build. The heartbeat's stop event is ``_stopping`` (a ``_stop``
attribute would shadow ``threading.Thread._stop`` on thread objects).
"""
from __future__ import annotations

import json
import threading
import time
from typing import List, Optional

from ..resilience import RetryPolicy, fault_point
from .kv_server import KVClient


class ElasticManager:
    """One per launcher process. ``node_id`` must be unique per launcher
    incarnation (a rejoining host gets a fresh id, so membership hashes
    never collide across generations).

    Heartbeat health is OBSERVABLE: the thread never dies silently — any
    exception (transport or otherwise) is recorded in ``last_error`` and
    the tick keeps running; :meth:`is_healthy` reports whether a beat
    landed recently enough for our lease to still be alive, and the
    launcher polls it to warn before the rest of the cluster notices.
    """

    def __init__(self, kv_endpoint: str, job_id: str, node_id: str,
                 ttl: float = 6.0):
        # per-request timeout of ttl/4: two heartbeat attempts + backoff
        # always finish inside the lease TTL, so a slow-but-alive store
        # can never stall the refresh long enough to expire our own lease
        # (no fixed floor — it would break the invariant for small TTLs)
        self.kv = KVClient(kv_endpoint, timeout=max(0.05, ttl / 4.0))
        self.job_id = job_id
        self.node_id = node_id
        self.ttl = ttl
        self._prefix = f"elastic/{job_id}/nodes/"
        self._key = f"{self._prefix}{node_id}"
        self._stopping = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None
        self._last_beat: Optional[float] = None  # monotonic, successful PUT
        # one tick = a couple of quick attempts; the outer loop is the
        # long-horizon retry, so a tick must never outlive its period
        self._beat_policy = RetryPolicy(max_attempts=2, base_delay=0.1,
                                        max_delay=0.5)

    # ------------------------------------------------------ lease lifecycle
    def register(self, timeout: Optional[float] = None) -> None:
        """Write our lease (retrying transport failures up to ``timeout``,
        default one TTL) and start the heartbeat thread."""
        policy = RetryPolicy(deadline=timeout or self.ttl, base_delay=0.2)
        policy.call(lambda: self.kv.put(self._key, "1", ttl=self.ttl),
                    what=f"elastic register {self.node_id}")
        self._last_beat = time.monotonic()
        self._thread = threading.Thread(target=self._heartbeat, daemon=True)
        self._thread.start()

    def _beat_once(self) -> None:
        fault_point("elastic.heartbeat")
        self.kv.put(self._key, "1", ttl=self.ttl)

    def _heartbeat(self) -> None:
        while not self._stopping.wait(self.ttl / 3.0):
            try:
                self._beat_policy.call(self._beat_once,
                                       what="elastic heartbeat")
            except BaseException as e:  # surfaced, never silently fatal
                self.last_error = e
            else:
                self.last_error = None
                self._last_beat = time.monotonic()

    def is_healthy(self) -> bool:
        """True while the heartbeat thread is alive and a beat landed
        within the lease TTL (i.e. our membership key cannot have expired
        for lack of refreshes)."""
        if self._thread is None or not self._thread.is_alive():
            return self._stopping.is_set()  # post-leave() is not "unhealthy"
        return (self._last_beat is not None
                and time.monotonic() - self._last_beat < self.ttl)

    def leave(self) -> None:
        self._stopping.set()
        if self._thread is not None:
            self._thread.join(timeout=self.ttl)
        try:
            self.kv.delete(self._key)
        except OSError:
            pass

    # ---------------------------------------------------------- membership
    def members(self) -> List[str]:
        return sorted(k[len(self._prefix):]
                      for k in self.kv.list(self._prefix))

    def wait_stable(self, min_nodes: int, max_nodes: int,
                    timeout: float = 300.0, settle: float = 1.0) -> List[str]:
        """Block until membership has >= min_nodes and hasn't changed for
        ``settle`` seconds (or has reached max_nodes) — the reference's
        pre-launch hold that lets stragglers join before ranks freeze.

        Returns the FULL membership (may exceed max_nodes): the caller
        takes ``members[:max_nodes]`` as the active set and keeps overflow
        nodes as spares, so every node computes the same view."""
        state = {"last": None, "changed": time.monotonic()}

        def stable() -> Optional[List[str]]:
            cur = self.members()  # OSError retries through the policy
            if cur != state["last"]:
                state["last"], state["changed"] = cur, time.monotonic()
            if len(cur) >= max_nodes:
                return cur
            if (len(cur) >= min_nodes
                    and time.monotonic() - state["changed"] >= settle):
                return cur
            return None

        policy = RetryPolicy(deadline=timeout, base_delay=0.2,
                             multiplier=1.0, max_delay=0.5)
        try:
            return policy.until(stable, what="elastic rendezvous")
        except TimeoutError:
            raise TimeoutError(
                f"elastic rendezvous: {len(state['last'] or [])}/{min_nodes} "
                f"nodes after {timeout}s") from None

    def watch(self, baseline: List[str], interval: float = 1.0,
              stop: Optional[threading.Event] = None) -> List[str]:
        """Block until membership differs from ``baseline``; returns the new
        membership (the etcd watch loop, polled)."""
        while stop is None or not stop.is_set():
            time.sleep(interval)
            try:
                cur = self.members()
            except OSError:
                continue
            if cur != baseline:
                return cur
        return baseline

    # ---------------------------------------------------------- rendezvous
    def publish_coordinator(self, addr: str, members: List[str]) -> int:
        """Leader (lowest active member id) announces the JAX coordinator.
        Each publish bumps a monotonic generation so a *restart with
        unchanged membership* still produces a distinguishable value —
        followers matching only on the member list could otherwise grab the
        previous (dead) coordinator address. Returns the generation."""
        key = f"elastic/{self.job_id}/coord"
        raw = self.kv.get(key)
        gen = (json.loads(raw)["gen"] + 1) if raw else 1
        self.kv.put(key, json.dumps(
            {"addr": addr, "members": members, "gen": gen}))
        return gen

    def wait_coordinator(self, members: List[str], min_gen: int = 1,
                         timeout: float = 120.0) -> tuple:
        """Followers poll until a coordinator is published whose member list
        matches their view AND whose generation is >= ``min_gen`` (strictly
        newer than any coordinator this follower already used). Returns
        ``(addr, gen)``."""
        def published():
            raw = self.kv.get(f"elastic/{self.job_id}/coord")
            if raw:
                data = json.loads(raw)
                if (data["members"] == members
                        and data.get("gen", 0) >= min_gen):
                    return data["addr"], data["gen"]
            return None

        policy = RetryPolicy(deadline=timeout, base_delay=0.2,
                             multiplier=1.0, max_delay=0.5)
        try:
            return policy.until(published, what="elastic coordinator")
        except TimeoutError:
            raise TimeoutError("elastic: coordinator for current membership "
                               "never published") from None
